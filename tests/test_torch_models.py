"""Module-level parity of the PyTorch port against the JAX reference.

yi-6b at its smoke size (2 layers, d_model 64, 4 heads, head_dim 16, f32
compute), weights drawn by the reference and carried across with
``convert.params_from_jax``.  The reference runs its Pallas kernels in
interpret mode; the port runs the kernels' plain versions (CPU tensors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.precision import PrecisionPolicy as JPolicy
from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.core.quantization import default_exempt as jexempt
from repro.dist.collectives import AxisCtx as JAxisCtx
from repro.launch.paging import set_page_tables as jset_page_tables
from repro.models import attention as jattn
from repro.models import transformer as jtr
from repro.models.common import ParamCtx as JParamCtx
from repro.models.common import pack_params_for_serving as jpack
from repro_torch.api.precision import PrecisionPolicy
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.quantization import default_exempt
from repro_torch.dist.collectives import AxisCtx
from repro_torch.launch.paging import set_page_tables
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttr
from repro_torch.models.common import ParamCtx, QTensor, pack_params_for_serving
from repro_torch.models.convert import caches_from_jax, params_from_jax

B, S_MAX, PAGE, S_P = 3, 32, 4, 8
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors gain nothing from intra-op threads, and the suite runs
    several workers on few cores: keep this module's PyTorch to one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cfgs():
    return jsmoke(jget_config("yi-6b")), smoke_variant(get_config("yi-6b"))


@pytest.fixture(scope="module")
def jparams(cfgs):
    return jtr.init_lm(cfgs[0], jax.random.PRNGKey(0), 1)


@pytest.fixture(scope="module")
def packed(jparams):
    """(reference packed tree, the port's dict converted from it)."""
    jq = jpack(jparams, 7, jax.random.PRNGKey(1), exempt=jexempt)
    return jq, params_from_jax(jq)


def _ctxs():
    return (JParamCtx.from_policy(JAxisCtx((), None, ()), JPolicy.lazy_int8(7),
                                  compute_dtype=jnp.float32),
            ParamCtx.from_policy(AxisCtx(), PrecisionPolicy.lazy_int8(7),
                                 compute_dtype=torch.float32))


def _table():
    """Slot 0 owns 3 pages, slot 1 owns 2 (prompt fills them), slot 2 owns
    pages with a hole (-1) after its prompt."""
    t = np.full((B, S_MAX // PAGE), -1, np.int32)
    t[0, :3] = [5, 1, 7]
    t[1, :2] = [0, 3]
    t[2, :3] = [2, -1, 6]
    return t


def _caches(cfgs, layout):
    jc, tc = cfgs
    kw = {}
    if layout == "paged":
        kw = {"page_size": PAGE, "pool_pages": 10}
    jcache = jtr.init_caches(jc, B, S_MAX, 1, jnp.float32, **kw)
    tcache = ttr.init_caches(tc, B, S_MAX, 1, torch.float32, device="cpu", **kw)
    if layout == "paged":
        jcache = jset_page_tables(jcache, _table())
        tcache = set_page_tables(tcache, _table())
    return jcache, tcache


def _assert_caches_close(tcache, jcache):
    for name in type(tcache)._fields:
        got, want = getattr(tcache, name).numpy(), np.asarray(getattr(jcache, name))
        assert got.shape == want.shape, name
        if got.dtype.kind in "iu":
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, err_msg=name, **TOL)


@pytest.mark.parametrize("bits", [7, 12])
def test_packing_bit_exact(jparams, bits):
    jq = jpack(jparams, bits, jax.random.PRNGKey(1), exempt=jexempt)
    tq = pack_params_for_serving(params_from_jax(jparams), bits, exempt=default_exempt)
    want = params_from_jax(jq)
    assert set(tq) == set(want)
    n_packed = 0
    for path, w in want.items():
        got = tq[path]
        assert isinstance(got, QTensor) == isinstance(w, QTensor), path
        if isinstance(w, QTensor):
            n_packed += 1
            assert got.codes.dtype == w.codes.dtype, path
            np.testing.assert_array_equal(got.codes.numpy(), w.codes.numpy(), err_msg=path)
            np.testing.assert_array_equal(got.scale.numpy(), w.scale.numpy(), err_msg=path)
        else:
            np.testing.assert_array_equal(got.numpy(), w.numpy(), err_msg=path)
    # every projection and the embedding pack; the norms stay f32
    assert n_packed == 9
    assert tq["blocks/attn/wq"].scale.shape == (2,)       # per-layer scales
    assert tq["embed/table"].scale.shape == ()


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
@pytest.mark.parametrize("impl", ["flash", "auto", "chunked"])
def test_prefill_logits_and_caches(cfgs, packed, layout, impl):
    jq, tq = packed
    jpc, tpc = _ctxs()
    jcache, tcache = _caches(cfgs, layout)
    toks = np.random.default_rng(0).integers(2, 512, size=(B, S_P)).astype(np.int32)
    plens = np.array([8, 5, 3], np.int32)
    jl, jc = jtr.prefill(cfgs[0], jpc, jq, jnp.asarray(toks), jcache, attn_impl=impl,
                         prompt_lens=jnp.asarray(plens))
    tl, tc = ttr.prefill(cfgs[1], tpc, tq, torch.from_numpy(toks), tcache,
                         attn_impl=impl, prompt_lens=torch.from_numpy(plens))
    assert tl.shape == (B, 1, 512)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_caches_close(tc, jc)


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
@pytest.mark.parametrize("impl", ["flash", "ref"])
def test_decode_step(cfgs, packed, layout, impl):
    jq, tq = packed
    jpc, tpc = _ctxs()
    jcache, _ = _caches(cfgs, layout)
    toks = np.random.default_rng(1).integers(2, 512, size=(B, S_P)).astype(np.int32)
    plens = jnp.asarray([8, 5, 3], jnp.int32)
    _, jcache = jtr.prefill(cfgs[0], jpc, jq, jnp.asarray(toks), jcache,
                            attn_impl="auto", prompt_lens=plens)
    tcache = caches_from_jax(jcache)      # both steps start from one cache
    tok = np.array([[11], [7], [300]], np.int32)
    jl, jc = jtr.decode_step(cfgs[0], jpc, jq, jnp.asarray(tok), jcache, attn_impl=impl)
    tl, tc = ttr.decode_step(cfgs[1], tpc, tq, torch.from_numpy(tok), tcache,
                             attn_impl=impl)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_caches_close(tc, jc)
    np.testing.assert_array_equal(tc.length.numpy(), np.broadcast_to([9, 6, 4], (2, B)))


def test_merge_slot_caches_paged(cfgs):
    rng = np.random.default_rng(2)
    jold, _ = _caches(cfgs, "paged")
    jnew = jold._replace(
        k_pages=jnp.asarray(rng.standard_normal(jold.k_pages.shape), jnp.float32),
        v_pages=jnp.asarray(rng.standard_normal(jold.v_pages.shape), jnp.float32),
        length=jnp.asarray(rng.integers(1, 9, size=jold.length.shape), jnp.int32))
    jold = jold._replace(k_pages=jold.k_pages + 1.0)
    keep = np.array([True, False, True])
    want = jattn.merge_slot_caches(jold, jnew, jnp.asarray(keep))
    got = tattn.merge_slot_caches(caches_from_jax(jold), caches_from_jax(jnew),
                                  torch.from_numpy(keep))
    _assert_caches_close(got, want)


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
@pytest.mark.parametrize("lengths", [(32, 8, 3), (32, 32, 32)],
                         ids=["some-dropped", "all-dropped"])
def test_decode_drops_out_of_range_writes(cfgs, packed, layout, lengths):
    """Slot 0 at capacity and (paged) slot 1 writing into an unallocated page
    lose their token's K/V, exactly as the reference's mode="drop" writes
    do; every other row of the cache is left as it was."""
    jq, tq = packed
    jpc, tpc = _ctxs()
    jcache, _ = _caches(cfgs, layout)
    toks = np.random.default_rng(3).integers(2, 512, size=(B, S_P)).astype(np.int32)
    _, jcache = jtr.prefill(cfgs[0], jpc, jq, jnp.asarray(toks), jcache,
                            attn_impl="auto", prompt_lens=jnp.asarray([8, 8, 3], jnp.int32))
    jcache = jcache._replace(length=jnp.broadcast_to(
        jnp.asarray(lengths, jnp.int32), jcache.length.shape))
    tcache = caches_from_jax(jcache)
    tok = np.array([[11], [7], [300]], np.int32)
    impl = "flash" if layout == "paged" else "ref"
    jl, jc = jtr.decode_step(cfgs[0], jpc, jq, jnp.asarray(tok), jcache, attn_impl=impl)
    tl, tc = ttr.decode_step(cfgs[1], tpc, tq, torch.from_numpy(tok), tcache,
                             attn_impl=impl)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_caches_close(tc, jc)


def test_demote_kv_cache_matches_reference(cfgs):
    """f32 -> bf16 pool demotion rounds as the reference does (and bf16
    leaves cross from the reference as bf16)."""
    rng = np.random.default_rng(4)
    jcache, _ = _caches(cfgs, "paged")
    jcache = jcache._replace(
        k_pages=jnp.asarray(rng.standard_normal(jcache.k_pages.shape), jnp.float32))
    want = caches_from_jax(jattn.demote_kv_cache(jcache, jnp.bfloat16))
    got = tattn.demote_kv_cache(caches_from_jax(jcache), torch.bfloat16)
    for name in tattn.PagedKVCache._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        assert torch.equal(a, b), name
    assert got.k_pages.dtype == torch.bfloat16

