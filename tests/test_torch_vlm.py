"""Parity of the port's VLM family (llama-3.2-vision) with the JAX reference
on the CPU.

llama-3.2-vision-90b at its smoke size (``configs.smoke_variant``: 4 layers
in 2 periods of a gated cross-attention layer and a self-attention layer,
d_model 64, 4 heads of 16, 9 image tokens of width 32, vocab 512, f32
compute), weights drawn by the reference and carried across with
``convert.params_from_jax``, and seeded non-zero images handed to both
packages.  The cross gates are zero-initialised, so that a fresh model's
output does not depend on its images; every parity test sets them to
non-zero values (``GATES``) in both packages.  The reference runs its
Pallas kernels in interpret mode, the port the kernels' plain versions (CPU
tensors).  Tolerance ``TOL`` (rtol = atol = 1e-4).

* Parameter paths and shapes, use-paths, forward logits; packing bit-exact.
* A ragged-``prompt_lens`` prefill (the self-attention through the
  flash-attention kernel's plain version, causal) into paged and contiguous
  caches, and a decode step on the flash-decode path, packed
  (``lazy_int8(7)``) and unpacked: logits and every cache leaf,
  ``cross_k``/``cross_v`` included, also from the reference's caches
  carried across with ``caches_from_jax``.
* ``kv_cache_bytes`` excludes the cross caches.
* ``Session.serve`` at smoke size, paged, flash: K3, K4 and K5; without
  the CPU asked for and without a card, the session raises.
* One 2x1 train step with the SR wire on against the reference in a
  subprocess fed the reference's SR draws; K1's inline calls a step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (assert_tree_close, check_train_step, close, count_serving_kernels,
                           ctxs, k1_inline_calls, reference_step, serve_smoke,
                           start_reference_step)

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.core.quantization import default_exempt as jexempt
from repro.launch import paging as jpaging
from repro.models import vlm as jvlm
from repro.models.common import pack_params_for_serving as jpack
from repro_torch.api import RunSpec, Session
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.quantization import default_exempt
from repro_torch.launch import paging
from repro_torch.models import vlm as tvlm
from repro_torch.models.common import QTensor, pack_params_for_serving
from repro_torch.models.convert import caches_from_jax, params_from_jax

ARCH = "llama-3.2-vision-90b"
B, S_MAX, PAGE, S_P = 3, 16, 4, 8
PLENS = np.array([8, 5, 3], np.int32)
TABLE = np.array([[5, 1, 7, -1], [0, 3, -1, -1], [2, -1, 6, 9]], np.int32)
#: the cross gates every parity test sets (tanh(0.5) and tanh(-0.7))
GATES = {"gate": 0.5, "mlp_gate": -0.7}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _reference_run(tmp_path_factory):
    """The reference's train step (gates :data:`GATES`), started when the
    module's first test starts, so that its compiles overlap the tests
    before the train-step test (which waits for it)."""
    path = str(tmp_path_factory.mktemp("ref") / "ref.npz")
    proc = start_reference_step(ARCH, path, gates=GATES)
    yield proc, path
    proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def cfgs():
    return jsmoke(jget_config(ARCH)), smoke_variant(get_config(ARCH))


def _with_gates(tree):
    """The reference's param tree with the cross gates set to :data:`GATES`."""
    cross = dict(tree["periods"]["cross"])
    for name, g in GATES.items():
        cross[name] = jnp.full(cross[name].shape, g, cross[name].dtype)
    return {**tree, "periods": {**tree["periods"], "cross": cross}}


@pytest.fixture(scope="module")
def jparams(cfgs):
    return _with_gates(jvlm.init_vlm(cfgs[0], jax.random.PRNGKey(0), 1))


@pytest.fixture(scope="module")
def packed(jparams):
    jq = jpack(jparams, 7, jax.random.PRNGKey(1), exempt=jexempt)
    return jq, params_from_jax(jq)


def _images(cfg, n=B, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (n, cfg.n_image_tokens, cfg.d_frontend)).astype(np.float32)


def test_params_uses_and_forward_match_reference(cfgs, jparams, packed):
    jc, tc = cfgs
    tp = params_from_jax(jparams)
    mine = tvlm.init_vlm(tc, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: tuple(v.shape) for k, v in tp.items()}
    for name in GATES:      # zero-initialised, a value a period
        assert mine[f"periods/cross/{name}"].shape == (2,)
        assert not mine[f"periods/cross/{name}"].any()
    assert tp["periods/self0/attn/wq"].shape == (2, 64, 64) and tp["adapter"].shape == (32, 64)
    # packing: the port's of the same f32 weights is the reference's, bit for
    # bit; the 1-D gates stay f32
    mine_q = pack_params_for_serving(tp, 7, exempt=default_exempt)
    for path, q in packed[1].items():
        if isinstance(q, QTensor):
            assert torch.equal(mine_q[path].codes, q.codes), path
            assert torch.equal(mine_q[path].scale, q.scale), path
        else:
            assert not isinstance(mine_q[path], QTensor) and torch.equal(mine_q[path], q)
    assert not isinstance(packed[1]["periods/cross/gate"], QTensor)
    seen = {"jax": [], "torch": []}
    jpc, tpc = ctxs(False, (lambda p, w: seen["jax"].append(p) or w,
                             lambda p, w: seen["torch"].append(p) or w))
    toks = np.random.default_rng(0).integers(2, 512, (B, S_P)).astype(np.int32)
    images = _images(jc)
    jl = jvlm.forward(jc, jpc, jparams, jnp.asarray(toks), jnp.asarray(images))
    tl = tvlm.forward(tc, tpc, tp, torch.from_numpy(toks), torch.from_numpy(images))
    close(tl, jl)
    assert sorted(set(seen["torch"])) == sorted(set(seen["jax"]))
    assert {"adapter", "cross/ln", "cross/attn/wk", "cross/mlp/w_down", "self0/attn/wq",
            "self0/ln2"} <= set(seen["torch"])
    # the hazard the gates hide: at zero gates the images change nothing
    other = torch.from_numpy(_images(jc, seed=9))
    assert not torch.allclose(tvlm.forward(tc, tpc, tp, torch.from_numpy(toks), other), tl)
    zero = {**tp, **{f"periods/cross/{n}": torch.zeros(2) for n in GATES}}
    assert torch.equal(tvlm.forward(tc, tpc, zero, torch.from_numpy(toks), other),
                       tvlm.forward(tc, tpc, zero, torch.from_numpy(toks),
                                    torch.from_numpy(images)))


@pytest.mark.parametrize("layout, weights", [("paged", "packed"), ("paged", "f32"),
                                            ("contiguous", "f32")])
def test_ragged_prefill_and_decode_match_reference(cfgs, jparams, packed, weights, layout,
                                                   monkeypatch):
    jc, tc = cfgs
    jp, tp = packed if weights == "packed" else (jparams, params_from_jax(jparams))
    jpc, tpc = ctxs(weights == "packed")
    calls = count_serving_kernels(monkeypatch)
    kw = {"page_size": PAGE, "pool_pages": 10} if layout == "paged" else {}
    jcache = jvlm.init_vlm_caches(jc, B, S_MAX, 1, jnp.float32, **kw)
    tcache = tvlm.init_vlm_caches(tc, B, S_MAX, 1, torch.float32, **kw)
    if layout == "paged":
        jcache = jpaging.set_page_tables(jcache, TABLE)
        tcache = paging.set_page_tables(tcache, TABLE)
    toks = np.random.default_rng(1).integers(2, 512, (B, S_P)).astype(np.int32)
    images = _images(jc)
    jl, jcache = jvlm.prefill(jc, jpc, jp, jnp.asarray(toks), jnp.asarray(images), jcache,
                              prompt_lens=jnp.asarray(PLENS))
    tl, tcache = tvlm.prefill(tc, tpc, tp, torch.from_numpy(toks), torch.from_numpy(images),
                              tcache, attn_impl="flash", prompt_lens=torch.from_numpy(PLENS))
    close(tl, jl)
    assert_tree_close(tcache, jcache)
    n_periods, self_layers = tc.n_layers // tc.cross_attn_period, tc.cross_attn_period - 1
    assert tcache["cross_k"].shape == (n_periods, B, tc.n_image_tokens, 4, 16)
    # a prefill: K4 (causal) a self layer; K3 the adapter, 7 a layer (a cross
    # layer's q, k, v, o and MLP; a self layer's), and the head (packed)
    assert calls["k4"] == [True] * (n_periods * self_layers)
    assert calls["k3"] == ((7 * tc.n_layers + 2) if weights == "packed" else 0)
    tok = np.array([[11], [7], [300]], np.int32)
    jd, jc2 = jvlm.decode_step(jc, jpc, jp, jnp.asarray(tok), jcache, attn_impl="flash")
    calls.update(k3=0, k5=0)
    td, tc2 = tvlm.decode_step(tc, tpc, tp, torch.from_numpy(tok), tcache, attn_impl="flash")
    close(td, jd)
    assert_tree_close(tc2, jc2)
    # a decode step: a cross layer's q, o and MLP (its K/V cached), 7 a self
    # layer, and the head; K5 a self layer on the paged layout
    assert calls["k3"] == (((5 + 7 * self_layers) * n_periods + 1)
                           if weights == "packed" else 0)
    assert calls["k5"] == (n_periods * self_layers if layout == "paged" else 0)
    td2, _ = tvlm.decode_step(tc, tpc, tp, torch.from_numpy(tok), caches_from_jax(jcache),
                              attn_impl="flash")
    close(td2, jd)


def test_kv_cache_bytes_exclude_the_cross_caches(cfgs):
    jc, tc = cfgs
    for kw in ({"page_size": PAGE, "pool_pages": 10}, {}):
        j = jvlm.init_vlm_caches(jc, B, S_MAX, 1, jnp.float32, **kw)
        t = tvlm.init_vlm_caches(tc, B, S_MAX, 1, torch.float32, **kw)
        assert paging.kv_cache_bytes(t) == jpaging.kv_cache_bytes(j) \
            == paging.kv_cache_bytes(t["self0"]) > 0


def test_session_serves_smoke_through_k3_k4_and_k5(monkeypatch):
    calls = count_serving_kernels(monkeypatch)
    sess, _stats = serve_smoke(ARCH)
    cfg = sess.cfg
    n_periods = cfg.n_layers // cfg.cross_attn_period
    assert calls["k4"] and set(calls["k4"]) == {True}
    prefills = len(calls["k4"]) // n_periods
    decode = calls["k3"] - prefills * (7 * cfg.n_layers + 2)
    per_step = (5 + 7 * (cfg.cross_attn_period - 1)) * n_periods + 1
    assert decode > 0 and decode % per_step == 0, calls
    assert calls["k5"] == decode // per_step * n_periods * (cfg.cross_attn_period - 1)
    # without the CPU asked for, a session asks for the card, and raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in (ARCH, "seamless-m4t-large-v2"):
        with pytest.raises(RuntimeError, match="CUDA"):
            Session(RunSpec(arch, workload="serve", smoke=True))


# ---------------------------------------------------------------------------
# The train step on a 2x1 mesh, SR wire on
# ---------------------------------------------------------------------------


def test_train_step_matches_reference(_reference_run, monkeypatch):
    """Seeded non-zero images, the gates at :data:`GATES`, the reference's
    params and SR draws: the step's loss, parameters and ``comm_report()``
    (``check_train_step``); at smoke width every leaf but the vocab tables
    is too small to shard, so the wire carries 22 leaves, the gates too,
    and the gates learn."""
    params, p1, wire = check_train_step(ARCH, reference_step(*_reference_run), monkeypatch)
    assert float(params["periods/cross/gate"][0]) == GATES["gate"]
    assert len(wire) == 22 and "periods/cross/gate" in wire and "unembed/w" not in wire
    assert not torch.equal(p1["periods/cross/gate"], params["periods/cross/gate"])


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_k1_inline_calls(remat, monkeypatch):
    """Each weight use is one call of K1's inline entry: the embed, the
    adapter and the unembed once, 7 a layer (a cross layer's q, k, v, o and
    MLP; a self layer's), the periods twice under remat; the norms and
    gates never."""
    cfg = dataclasses.replace(smoke_variant(get_config(ARCH)), remat=remat)
    assert k1_inline_calls(cfg, monkeypatch) == 3 + 7 * cfg.n_layers * (2 if remat else 1)
