"""Parity of the port's hybrid family (jamba) with the JAX reference on the CPU.

jamba-1.5-large-398b at its smoke size (``configs.smoke_variant``: 4 layers
in 2 periods of attention + MoE (4 experts, top-2), mamba + MLP; d_model 64,
4 heads of 16, SSM state 16, chunk 8, vocab 512, f32 compute), weights drawn
by the reference and carried across with ``convert.params_from_jax``.  The
reference runs its Pallas kernels in interpret mode, the port the kernels'
plain versions (CPU tensors).  Tolerance ``TOL`` (rtol = atol = 1e-4).

* Parameter tree paths (``periods/sub{j}/mixer/...``) and use-paths equal
  the reference's; forward logits.
* A ragged-``prompt_lens`` prefill into paged and contiguous caches, and a
  decode step with the attention sublayers on the flash-decode path (K5),
  packed (``lazy_int8(7)``: one K3 call a projection and an expert) and
  unpacked: logits and every cache leaf.  The prefill is a loop of decode
  steps whose attention writes K/V in place: a padded step writes the
  slot's frozen position, and the test shows that this is the only
  difference from the reference's pools and that the next decode step
  overwrites it before reading it.
* ``Session.serve`` at smoke size, paged, flash: K3 and K5 launched.
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
from repro.models import hybrid as jhyb
from repro.models.common import ParamCtx as JParamCtx
from repro.models.common import pack_params_for_serving as jpack
from repro_torch.api import PrecisionPolicy, RunSpec, Session
from repro_torch.configs import get_config, smoke_variant
from repro_torch.dist.collectives import AxisCtx
from repro_torch.kernels import ops
from repro_torch.launch.paging import set_page_tables
from repro_torch.models import hybrid as thyb
from repro_torch.models.common import ParamCtx, QTensor
from repro_torch.models.convert import caches_from_jax, params_from_jax

ARCH = "jamba-1.5-large-398b"
B, S_MAX, PAGE, S_P = 3, 16, 4, 8
PLENS = np.array([8, 5, 3], np.int32)
TOL = dict(rtol=1e-4, atol=1e-4)
TABLE = np.array([[5, 1, 7, -1], [0, 3, -1, -1], [2, -1, 6, 9]], np.int32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cfgs():
    return jsmoke(jget_config(ARCH)), smoke_variant(get_config(ARCH))


@pytest.fixture(scope="module")
def jparams(cfgs):
    return jhyb.init_hybrid(cfgs[0], jax.random.PRNGKey(0), 1)


@pytest.fixture(scope="module")
def packed(jparams):
    jq = jpack(jparams, 7, jax.random.PRNGKey(1), exempt=jexempt)
    return jq, params_from_jax(jq)


def _ctxs(packed_: bool, transforms=(None, None)):
    if packed_:
        return (JParamCtx.from_policy(JAxisCtx((), None, ()), JPolicy.lazy_int8(7),
                                      compute_dtype=jnp.float32),
                ParamCtx.from_policy(AxisCtx(), PrecisionPolicy.lazy_int8(7),
                                     compute_dtype=torch.float32))
    return (JParamCtx(ctx=JAxisCtx((), None, ()), compute_dtype=jnp.float32,
                      transform=transforms[0]),
            ParamCtx(ctx=AxisCtx(), compute_dtype=torch.float32, transform=transforms[1]))


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=msg, **TOL)


def _assert_tree_close(tcache, jcache, skip_pools=False):
    assert tcache.keys() == jcache.keys()
    for sub in tcache:
        t, j = tcache[sub], jcache[sub]
        assert type(t).__name__ == type(j).__name__, sub
        for name in type(t)._fields:
            if skip_pools and name in ("k_pages", "v_pages", "k", "v"):
                continue
            got, want = getattr(t, name).numpy(), np.asarray(getattr(j, name))
            if got.dtype.kind in "iu":
                np.testing.assert_array_equal(got, want, err_msg=f"{sub}.{name}")
            else:
                np.testing.assert_allclose(got, want, err_msg=f"{sub}.{name}", **TOL)


def test_params_and_forward_match_reference(cfgs, jparams):
    jc, tc = cfgs
    tp = params_from_jax(jparams)
    mine = thyb.init_hybrid(tc, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: tuple(v.shape) for k, v in tp.items()}
    for path in ("periods/sub0/mixer/wq", "periods/sub0/ffn/router", "periods/sub0/ffn/w_up",
                 "periods/sub1/mixer/conv_x", "periods/sub1/mixer/a_log",
                 "periods/sub1/ffn/w_gate", "periods/sub1/ln2"):
        assert tp[path].shape[0] == 2, path                   # stacked over 2 periods
    assert tp["periods/sub0/ffn/w_up"].shape == (2, 4, 64, 32)
    seen = {"jax": set(), "torch": set()}
    jpc, tpc = _ctxs(False, (lambda p, w: seen["jax"].add(p) or w,
                             lambda p, w: seen["torch"].add(p) or w))
    toks = np.random.default_rng(0).integers(2, 512, (B, 16)).astype(np.int32)
    jl = jhyb.forward(jc, jpc, jparams, jnp.asarray(toks))
    tl = thyb.forward(tc, tpc, tp, torch.from_numpy(toks))
    _close(tl, jl)
    assert seen["torch"] == seen["jax"]
    assert {"sub0/attn/wq", "sub0/moe/w_up", "sub1/ssm/wx", "sub1/mlp/w_down"} <= seen["torch"]


def _pool_rows(positions):
    """Rows of the (pool * page) view holding slot b's position p."""
    return [int(TABLE[b, p // PAGE]) * PAGE + p % PAGE for b, p in positions
            if TABLE[b, p // PAGE] >= 0]


@pytest.mark.parametrize("layout, weights", [("paged", "packed"), ("paged", "f32"),
                                            ("contiguous", "f32")])
def test_ragged_prefill_and_decode_match_reference(cfgs, jparams, packed, weights, layout,
                                                   monkeypatch):
    jc, tc = cfgs
    if weights == "packed":
        jp, tp = packed
        assert isinstance(tp["periods/sub1/mixer/wx"], QTensor)
        assert not isinstance(tp["periods/sub0/ffn/router"], QTensor)
    else:
        jp, tp = jparams, params_from_jax(jparams)
    jpc, tpc = _ctxs(weights == "packed")
    calls = {"k3": 0, "k5": 0}
    k3, k5 = ops.quant_matmul, ops.flash_paged_decode

    def count(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(ops, "quant_matmul", count("k3", k3))
    monkeypatch.setattr(ops, "flash_paged_decode", count("k5", k5))
    kw = {"page_size": PAGE, "pool_pages": 10} if layout == "paged" else {}
    jcache = jhyb.init_hybrid_caches(jc, B, S_MAX, 1, jnp.float32, **kw)
    tcache = thyb.init_hybrid_caches(tc, B, S_MAX, 1, torch.float32, **kw)
    if layout == "paged":
        jcache, tcache = jset_page_tables(jcache, TABLE), set_page_tables(tcache, TABLE)
    toks = np.random.default_rng(1).integers(2, 512, (B, S_P)).astype(np.int32)
    jl, jcache = jhyb.prefill(jc, jpc, jp, jnp.asarray(toks), jcache,
                              prompt_lens=jnp.asarray(PLENS))
    tl, tcache = thyb.prefill(tc, tpc, tp, torch.from_numpy(toks), tcache, attn_impl="flash",
                              prompt_lens=torch.from_numpy(PLENS))
    _close(tl, jl)
    assert calls["k5"] == 0                 # prefill attends through the gather path
    _assert_tree_close(tcache, jcache, skip_pools=True)
    # the K/V storage: equal but at each padded slot's frozen position,
    # where the port's in-place decode wrote the pad token
    pad = [(b, int(p)) for b, p in enumerate(PLENS) if p < S_P]
    if layout == "paged":
        rows = _pool_rows(pad)
        assert len(rows) == 2
        flat = lambda a: np.asarray(a).reshape((a.shape[0], -1) + a.shape[-2:])  # noqa: E731
        got, want = flat(tcache["sub0"].k_pages.numpy()), flat(jcache["sub0"].k_pages)
        other = np.setdiff1d(np.arange(got.shape[1]), rows)
    else:
        got, want = tcache["sub0"].k.numpy(), np.asarray(jcache["sub0"].k)
        got, want = got.reshape(2, -1, *got.shape[-2:]), want.reshape(2, -1, *want.shape[-2:])
        rows = [b * S_MAX + p for b, p in pad]
        other = np.setdiff1d(np.arange(got.shape[1]), rows)
    np.testing.assert_allclose(got[:, other], want[:, other], **TOL)
    assert not want[:, rows].any() and np.abs(got[:, rows]).min(axis=(0, 2, 3)).all()
    # one decode step from each side's own prefill: the pad rows are
    # overwritten by the new token before it attends, so logits and every
    # cache leaf agree, the pools entirely
    tok = np.array([[11], [7], [300]], np.int32)
    jd, jc2 = jhyb.decode_step(jc, jpc, jp, jnp.asarray(tok), jcache, attn_impl="flash")
    calls.update(k3=0, k5=0)
    td, tc2 = thyb.decode_step(tc, tpc, tp, torch.from_numpy(tok), tcache, attn_impl="flash")
    _close(td, jd)
    _assert_tree_close(tc2, jc2)
    # and from the reference's caches carried across
    td2, _ = thyb.decode_step(tc, tpc, tp, torch.from_numpy(tok), caches_from_jax(jcache),
                              attn_impl="flash")
    _close(td2, jd)
    # a decode step: per period attention 4, the MoE's 3 an expert, SSM 5,
    # MLP 3; and the head (packed).  K5 once a period on the paged layout
    n_periods, e = tc.n_layers // tc.attn_period, tc.n_experts
    assert calls["k3"] == (((4 + 3 * e + 5 + 3) * n_periods + 1) * 2
                           if weights == "packed" else 0)
    assert calls["k5"] == (2 * n_periods if layout == "paged" else 0)


def test_session_serves_jamba_smoke_through_k3_and_k5(monkeypatch):
    calls = {"k3": 0, "k5": 0}
    k3, k5 = ops.quant_matmul, ops.flash_paged_decode
    monkeypatch.setattr(ops, "quant_matmul",
                        lambda *a: calls.__setitem__("k3", calls["k3"] + 1) or k3(*a))
    monkeypatch.setattr(ops, "flash_paged_decode",
                        lambda *a: calls.__setitem__("k5", calls["k5"] + 1) or k5(*a))
    spec = RunSpec(ARCH, workload="serve", smoke=True, seed=0, batch=2, seq=32,
                   precision=PrecisionPolicy.lazy_int8(7),
                   options={"attn_impl": "flash", "kv_layout": "paged", "prompt_len": 8,
                            "requests": 3, "max_new": 4, "steps": 16, "vary_prompt": True,
                            "quiet": True})
    stats = Session(spec, device="cpu").serve()
    assert stats.admitted == stats.completed == 3
    assert stats.kv_layout == "paged" and stats.kv_bytes > 0
    cfg = smoke_variant(get_config(ARCH))
    per_pass = (4 + 3 * cfg.n_experts + 5 + 3) * (cfg.n_layers // cfg.attn_period) + 1
    assert calls["k3"] > 0 and calls["k3"] % per_pass == 0 and calls["k5"] > 0
