"""Parity of the port's SSM family (mamba2) with the JAX reference on the CPU.

mamba2-780m at its smoke size (``configs.smoke_variant``: 2 layers, d_model
64, d_inner 128, 8 heads of 16, state 16, chunk 8, vocab 512, f32 compute),
weights drawn by the reference and carried across with
``convert.params_from_jax``.  The reference runs its Pallas kernels in
interpret mode, the port the kernels' plain versions (CPU tensors).
Tolerance ``TOL`` (rtol = atol = 1e-4) unless a test says otherwise.

* ``_ssd_scan`` against the naive recurrence and the reference's scan;
  ``ssm_block`` and ``ssm_decode_step`` against the reference; decode state
  tracking the chunked path; ``ssm_decode_step`` never writes its cache.
* Forward logits; a ragged-``prompt_lens`` prefill (logits and every cache
  leaf: the padding never reaches a slot's state); a decode step, packed
  (``lazy_int8(7)``: one K3 call a projection) and unpacked.
* The four repairs the SSM family needed: ``Session.serve`` falls back to a
  contiguous layout, tree-aware slot merges, page tables and K/V byte
  counts over cache trees, and ``caches_from_jax`` on SSM and dict trees.
* One 2x1 train step with the SR wire on, for mamba2 AND the hybrid (jamba
  smoke), against the reference in one subprocess fed the reference's SR
  draws; ``Session.comm_report()`` equal; K1's inline call count a step.
* The smoke CLIs.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.precision import PrecisionPolicy as JPolicy
from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.core.fwq import _stable_hash
from repro.core.quantization import default_exempt as jexempt
from repro.dist.collectives import AxisCtx as JAxisCtx
from repro.launch import paging as jpaging
from repro.models import attention as jattn
from repro.models import hybrid as jhyb
from repro.models import ssm as jssm
from repro.models import ssm_lm as jlm
from repro.models.common import ParamCtx as JParamCtx
from repro.models.common import pack_params_for_serving as jpack
from repro_torch.api import PrecisionPolicy, RunSpec, Session
from repro_torch.configs import get_config, smoke_variant
from repro_torch.configs.base import TrainConfig
from repro_torch.core.fwq import delta_for_clients
from repro_torch.dist.collectives import AxisCtx
from repro_torch.kernels import ops
from repro_torch.launch import paging
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import axis_ctx_for
from repro_torch.models import attention as tattn
from repro_torch.models import hybrid as thyb
from repro_torch.models import ssm as tssm
from repro_torch.models import ssm_lm as tlm
from repro_torch.models.common import ParamCtx, QTensor, fsdp_plan
from repro_torch.models.convert import caches_from_jax, params_from_jax
from repro_torch.models.model import build_model
from repro_torch.optim import build_optimizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, HYBRID = "mamba2-780m", "jamba-1.5-large-398b"
B, S_P = 3, 8
TOL = dict(rtol=1e-4, atol=1e-4)
#: the train step's batch, sequence, learning rate, seed and round
TB, TS, LR, SEED, ROUND = 4, 16, 0.5, 0, 3


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
    return jlm.init_ssm_lm(cfgs[0], jax.random.PRNGKey(0), 1)


def _ctxs(packed: bool):
    if packed:
        return (JParamCtx.from_policy(JAxisCtx((), None, ()), JPolicy.lazy_int8(7),
                                      compute_dtype=jnp.float32),
                ParamCtx.from_policy(AxisCtx(), PrecisionPolicy.lazy_int8(7),
                                     compute_dtype=torch.float32))
    return (JParamCtx(ctx=JAxisCtx((), None, ()), compute_dtype=jnp.float32),
            ParamCtx(ctx=AxisCtx(), compute_dtype=torch.float32))


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), err_msg=msg, **tol)


def _assert_tree_close(tcache, jcache, path=""):
    """Every leaf of a port cache tree against the reference's: integer
    leaves (page tables, lengths) exactly, the rest within TOL."""
    if isinstance(tcache, dict):
        assert tcache.keys() == jcache.keys()
        for k in tcache:
            _assert_tree_close(tcache[k], jcache[k], f"{path}/{k}")
        return
    assert type(tcache).__name__ == type(jcache).__name__, path
    for name in type(tcache)._fields:
        got, want = getattr(tcache, name).numpy(), np.asarray(getattr(jcache, name))
        if got.dtype.kind in "iu":
            np.testing.assert_array_equal(got, want, err_msg=f"{path}.{name}")
        else:
            np.testing.assert_allclose(got, want, err_msg=f"{path}.{name}", **TOL)


# ---------------------------------------------------------------------------
# The mixer
# ---------------------------------------------------------------------------


def naive_ssd(xdt, la, Bm, Cm):
    """Direct recurrence: s_t = exp(la_t) s_{t-1} + B_t (x dt)_t; y = C_t s_t."""
    Bsz, S, H, P = xdt.shape
    s = np.zeros((Bsz, H, Bm.shape[-1], P))
    ys = np.zeros((Bsz, S, H, P))
    for t in range(S):
        s = s * np.exp(la[:, t])[:, :, None, None] + np.einsum("bn,bhp->bhnp", Bm[:, t],
                                                               xdt[:, t])
        ys[:, t] = np.einsum("bn,bhnp->bhp", Cm[:, t], s)
    return ys, s


def _scan_inputs(shape, seed):
    Bsz, S, H, P, N = shape
    rng = np.random.default_rng(seed)
    xdt = (rng.standard_normal((Bsz, S, H, P)) * 0.5).astype(np.float32)
    la = -np.log1p(np.exp(rng.standard_normal((Bsz, S, H)))).astype(np.float32)  # <= 0
    Bm = (rng.standard_normal((Bsz, S, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((Bsz, S, N)) * 0.5).astype(np.float32)
    return xdt, la, Bm, Cm


@pytest.mark.parametrize("chunk", [4, 8, 16])
@pytest.mark.parametrize("shape", [(2, 16, 3, 4, 8), (1, 32, 2, 8, 4)])
def test_ssd_scan_matches_naive_recurrence_and_reference(chunk, shape):
    """Against the naive recurrence within 2e-4 (the reference's own
    oracle test's tolerance) and against the reference's scan within TOL."""
    xdt, la, Bm, Cm = _scan_inputs(shape, chunk)
    y, state = tssm._ssd_scan(*map(torch.from_numpy, (xdt, la, Bm, Cm)), chunk)
    y_ref, state_ref = naive_ssd(xdt, la, Bm, Cm)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(state.numpy(), state_ref, rtol=2e-4, atol=2e-4)
    jy, jstate = jssm._ssd_scan(*map(jnp.asarray, (xdt, la, Bm, Cm)), chunk)
    _close(y, jy)
    _close(state, jstate)


def test_ssd_scan_head_groups_match_one_group(monkeypatch):
    """A decay budget of one head's block (one head a group) gives the
    all-heads result bit for bit, and its gradient is finite."""
    xdt, la, Bm, Cm = (torch.from_numpy(a) for a in _scan_inputs((2, 32, 5, 4, 8), 1))
    whole, _ = tssm._ssd_scan(xdt, la, Bm, Cm, 16)
    monkeypatch.setattr(tssm, "DECAY_BLOCK_BYTES", 2 * 2 * 16 * 16 * 4)
    xg = xdt.clone().requires_grad_()
    grouped, _ = tssm._ssd_scan(xg, la, Bm, Cm, 16)
    assert torch.equal(whole, grouped)
    grouped.sum().backward()
    assert torch.isfinite(xg.grad).all()


def _mixer(cfgs, seed=3):
    jc, tc = cfgs
    jd = jhyb.ssm_dims(jc, 1)
    from repro.models.common import key_iter
    jp = jssm.init_ssm(key_iter(jax.random.PRNGKey(seed)), jd)
    tp = {k.split("/", 1)[1]: v for k, v in params_from_jax({"m": jp}).items()}
    # a nonzero recurrence: the reference's init makes a_log 0 and norm 0
    rng = np.random.default_rng(seed)
    for name in ("a_log", "dt_bias", "norm"):
        v = rng.standard_normal(tp[name].shape).astype(np.float32) * 0.3
        jp[name], tp[name] = jnp.asarray(v), torch.from_numpy(v)
    return jd, jp, thyb.ssm_dims(tc, 1), tp


def test_ssm_block_and_decode_match_reference(cfgs):
    jd, jp, td, tp = _mixer(cfgs)
    jpc, tpc = _ctxs(False)
    x = (np.random.default_rng(4).standard_normal((2, 16, 64)) * 0.5).astype(np.float32)
    jy = jssm.ssm_block(jpc, "ssm", jp, jnp.asarray(x), jd)
    ty = tssm.ssm_block(tpc, "ssm", tp, torch.from_numpy(x), td)
    _close(ty, jy)
    jcache = jssm.init_ssm_cache(2, jd, jnp.float32)
    tcache = tssm.init_ssm_cache(2, td, torch.float32)
    jstep = jax.jit(lambda xt, c: jssm.ssm_decode_step(jpc, "ssm", jp, xt, c, jd))
    steps = []
    for t in range(16):
        jo, jcache = jstep(jnp.asarray(x[:, t:t + 1]), jcache)
        before = [f.clone() for f in tcache]
        to, new = tssm.ssm_decode_step(tpc, "ssm", tp, torch.from_numpy(x[:, t:t + 1]),
                                       tcache, td)
        # the cache it was given is read, never written
        assert all(torch.equal(a, b) for a, b in zip(before, tcache))
        tcache = new
        _close(to, jo, msg=f"step {t}")
        steps.append(to)
    _assert_tree_close(tcache, jcache)
    # the decode state tracks the chunked path (the reference's oracle test's
    # tolerance: one-token and chunked orders of the same sums)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), ty.numpy(), rtol=5e-3, atol=5e-3)


# ---------------------------------------------------------------------------
# The model: forward, prefill, decode
# ---------------------------------------------------------------------------


def test_init_and_forward_match_reference(cfgs, jparams):
    jc, tc = cfgs
    tp = params_from_jax(jparams)
    mine = tlm.init_ssm_lm(tc, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: tuple(v.shape) for k, v in tp.items()}
    assert tp["blocks/ssm/wx"].shape == (2, 64, 128) and "blocks/ln" in tp
    toks = np.random.default_rng(0).integers(2, 512, (B, 16)).astype(np.int32)
    jpc, tpc = _ctxs(False)
    jl = jlm.forward(jc, jpc, jparams, jnp.asarray(toks))
    tl = tlm.forward(tc, tpc, tp, torch.from_numpy(toks))
    _close(tl, jl)


def test_use_paths_match_reference(cfgs, jparams):
    """The paths every weight is used under (the SR site keys of the
    trainer's inline quantizer) equal the reference's."""
    jc, tc = cfgs
    seen = {"jax": set(), "torch": set()}
    jpc = JParamCtx(ctx=JAxisCtx((), None, ()), compute_dtype=jnp.float32,
                    transform=lambda p, w: seen["jax"].add(p) or w)
    tpc = ParamCtx(ctx=AxisCtx(), compute_dtype=torch.float32,
                   transform=lambda p, w: seen["torch"].add(p) or w)
    toks = np.ones((1, 8), np.int32)
    jlm.forward(jc, jpc, jparams, jnp.asarray(toks))
    tlm.forward(tc, tpc, params_from_jax(jparams), torch.from_numpy(toks))
    assert seen["torch"] == seen["jax"]
    assert "blocks/ssm/wx" in seen["torch"] and "blocks/ssm/conv_bc" in seen["torch"]


@pytest.fixture(scope="module")
def packed(jparams):
    jq = jpack(jparams, 7, jax.random.PRNGKey(1), exempt=jexempt)
    return jq, params_from_jax(jq)


@pytest.mark.parametrize("weights", ["packed", "f32"])
def test_ragged_prefill_and_decode_match_reference(cfgs, jparams, packed, weights,
                                                   monkeypatch):
    """A bucketed prompt batch with ragged lengths: the logits at each slot's
    own last position and every cache leaf equal the reference's, so the
    padding never reached a slot's state; then one decode step."""
    jc, tc = cfgs
    if weights == "packed":
        jp, tp = packed
        assert isinstance(tp["blocks/ssm/wx"], QTensor)
        for name in ("a_log", "dt_bias", "d_skip", "conv_x", "conv_bc", "norm"):
            assert not isinstance(tp[f"blocks/ssm/{name}"], QTensor), name
    else:
        jp, tp = jparams, params_from_jax(jparams)
    jpc, tpc = _ctxs(weights == "packed")
    calls = []
    real = ops.quant_matmul
    monkeypatch.setattr(ops, "quant_matmul", lambda *a: calls.append(1) or real(*a))
    toks = np.random.default_rng(1).integers(2, 512, (B, S_P)).astype(np.int32)
    plens = np.array([8, 5, 2], np.int32)
    jl, jcache = jlm.prefill(jc, jpc, jp, jnp.asarray(toks),
                             jlm.init_ssm_lm_caches(jc, B, 1, jnp.float32),
                             prompt_lens=jnp.asarray(plens))
    tl, tcache = tlm.prefill(tc, tpc, tp, torch.from_numpy(toks),
                             tlm.init_ssm_lm_caches(tc, B, 1, torch.float32),
                             prompt_lens=torch.from_numpy(plens))
    _close(tl, jl)
    _assert_tree_close(tcache, jcache)
    # other padding, the same logits and state, bit for bit
    pad = np.arange(S_P)[None, :] >= plens[:, None]
    toks2 = np.where(pad, 509 - toks, toks).astype(np.int32)
    tl2, tcache2 = tlm.prefill(tc, tpc, tp, torch.from_numpy(toks2),
                               tlm.init_ssm_lm_caches(tc, B, 1, torch.float32),
                               prompt_lens=torch.from_numpy(plens))
    assert torch.equal(tl2, tl) and all(map(torch.equal, tcache2, tcache))
    tok = np.array([[11], [7], [300]], np.int32)
    jd, jc2 = jlm.decode_step(jc, jpc, jp, jnp.asarray(tok), jcache)
    calls.clear()
    td, tc2 = tlm.decode_step(tc, tpc, tp, torch.from_numpy(tok), caches_from_jax(jcache))
    _close(td, jd)
    _assert_tree_close(tc2, jc2)
    # K3 calls a decode step: wx, wz, w_bc, w_dt, wo a layer, and the head
    assert len(calls) == ((5 * tc.n_layers + 1) if weights == "packed" else 0)


# ---------------------------------------------------------------------------
# The repairs: layouts, slot merges, page tables, byte counts over trees
# ---------------------------------------------------------------------------


def test_session_serves_mamba2_contiguous_even_when_paged_is_asked():
    """As the reference does, an SSM model serves with its O(1) state in the
    contiguous layout, whatever layout was asked for."""
    for layout in ("paged", None):
        opts = {"prompt_len": 8, "requests": 3, "max_new": 4, "steps": 16, "quiet": True,
                "vary_prompt": True}
        if layout:
            opts["kv_layout"] = layout
        spec = RunSpec(ARCH, workload="serve", smoke=True, seed=0, batch=2, seq=32,
                       precision=PrecisionPolicy.lazy_int8(7), options=opts)
        stats = Session(spec, device="cpu").serve()
        assert stats.kv_layout == "contiguous" and stats.page_size == 0
        assert stats.kv_bytes == 0                    # the SSM state is not K/V
        assert stats.admitted == stats.completed == 3


def _hybrid_trees(seed: int, page_size=4):
    """The reference's and the port's jamba-smoke cache trees (paged
    attention, SSM state) holding the same random contents and tables."""
    jc = jsmoke(jget_config(HYBRID))
    j = jhyb.init_hybrid_caches(jc, B, 16, 1, jnp.float32, page_size=page_size, pool_pages=10)
    rng = np.random.default_rng(seed)
    table = np.array([[5, 1, 7, -1], [0, 3, -1, -1], [2, -1, 6, 9]], np.int32)
    j = jpaging.set_page_tables(j, table)

    def fill(x):
        if x.dtype == jnp.int32:
            return x if x.ndim == 3 else jnp.asarray(rng.integers(0, 9, x.shape), jnp.int32)
        return jnp.asarray(rng.standard_normal(x.shape), x.dtype)

    j = jax.tree_util.tree_map(fill, j)
    return j, caches_from_jax(j)


def test_merge_and_fresh_slot_caches_on_a_hybrid_tree():
    jold, told = _hybrid_trees(0)
    jnew, tnew = _hybrid_trees(1)
    keep = np.array([True, False, True])
    want = jattn.merge_slot_caches(jold, jnew, jnp.asarray(keep))
    got = tattn.merge_slot_caches(told, tnew, torch.from_numpy(keep))
    _assert_tree_close(got, want)
    assert got["sub0"].k_pages is told["sub0"].k_pages          # the pool merged in place
    # a decode step that wrote the pools in place returns the same pools:
    # only the lengths and tables merge (the pools are left as they are),
    # and the SSM state merges per slot
    _j, told = _hybrid_trees(0)
    stepped = dict(tnew, sub0=tnew["sub0"]._replace(k_pages=told["sub0"].k_pages,
                                                    v_pages=told["sub0"].v_pages))
    pools = told["sub0"].k_pages.clone()
    got = tattn.merge_slot_caches(told, stepped, torch.from_numpy(keep))
    assert torch.equal(got["sub0"].k_pages, pools)
    sel = torch.from_numpy(keep)[None, :]
    assert torch.equal(got["sub0"].length, torch.where(sel, tnew["sub0"].length,
                                                       told["sub0"].length))
    assert torch.equal(got["sub1"].state, torch.where(sel[..., None, None, None],
                                                      tnew["sub1"].state, told["sub1"].state))
    fresh_j, fresh_t = jattn.fresh_slot_caches(jold), tattn.fresh_slot_caches(told)
    _assert_tree_close(fresh_t, fresh_j)
    assert not fresh_t["sub1"].state.any() and (fresh_t["sub0"].page_table >= 0).any()


def test_page_tables_and_kv_bytes_over_trees():
    jc = jsmoke(jget_config(HYBRID))
    tc = smoke_variant(get_config(HYBRID))
    table = np.array([[5, 1, 7, -1], [0, 3, -1, -1], [2, -1, 6, 9]], np.int32)
    for kw in ({"page_size": 4, "pool_pages": 10}, {}):
        j = jhyb.init_hybrid_caches(jc, B, 16, 1, jnp.float32, **kw)
        t = thyb.init_hybrid_caches(tc, B, 16, 1, torch.float32, **kw)
        j, t = jpaging.set_page_tables(j, table), paging.set_page_tables(t, table)
        _assert_tree_close(t, j)
        assert paging.kv_cache_bytes(t) == jpaging.kv_cache_bytes(j) > 0
    ssm = tlm.init_ssm_lm_caches(smoke_variant(get_config(ARCH)), B)
    assert paging.kv_cache_bytes(ssm) == 0 and paging.set_page_tables(ssm, table) is ssm


def test_caches_from_jax_takes_ssm_and_dict_trees(cfgs):
    jc, _tc = cfgs
    j = jlm.init_ssm_lm_caches(jc, B, 1, jnp.bfloat16)
    t = caches_from_jax(j)
    assert isinstance(t, tssm.SSMCache) and t.state.dtype == torch.bfloat16
    assert t.state.shape == (2, B, 8, 16, 16) and t.conv_x.shape == (2, B, 3, 128)
    jt, tt = _hybrid_trees(2)
    assert isinstance(tt["sub0"], tattn.PagedKVCache) and isinstance(tt["sub1"], tssm.SSMCache)
    _assert_tree_close(tt, jt)


# ---------------------------------------------------------------------------
# The train step on a 2x1 mesh, SR wire on: both families, one subprocess
# ---------------------------------------------------------------------------

_REFERENCE = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import numpy as np
import repro  # installs the jax forward-compat shims before any mesh API
import jax, jax.numpy as jnp
from repro.api import PrecisionPolicy, RunSpec, Session
from repro.configs import get_config, smoke_variant
from repro.configs.base import TrainConfig
from repro.core.fwq import delta_for_clients
from repro.launch.mesh import mesh_and_axes
from repro.launch.steps import build_init_fn, build_train_step
from repro.models.model import build_model
from repro.optim import build_optimizer
from repro_torch.models.convert import params_from_jax

out_path = sys.argv[1]
ARCHS, B, S, LR, SEED, ROUND = %(consts)s
mesh, axes = mesh_and_axes("2x1")
rng = np.random.default_rng(0)
toks = rng.integers(0, 512, (B, S)).astype(np.int32)
labs = rng.integers(0, 512, (B, S)).astype(np.int32)
save, meta = {"tokens": toks, "labels": labs}, {}
for arch in ARCHS:
    model = build_model(smoke_variant(get_config(arch)))
    params = build_init_fn(model, mesh, axes)[0](jax.random.PRNGKey(SEED))
    opt = build_optimizer("sgd", LR)
    tc = TrainConfig(learning_rate=LR, seed=SEED, grad_compression_bits=8)
    step = build_train_step(model, mesh, axes, opt, tc, donate=False).fn(
        model.train_batch_spec(B, S))
    p1, _o, m = step(params, opt.init(params),
                     {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)},
                     delta_for_clients(np.array([8, 16])),
                     jax.random.fold_in(jax.random.PRNGKey(SEED), ROUND))
    save.update({f"{arch}|init:" + k: v.numpy() for k, v in params_from_jax(params).items()})
    save.update({f"{arch}|step:" + k: v.numpy() for k, v in params_from_jax(p1).items()})
    sess = Session(RunSpec(arch, workload="train", mesh="2x1", smoke=True, rounds=2,
                           precision=PrecisionPolicy(comm=8)))
    meta[arch] = {"loss": float(m["loss"]), "comm_report": sess.comm_report()}
np.savez(out_path, **save)
print("RESULT " + json.dumps(meta))
""" % {"consts": repr(((ARCH, HYBRID), TB, TS, LR, SEED, ROUND))}


@pytest.fixture(autouse=True, scope="module")
def _reference_run(tmp_path_factory):
    """The reference's train steps, started in a subprocess when the module's
    first test starts, so that its compiles overlap the tests before the
    train-step tests (which wait for it)."""
    path = str(tmp_path_factory.mktemp("ref") / "ref.npz")
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE, path], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
                                 "JAX_PLATFORMS": "cpu"})
    yield proc, path
    proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def reference_steps(_reference_run):
    proc, path = _reference_run
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-3000:] + err[-3000:]
    meta = json.loads(out.split("RESULT ", 1)[1])
    with np.load(path) as z:
        return {k: z[k] for k in z.files}, meta


class ReferenceDraws(tsteps.SRDraws):
    """The reference's SR uniforms of round ``ROUND``: weights
    ``fold_in(fold_in(rng, c), _stable_hash(path))``, wire leaf ``i``
    ``fold_in(fold_in(fold_in(rng, 17), i), c)``."""

    def __init__(self):
        super().__init__(SEED, ROUND)
        self.rng = jax.random.fold_in(jax.random.PRNGKey(SEED), ROUND)

    def weights(self, client, path, shape, device):
        k = jax.random.fold_in(jax.random.fold_in(self.rng, client), _stable_hash(path))
        return torch.from_numpy(np.array(jax.random.uniform(k, tuple(shape), jnp.float32)))

    def wire(self, leaf, n_clients, shape, device):
        k = jax.random.fold_in(jax.random.fold_in(self.rng, 17), leaf)
        return torch.stack([torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(k, c), tuple(shape), jnp.float32))) for c in range(n_clients)])


#: wire leaves of a smoke model: mamba2's norms, conv kernels, recurrence
#: vectors, w_bc (2N = 32 < 256) and w_dt; the hybrid's adds its routers
#: and attention-free mlp norms
WIRE_LEAVES = {ARCH: 13, HYBRID: 27}


@pytest.mark.parametrize("arch", [ARCH, HYBRID])
def test_train_step_matches_reference(reference_steps, arch, monkeypatch):
    """Loss within 1e-5, FSDP leaves within rtol 1e-5; the wire's leaves
    within ``lr * step / D``, the last-bit differences of the two packages'
    gradients moving a code by at most one step."""
    arrays, meta = reference_steps
    cfg = smoke_variant(get_config(arch))
    axes = axis_ctx_for("2x1")
    params = {k.split(":", 1)[1]: torch.from_numpy(v.copy()) for k, v in arrays.items()
              if k.startswith(f"{arch}|init:")}
    seen = {}
    psum = tsteps.quantized_psum_batch

    def recorder(axes_, grads, us, bits_, **kw):
        seen["grads"] = grads
        return psum(axes_, grads, us, bits_, **kw)

    monkeypatch.setattr(tsteps, "quantized_psum_batch", recorder)
    opt = build_optimizer("sgd", LR)
    step = tsteps.build_train_step(build_model(cfg), axes, opt,
                                   TrainConfig(learning_rate=LR, seed=SEED,
                                               grad_compression_bits=8))
    batch = {"tokens": torch.from_numpy(arrays["tokens"]),
             "labels": torch.from_numpy(arrays["labels"])}
    p1, _opt, m = step.fn(params, opt.init(params), batch,
                          delta_for_clients(np.array([8, 16])), ReferenceDraws())
    assert abs(float(m["loss"]) - meta[arch]["loss"]) <= 1e-5
    paths, _leaves, plan = fsdp_plan(params, axes.fsdp, check_divisibility=False)
    wire = [p for p, d in zip(paths, plan) if d is None]
    assert len(wire) == WIRE_LEAVES[arch], wire
    for p in paths:
        got, want = p1[p].numpy(), arrays[f"{arch}|step:" + p]
        if p in wire:
            g = seen["grads"][wire.index(p)]
            bound = LR * float(g.abs().max()) / (2**8 - 1) / axes.dp
            assert np.abs(got - want).max() <= bound * (1 + 1e-3) + 1e-7, p
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=p)


@pytest.mark.parametrize("arch", [ARCH, HYBRID])
def test_comm_report_matches_reference(reference_steps, arch):
    _arrays, meta = reference_steps
    sess = Session(RunSpec(arch, workload="train", mesh="2x1", smoke=True, rounds=2,
                           precision=PrecisionPolicy(comm=8)), device="cpu")
    got = json.loads(json.dumps(sess.comm_report()))
    assert got == meta[arch]["comm_report"]
    assert got["replicated_leaves"] == WIRE_LEAVES[arch]


@pytest.mark.parametrize("arch, remat, per_client", [
    (ARCH, False, lambda L: 2 + 5 * L),
    # under remat every block's weights are used again in backward
    (ARCH, True, lambda L: 2 + 5 * L * 2),
    # a period: attention 4, its MoE's 3 expert stacks, SSM 5, MLP 3
    (HYBRID, False, lambda L: 2 + 15 * (L // 2)),
])
def test_train_step_k1_inline_calls(arch, remat, per_client, monkeypatch):
    """With the seeded draws each weight use is one call of K1's inline
    entry (the recurrence vectors, conv kernels, norms and routers never:
    exempt); the wire is one call of K2's keyed entry."""
    import dataclasses

    cfg = dataclasses.replace(smoke_variant(get_config(arch)), remat=remat)
    model, axes = build_model(cfg), axis_ctx_for("2x1")
    params = model.init(torch.Generator().manual_seed(0), 1)
    seen, packs = [], []
    inline, pack = ops.sr_quantize_inline, ops.sr_pack_keyed
    monkeypatch.setattr(ops, "sr_quantize_inline",
                        lambda w, *a: seen.append(tuple(w.shape)) or inline(w, *a))
    monkeypatch.setattr(ops, "sr_pack_keyed", lambda *a: packs.append(1) or pack(*a))
    opt = build_optimizer("sgd", LR)
    step = tsteps.build_train_step(model, axes, opt, TrainConfig(
        learning_rate=LR, seed=SEED, grad_compression_bits=8))
    toks = torch.randint(0, cfg.vocab_size, (4, 16), generator=torch.Generator().manual_seed(1))
    _p, _o, m = step.fn(params, opt.init(params), {"tokens": toks, "labels": toks},
                        delta_for_clients(np.array([8, 16])), tsteps.SRDraws(SEED, ROUND))
    assert np.isfinite(float(m["loss"]))
    assert len(seen) == axes.dp * per_client(cfg.n_layers)
    assert len(packs) == 1


# ---------------------------------------------------------------------------
# The smoke CLIs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [ARCH, HYBRID])
def test_smoke_clis_on_cpu(arch, capsys):
    from repro_torch.launch import serve, train

    stats = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "12",
                        "--batch", "2", "--s-max", "32", "--prompt-len", "8", "--requests", "3",
                        "--max-new", "4", "--attn-impl", "flash"])
    assert stats.admitted == stats.completed == 3
    assert stats.kv_layout == ("contiguous" if arch == ARCH else "paged")
    hist = train.main(["--device", "cpu", "--arch", arch, "--smoke", "--mesh", "2x1",
                       "--scheme", "fixed", "--bits", "8", "--grad-compression-bits", "8",
                       "--rounds", "2", "--batch", "2", "--seq", "16"])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
