"""Parity of the port's MoE family with the JAX reference on the CPU.

olmoe-1b-7b at its smoke size (``configs.smoke_variant``: 2 layers, d_model
64, 8 experts, top-2, expert FFN 32, f32 compute), weights drawn by the
reference and carried across with ``convert.params_from_jax``.  The
reference runs its Pallas kernels in interpret mode, the port the kernels'
plain versions (CPU tensors).

* ``expert_dispatch`` in its three branches (the reference's
  ``TestExpertDispatch`` cases): a packed stack with one scale (one K3 call
  an expert), a per-expert scale row (eager dequant), a plain stack.
* ``moe_block``: the routed ids, and the dispatch buffer (which assignment
  lands in which expert slot, so the capacity drops too) exactly equal, at
  the config's capacity and in a case built to overflow it; the output and
  the router's mean within TOL.
* Forward logits; prefill logits and caches and a paged decode step, packed
  (``lazy_int8(7)``) and unpacked.
* One train step on a 2x1 mesh with the SR wire on (comm 8), the reference
  in one subprocess on 2 fake devices, fed the reference's own SR draws;
  ``Session.comm_report()`` equal.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jmoe_mod
from repro.api.precision import PrecisionPolicy as JPolicy
from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.core.fwq import _stable_hash
from repro.core.quantization import default_exempt as jexempt
from repro.dist.collectives import AxisCtx as JAxisCtx
from repro.kernels import ops as jops
from repro.launch.paging import set_page_tables as jset_page_tables
from repro.models import transformer as jtr
from repro.models.common import ParamCtx as JParamCtx
from repro.models.common import QTensor as JQTensor
from repro.models.common import pack_params_for_serving as jpack
from repro_torch.api import PrecisionPolicy, RunSpec, Session
from repro_torch.configs import get_config, smoke_variant
from repro_torch.configs.base import TrainConfig
from repro_torch.core.fwq import delta_for_clients
from repro_torch.dist.collectives import AxisCtx
from repro_torch.kernels import ops
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import axis_ctx_for
from repro_torch.launch.paging import set_page_tables
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr
from repro_torch.models.common import ParamCtx, QTensor, fsdp_plan
from repro_torch.models.convert import caches_from_jax, params_from_jax
from repro_torch.models.model import build_model
from repro_torch.optim import build_optimizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "olmoe-1b-7b"
B, S_MAX, PAGE, S_P = 3, 32, 4, 8
TOL = dict(rtol=1e-4, atol=1e-4)
#: the train step's batch, sequence, learning rate, seed and round
TB, TS, LR, SEED, ROUND = 4, 32, 0.5, 0, 3


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
    return jtr.init_lm(cfgs[0], jax.random.PRNGKey(0), 1)


@pytest.fixture(scope="module")
def packed(jparams):
    jq = jpack(jparams, 7, jax.random.PRNGKey(1), exempt=jexempt)
    return jq, params_from_jax(jq)


def _ctxs(policy_packed: bool):
    if policy_packed:
        return (JParamCtx.from_policy(JAxisCtx((), None, ()), JPolicy.lazy_int8(7),
                                      compute_dtype=jnp.float32),
                ParamCtx.from_policy(AxisCtx(), PrecisionPolicy.lazy_int8(7),
                                     compute_dtype=torch.float32))
    return (JParamCtx(ctx=JAxisCtx((), None, ()), compute_dtype=jnp.float32),
            ParamCtx(ctx=AxisCtx(), compute_dtype=torch.float32))


# ---------------------------------------------------------------------------
# expert_dispatch
# ---------------------------------------------------------------------------


def _pack_stack(w: np.ndarray, bits: int):
    """One scalar scale over an expert stack, as the reference's test packs."""
    s = max(float(np.abs(w).max()), 1e-12)
    scale = np.float32(s * (1.0 / (2.0**bits - 1.0)))
    lim = 2**bits - 1
    codes = np.clip(np.round(w / scale), -lim, lim)
    dt = np.int8 if bits <= 7 else np.int16
    return codes.astype(dt), np.asarray(scale, np.float32)


@pytest.mark.parametrize("branch", ["k3", "per_expert_scale", "plain"])
@pytest.mark.parametrize("bits, shape", [(4, (4, 8, 32, 48)), (7, (4, 8, 32, 48)),
                                         (12, (4, 8, 32, 48)), (4, (3, 5, 40, 24)),
                                         (7, (3, 5, 40, 24)), (12, (3, 5, 40, 24))])
def test_expert_dispatch_matches_reference(branch, bits, shape, monkeypatch):
    E, C, D, F = shape
    rng = np.random.default_rng(bits * 10 + E)
    w = rng.standard_normal((E, D, F)).astype(np.float32)
    x = rng.standard_normal((E, C, D)).astype(np.float32)
    codes, scale = _pack_stack(w, bits)
    if branch == "per_expert_scale":
        scale = np.full((E,), scale, np.float32) * (1.0 + np.arange(E, dtype=np.float32))
    if branch == "plain":
        jw, tw = jnp.asarray(w), torch.from_numpy(w)
    else:
        jw = JQTensor(codes=jnp.asarray(codes), scale=jnp.asarray(scale))
        tw = QTensor(torch.from_numpy(codes), torch.from_numpy(scale))
    calls = []
    real = ops.quant_matmul
    monkeypatch.setattr(ops, "quant_matmul", lambda *a: calls.append(1) or real(*a))
    got = ops.expert_dispatch(torch.from_numpy(x), tw)
    want = np.asarray(jops.expert_dispatch(jnp.asarray(x), jw))
    assert got.shape == (E, C, F) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert len(calls) == (E if branch == "k3" else 0)        # one K3 call an expert


def test_expert_dispatch_casts_to_dtype():
    rng = np.random.default_rng(3)
    codes, scale = _pack_stack(rng.standard_normal((2, 16, 24)).astype(np.float32), 7)
    x = torch.from_numpy(rng.standard_normal((2, 3, 16)).astype(np.float32))
    got = ops.expert_dispatch(x, QTensor(torch.from_numpy(codes), torch.from_numpy(scale)),
                              torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 3, 24)


# ---------------------------------------------------------------------------
# moe_block: routing, capacity, combine
# ---------------------------------------------------------------------------


def _record_buffers(monkeypatch):
    """The dispatch buffer each package hands its first expert matmul."""
    seen = {"jax": [], "torch": []}
    jreal, treal = jmoe_mod.expert_dispatch, ops.expert_dispatch

    def jrec(x, w, dtype=None):
        seen["jax"].append(np.asarray(x))
        return jreal(x, w, dtype)

    def trec(x, w, dtype=None):
        seen["torch"].append(x.detach().numpy().copy())
        return treal(x, w, dtype)

    monkeypatch.setattr(jmoe_mod, "expert_dispatch", jrec)
    monkeypatch.setattr(ops, "expert_dispatch", trec)
    return seen


def _topk_margin(probs: np.ndarray, k: int) -> float:
    s = np.sort(probs, axis=-1)[:, ::-1]
    return float((s[:, k - 1] - s[:, k]).min())


@pytest.mark.parametrize("capacity_factor, n_tok", [(1.25, 24), (1.25, 96), (0.3, 96)],
                         ids=["config-24", "config-96", "overflow-96"])
def test_moe_block_routes_and_drops_as_reference(cfgs, jparams, capacity_factor, n_tok,
                                                 monkeypatch):
    jc, tc = cfgs
    jmd = dataclasses.replace(jtr.moe_dims(jc, 1), capacity_factor=capacity_factor)
    tmd = dataclasses.replace(ttr.moe_dims(tc, 1), capacity_factor=capacity_factor)
    lp_j = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"]["moe"])
    lp_t = {k.split("/", 1)[1]: v for k, v in params_from_jax({"m": lp_j}).items()}
    x = np.random.default_rng(n_tok).standard_normal((n_tok // 8, 8, tc.d_model)).astype(
        np.float32)
    jpc, tpc = _ctxs(False)
    seen = _record_buffers(monkeypatch)
    jy, jaux = jmoe_mod.moe_block(jpc, "blocks/moe", lp_j, jnp.asarray(x), jmd)
    ty, taux = tmoe.moe_block(tpc, "blocks/moe", lp_t, torch.from_numpy(x), tmd)
    # the routed ids: the reference's top-k against the port's
    xt = x.reshape(-1, tc.d_model)
    jprobs = jax.nn.softmax(jnp.asarray(xt) @ lp_j["router"], axis=-1)
    _, jids = jax.lax.top_k(jprobs, tmd.k)
    tprobs = torch.softmax(torch.from_numpy(xt) @ lp_t["router"], dim=-1)
    _, tids = torch.topk(tprobs, tmd.k, dim=-1)
    assert np.array_equal(np.asarray(jids), tids.numpy()), \
        f"routed ids differ; top-k margin {_topk_margin(np.asarray(jprobs), tmd.k):.3e}"
    # which (token, expert) assignment lands in which slot, and which drop
    jb, tb = seen["jax"][0], seen["torch"][0]
    cap = tmd.capacity(n_tok)
    assert jb.shape == tb.shape == (tmd.n_experts, cap, tc.d_model)
    np.testing.assert_array_equal(tb, jb)
    kept = int((np.abs(tb).sum(-1) > 0).sum())
    counts = np.bincount(tids.numpy().reshape(-1), minlength=tmd.n_experts)
    assert kept == int(np.minimum(counts, cap).sum())
    if capacity_factor < 1:
        assert kept < n_tok * tmd.k, "the overflow case must drop assignments"
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(taux["router_probs_mean"].numpy(),
                               np.asarray(jaux["router_probs_mean"]), rtol=1e-6, atol=1e-7)


def test_moe_combine_sums_each_token_in_expert_order():
    """The combine adds a token's k outputs from zero in increasing expert
    id: equal, bit for bit, to that sum written out."""
    md = tmoe.MoEDims(n_experts=4, k=3, d_model=8, d_ff=4, tp=1, capacity_factor=4.0)
    gen = torch.Generator().manual_seed(0)
    p = tmoe.init_moe(gen, md)
    x = torch.randn((1, 5, 8), generator=gen)
    pc = ParamCtx(ctx=AxisCtx(), compute_dtype=torch.float32)
    y, _ = tmoe.moe_block(pc, "m", p, x, md)
    xt = x.reshape(5, 8)
    probs = torch.softmax(xt @ p["router"], dim=-1)
    gate, ids = torch.topk(probs, 3)
    gate = gate / gate.sum(-1, keepdim=True)
    want = torch.zeros_like(xt)
    for t in range(5):
        acc = torch.zeros(8)
        for j in torch.argsort(ids[t]).tolist():
            e = int(ids[t, j])
            h = torch.nn.functional.silu(xt[t] @ p["w_gate"][e]) * (xt[t] @ p["w_up"][e])
            acc = acc + (h @ p["w_down"][e]) * gate[t, j]
        want[t] = acc
    torch.testing.assert_close(y.reshape(5, 8), want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# The model: forward, prefill, decode
# ---------------------------------------------------------------------------


def test_init_and_forward_match_reference(cfgs, jparams):
    jc, tc = cfgs
    tp = params_from_jax(jparams)
    mine = ttr.init_lm(tc, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: tuple(v.shape) for k, v in tp.items()}
    assert tp["blocks/moe/w_up"].shape == (2, 8, 64, 32)
    toks = np.random.default_rng(0).integers(2, 512, (B, S_P)).astype(np.int32)
    jpc, tpc = _ctxs(False)
    jl = jtr.forward(jc, jpc, jparams, jnp.asarray(toks))
    tl = ttr.forward(tc, tpc, tp, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def _table():
    t = np.full((B, S_MAX // PAGE), -1, np.int32)
    t[0, :3] = [5, 1, 7]
    t[1, :2] = [0, 3]
    t[2, :3] = [2, -1, 6]
    return t


def _paged(cfgs):
    jc, tc = cfgs
    kw = {"page_size": PAGE, "pool_pages": 10}
    jcache = jset_page_tables(jtr.init_caches(jc, B, S_MAX, 1, jnp.float32, **kw), _table())
    tcache = set_page_tables(ttr.init_caches(tc, B, S_MAX, 1, torch.float32, device="cpu",
                                             **kw), _table())
    return jcache, tcache


def _assert_caches_close(tcache, jcache):
    for name in type(tcache)._fields:
        got, want = getattr(tcache, name).numpy(), np.asarray(getattr(jcache, name))
        if got.dtype.kind in "iu":
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, err_msg=name, **TOL)


@pytest.mark.parametrize("weights", ["packed", "f32"])
def test_prefill_and_paged_decode_match_reference(cfgs, jparams, packed, weights,
                                                  monkeypatch):
    jc, tc = cfgs
    if weights == "packed":
        jp, tp = packed
        assert isinstance(tp["blocks/moe/w_up"], QTensor)
        assert tp["blocks/moe/w_up"].scale.shape == (2,)       # per layer: K3 a layer
        assert not isinstance(tp["blocks/moe/router"], QTensor)
    else:
        jp, tp = jparams, params_from_jax(jparams)
    jpc, tpc = _ctxs(weights == "packed")
    calls = []
    real = ops.quant_matmul
    monkeypatch.setattr(ops, "quant_matmul", lambda *a: calls.append(1) or real(*a))
    jcache, tcache = _paged(cfgs)
    toks = np.random.default_rng(1).integers(2, 512, (B, S_P)).astype(np.int32)
    plens = np.array([8, 5, 3], np.int32)
    jl, jcache = jtr.prefill(jc, jpc, jp, jnp.asarray(toks), jcache, attn_impl="flash",
                             prompt_lens=jnp.asarray(plens))
    tl, tcache = ttr.prefill(tc, tpc, tp, torch.from_numpy(toks), tcache, attn_impl="flash",
                             prompt_lens=torch.from_numpy(plens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_caches_close(tcache, jcache)
    tcache = caches_from_jax(jcache)          # both decode steps start from one cache
    tok = np.array([[11], [7], [300]], np.int32)
    jd, jc2 = jtr.decode_step(jc, jpc, jp, jnp.asarray(tok), jcache, attn_impl="flash")
    calls.clear()
    td, tc2 = ttr.decode_step(tc, tpc, tp, torch.from_numpy(tok), tcache, attn_impl="flash")
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    _assert_caches_close(tc2, jc2)
    # K3 calls a decode step: 4 attention projections and 3 per expert a
    # layer, and the head (packed); none unpacked
    want = (4 + 3 * tc.n_experts) * tc.n_layers + 1 if weights == "packed" else 0
    assert len(calls) == want


def test_session_serves_olmoe_smoke():
    spec = RunSpec(ARCH, workload="serve", smoke=True, seed=0, batch=2, seq=32,
                   precision=PrecisionPolicy.lazy_int8(7),
                   options={"attn_impl": "flash", "kv_layout": "paged", "prompt_len": 8,
                            "requests": 3, "max_new": 4, "steps": 16, "quiet": True})
    stats = Session(spec, device="cpu").serve()
    assert stats.admitted == stats.completed == 3


# ---------------------------------------------------------------------------
# The train step on a 2x1 mesh, SR wire on
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
ARCH, B, S, LR, SEED, ROUND = %(consts)s
model = build_model(smoke_variant(get_config(ARCH)))
mesh, axes = mesh_and_axes("2x1")
params = build_init_fn(model, mesh, axes)[0](jax.random.PRNGKey(SEED))
rng = np.random.default_rng(0)
toks = rng.integers(0, 512, (B, S)).astype(np.int32)
labs = rng.integers(0, 512, (B, S)).astype(np.int32)
opt = build_optimizer("sgd", LR)
tc = TrainConfig(learning_rate=LR, seed=SEED, grad_compression_bits=8)
step = build_train_step(model, mesh, axes, opt, tc, donate=False).fn(
    model.train_batch_spec(B, S))
p1, _o, m = step(params, opt.init(params),
                 {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)},
                 delta_for_clients(np.array([8, 16])),
                 jax.random.fold_in(jax.random.PRNGKey(SEED), ROUND))
save = {"init:" + k: v.numpy() for k, v in params_from_jax(params).items()}
save.update({"step:" + k: v.numpy() for k, v in params_from_jax(p1).items()})
save["tokens"], save["labels"] = toks, labs
sess = Session(RunSpec(ARCH, workload="train", mesh="2x1", smoke=True, rounds=2,
                       precision=PrecisionPolicy(comm=8)))
meta = {"loss": float(m["loss"]), "comm_report": sess.comm_report()}
np.savez(out_path, **save)
print("RESULT " + json.dumps(meta))
""" % {"consts": repr((ARCH, TB, TS, LR, SEED, ROUND))}


@pytest.fixture(scope="module")
def reference_step(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "ref.npz")
    out = subprocess.run([sys.executable, "-c", _REFERENCE, path], capture_output=True,
                         text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
                              "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    meta = json.loads(out.stdout.split("RESULT ", 1)[1])
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


def test_train_step_matches_reference(reference_step, monkeypatch):
    """Loss within 1e-5, FSDP leaves (the expert stacks, the vocab tables)
    within rtol 1e-5; the wire's leaves (attention, norms, the router)
    within ``lr * step / D``, the last-bit differences of the two packages'
    gradients moving a code by at most one step."""
    arrays, meta = reference_step
    cfg = smoke_variant(get_config(ARCH))
    axes = axis_ctx_for("2x1")
    params = {k[5:]: torch.from_numpy(v.copy()) for k, v in arrays.items()
              if k.startswith("init:")}
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
    assert abs(float(m["loss"]) - meta["loss"]) <= 1e-5
    paths, _leaves, plan = fsdp_plan(params, axes.fsdp, check_divisibility=False)
    wire = [p for p, d in zip(paths, plan) if d is None]
    assert len(wire) == 8 and "blocks/moe/router" in wire
    assert "blocks/moe/w_up" not in wire
    for p in paths:
        got, want = p1[p].numpy(), arrays["step:" + p]
        if p in wire:
            g = seen["grads"][wire.index(p)]
            bound = LR * float(g.abs().max()) / (2**8 - 1) / axes.dp
            assert np.abs(got - want).max() <= bound * (1 + 1e-3) + 1e-7, p
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=p)


def test_comm_report_matches_reference(reference_step):
    _arrays, meta = reference_step
    sess = Session(RunSpec(ARCH, workload="train", mesh="2x1", smoke=True, rounds=2,
                           precision=PrecisionPolicy(comm=8)), device="cpu")
    got = json.loads(json.dumps(sess.comm_report()))
    assert got == meta["comm_report"]
    assert got["replicated_leaves"] == 8


def test_train_step_runs_keyed_k1_on_expert_stacks(monkeypatch):
    """With the seeded draws each weight use is one call of K1's inline
    entry, the router never (exempt), the expert stacks once each a layer
    and client; the wire is one call of K2's keyed entry."""
    cfg = smoke_variant(get_config(ARCH))
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
    # a client: embed, unembed, 4 attention and 3 expert stacks a layer
    assert len(seen) == axes.dp * (2 + 7 * cfg.n_layers)
    assert seen.count((cfg.n_experts, cfg.d_model, cfg.moe_d_ff)) == 2 * axes.dp * cfg.n_layers
    assert (cfg.d_model, cfg.n_experts) not in seen          # the router stays f32
    assert len(packs) == 1
