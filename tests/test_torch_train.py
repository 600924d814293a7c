"""Parity of the port's pod trainer (``train`` / ``fl-orchestrate``) with the
JAX reference on the CPU, and its checkpoints.

* ``train_loss`` forward and gradient on the smoke config (f32 compute), with
  and without rematerialization.
* One ``build_train_step`` step against the reference's on a 2-device fake
  mesh (one subprocess: XLA's device count is fixed at start-up), from the
  reference's initial weights and its own SR draws (the port's
  :class:`~repro_torch.launch.steps.SRDraws` is the seam), at a width where
  both FSDP-sharded and replicated leaves occur, at comm 8, 32 and off.
* ``fl-orchestrate``: the port's Session plans the reference's rounds
  exactly (bits, energy, cohorts, wire bytes).
* The CLI, and checkpoint resume for ``train`` and ``fl-sim``.
* One client a process (``gloo`` on the CPU, ranks started once a module by
  ``tests/torch_dist_worker.py``): the step on 2 ranks fed the reference's
  draws equals the one-process loop bit for bit and the reference's step
  within its tolerances, at comm 8, 32 and off; on 4 ranks at comm 8 (the
  int16 wire, widened) the wire leaves are bit-equal to the loop and the
  FSDP leaves within rtol 1e-6; ``build_init_fn``, the wire's "raise" on
  every rank, ``comm_report``; the CLI under torchrun (its checkpoint is the
  one-process run's, a resume the uninterrupted run); NCCL refused where it
  cannot run.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.core.fwq import _stable_hash, make_inline_quantizer as jinline
from repro.dist.collectives import AxisCtx as JAxisCtx
from repro.models.common import ParamCtx as JParamCtx
from repro.models.model import build_model as jbuild_model
from repro_torch.api import PrecisionPolicy, RunSpec, Session
from repro_torch.configs import get_config, smoke_variant
from repro_torch.configs.base import TrainConfig
from repro_torch.core.fwq import delta_for_clients
from repro_torch.dist.collectives import AxisCtx
from repro_torch.kernels import ops
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import axis_ctx_for
from repro_torch.models.common import ParamCtx
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.optim import build_optimizer
from torch_dist_worker import run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, LR, SEED, ROUND = 4, 32, 0.5, 0, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _step_cfg():
    """The smoke config widened to d_model 256: the reference FSDP-shards wq,
    wo, the MLP and the vocab tables there and replicates wk, wv and the
    norms, so a step exercises both reductions."""
    return dataclasses.replace(smoke_variant(get_config("yi-6b")), d_model=256, n_heads=4,
                               n_kv_heads=2, head_dim=64, d_ff=512, remat=True)


_REFERENCE = r"""
import os, sys, json, dataclasses
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

out_path = sys.argv[1]
B, S, LR, SEED, ROUND = %(consts)s
cfg = dataclasses.replace(smoke_variant(get_config("yi-6b")), d_model=256, n_heads=4,
                          n_kv_heads=2, head_dim=64, d_ff=512, remat=True)
model = build_model(cfg)
mesh, axes = mesh_and_axes("2x1")
params = build_init_fn(model, mesh, axes)[0](jax.random.PRNGKey(SEED))
rng = np.random.default_rng(0)
toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
labs = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
delta = delta_for_clients(np.array([8, 16]))
key = jax.random.fold_in(jax.random.PRNGKey(SEED), ROUND)

def flat(tree, prefix):
    return {prefix + "/".join(str(k.key) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

# the global, gathered tree of the sharded arrays crosses as the port's dict
from repro_torch.models.convert import params_from_jax
save = {"init:" + k: v.numpy() for k, v in params_from_jax(params).items()}
save["tokens"], save["labels"] = toks, labs
meta = {}
for bits in (8, 32, 0):
    opt = build_optimizer("sgd", LR)
    tc = TrainConfig(learning_rate=LR, seed=SEED, grad_compression_bits=bits)
    step = build_train_step(model, mesh, axes, opt, tc, donate=False).fn(
        model.train_batch_spec(B, S))
    p1, _o, m = step(params, opt.init(params),
                     {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)}, delta, key)
    save.update(flat(p1, f"comm{bits}:"))
    meta[str(bits)] = {"loss": float(m["loss"]), "gnorm": float(m["grad_sq_shard_sum"])}
sess = Session(RunSpec("yi-6b", workload="fl-orchestrate", mesh="2x1", smoke=True,
                       rounds=2, batch=2, seq=32, precision=PrecisionPolicy(comm=8),
                       options={"quiet": True}))
meta["history"] = sess.run_train()
meta["comm_report"] = sess.comm_report()
np.savez(out_path, **save)
print("RESULT " + json.dumps(meta))
""" % {"consts": repr((B, S, LR, SEED, ROUND))}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's step results and fl-orchestrate run on 2 fake devices."""
    path = str(tmp_path_factory.mktemp("ref") / "ref.npz")
    out = subprocess.run([sys.executable, "-c", _REFERENCE, path], capture_output=True,
                         text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
                              "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    meta = json.loads(out.stdout.split("RESULT ", 1)[1])
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    return arrays, meta


class ReferenceDraws(tsteps.SRDraws):
    """The reference's SR uniforms for round ``ROUND`` of seed ``SEED``:
    weights ``fold_in(fold_in(rng, c), _stable_hash(path))``, wire leaf ``i``
    ``fold_in(fold_in(fold_in(rng, 17), i), c)``."""

    def __init__(self):
        super().__init__(SEED, ROUND)
        self.rng = jax.random.fold_in(jax.random.PRNGKey(SEED), ROUND)
        self.calls = []

    def weights(self, client, path, shape, device):
        self.calls.append((client, path))
        k = jax.random.fold_in(jax.random.fold_in(self.rng, client), _stable_hash(path))
        return torch.from_numpy(np.array(jax.random.uniform(k, tuple(shape), jnp.float32)))

    def wire(self, leaf, n_clients, shape, device):
        k = jax.random.fold_in(jax.random.fold_in(self.rng, 17), leaf)
        return torch.stack([torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(k, c), tuple(shape), jnp.float32))) for c in range(n_clients)])


def _port_step(arrays, bits, monkeypatch):
    model = build_model(_step_cfg())
    axes = axis_ctx_for("2x1")
    params = {k[5:]: torch.from_numpy(v.copy()) for k, v in arrays.items()
              if k.startswith("init:")}
    opt = build_optimizer("sgd", LR)
    tc = TrainConfig(learning_rate=LR, seed=SEED, grad_compression_bits=bits)
    step = tsteps.build_train_step(model, axes, opt, tc)
    seen = {}
    psum = tsteps.quantized_psum_batch

    def recorder(axes_, grads, us, bits_, **kw):
        seen["grads"] = grads
        return psum(axes_, grads, us, bits_, **kw)

    monkeypatch.setattr(tsteps, "quantized_psum_batch", recorder)
    draws = ReferenceDraws()
    batch = {"tokens": torch.from_numpy(arrays["tokens"]),
             "labels": torch.from_numpy(arrays["labels"])}
    p1, _opt, m = step.fn(params, opt.init(params), batch,
                          delta_for_clients(np.array([8, 16])), draws)
    return params, p1, m, seen, draws


@pytest.mark.parametrize("bits", [8, 32, 0])
def test_train_step_matches_reference(reference, bits, monkeypatch):
    """Loss within 1e-5, FSDP leaves within rtol 1e-5; on the wire leaves the
    two packages' gradients differ in their last bits, which can move one
    client's code by one step: the bound there is ``lr * step / D``."""
    arrays, meta = reference
    params, p1, m, seen, draws = _port_step(arrays, bits, monkeypatch)
    assert abs(float(m["loss"]) - meta[str(bits)]["loss"]) <= 1e-5
    axes = axis_ctx_for("2x1")
    from repro_torch.models.common import fsdp_plan
    paths, _leaves, plan = fsdp_plan(params, axes.fsdp, check_divisibility=False)
    kinds = {p: ("fsdp" if d is not None else "replicated") for p, d in zip(paths, plan)}
    assert set(kinds.values()) == {"fsdp", "replicated"}
    # grad_sq_shard_sum by its definition, from the reference's own update
    # (FSDP leaves once, replicated leaves once per client); the reference's
    # compiled step reports 5e-4 less at this config (ROADMAP §3)
    ref_g = {p: (arrays["init:" + p].astype(np.float64) - arrays[f"comm{bits}:" + p]) / LR
             for p in paths}
    defined = sum(float((ref_g[p] ** 2).sum()) * (axes.dp if kinds[p] == "replicated" else 1)
                  for p in paths)
    np.testing.assert_allclose(float(m["grad_sq_shard_sum"]), defined, rtol=1e-4)
    np.testing.assert_allclose(float(m["grad_sq_shard_sum"]), meta[str(bits)]["gnorm"],
                               rtol=1e-3)
    wire = [p for p in paths if kinds[p] == "replicated"] if bits else []
    assert ("grads" in seen) == bool(bits)
    for p in paths:
        got, want = p1[p].numpy(), arrays[f"comm{bits}:{p}"]
        if p in wire and bits < 32:
            g = seen["grads"][wire.index(p)]
            step_ = float(g.abs().max()) / (2**bits - 1)
            bound = LR * step_ / axes.dp
            assert np.abs(got - want).max() <= bound * (1 + 1e-3) + 1e-7, p
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=p)
    # every layer of a stacked weight draws the same uniforms (the site key
    # has no layer index), once in forward and once more under remat
    n_layers = params["blocks/attn/wq"].shape[0]
    assert draws.calls.count((0, "blocks/attn/wq")) == 2 * n_layers
    assert draws.calls.count((1, "unembed/w")) == 1


def test_train_loss_and_gradient_match_reference():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (2, 32)).astype(np.int32)
    labs = rng.integers(0, 512, (2, 32)).astype(np.int32)
    for remat in (False, True):
        jcfg = dataclasses.replace(jsmoke(jget_config("yi-6b")), remat=remat)
        tcfg = dataclasses.replace(smoke_variant(get_config("yi-6b")), remat=remat)
        jm, tm = jbuild_model(jcfg), build_model(tcfg)
        jp = jm.init(jax.random.PRNGKey(1), 1)
        jpc = JParamCtx(ctx=JAxisCtx((), None, ()), compute_dtype=jnp.float32)
        jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)}
        (jl, _), jg = jax.jit(jax.value_and_grad(lambda p: jm.train_loss(jpc, p, jb),
                                                 has_aux=True))(jp)
        tp = {k: v.requires_grad_() for k, v in params_from_jax(jp).items()}
        tpc = ParamCtx(ctx=AxisCtx(), compute_dtype=torch.float32)
        tl, aux = tm.train_loss(tpc, tp, {"tokens": torch.from_numpy(toks),
                                          "labels": torch.from_numpy(labs)})
        assert aux == {} and abs(tl.item() - float(jl)) <= 1e-5
        want = params_from_jax(jg)
        for k, g in zip(tp, torch.autograd.grad(tl, list(tp.values()))):
            np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=k)


def test_vocab_parallel_xent_matches_reference():
    from repro.models import layers as jl
    from repro_torch.models import layers as tl

    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[0, :3] = -1                                   # ignored positions
    jpc = JParamCtx(ctx=JAxisCtx((), None, ()), compute_dtype=jnp.float32)
    jloss, jn = jl.vocab_parallel_xent(jpc, jnp.asarray(logits), jnp.asarray(labels), 50)
    tloss, tn = tl.vocab_parallel_xent(ParamCtx(ctx=AxisCtx()), torch.from_numpy(logits),
                                       torch.from_numpy(labels), 50)
    assert int(tn) == int(jn) == 18
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)


def test_inline_quantizer_reuses_site_draws_across_layers():
    """The reference keys a weight use by client and path only: under its
    layer scan every layer of a stacked weight is rounded with the same
    uniforms.  The port's quantizer, given the same draws, rounds each layer
    to the reference's values, and its seeded draws repeat per site too."""
    rng = np.random.default_rng(4)
    w = rng.standard_normal((3, 16, 24)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    delta = jnp.float32(1.0 / 15.0)
    jt = jinline(delta, key)
    ref = [np.asarray(jt("blocks/mlp/w_up", jnp.asarray(w[i]))) for i in range(3)]
    u = np.array(jax.random.uniform(jax.random.fold_in(key, _stable_hash("blocks/mlp/w_up")),
                                    (16, 24), jnp.float32))
    from repro_torch.core.fwq import make_inline_quantizer
    tt = make_inline_quantizer(torch.tensor(1.0 / 15.0), uniforms=lambda p, x: torch.from_numpy(u))
    for i in range(3):
        np.testing.assert_array_equal(tt("blocks/mlp/w_up", torch.from_numpy(w[i])).numpy(),
                                      ref[i])
    seeded = make_inline_quantizer(torch.tensor(1.0 / 15.0), seed=2)
    d = tsteps.SRDraws(0, 1)
    assert torch.equal(d.weights(1, "blocks/mlp/w_up", (4, 5), "cpu"),
                       d.weights(1, "blocks/mlp/w_up", (4, 5), "cpu"))
    assert not torch.equal(d.weights(0, "blocks/mlp/w_up", (4, 5), "cpu"),
                           d.weights(1, "blocks/mlp/w_up", (4, 5), "cpu"))
    x = torch.from_numpy(w[0])
    assert torch.equal(seeded("blocks/mlp/w_up", x), seeded("blocks/mlp/w_up", x))


def test_remat_runs_each_weight_quantization_twice(monkeypatch):
    """Under remat the checkpointed blocks run again in backward, and so do
    their inline quantizations (calls of K1's inline entry): counted, not
    hidden.  The seeded quantizer takes the keyed entry only."""
    counts = {}

    def counting(name):
        real = getattr(ops, name)

        def count(*a, **kw):
            counts[name] = counts.get(name, 0) + 1
            return real(*a, **kw)
        return count

    for name in ("sr_quantize_inline", "sr_quantize_segments"):
        monkeypatch.setattr(ops, name, counting(name))
    cfg0 = smoke_variant(get_config("yi-6b"))
    toks = torch.randint(0, 512, (2, 32), generator=torch.Generator().manual_seed(0))
    for remat, per_step in ((False, 1), (True, 2)):
        cfg = dataclasses.replace(cfg0, remat=remat)
        model = build_model(cfg)
        params = {k: v.requires_grad_() for k, v in
                  model.init(torch.Generator().manual_seed(0), 1).items()}
        from repro_torch.core.fwq import make_inline_quantizer
        pc = ParamCtx(ctx=AxisCtx(), compute_dtype=torch.float32,
                      transform=make_inline_quantizer(torch.tensor(1.0 / 255), seed=0))
        counts.clear()
        loss, _ = model.train_loss(pc, params, {"tokens": toks, "labels": toks})
        torch.autograd.grad(loss, list(params.values()))
        # embed + unembed once; the block weights (7 a layer) per pass
        assert counts.get("sr_quantize_inline") == 2 + 7 * cfg.n_layers * per_step, (
            remat, counts)
        assert "sr_quantize_segments" not in counts, counts


class GivenPhiloxDraws(tsteps.SRDraws):
    """Overrides ``weights`` with the uniforms the keyed entry would draw:
    the step must take them as given (K1's segment entry)."""

    def __init__(self, seed, round_idx):
        super().__init__(seed, round_idx)
        self.calls = []

    def weights(self, client, path, shape, device):
        self.calls.append((client, path))
        return super().weights(client, path, shape, device)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_train_step_takes_the_keyed_entry_unless_weights_are_overridden(
        compute_dtype, monkeypatch):
    """The default :class:`SRDraws` makes each weight use one call of K1's
    inline entry (no uniforms tensor); a subclass that overrides ``weights``
    has its uniforms used (the segment entry), never bypassed.  Fed the
    keyed entry's own uniforms, that path gives the same step bit for bit."""
    cfg = dataclasses.replace(smoke_variant(get_config("yi-6b")), compute_dtype=compute_dtype)
    model, axes = build_model(cfg), axis_ctx_for("2x1")
    params0 = model.init(torch.Generator().manual_seed(0), 1)
    toks = torch.randint(0, cfg.vocab_size, (4, 32), generator=torch.Generator().manual_seed(1))
    opt = build_optimizer("sgd", LR)
    step = tsteps.build_train_step(model, axes, opt, TrainConfig(learning_rate=LR, seed=SEED,
                                                                 grad_compression_bits=8))
    counts = {}

    def counting(name):
        real = getattr(ops, name)

        def count(*a, **kw):
            counts[name] = counts.get(name, 0) + 1
            return real(*a, **kw)
        return count

    for name in ("sr_quantize_inline", "sr_quantize_segments"):
        monkeypatch.setattr(ops, name, counting(name))
    out = {}
    for kind, draws in (("keyed", tsteps.SRDraws(SEED, ROUND)),
                        ("given", GivenPhiloxDraws(SEED, ROUND))):
        counts.clear()
        params = {k: v.clone() for k, v in params0.items()}
        out[kind] = step.fn(params, opt.init(params), {"tokens": toks, "labels": toks},
                            delta_for_clients(np.array([8, 16])), draws)
        uses = axes.dp * (2 + 7 * cfg.n_layers)         # remat off in the smoke config
        want = ({"sr_quantize_inline": uses} if kind == "keyed"
                else {"sr_quantize_segments": uses})
        assert counts == want, (kind, counts)
    assert len(draws.calls) == uses
    (p_k, _ok, m_k), (p_g, _og, m_g) = out["keyed"], out["given"]
    assert torch.equal(m_k["loss"], m_g["loss"])
    assert _params_equal(p_k, p_g)


def test_remat_rerun_reproduces_the_quantized_weights(monkeypatch):
    """Under remat each block's weight uses are quantized again in backward,
    from the same keys: every rerun gives the first pass's values."""
    seen = {}
    real = ops.sr_quantize_inline

    def recording(w, delta, key, out_dtype):
        q = real(w, delta, key, out_dtype)
        seen.setdefault((key, w.data_ptr()), []).append(q)
        return q

    monkeypatch.setattr(ops, "sr_quantize_inline", recording)
    cfg = dataclasses.replace(smoke_variant(get_config("yi-6b")), remat=True,
                              compute_dtype="bfloat16")
    model = build_model(cfg)
    params = {k: v.requires_grad_() for k, v in
              model.init(torch.Generator().manual_seed(0), 1).items()}
    from repro_torch.core.fwq import make_inline_quantizer
    pc = ParamCtx(ctx=AxisCtx(), compute_dtype=torch.bfloat16,
                  transform=make_inline_quantizer(torch.tensor(1.0 / 255), seed=0,
                                                  out_dtype=torch.bfloat16))
    toks = torch.randint(0, 512, (2, 32), generator=torch.Generator().manual_seed(0))
    loss, _ = model.train_loss(pc, params, {"tokens": toks, "labels": toks})
    torch.autograd.grad(loss, list(params.values()))
    runs = sorted(len(v) for v in seen.values())
    assert runs == [1, 1] + [2] * (7 * cfg.n_layers), runs
    for outs in seen.values():
        assert all(o.dtype == torch.bfloat16 and torch.equal(o, outs[0]) for o in outs)


def _port_session(workload, **kw):
    opts = kw.pop("options", {})
    return Session(RunSpec("yi-6b", workload=workload, mesh="2x1", smoke=True,
                           options={"quiet": True, **opts}, **kw), device="cpu")


def test_fl_orchestrate_plans_equal_reference(reference):
    """Same seed and fleet: the port plans the reference's rounds exactly
    (bits, energy, simulated time, cohort, comm bits) and reports the same
    wire bytes; the losses come from different initial weights."""
    _arrays, meta = reference
    sess = _port_session("fl-orchestrate", rounds=2, batch=2, seq=32,
                         precision=PrecisionPolicy(comm=8))
    hist = sess.run_train()
    for mine, ref in zip(hist, meta["history"], strict=True):
        for k in ("round", "bits", "comm_bits", "energy_j", "t_round_s", "cohort"):
            assert mine[k] == ref[k], (k, mine[k], ref[k])
        assert np.isfinite(mine["loss"])
    assert sess.comm_report() == meta["comm_report"]


def test_train_cli_on_cpu():
    from repro_torch.launch import train

    hist = train.main(["--device", "cpu", "--arch", "yi-6b", "--smoke", "--mesh", "2x1",
                       "--grad-compression-bits", "8", "--rounds", "2", "--batch", "2"])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert all(h["comm_bits"] == 8 and h["cohort"] == 2 for h in hist)


def _params_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_train_resume_equals_uninterrupted(tmp_path):
    """``train`` with checkpoints every 2 rounds: stopped after round 2 and
    resumed, it ends where the uninterrupted run ends, bit for bit."""
    kw = dict(batch=2, seq=32, precision=PrecisionPolicy.uniform(8, comm=4))
    full = _port_session("train", rounds=4, **kw)
    full_hist = full.run_train()
    ck = {"ckpt_dir": str(tmp_path / "ck"), "ckpt_every": 2}
    _port_session("train", rounds=2, options=ck, **kw).run_train()
    resumed = _port_session("train", rounds=4, options=ck, **kw)
    hist = resumed.run_train()
    assert [h["round"] for h in hist] == [2, 3]
    assert [h["loss"] for h in hist] == [h["loss"] for h in full_hist[2:]]
    assert _params_equal(resumed._train_state["params"], full._train_state["params"])
    assert sorted(os.listdir(tmp_path / "ck")) == [
        "ckpt_00000002.json", "ckpt_00000002.npz", "ckpt_00000004.json",
        "ckpt_00000004.npz"]


def test_fl_sim_resume_equals_uninterrupted(tmp_path):
    spec = dict(arch="mobilenet", workload="fl-sim", batch=2, rounds=4,
                options={"scheme": "unified_q", "n_clients": 2})

    def run(rounds, ckpt):
        opts = {**spec["options"], **({"ckpt_dir": ckpt, "ckpt_every": 2} if ckpt else {})}
        return Session(RunSpec(**{**spec, "rounds": rounds, "options": opts}),
                       device="cpu").run()

    full = run(4, None)
    ck = str(tmp_path / "ck")
    run(2, ck)
    out = run(4, ck)
    assert [h["round"] for h in out["history"]] == [2, 3]
    assert [h["loss"] for h in out["history"]] == [h["loss"] for h in full["history"][2:]]
    assert out["total_energy_j"] == full["total_energy_j"]


def test_checkpoint_format_is_the_references(tmp_path):
    """A port checkpoint (bf16 and int8 leaves included) loads in the
    reference with its checksums verified, and back."""
    from repro.ckpt import load_checkpoint as jload
    from repro.ckpt import save_checkpoint as jsave
    from repro.models.common import QTensor as JQTensor
    from repro_torch.ckpt import load_checkpoint, save_checkpoint
    from repro_torch.models.common import QTensor

    state = {"p": {"blocks/attn/wq": torch.randn(2, 3, 4).to(torch.bfloat16),
                   "embed/table": torch.randn(5, 4),
                   "unembed/w": QTensor(torch.randint(-9, 9, (4, 5), dtype=torch.int8),
                                        torch.tensor(0.25))},
             "o": {"step": torch.tensor(7, dtype=torch.int32)}}
    save_checkpoint(str(tmp_path / "a"), 3, state, extra={"round": 3})
    jtemplate = {"p": {"blocks": {"attn": {"wq": 0}}, "embed": {"table": 0},
                       "unembed": {"w": JQTensor(0, 0)}}, "o": {"step": 0}}
    jstate, manifest = jload(str(tmp_path / "a"), jtemplate)
    assert manifest["extra"] == {"round": 3} and manifest["step"] == 3
    np.testing.assert_array_equal(
        np.asarray(jstate["p"]["blocks"]["attn"]["wq"]).astype(np.float32),
        state["p"]["blocks/attn/wq"].float().numpy())
    jsave(str(tmp_path / "b"), 5, jstate)
    back, _ = load_checkpoint(str(tmp_path / "b"), state)
    assert back["p"]["blocks/attn/wq"].dtype == torch.bfloat16
    assert torch.equal(back["p"]["blocks/attn/wq"], state["p"]["blocks/attn/wq"])
    assert torch.equal(back["p"]["unembed/w"].codes, state["p"]["unembed/w"].codes)
    assert int(back["o"]["step"]) == 7
    with open(tmp_path / "a" / "ckpt_00000003.json") as f:
        manifest = json.load(f)
    manifest["leaves"]["p/embed/table"][2] = "0" * 16
    with open(tmp_path / "a" / "ckpt_00000003.json", "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="checksum"):
        load_checkpoint(str(tmp_path / "a"), state)


def test_full_width_fwq_plan_is_infeasible_in_both_packages():
    """At full yi-6b width the fleet's 8-64 MB device memories hold no
    bit-width of the model, so fwq's GBD has no memory-feasible seed: the
    reference and the port fail alike (the chip runs unified_q there)."""
    from repro.core.energy import heterogeneous_fleet, memory_capacities
    from repro.fed.orchestrator import FLOrchestrator, OrchestratorConfig

    n = 4
    n_params = jget_config("yi-6b").param_count()
    ref = FLOrchestrator(OrchestratorConfig(n_devices=n, n_rounds=2, scheme="fwq",
                                            model_dim_d=n_params, seed=0),
                         heterogeneous_fleet(n, seed=0, group_step_mhz=5.0),
                         memory_capacities(n, lo_mb=8, hi_mb=64) * 1e6,
                         grad_bytes=4.0 * n_params)
    spec = dict(arch="yi-6b", workload="fl-orchestrate", smoke=False, rounds=2)
    port = Session(RunSpec(**spec, options={"scheme": "fwq"}), device="cpu").orchestrator(n)
    for orch in (ref, port):
        with pytest.raises(IndexError):
            orch.plan_round(0)
    sess = Session(RunSpec(**spec, options={"scheme": "unified_q"}), device="cpu")
    assert sess.orchestrator(n).plan_round(0)["q"].tolist() == [16] * n


# ------------------------------------------------- one client a process (gloo)


@pytest.fixture(scope="module")
def two_ranks(reference, tmp_path_factory):
    """The port's step on 2 gloo ranks at comm 8, 32 and 0 from the
    reference's init, fed the reference's draws (the ``SRDraws`` seam, read
    from a file by each rank); gathered params per comm."""
    arrays, _meta = reference
    tmp = str(tmp_path_factory.mktemp("two_ranks"))
    from repro_torch.models.common import is_stacked, tree_paths_leaves

    params = {k[5:]: v for k, v in arrays.items() if k.startswith("init:")}
    draws = ReferenceDraws()
    data = {"init:" + k: v for k, v in params.items()}
    data.update(tokens=arrays["tokens"], labels=arrays["labels"])
    paths = tree_paths_leaves({k: torch.from_numpy(v) for k, v in params.items()})[0]
    for i, p in enumerate(paths):
        v = params[p]
        for c in range(2):
            shape = v.shape[1:] if is_stacked(p) else v.shape
            data[f"w:{c}:{p}"] = draws.weights(c, p, shape, "cpu").numpy()
        data[f"u:{i}"] = draws.wire(i, 2, v.shape, "cpu").numpy()
    np.savez(os.path.join(tmp, "data.npz"), **data)
    tasks = [dict(name=f"comm{b}", kind="step", data=os.path.join(tmp, "data.npz"), mesh="2x1",
                  bits=b, lr=LR, seed=SEED, round=ROUND, client_bits=[8, 16], draws="file",
                  save=os.path.join(tmp, f"comm{b}.npz")) for b in (8, 32, 0)]
    out = run_ranks(2, {"tasks": tasks}, tmp)
    return {b: (out[f"comm{b}"], dict(np.load(os.path.join(tmp, f"comm{b}.npz"))))
            for b in (8, 32, 0)}


@pytest.mark.parametrize("bits", [8, 32, 0])
def test_two_rank_step_equals_the_loop_and_the_reference(reference, two_ranks, bits,
                                                         monkeypatch):
    """2 ranks, one client each, fed the reference's draws: the params, loss
    and wire equal the one-process loop's bit for bit (two addends sum
    alike in any order), and so hold the reference's step within the
    tolerances of ``test_train_step_matches_reference``."""
    arrays, meta = reference
    res, got = two_ranks[bits]
    params, p1, m, seen, _draws = _port_step(arrays, bits, monkeypatch)
    assert set(got) == set(p1)
    for p in p1:
        assert np.array_equal(got[p], p1[p].numpy()), p
    assert res["loss"] == float(m["loss"])
    assert abs(res["loss"] - meta[str(bits)]["loss"]) <= 1e-5
    np.testing.assert_allclose(res["gnorm"], meta[str(bits)]["gnorm"], rtol=1e-3)
    np.testing.assert_allclose(res["gnorm"], float(m["grad_sq_shard_sum"]), rtol=1e-5)
    from repro_torch.models.common import fsdp_plan
    paths, _leaves, plan = fsdp_plan(params, 2, check_divisibility=False)
    for p, dim in zip(paths, plan):
        if dim is not None or not bits or bits >= 32:
            np.testing.assert_allclose(got[p], arrays[f"comm{bits}:{p}"], rtol=1e-5, atol=1e-6,
                                       err_msg=p)
    # one rank's collectives: FSDP gathers and their reduce-scatters, the
    # wire's count, scale and codes (int16 at 2 x 255, summed as int32)
    kinds = {k.rsplit(" ", 1)[0] for k in res["issued"]}
    assert {"all-gather", "reduce-scatter", "all-reduce sum"} <= kinds
    assert ("all-reduce sum int32" in res["issued"]) == (bits == 8)
    assert res["staged"] == {}


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """4 gloo ranks: a step at comm 8 with the keyed draws, ``build_init_fn``,
    the wire with a NaN, and ``comm_report``."""
    tmp = str(tmp_path_factory.mktemp("four_ranks"))
    from torch_dist_worker import step_cfg

    model = build_model(step_cfg())
    params = model.init(torch.Generator().manual_seed(5), 1)
    rng = np.random.default_rng(1)
    data = {"init:" + k: v.numpy() for k, v in params.items()}
    data["tokens"] = rng.integers(0, 512, (8, S)).astype(np.int32)
    data["labels"] = rng.integers(0, 512, (8, S)).astype(np.int32)
    np.savez(os.path.join(tmp, "data.npz"), **data)
    tasks = [dict(name="step", kind="step", data=os.path.join(tmp, "data.npz"), mesh="4x1",
                  bits=8, lr=LR, seed=SEED, round=ROUND, client_bits=[8, 16, 4, 32],
                  save=os.path.join(tmp, "step.npz")),
             dict(name="init", kind="init", mesh="4x1", seed=7,
                  save=os.path.join(tmp, "init.npz")),
             dict(name="wire", kind="wire", ranks=4, seed=3, sizes=[37, 6, 300], bits=8,
                  key=int(tsteps.SRDraws(SEED, ROUND).wire_key()), nan=True,
                  save=os.path.join(tmp, "wire.npz")),
             dict(name="comm_report", kind="comm_report", mesh="4x1", comm=8),
             dict(name="packed", kind="packed_gather", ranks=4, seed=9,
                  save=os.path.join(tmp, "packed.npz"))]
    out = run_ranks(4, {"tasks": tasks}, tmp)
    out["arrays"] = {k: dict(np.load(os.path.join(tmp, f"{k}.npz")))
                     for k in ("step", "init", "wire", "packed")}
    out["data"] = data
    return out


def test_four_rank_step_holds_the_loop(four_ranks):
    """4 ranks at comm 8 (int16 codes, widened to int32 on the wire): the
    wire leaves bit-equal to the one-process loop (the codes are the loop's
    rows: stream r on rank r), the FSDP leaves within rtol 1e-6 of each
    leaf's largest magnitude (four addends summed in another order: an
    element near zero may differ by an ulp of its update, which is no
    relative bound of that element), the loss within 1e-6."""
    from torch_dist_worker import step_cfg

    from repro_torch.models.common import fsdp_plan

    data, got = four_ranks["data"], four_ranks["arrays"]["step"]
    model, axes = build_model(step_cfg()), axis_ctx_for("4x1")
    params = {k[5:]: torch.from_numpy(v) for k, v in data.items() if k.startswith("init:")}
    opt = build_optimizer("sgd", LR)
    step = tsteps.build_train_step(model, axes, opt, TrainConfig(learning_rate=LR, seed=SEED,
                                                                 grad_compression_bits=8))
    p1, _o, m = step.fn(params, opt.init(params), {k: torch.from_numpy(data[k])
                                                   for k in ("tokens", "labels")},
                        delta_for_clients(np.array([8, 16, 4, 32])), tsteps.SRDraws(SEED, ROUND))
    paths, _leaves, plan = fsdp_plan(p1, 4)
    assert {d is None for d in plan} == {True, False}
    for p, dim in zip(paths, plan):
        if dim is None:
            assert np.array_equal(got[p], p1[p].numpy()), p
        else:
            want = p1[p].numpy()
            assert np.abs(got[p] - want).max() <= 1e-6 * np.abs(want).max(), p
    assert abs(four_ranks["step"]["loss"] - float(m["loss"])) <= 1e-6
    issued = four_ranks["step"]["issued"]
    assert "all-reduce sum int32" in issued and "all-reduce sum int16" not in issued


def test_build_init_fn_slices_the_one_process_init(four_ranks):
    """Each rank's storage is its FSDP shard of exactly the one-process
    init's leaves (gathered back here), the replicated leaves whole."""
    from torch_dist_worker import step_cfg

    from repro_torch.models.common import fsdp_plan

    whole = build_model(step_cfg()).init(torch.Generator().manual_seed(7), 1)
    got = four_ranks["arrays"]["init"]
    assert all(np.array_equal(got[p], whole[p].numpy()) for p in whole)
    paths, _leaves, plan = fsdp_plan(whole, 4)
    for rk in four_ranks["ranks"]:
        shapes = rk["init"]["local_shapes"]
        for p, dim in zip(paths, plan):
            want = list(whole[p].shape)
            if dim is not None:
                want[dim] //= 4
            assert shapes[p] == want, (p, shapes[p], want)


@pytest.mark.parametrize("arch", ["yi-6b", "olmoe-1b-7b", "seamless-m4t-large-v2"])
def test_sharded_init_slices_each_draw_before_the_next(arch, monkeypatch):
    """Rank 1 of 4's storage: each FSDP leaf is sliced where it is drawn
    (the draw hook returns the shard, so a rank never holds the whole
    model), and equals the slice of the one-process init."""
    from repro_torch.models import common

    cfg = dataclasses.replace(smoke_variant(get_config(arch)), d_model=256, d_ff=512)
    model, axes = build_model(cfg), axis_ctx_for("4x1").at_client(1)
    whole = model.init(torch.Generator().manual_seed(3), 1)
    paths, _leaves, plan = common.fsdp_plan(whole, 4)
    sharded = {p for p, dim in zip(paths, plan) if dim is not None}
    assert sharded
    returned = []
    drawn = common._drawn

    def recording(w):
        out = drawn(w)
        returned.append(out)
        return out

    monkeypatch.setattr(common, "_drawn", recording)
    got = common.sharded_init(lambda meta: model.init(
        torch.Generator().manual_seed(0 if meta else 3), 1, device="meta" if meta else None),
        axes)
    for p, dim in zip(paths, plan):
        want = whole[p] if dim is None else common.shard_leaf(whole[p], dim, axes)
        assert torch.equal(got[p], want), p
        if p in sharded:
            assert any(r is got[p] for r in returned), f"{p} was not sliced where drawn"


def test_wire_raise_raises_on_every_rank(four_ranks):
    """A NaN and an Inf on one rank: every rank reads the summed count and
    raises (none is left waiting in a collective); "saturate" gives the
    one-process wire's means bit for bit."""
    raised = [rk["wire"]["raised"] for rk in four_ranks["ranks"]]
    assert all(r is not None and "2 non-finite gradient values" in r for r in raised), raised
    gen = torch.Generator().manual_seed(3)
    leaves = [torch.randn(4, n, generator=gen) * (i + 1) for i, n in enumerate([37, 6, 300])]
    leaves[0][1, 2], leaves[-1][1, 0] = float("nan"), float("inf")
    want = tsteps.quantized_psum_batch(axis_ctx_for("4x1"), [list(g) for g in leaves], None, 8,
                                       key=tsteps.SRDraws(SEED, ROUND).wire_key(),
                                       on_nonfinite="saturate")
    got = four_ranks["arrays"]["wire"]
    for i, w in enumerate(want):
        assert np.array_equal(got[f"arr_{i}"], w.numpy()), i


def test_packed_fsdp_leaves_gather_as_bytes(four_ranks):
    """``ParamCtx.use`` gathers a packed FSDP leaf's int8 or int16 codes as a
    ``uint8`` view (a gather moves bytes), on the first or the last dim:
    exactly the whole codes."""
    gen = torch.Generator().manual_seed(9)
    got = four_ranks["arrays"]["packed"]
    for path, shape, dtype in (("blocks/attn/wq", (64, 512), torch.int16),
                               ("embed/table", (512, 64), torch.int8)):
        whole = torch.randint(-300 if dtype == torch.int16 else -127, 127, shape,
                              generator=gen).to(dtype)
        assert np.array_equal(got[path.replace("/", ".")], whole.numpy()), path


def test_comm_report_under_a_group_is_the_one_process_report(four_ranks):
    """The reference's s16 accounting: the widened int32 sum is a transport
    detail (ROADMAP §3, D12), not a report field."""
    sess = Session(RunSpec("yi-6b", workload="train", mesh="4x1", smoke=True, batch=2, seq=32,
                           rounds=1, precision=PrecisionPolicy(comm=8),
                           options={"quiet": True}), device="cpu")
    assert four_ranks["comm_report"]["comm_report"] == json.loads(json.dumps(sess.comm_report()))


def _torchrun_train(tmp_path, n, *args):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={n}", "-m", "repro_torch.launch.train", "--device", "cpu",
           "--backend", "gloo", *args]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
                         env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
                              "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out


def test_train_cli_under_torchrun_checkpoints_and_resumes_as_one_process(tmp_path):
    """``torchrun --nproc-per-node 2 ... --device cpu --backend gloo``: its
    round-10 checkpoint is the one-process run's, array for array, and a
    2-rank resume to round 12 ends where the uninterrupted one-process run
    does (losses of rounds 10-11 equal)."""
    flags = ["--arch", "yi-6b", "--smoke", "--mesh", "2x1", "--scheme", "fixed", "--bits", "8",
             "--grad-compression-bits", "8", "--batch", "2"]
    from repro_torch.launch import train

    one = train.main(["--device", "cpu", *flags, "--rounds", "12",
                      "--ckpt-dir", str(tmp_path / "one")])
    _torchrun_train(tmp_path, 2, *flags, "--rounds", "10", "--ckpt-dir", "two")
    with np.load(tmp_path / "one" / "ckpt_00000010.npz") as a, \
            np.load(tmp_path / "two" / "ckpt_00000010.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[k], b[k]) for k in a.files)
    shutil.copytree(tmp_path / "two", tmp_path / "resume")
    _torchrun_train(tmp_path, 2, *flags, "--rounds", "12", "--ckpt-dir", "resume",
                    "--out", "hist.json")
    with open(tmp_path / "hist.json") as f:
        hist = json.load(f)
    assert [h["round"] for h in hist] == [10, 11]
    assert [h["loss"] for h in hist] == [h["loss"] for h in one[10:]]


def test_nccl_where_it_cannot_run_raises(monkeypatch):
    """NCCL takes one card a rank and CUDA tensors: two ranks on one device,
    or on the CPU, are refused with the reason (nothing falls back to
    gloo); the torchrun-only flags outside torchrun are refused too."""
    from repro_torch.launch import mesh, train

    flags = ["--arch", "yi-6b", "--smoke", "--mesh", "2x1", "--rounds", "1"]
    with pytest.raises(ValueError, match="torchrun"):
        train.main([*flags, "--device", "cpu", "--backend", "gloo"])
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(ValueError, match="cannot put 2 ranks on one card"):
        train.main([*flags, "--share-device", "--backend", "nccl"])
    with pytest.raises(ValueError, match="CUDA tensors only"):
        train.main([*flags, "--device", "cpu", "--backend", "nccl"])
    with pytest.raises(ValueError, match="one card a rank"):
        mesh.check_backend("nccl", None, 2)
    with pytest.raises(RuntimeError, match="is_available"):
        train.main([*flags, "--backend", "gloo"])       # ranks ask for CUDA by default
