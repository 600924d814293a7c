"""Helpers shared by the cross-attention families' parity tests
(``test_torch_encdec.py``, ``test_torch_vlm.py``): the two packages' param
contexts, cache-tree comparison, kernel-call counters, and one 2x1 train
step of the reference in a subprocess fed the reference's SR draws."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.api.precision import PrecisionPolicy as JPolicy
from repro.core.fwq import _stable_hash
from repro.dist.collectives import AxisCtx as JAxisCtx
from repro.models.common import ParamCtx as JParamCtx
from repro_torch.api import PrecisionPolicy, RunSpec, Session
from repro_torch.configs import get_config, smoke_variant
from repro_torch.configs.base import TrainConfig
from repro_torch.core.fwq import delta_for_clients
from repro_torch.dist.collectives import AxisCtx
from repro_torch.kernels import ops
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import axis_ctx_for
from repro_torch.models.common import ParamCtx, fsdp_plan
from repro_torch.models.model import build_model
from repro_torch.optim import build_optimizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
#: the train step's batch, sequence, learning rate, seed and round
TB, TS, LR, SEED, ROUND = 4, 16, 0.5, 0, 3


def ctxs(packed: bool, transforms=(None, None)):
    """(reference, port) param contexts in f32: lazy int8 (``packed``) or
    plain weights through ``transforms``."""
    if packed:
        return (JParamCtx.from_policy(JAxisCtx((), None, ()), JPolicy.lazy_int8(7),
                                      compute_dtype=jnp.float32),
                ParamCtx.from_policy(AxisCtx(), PrecisionPolicy.lazy_int8(7),
                                     compute_dtype=torch.float32))
    return (JParamCtx(ctx=JAxisCtx((), None, ()), compute_dtype=jnp.float32,
                      transform=transforms[0]),
            ParamCtx(ctx=AxisCtx(), compute_dtype=torch.float32, transform=transforms[1]))


def close(got, want, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), err_msg=msg, **TOL)


def assert_tree_close(tcache, jcache, path=""):
    """Every leaf of a port cache tree against the reference's: integer
    leaves (page tables, lengths) exactly, the rest within TOL; bare
    tensors (the cross K/V) too."""
    if isinstance(tcache, dict):
        assert tcache.keys() == jcache.keys()
        for k in tcache:
            assert_tree_close(tcache[k], jcache[k], f"{path}/{k}")
        return
    if isinstance(tcache, torch.Tensor):
        assert not hasattr(jcache, "_fields"), path
        close(tcache, jcache, path)
        return
    assert type(tcache).__name__ == type(jcache).__name__, path
    for name in type(tcache)._fields:
        got, want = getattr(tcache, name).numpy(), np.asarray(getattr(jcache, name))
        if got.dtype.kind in "iu":
            np.testing.assert_array_equal(got, want, err_msg=f"{path}.{name}")
        else:
            np.testing.assert_allclose(got, want, err_msg=f"{path}.{name}", **TOL)


def count_serving_kernels(monkeypatch) -> dict:
    """Counts ``ops``' K3 and K5 calls and records each K4 call's ``causal``."""
    calls = {"k3": 0, "k4": [], "k5": 0}
    k3, k4, k5 = ops.quant_matmul, ops.flash_attention, ops.flash_paged_decode

    def count3(*a):
        calls["k3"] += 1
        return k3(*a)

    def count4(q, k, v, causal=True):
        calls["k4"].append(causal)
        return k4(q, k, v, causal)

    def count5(*a):
        calls["k5"] += 1
        return k5(*a)

    monkeypatch.setattr(ops, "quant_matmul", count3)
    monkeypatch.setattr(ops, "flash_attention", count4)
    monkeypatch.setattr(ops, "flash_paged_decode", count5)
    return calls


def serve_smoke(arch: str):
    """``Session.serve`` of ``arch`` at smoke size on the CPU: paged, flash,
    3 requests over 2 slots.  Returns the session and its stats."""
    spec = RunSpec(arch, workload="serve", smoke=True, seed=0, batch=2, seq=32,
                   precision=PrecisionPolicy.lazy_int8(7),
                   options={"attn_impl": "flash", "kv_layout": "paged", "prompt_len": 8,
                            "requests": 3, "max_new": 4, "steps": 16, "vary_prompt": True,
                            "quiet": True})
    sess = Session(spec, device="cpu")
    stats = sess.serve()
    assert stats.admitted == stats.completed == 3
    assert stats.kv_layout == "paged" and stats.kv_bytes > 0
    return sess, stats


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
ARCH, B, S, LR, SEED, ROUND, GATES = %(consts)s
cfg = smoke_variant(get_config(ARCH))
model = build_model(cfg)
mesh, axes = mesh_and_axes("2x1")
params = build_init_fn(model, mesh, axes)[0](jax.random.PRNGKey(SEED))
for name, g in GATES.items():
    cross = params["periods"]["cross"]
    cross[name] = jax.device_put(jnp.full(cross[name].shape, g, cross[name].dtype),
                                 cross[name].sharding)
rng = np.random.default_rng(0)
batch = {"tokens": rng.integers(0, 512, (B, S)).astype(np.int32),
         "labels": rng.integers(0, 512, (B, S)).astype(np.int32)}
# the stub frontend's input, seeded and non-zero
for name, t in model.train_batch_spec(B, S).items():
    if name not in batch:
        batch[name] = rng.standard_normal(t.shape).astype(np.float32)
opt = build_optimizer("sgd", LR)
tc = TrainConfig(learning_rate=LR, seed=SEED, grad_compression_bits=8)
step = build_train_step(model, mesh, axes, opt, tc, donate=False).fn(
    model.train_batch_spec(B, S))
p1, _o, m = step(params, opt.init(params), {k: jnp.asarray(v) for k, v in batch.items()},
                 delta_for_clients(np.array([8, 16])),
                 jax.random.fold_in(jax.random.PRNGKey(SEED), ROUND))
save = {"init:" + k: v.numpy() for k, v in params_from_jax(params).items()}
save.update({"step:" + k: v.numpy() for k, v in params_from_jax(p1).items()})
save.update({"batch:" + k: v for k, v in batch.items()})
sess = Session(RunSpec(ARCH, workload="train", mesh="2x1", smoke=True, rounds=2,
                       precision=PrecisionPolicy(comm=8)))
meta = {"loss": float(m["loss"]), "comm_report": sess.comm_report()}
np.savez(out_path, **save)
print("RESULT " + json.dumps(meta))
"""


def start_reference_step(arch: str, out_path: str, gates=None):
    """The reference's train step of ``arch`` at smoke size on 2 fake
    devices, started in a subprocess (its cross gates set to ``gates``,
    its frontend's input seeded non-zero); :func:`reference_step` waits for
    it."""
    script = _REFERENCE % {"consts": repr((arch, TB, TS, LR, SEED, ROUND, gates or {}))}
    return subprocess.Popen([sys.executable, "-c", script, out_path], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
                                 "JAX_PLATFORMS": "cpu"})


def reference_step(proc, out_path: str):
    """``(arrays, meta)`` of a :func:`start_reference_step` run."""
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-3000:] + err[-3000:]
    meta = json.loads(out.split("RESULT ", 1)[1])
    with np.load(out_path) as z:
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


def check_train_step(arch: str, reference, monkeypatch) -> tuple[dict, dict, list]:
    """The port's train step from the reference's initial params and batch,
    fed its SR draws: loss within 1e-5, FSDP leaves within rtol 1e-5; the
    wire's leaves within ``lr * step / D`` (the last-bit differences of the
    two packages' gradients move a code by at most one step);
    ``Session.comm_report()`` equal.  Returns (initial params, stepped
    params, wire paths)."""
    arrays, meta = reference
    cfg = smoke_variant(get_config(arch))
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
    batch = {k[6:]: torch.from_numpy(v) for k, v in arrays.items() if k.startswith("batch:")}
    memory = set(batch) - {"tokens", "labels"}
    assert len(memory) == 1 and batch[memory.pop()].abs().min() > 0
    p1, _opt, m = step.fn(params, opt.init(params), batch,
                          delta_for_clients(np.array([8, 16])), ReferenceDraws())
    assert abs(float(m["loss"]) - meta["loss"]) <= 1e-5
    paths, _leaves, plan = fsdp_plan(params, axes.fsdp, check_divisibility=False)
    wire = [p for p, d in zip(paths, plan) if d is None]
    for p in paths:
        got, want = p1[p].numpy(), arrays["step:" + p]
        if p in wire:
            g = seen["grads"][wire.index(p)]
            bound = LR * float(g.abs().max()) / (2**8 - 1) / axes.dp
            assert np.abs(got - want).max() <= bound * (1 + 1e-3) + 1e-7, p
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=p)
    sess = Session(RunSpec(arch, workload="train", mesh="2x1", smoke=True, rounds=2,
                           precision=PrecisionPolicy(comm=8)), device="cpu")
    got = json.loads(json.dumps(sess.comm_report()))
    assert got == meta["comm_report"] and got["replicated_leaves"] == len(wire)
    return params, p1, wire


def k1_inline_calls(cfg, monkeypatch) -> int:
    """K1 inline calls of one seeded 2x1 train step of ``cfg`` with a
    seeded non-zero frontend input (the wire one keyed K2 call); then one
    session train round at smoke size, which feeds zero inputs as the
    reference does, must give a finite loss."""
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
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, TS), generator=gen)
    batch = {name: torch.randn(tuple(t.shape), generator=gen)
             for name, t in model.train_batch_spec(4, TS).items()}
    batch.update(tokens=toks, labels=toks)
    _p, _o, m = step.fn(params, opt.init(params), batch, delta_for_clients(np.array([8, 16])),
                        tsteps.SRDraws(SEED, ROUND))
    assert np.isfinite(float(m["loss"])) and len(packs) == 1
    per_client = len(seen) // axes.dp
    hist = Session(RunSpec(cfg.name.removesuffix("-smoke"), workload="train", mesh="2x1",
                           smoke=True, rounds=1, batch=2, seq=TS,
                           precision=PrecisionPolicy(weights=8, comm=8)),
                   device="cpu").run_train()
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
    return per_client
