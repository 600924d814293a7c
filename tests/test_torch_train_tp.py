"""Training under tensor parallelism (``1xT`` / ``DxT`` meshes) on the CPU.

* The port's tp step of every family at smoke size on 1x2 (yi-6b also on
  2x2) against its own ``1x1`` (``2x1``) step of the same model cut, at
  32-bit weights: the whole parameters after the step (slices joined) equal
  within a stated tolerance, every replicated leaf the same on every rank of
  a model group.  mamba2's and jamba's ``1x1`` side takes its gated norm in
  T groups of channels (the reference's semantics under tp, ROADMAP §3).
* The forward under SR at 8 bits: the port's 1x2 loss against the
  reference's 1x2 loss, each rank fed the reference's per-shard uniforms
  through ``SRDraws.weights`` (each shard quantizes its own slice with its
  own scale).
* The 2x2 SR wire against the reference's ``quantized_psum_batch`` for the
  same per-shard gradients and uniforms, bit for bit.
* D16 (ROADMAP §3): the reference's 1x2 step from the 1x1 parameters cut
  has the port's loss, but its TP-sharded leaves move T times the port's
  update (its ``psum`` transposes to a ``psum``) and its replicated leaves
  move otherwise; the port's 1x2 step is the reference's 1x1 step.
* A 1x2 checkpoint resumes to the uninterrupted run and loads at 1x1.

The reference runs in one subprocess with 4 forced host devices; the port's
ranks are two gloo jobs (2 and 4 ranks, ``tests/torch_dist_worker.py``),
all started at the module's first test.
"""

import concurrent.futures
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
from repro.core.fwq import _stable_hash
from repro.models.model import build_model as jbuild_model
from repro_torch.api import PrecisionPolicy, RunSpec, Session
from repro_torch.ckpt.checkpoint import load_checkpoint
from repro_torch.dist.collectives import AxisCtx
from repro_torch.dist.sharding import tree_param_specs
from repro_torch.launch.mesh import axis_ctx_for
from repro_torch.launch.steps import build_init_fn
from repro_torch.models import ssm
from repro_torch.models.common import is_stacked
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.models.transformer import attn_dims
from torch_dist_worker import (TRAIN_TP, family_cfg, run_ranks, set_cross_gates,
                               train_tp_batch, train_tp_step)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "OMP_NUM_THREADS": "1"}
#: (arch, mesh, config overrides) of the port's tp steps held to its 1x1
#: (2x1) step: every family at 1x2, yi-6b at 2x2, and yi-6b at 1x2 without
#: sequence parallelism (a block's replicated input enters the rank-local
#: work through ``copy_model``; the norm scales' gradients are whole) and
#: with a vocabulary padded to the model axis (511 ids in 2 x 256 rows: the
#: padding column masked out of the softmax)
STEPS = (("yi-6b", "1x2", {}), ("olmoe-1b-7b", "1x2", {}), ("mamba2-780m", "1x2", {}),
         ("jamba-1.5-large-398b", "1x2", {}), ("llama-3.2-vision-90b", "1x2", {}),
         ("seamless-m4t-large-v2", "1x2", {}), ("yi-6b", "2x2", {}),
         ("yi-6b", "1x2", {"seq_parallel": False}), ("yi-6b", "1x2", {"vocab_size": 511}))
#: a leaf's update on the tp mesh against the 1x1 step's: within this share
#: of the 1x1 update's largest magnitude (the model group's sums add the
#: ranks' parts in another order than one device's matmuls)
UPDATE_RTOL = 1e-4
#: the reference's init (PRNGKey), and the SR round of its bits-8 forward
REF_KEY, SEED, ROUND = 7, 0, 1
#: the SR wire case: leaf shapes, comm bits
WIRE = dict(shapes=[(3, 40), (129,), (8, 8, 2)], bits=8)

_REFERENCE = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import repro  # installs the jax forward-compat shims before any mesh API
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config, smoke_variant
from repro.configs.base import TrainConfig
from repro.core.fwq import delta_for_clients
from repro.dist.collectives import quantized_psum_batch
from repro.launch.mesh import mesh_and_axes
from repro.launch.steps import build_init_fn, build_train_step
from repro.models.model import build_model
from repro.optim import build_optimizer

inputs, out = sys.argv[1], sys.argv[2]
REF_KEY, SEED, ROUND, LR, BITS = %(consts)s
data = dict(np.load(inputs))
model = build_model(smoke_variant(get_config("yi-6b")))
params = model.init(jax.random.PRNGKey(REF_KEY), 1)
batch = {"tokens": jnp.asarray(data["tokens"]), "labels": jnp.asarray(data["labels"])}
key = jax.random.fold_in(jax.random.PRNGKey(SEED), ROUND)
res, save = {}, {}

def flat(tree, prefix):
    return {prefix + "/".join(str(k.key) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

for spec in ("1x1", "1x2"):
    mesh, axes = mesh_and_axes(spec)
    _init, specs = build_init_fn(model, mesh, axes)
    p = jax.tree_util.tree_map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                               params, specs)
    opt = build_optimizer("sgd", LR)
    step = build_train_step(model, mesh, axes, opt, TrainConfig(learning_rate=LR, seed=SEED),
                            donate=False).fn(model.train_batch_spec(*data["tokens"].shape))
    for bits in ((32, 8) if spec == "1x2" else (32,)):
        p1, _o, m = step(p, opt.init(p), batch, delta_for_clients(np.array([bits])), key)
        res[f"{spec} {bits}"] = {"loss": float(m["loss"]),
                                 "gnorm": float(m["grad_sq_shard_sum"])}
        if bits == 32:
            save.update(flat(p1, f"{spec}:"))

mesh, axes = mesh_and_axes("2x2")
wkey = jax.random.fold_in(key, 17)
for i in range(len([k for k in data if k.startswith("g:")])):
    g = jax.device_put(data[f"g:{i}"], NamedSharding(mesh, P("data", "model")))
    fn = jax.jit(jax.shard_map(
        lambda x, i=i: quantized_psum_batch(axes, x[0, 0], jax.random.fold_in(wkey, i),
                                            BITS)[None, None],
        mesh=mesh, in_specs=P("data", "model"), out_specs=P("data", "model"),
        check_vma=False))
    save[f"wire:{i}"] = np.asarray(fn(g))
np.savez(out, **save)
print("RESULT " + json.dumps(res))
""" % {"consts": repr((REF_KEY, SEED, ROUND, TRAIN_TP["LR"], WIRE["bits"]))}


def _wire_inputs() -> dict:
    """The wire case: leaf i's gradients ``g:{i}`` at each (data, model)
    index of a 2x2 mesh, and ``u:{i}`` the uniforms the reference's
    ``quantized_psum_batch`` draws for client d under the step's wire key
    (``uniform(fold_in(fold_in(fold_in(rng, 17), i), d))``)."""
    rng = np.random.default_rng(11)
    wkey = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(SEED), ROUND), 17)
    out = {}
    for i, shape in enumerate(WIRE["shapes"]):
        out[f"g:{i}"] = (rng.standard_normal((2, 2, *shape)) * 0.01 * (i + 1)).astype(
            np.float32)
        out[f"u:{i}"] = np.stack([np.asarray(jax.random.uniform(
            jax.random.fold_in(jax.random.fold_in(wkey, i), d), shape, jnp.float32))
            for d in range(2)])
    return out


def _reference_uniforms(model, tp: int) -> dict:
    """The reference's weight uniforms of client 0 on a ``1xT`` shard for
    every leaf (its per-layer local shape): ``uniform(fold_in(fold_in(rng,
    0), _stable_hash(path)))`` of the round's key."""
    rng = jax.random.fold_in(jax.random.PRNGKey(SEED), ROUND)
    ckey = jax.random.fold_in(rng, 0)
    out = {}
    for path, w in model.init(torch.Generator().manual_seed(0), tp, device="meta").items():
        shape = tuple(w.shape[1:] if is_stacked(path) else w.shape)
        out[f"w:0:{path}"] = np.asarray(jax.random.uniform(
            jax.random.fold_in(ckey, _stable_hash(path)), shape, jnp.float32))
    return out


def _step_name(arch: str, mesh: str, overrides: dict) -> str:
    return " ".join([arch, mesh, *(f"{k}={v}" for k, v in overrides.items())])


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """The inputs (the reference's yi-6b init, the batch, its bits-8
    uniforms at 1x2, the wire's gradients and uniforms), then the reference's
    subprocess and the port's 2- and 4-rank gloo jobs, started at once."""
    tmp = str(tmp_path_factory.mktemp("train_tp"))
    model = build_model(family_cfg("yi-6b"))
    whole = params_from_jax(jbuild_model(jsmoke(jget_config("yi-6b"))).init(
        jax.random.PRNGKey(REF_KEY), 1))
    batch = train_tp_batch(model, 1)
    inputs = os.path.join(tmp, "inputs.npz")
    np.savez(inputs, tokens=batch["tokens"].numpy(), labels=batch["labels"].numpy(),
             **{f"param:{p}": w.numpy() for p, w in whole.items()},
             **_reference_uniforms(model, 2), **_wire_inputs())
    ref_out = os.path.join(tmp, "ref.npz")
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE, inputs, ref_out],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                           env={**ENV, "JAX_PLATFORMS": "cpu"})
    two = [dict(name=_step_name(*run), kind="train_tp", arch=run[0], mesh=run[1],
                overrides=run[2], bits=32, save=os.path.join(tmp, f"{_step_name(*run)}.npz"))
           for run in STEPS if run[1] == "1x2"]
    two += [dict(name="reference params", kind="train_tp", arch="yi-6b", mesh="1x2", bits=32,
                 data=inputs, save=os.path.join(tmp, "yi-6b-1x2-ref.npz")),
            dict(name="sr 8", kind="train_tp", arch="yi-6b", mesh="1x2", bits=8, data=inputs,
                 draws="file"),
            dict(name="ckpt", kind="ckpt_tp", mesh="1x2", dir=os.path.join(tmp, "ckpt"),
                 save=os.path.join(tmp, "ckpt-run-{r}.npz"))]
    four = [dict(name=_step_name(*run), kind="train_tp", arch=run[0], mesh=run[1],
                 overrides=run[2], bits=32, save=os.path.join(tmp, f"{_step_name(*run)}.npz"))
            for run in STEPS if run[1] == "2x2"]
    four.append(dict(name="wire", kind="wire_tp", mesh="2x2", bits=WIRE["bits"], data=inputs,
                     save=os.path.join(tmp, "wire-port-{rank}.npz")))
    pool = concurrent.futures.ThreadPoolExecutor(2)
    futures = {}
    for n, tasks in ((2, two), (4, four)):
        os.makedirs(os.path.join(tmp, f"ranks{n}"))
        futures[n] = pool.submit(run_ranks, n, {"tasks": tasks}, os.path.join(tmp, f"ranks{n}"),
                                 300)
    done: dict = {"tmp": tmp, "whole": whole}

    def wait_reference():
        if "ref" not in done:
            stdout, stderr = ref.communicate(timeout=600)
            assert ref.returncode == 0, stdout[-3000:] + stderr[-3000:]
            done["ref"] = json.loads(stdout.split("RESULT ", 1)[1])
            done["ref_arrays"] = dict(np.load(ref_out))
        return done["ref"], done["ref_arrays"]

    def wait(n):
        if n not in done:
            done[n] = futures[n].result()
        return done[n]

    done["wait_reference"], done["wait"] = wait_reference, wait
    yield done
    pool.shutdown(wait=True)
    if ref.poll() is None:
        ref.kill()


def _one_process_step(arch: str, D: int, T: int, overrides: dict, monkeypatch):
    """The port's step of ``arch`` (``overrides``) on ``Dx1`` in one process
    from its own init at seed 0, the SSM's gated norm in ``T`` groups
    (``chip_smoke.grouped_gated_norm``): the whole parameters before and
    after, and the metrics."""
    monkeypatch.syspath_prepend(ROOT)
    from chip_smoke import grouped_gated_norm

    monkeypatch.setattr(ssm, "_gated_norm", grouped_gated_norm(T))
    model = build_model(family_cfg(arch, overrides))
    axes = axis_ctx_for(f"{D}x1")
    whole = set_cross_gates(build_init_fn(model, axes)(torch.Generator().manual_seed(0)))
    p1, m = train_tp_step(model, axes, dict(whole), train_tp_batch(model, D), 32)
    return whole, p1, m


def _assert_updates_equal(before, want, got, label):
    assert set(got) == set(want), label
    for p in want:
        upd_w, upd_g = want[p].numpy() - before[p].numpy(), got[p] - before[p].numpy()
        scale = max(float(np.abs(upd_w).max()), 1e-30)
        err = float(np.abs(upd_g - upd_w).max())
        assert err <= UPDATE_RTOL * scale, f"{label} {p}: {err} > {UPDATE_RTOL} x {scale}"


@pytest.mark.parametrize("arch,mesh,overrides", STEPS, ids=[_step_name(*r) for r in STEPS])
def test_tp_step_is_the_one_device_step_of_the_model_cut(jobs, arch, mesh, overrides,
                                                         monkeypatch):
    """At 32-bit weights the tp step updates every parameter as the
    one-process ``Dx1`` step of the same model (its parameters cut over the
    model axis) does, within ``UPDATE_RTOL`` of each leaf's largest update;
    the loss within 1e-5; every replicated leaf identical on every rank of
    a model group.  The model group issues its collectives in forward and
    backward, the replicated leaves' one sum among them."""
    D, T = (int(x) for x in mesh.split("x"))
    name = _step_name(arch, mesh, overrides)
    res = jobs["wait"](D * T)
    r = res[name]
    before, want, m = _one_process_step(arch, D, T, overrides, monkeypatch)
    got = dict(np.load(os.path.join(jobs["tmp"], f"{name}.npz")))
    _assert_updates_equal(before, want, got, name)
    assert abs(r["loss"] - float(m["loss"])) <= 1e-5, (r["loss"], float(m["loss"]))
    sp = overrides.get("seq_parallel", True)
    for rk in res["ranks"]:
        step = rk[name]
        assert step["replicated_differ"] == [], step["replicated_differ"]
        assert step["loss"] == r["loss"]
        calls = step["model_calls"]
        # sequence parallelism: the block boundaries' gathers and
        # reduce-scatters; without it the sums alone
        assert (calls.get("all-gather float32", 0) > 0) == sp, calls
        assert (calls.get("reduce-scatter float32", 0) > 0) == sp, calls
        assert calls.get("all-reduce sum float32", 0) > 0, calls


@pytest.mark.parametrize("arch,mesh", [(a, m) for a, m, o in STEPS if not o])
def test_a_traced_step_issues_rank_0s_model_collectives(jobs, arch, mesh):
    """The dry run's traced device of the same step (one client, its model
    group a stand-in, no process group) issues over its model group exactly
    the calls and bytes, by kind and dtype, that rank 0's model group
    carried under the gloo group."""
    from repro_torch.configs.base import ShapeSpec

    D, T = (int(x) for x in mesh.split("x"))
    want = jobs["wait"](D * T)["ranks"][0][_step_name(arch, mesh, {})]["model_issued"]
    sess = Session(RunSpec(arch, workload="dryrun", mesh=mesh, smoke=True), device="cpu")
    sess.trace(ShapeSpec("train_tp", TRAIN_TP["S"], TRAIN_TP["B"] * D, "train"))
    got = {k: [v["calls"], v["bytes"]]
           for k, v in sess.traced_axes.model_transport.report()["issued"].items()}
    assert got == want and got
    assert not torch.distributed.is_initialized()


def test_sr_forward_matches_the_reference_at_1x2(jobs):
    """The 1x2 forward under SR at 8 bits: each rank quantizes its own slices
    (the slice's own max|w|) with the reference's per-shard uniforms fed
    through ``SRDraws.weights`` (the same on both shards: the site key is the
    client's); the loss is the reference's 1x2 loss within 1e-5."""
    ref, _arrays = jobs["wait_reference"]()
    port = jobs["wait"](2)["sr 8"]
    assert abs(port["loss"] - ref["1x2 8"]["loss"]) <= 1e-5, (port["loss"], ref["1x2 8"])
    # 8-bit weights move the loss off the 32-bit one
    assert abs(ref["1x2 8"]["loss"] - ref["1x2 32"]["loss"]) > 1e-4


def test_wire_over_the_batch_group_matches_the_reference_at_2x2(jobs):
    """The SR wire on a 2x2 mesh: rank (d, t) sends its own gradient with the
    reference's uniforms of client d; each model index's two batch ranks
    agree on their scale and sum their codes, and the means equal the
    reference's ``quantized_psum_batch`` inside ``shard_map`` bit for bit."""
    _ref, arrays = jobs["wait_reference"]()
    res = jobs["wait"](4)
    for rank, rk in enumerate(res["ranks"]):
        d, t = rk["wire"]["at"]
        assert (d, t) == (rank // 2, rank % 2)
        got = dict(np.load(os.path.join(jobs["tmp"], f"wire-port-{rank}.npz")))
        for i in range(len(WIRE["shapes"])):
            want = arrays[f"wire:{i}"][d, t]
            assert np.array_equal(got[f"arr_{i}"], want), (rank, i)
    # the two model indices quantize their own slices: their means differ
    assert not np.array_equal(arrays["wire:0"][0, 0], arrays["wire:0"][0, 1])


def test_d16_reference_tp_gradients(jobs):
    """D16: from the reference's yi-6b init, the reference's 1x2 step (its
    1x1 parameters cut) has the port's 1x2 loss (rtol 1e-6), but its
    TP-sharded leaves move T = 2 times the port's update (rtol 1e-4) and its
    replicated leaves (the norm scales, under sequence parallelism) move
    otherwise; the port's 1x2 step is the reference's 1x1 step (rtol 1e-5
    of each leaf's largest update).  ``grad_sq_shard_sum`` is its
    definition over the port's gradients: every TP-sharded leaf once, every
    replicated one once a model rank."""
    ref, arrays = jobs["wait_reference"]()
    port = jobs["wait"](2)["reference params"]
    got = dict(np.load(os.path.join(jobs["tmp"], "yi-6b-1x2-ref.npz")))
    whole = jobs["whole"]
    cfg = family_cfg("yi-6b")
    axes = AxisCtx(batch_axes=("data",), model_axis="model", sizes=(("data", 1), ("model", 2)),
                   model_transport=_Group(2))
    specs = tree_param_specs(whole, cfg, axes, 1, attn_dims(cfg, 2).kv_sharded)
    sharded = {p for p, s in specs.items() if "model" in s}
    T, LR = 2, TRAIN_TP["LR"]
    np.testing.assert_allclose(port["loss"], ref["1x2 32"]["loss"], rtol=1e-6)
    np.testing.assert_allclose(port["loss"], ref["1x1 32"]["loss"], rtol=1e-6)
    differ = set()
    gnorm = 0.0
    for p, w0 in whole.items():
        w0 = w0.numpy()
        upd = got[p] - w0
        ref1, ref2 = arrays[f"1x1:{p}"] - w0, arrays[f"1x2:{p}"] - w0
        scale = float(np.abs(ref1).max())
        assert np.abs(upd - ref1).max() <= 1e-5 * scale, p
        g = upd.astype(np.float64) / LR
        gnorm += float((g * g).sum()) * (1 if p in sharded else T)
        if p in sharded:
            assert np.abs(ref2 - T * upd).max() <= 1e-4 * T * scale, p
        elif np.abs(ref2 - upd).max() > 1e-3 * scale:
            differ.add(p)
            assert np.abs(ref2 - T * upd).max() > 1e-3 * scale, p
    assert differ == {"blocks/ln1", "blocks/ln2", "final_norm"}, differ
    assert sharded and not sharded & differ
    np.testing.assert_allclose(port["gnorm"], gnorm, rtol=1e-4)


def test_1x2_checkpoint_resumes_and_loads_at_1x1(jobs, tmp_path):
    """A 1x2 ``train`` run checkpointing every round: the run resumed from
    its round-2 checkpoint ends bit-equal to the uninterrupted run (losses
    and the joined parameters); the checkpoint holds the whole ``tp = 1``
    model, which a one-process 1x1 session loads and trains on from round 2
    to the 1x2 run's loss."""
    res = jobs["wait"](2)["ckpt"]
    assert res["first"] == res["losses"][:2] and res["resumed"] == res["losses"][2:]
    assert res["resumed_equal"]
    ckpt = str(tmp_path / "ckpt")
    shutil.copytree(os.path.join(jobs["tmp"], "ckpt"), ckpt)
    sess = Session(RunSpec("yi-6b", workload="train", mesh="1x1", smoke=True, batch=2, seq=32,
                           rounds=3, precision=PrecisionPolicy.uniform(32, comm=32),
                           options={"quiet": True, "ckpt_dir": ckpt}), device="cpu")
    params = sess.init_params()
    state, manifest = load_checkpoint(ckpt, {"p": params}, step=2)
    assert manifest["step"] == 2
    at2 = dict(np.load(os.path.join(jobs["tmp"], "ckpt-run-2.npz")))
    for p, w in params.items():
        assert tuple(state["p"][p].shape) == tuple(w.shape), p
        np.testing.assert_array_equal(state["p"][p].numpy(), at2[p], err_msg=p)
    hist = sess.run_train()
    assert [h["round"] for h in hist] == [2]
    assert abs(hist[0]["loss"] - res["losses"][2]) <= 1e-5, (hist, res["losses"])
    at3 = dict(np.load(os.path.join(jobs["tmp"], "ckpt-run-3.npz")))
    after = sess._train_state["params"]
    for p in after:
        upd_w, upd_g = at3[p] - at2[p], after[p].numpy() - at2[p]
        assert np.abs(upd_g - upd_w).max() <= UPDATE_RTOL * max(np.abs(upd_w).max(), 1e-30), p


def test_sequence_must_divide_the_model_axis():
    """Sequence parallelism cuts the residual stream into T equal blocks: a
    sequence that does not divide raises before any collective is sent."""
    cfg = family_cfg("yi-6b")
    model = build_model(cfg)
    axes = AxisCtx(batch_axes=("data",), model_axis="model", fsdp_axes=("data",),
                   sizes=(("data", 1), ("model", 2)), model_transport=_Group(2))
    from repro_torch.models.common import ParamCtx

    pc = ParamCtx(ctx=axes, compute_dtype=torch.float32, sp=True)
    params = model.init(torch.Generator().manual_seed(0), 2)
    tokens = torch.zeros((1, 31), dtype=torch.int32)
    with pytest.raises(ValueError, match="does not divide over 2 model ranks"):
        model.train_loss(pc, params, {"tokens": tokens, "labels": tokens})


def test_the_pod_dry_run_traces_a_model_axis():
    """Training and serving run on a model axis above 1, and so does the dry
    run of such a mesh (item 14): one traced device, no process group."""
    spec = RunSpec("yi-6b", workload="dryrun", mesh="1x2", options={"shape": "decode_32k"})
    d = Session(spec, device="cpu").run()
    assert d["status"] == "ok" and d["n_devices"] == 2
    assert not torch.distributed.is_initialized()


class _Group:
    """A model group's size and rank for an axis context built in one
    process (nothing is sent)."""

    def __init__(self, size: int, rank: int = 0):
        self.size, self.rank = size, rank

