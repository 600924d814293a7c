"""The port's dry run on meshes with a model axis (the reference's pod
meshes): one traced device of the mesh, its model group a stand-in
(``dist/collectives.TraceTransport``), on the CPU.

* yi-6b's smoke train, prefill and decode cells on ``1x2``, live against the
  reference's ``run_dryrun`` (one subprocess with forced host devices,
  started at the module's first test): per-device dot FLOPs and bytes equal
  up to D3 (the xent chunk's recomputed logits, at the shard's vocabulary),
  bytes per collective kind equal up to D16-D18 (ROADMAP §3), each computed
  from the cell here;
* the other families' cells on ``1x2`` and a train cell each on ``2x2`` and
  ``2x1x2`` against ``tests/fixtures/roofline_pod_reference.json``
  (``tests/roofline_pod_reference.py``; its cheapest entry rerun live, bit
  for bit), up to D3, D4 (the SSD scan's einsums) and D16-D18;
* yi-6b's full-width ``decode_32k`` on ``16x16`` against its committed row
  in ``results/sweep_roofline-all-archs.jsonl``: 256 devices, every figure
  equal;
* a traced train step runs one client, the device's, at share 1: at ``2x1``
  and ``4x1`` its record is the loop's over the D clients at ``1 / D`` each,
  and its dots do not grow with D;
* the CLI (``python -m repro_torch dryrun``): a pod cell, the reference's row schema;
* no trace starts a process group.
"""

import json
import os
import subprocess
import sys
from collections import Counter

import pytest
import torch

from repro_torch.api import PrecisionPolicy, RunSpec, Session
from repro_torch.configs.base import ShapeSpec
from repro_torch.dist.sharding import model_summed_leaves
from repro_torch.launch import steps
from repro_torch.launch.mesh import trace_axis_ctx
from repro_torch.roofline.analysis import analyze_trace, model_flops
from roofline_pod_reference import CHEAPEST, ENTRIES, FIXTURE
from roofline_reference import CELLS, NAMED

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))
#: D4 on a model axis of 2, the port's ``_ssd_scan`` less the reference's
#: (dot FLOPs, bf16-equivalent bytes) at the smoke cells: half the heads of
#: the 1x1 figures in train, and the prefill's bytes
POD_SSD_DELTA = {"train": (-24576.0, -56832.0), "prefill": (0.0, -6144.0), "decode": (0.0, 0.0)}
#: the xent's model all-reduces a chunk: the port's 3 in the forward and 3
#: in the recompute; the reference's 3, its recompute's pmax and psum, and
#: its two psums' transposes (D17; 5 at one chunk, where XLA merges the
#: recompute, D3)
PORT_XENT, REF_XENT, REF_XENT_ONE_CHUNK = 6, 7, 5
XENT_CHUNK = 512

_REFERENCE = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, %(tests)r)
import repro  # the jax shims before any mesh API
from roofline_pod_reference import CHEAPEST, entry
from roofline_reference import reference_cell
out = {kind: reference_cell("yi-6b", kind, "1x2") for kind in ("train", "prefill", "decode")}
out[CHEAPEST] = entry(CHEAPEST)
print("RESULT " + json.dumps(out))
""" % {"tests": TESTS}


@pytest.fixture(scope="module")
def reference():
    """The reference's yi-6b 1x2 cells and its rerun of the fixture's
    cheapest entry, in one subprocess started with the module."""
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
                                 "JAX_PLATFORMS": "cpu"})
    done = {}

    def wait():
        if "out" not in done:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, out[-3000:] + err[-3000:]
            done["out"] = json.loads(out.split("RESULT ", 1)[1])
        return done["out"]

    yield wait
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(autouse=True, scope="module")
def _start_reference(reference):
    """Starts the reference's subprocess at the module's first test, so its
    compiles overlap the tests before the ones that wait for it."""
    yield


def port_cell(arch: str, kind: str, mesh: str, batch: int, precision=None) -> dict:
    """The port's report of a smoke cell (``roofline_reference.CELLS``'
    sequence) on ``mesh``, with ``named``, its dots in ROADMAP §3's named
    functions."""
    _k, seq, _b = CELLS[kind]
    sess = Session(RunSpec(arch=arch, workload="dryrun", mesh=mesh, smoke=True,
                           precision=precision or PrecisionPolicy()), device="cpu")
    cell = ShapeSpec(f"smoke_{kind}", seq, batch, kind)
    rec, meta = sess.trace(cell)
    rep = analyze_trace(rec, arch=arch, shape=cell.name, mesh_name=mesh,
                        n_devices=meta["n_devices"],
                        model_flops_global=model_flops(sess.cfg, kind, seq, batch)).to_dict()
    rep["named"] = {p: [sum(v[i] for site, v in rep["by_site"].items() if site.startswith(p))
                        for i in (0, 1)] for p in NAMED}
    rep["cfg"], rep["seq"] = sess.cfg, seq
    return rep


def _ring(n: int) -> float:
    return 2 * (n - 1) / n


def allreduce_divergence(cfg, kind: str, mesh: str, batch: int, seq: int) -> float:
    """The port's all-reduce wire bytes (raw) less the reference's in a
    train cell: D16, the one all-reduce of the replicated leaves' rank parts
    over the model group; D17, the xent's model all-reduces; D18, the grad
    norm's sum over the batch group then the model group where the
    reference sums once over the D·T devices."""
    axes = trace_axis_ctx(mesh)
    D, T = axes.dp, axes.tp
    if kind != "train" or T == 1:
        return 0.0
    from repro_torch.models.model import build_model

    params = build_model(cfg).init(torch.Generator().manual_seed(0), T, device="meta")
    parts = sum(params[p].numel() for p in model_summed_leaves(params, cfg, axes,
                                                               cfg.seq_parallel))
    c = min(XENT_CHUNK, seq)
    chunks = seq // c
    ref_xent = REF_XENT_ONE_CHUNK if chunks == 1 else REF_XENT * chunks
    xent = (PORT_XENT * chunks - ref_xent) * (batch // D) * c
    return 4 * (parts + xent) * _ring(T) + 4 * (_ring(D) + _ring(T) - _ring(D * T))


def encoder_scatter_divergence(cfg, kind: str, mesh: str, batch: int, seq: int) -> float:
    """D16's enc-dec input: the reference reduce-scatters the replicated
    encoder input (T equal copies summed) where the port cuts the rank's
    block; the port's reduce-scatter wire bytes (raw) less the reference's."""
    axes = trace_axis_ctx(mesh)
    if cfg.family != "encdec" or axes.tp == 1 or kind == "decode":
        return 0.0
    result = (batch // axes.dp) * seq * cfg.d_model // axes.tp
    return -4.0 * (axes.tp - 1) * result


def assert_pod_matches(got: dict, want: dict, arch: str, kind: str, mesh: str, batch: int):
    """``got`` (the port's report) equals ``want`` (the reference's) once
    the named divergences are taken out, and they are exactly D3, D4 and
    D16-D18."""
    from repro_torch.models.transformer import padded_vocab_local

    cfg, seq = got["cfg"], got["seq"]
    T = trace_axis_ctx(mesh).tp
    mine, theirs = got["named"], want["by_function"]
    rest = lambda d, parts, i: d - sum(v[i] for v in parts.values())  # noqa: E731
    assert rest(got["flops_per_device"], mine, 0) == rest(want["flops_per_device"], theirs, 0)
    assert rest(got["bytes_per_device"], mine, 1) == rest(want["bytes_per_device"], theirs, 1)
    if kind == "train" and seq <= XENT_CHUNK:     # D3 at the shard's vocabulary
        n, d, v = batch // trace_axis_ctx(mesh).dp * seq, cfg.d_model, padded_vocab_local(cfg, T)
        xf, xb = 2.0 * n * d * v, 2.0 * (n * d + d * v + n * v)
    else:
        xf = xb = 0.0
    assert mine["fused_vocab_xent"][0] - theirs["fused_vocab_xent"][0] == xf
    assert mine["fused_vocab_xent"][1] - theirs["fused_vocab_xent"][1] == xb
    sf, sb = POD_SSD_DELTA[kind] if cfg.family in ("ssm", "hybrid") else (0.0, 0.0)
    assert mine["_ssd_scan"][0] - theirs["_ssd_scan"][0] == sf
    assert mine["_ssd_scan"][1] - theirs["_ssd_scan"][1] == sb
    assert got["model_flops_global"] == want["model_flops_global"]
    assert got["useful_flops_ratio"] == want["model_flops_global"] / (
        got["flops_per_device"] * got["n_devices"])
    kinds = set(got["collective_breakdown"]["bytes"]) | set(want["collective_breakdown"]["bytes"])
    delta = {k: got["collective_breakdown"]["bytes"].get(k, 0.0)
             - want["collective_breakdown"]["bytes"].get(k, 0.0) for k in kinds}
    # the divergences are all f32: bf16-equivalent bytes are half the raw
    assert delta.pop("all-reduce", 0.0) == allreduce_divergence(cfg, kind, mesh, batch, seq) / 2
    assert delta.pop("reduce-scatter", 0.0) == encoder_scatter_divergence(cfg, kind, mesh,
                                                                          batch, seq) / 2
    assert delta == {k: 0.0 for k in delta}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_yi6b_1x2_cells_match_the_live_reference(reference, kind):
    got = port_cell("yi-6b", kind, "1x2", 2)
    assert got["n_devices"] == 2
    assert_pod_matches(got, reference()[kind], "yi-6b", kind, "1x2", 2)


with open(FIXTURE) as _f:
    _FIXTURE = json.load(_f)


@pytest.mark.parametrize("key", sorted(_FIXTURE))
def test_families_match_the_reference_fixture(key):
    arch, kind, mesh, batch = ENTRIES[key]
    got = port_cell(arch, kind, mesh, batch)
    assert_pod_matches(got, _FIXTURE[key], arch, kind, mesh, batch)


def test_fixture_is_the_reference_here(reference):
    """The cheapest fixture entry, rerun with the reference, bit for bit."""
    assert reference()[CHEAPEST] == _FIXTURE[CHEAPEST]


def test_full_width_decode_on_16x16_is_the_committed_row():
    """yi-6b ``decode_32k`` on the reference's 16x16 pod: one device of 256,
    its per-device figures the committed row's, with nothing allocated and
    no process group."""
    with open(os.path.join(ROOT, "results", "sweep_roofline-all-archs.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    want = next(r["metrics"] for r in rows if r["metrics"]["arch"] == "yi-6b"
                and r["metrics"]["shape"] == "decode_32k" and r["metrics"]["mesh"] == "16x16")
    got = Session(RunSpec("yi-6b", workload="dryrun", mesh="16x16", smoke=False),
                  device="cpu").run_dryrun(shape="decode_32k", verbose=False)
    assert got["status"] == "ok" and got["n_devices"] == want["n_devices"] == 256
    # the bf16-equivalent bytes, as at 1x1 (the reference's raw figure is its
    # CPU compile's: bf16 dots run in f32 there)
    for field in ("flops_per_device", "bytes_per_device", "collective_bytes",
                  "model_flops_global", "useful_flops_ratio"):
        assert got[field] == want[field], field
    # D5: the reference's counts are XLA's combined ones; the bytes are equal
    assert got["collective_breakdown"]["bytes"] == want["collective_breakdown"]["bytes"]
    assert not torch.distributed.is_initialized()


def _summary(rec) -> dict:
    """A record per device: dots by (op, shape), kernel nodes by (kernel,
    op, shape), collectives by (kind, dtype, elements, group, name), each
    weighted by its share."""
    dots, kernels, colls = Counter(), Counter(), Counter()
    for n in rec.nodes:
        if n.kernel is None:
            dots[(n.op, n.shape, n.flops, n.bytes)] += n.share
        else:
            kernels[(n.kernel, n.op, n.shape, n.flops, n.int_ops, n.bytes)] += n.share
    for c in rec.collectives:
        colls[(c.kind, c.dtype, c.elems, c.group_size, c.name)] += c.mult
    return {"dots": dict(dots), "kernels": dict(kernels), "collectives": dict(colls)}


def _traced_step(mesh: str, policy, rows: int, one_device: bool):
    """yi-6b's smoke train step on ``mesh`` traced on fake tensors of
    ``rows`` batch rows (sequence 16), as ``Session.trace`` runs it: one
    device of the mesh (``one_device``) or the loop over its D clients."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.optim import build_optimizer
    from repro_torch.roofline import count

    sess = Session(RunSpec("yi-6b", workload="dryrun", mesh=mesh, smoke=True,
                           precision=policy), device="cpu")
    axes = trace_axis_ctx(mesh)
    with FakeTensorMode():
        meta = sess.model.init(torch.Generator().manual_seed(0), axes.tp, device="meta")
        params = {k: torch.empty(v.shape) for k, v in meta.items()}
        opt = build_optimizer("sgd", 1e-3)
        ts = steps.build_train_step(sess.model, axes, opt, sess.train_config(),
                                    one_device=one_device)
        state = opt.init(params)
        batch = {k: torch.empty(v.shape, dtype=v.dtype)
                 for k, v in sess.model.train_batch_spec(rows, 16).items()}
        delta = torch.empty(axes.dp)
        with count.recording((params, state, batch, delta), computation="train") as rec:
            ts.fn(params, state, batch, delta, steps.SRDraws(0, 0))
    return rec


@pytest.mark.parametrize("mesh,policy", [("2x1", PrecisionPolicy()),
                                         ("4x1", PrecisionPolicy(weights=8, comm=8))])
def test_one_client_trace_is_the_loops_record(mesh, policy):
    """The traced device runs its own client (2 batch rows) at share 1; the
    loop over the D clients of the global batch at ``1 / D`` each records
    the same dots, K1/K2 nodes and collectives, and so does
    ``Session.trace``; the bound of the step on the port's one card (which
    runs the loop) is the loop's: the device's client counts D times."""
    from repro_torch.roofline.analysis import _card_bound_s
    from repro_torch.roofline.hw import H100_SXM

    D = trace_axis_ctx(mesh).dp
    one_rec = _traced_step(mesh, policy, 2, one_device=True)
    one = _summary(one_rec)
    sess = Session(RunSpec("yi-6b", workload="dryrun", mesh=mesh, smoke=True,
                           precision=policy), device="cpu")
    cell = ShapeSpec("smoke_train", 16, 2 * D, "train")
    assert _summary(sess.trace(cell)[0]) == one
    loop_rec = _traced_step(mesh, policy, 2 * D, one_device=False)
    loop = _summary(loop_rec)
    for part in ("dots", "kernels", "collectives"):
        assert one[part].keys() == loop[part].keys(), part
        for k, v in one[part].items():
            assert v == pytest.approx(loop[part][k], rel=1e-12), (part, k)
    if policy.comm < 32:
        assert [n.op for n in loop_rec.nodes if n.kernel == "K2"] == ["sr_pack_keyed"]
    card = _card_bound_s(loop_rec, H100_SXM)
    assert _card_bound_s(one_rec, H100_SXM) == pytest.approx(card, rel=1e-12)
    assert sess.run_dryrun(shape=cell, verbose=False)["card_bound_s"] == \
        pytest.approx(card, rel=1e-12)
    # the device's client stands for the loop's D, each once
    assert {n.copies for n in one_rec.nodes if n.op == "aten.mm"} == {D}
    assert {n.copies for n in loop_rec.nodes if n.op == "aten.mm"} == {1}


def test_a_traced_train_step_runs_one_client():
    """The dots a traced device dispatches do not grow with the clients."""
    def n_dots(mesh):
        D = trace_axis_ctx(mesh).dp
        sess = Session(RunSpec("yi-6b", workload="dryrun", mesh=mesh, smoke=True), device="cpu")
        rec, meta = sess.trace(ShapeSpec("smoke_train", 16, 2 * D, "train"))
        return len([n for n in rec.nodes if n.kernel is None]), meta["n_devices"]

    assert n_dots("8x1") == (n_dots("1x1")[0], 8)
    assert n_dots("8x2")[1] == 16 and n_dots("2x8x2")[1] == 32


def test_the_cli_runs_a_pod_cell(tmp_path, capsys):
    from repro_torch.__main__ import main

    out = tmp_path / "rows.json"
    rc = main(["dryrun", "--device", "cpu", "--arch", "mamba2-780m", "--shape", "decode_32k",
               "--mesh", "single", "--out", str(out)])
    assert rc == 0 and "1/1 cells OK" in capsys.readouterr().out
    rows = json.loads(out.read_text())
    assert [(r["arch"], r["shape"], r["mesh"], r["status"], r["n_devices"]) for r in rows] == \
        [("mamba2-780m", "decode_32k", "16x16", "ok", 256)]
    with open(os.path.join(ROOT, "results", "sweep_roofline-all-archs.jsonl")) as f:
        ref_keys = set(json.loads(f.readline())["metrics"])
    assert ref_keys - {"cost_analysis_flops"} <= set(rows[0])
    assert not torch.distributed.is_initialized()


def test_the_stand_in_group_takes_traced_tensors_only():
    """A real step through the stand-in model group raises, rather than
    returning the rank's own values as the group's sum."""
    from repro_torch.dist.collectives import TraceTransport

    group = TraceTransport(4)
    for call in (group.all_reduce, group.all_gather, group.reduce_scatter):
        with pytest.raises(RuntimeError, match="traced"):
            call(torch.ones(8))
    assert group.issued == {}
    with pytest.raises(RuntimeError, match="traced"):
        trace_axis_ctx("1x4").psum_model(torch.ones(2))
