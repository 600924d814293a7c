"""The port's roofline (``repro_torch/roofline``) and dry run
(``Session.run_dryrun``) against the reference's (``repro/roofline``,
``repro.api.Session.run_dryrun``), on the CPU.

* yi-6b's smoke train, prefill and decode cells at ``1x1``, live: the dot
  FLOPs, bf16-equivalent dot bytes, model FLOPs and useful ratio equal the
  reference's, the collective bytes are 0 and the dominant term is the same
  under the reference's ``TPU_V5E``;
* the other families' train and decode cells against
  ``tests/fixtures/roofline_reference.json`` (``tests/roofline_reference.py``;
  one live rerun pins it);
* yi-6b train at ``2x1`` and ``4x1``: collective bytes per kind equal the
  reference's, run in one subprocess with forced host devices;
* the two named differences (ROADMAP §3): D3, the xent chunk's logits that
  XLA merges with their recomputation at one chunk, and D4, the SSD scan's
  three-operand einsums; nothing else differs;
* the kernel cost functions against ``PERF.md`` §6's bound column, the trace
  route on fake and real tensors, ``model_flops`` for every arch and shape,
  and a full-width cell traced with nothing allocated.
"""

import json
import os
import subprocess
import sys

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ARCH_NAMES as J_ARCH_NAMES
from repro.configs import get_config as j_get_config
from repro.configs import shapes_for as j_shapes_for
from repro.roofline.analysis import model_flops as j_model_flops
from repro.roofline.hw import TPU_V5E
from repro_torch.api import PrecisionPolicy, RunSpec, Session
from repro_torch.configs import get_config, shapes_for
from repro_torch.configs.base import ShapeSpec
from repro_torch.kernels import ops
from repro_torch.kernels._build import LAUNCHES
from repro_torch.roofline import H100_SXM, count
from repro_torch.roofline.analysis import analyze_trace, model_flops
from roofline_reference import CELLS, FIXTURE, NAMED, reference_cell

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"2x1": dict(comm=32, batch=2), "4x1": dict(weights=8, comm=8, batch=4)}


def port_cell(arch, kind, mesh="1x1", precision=None, seq_len=None, batch=None,
              options=None) -> dict:
    """The port's report of a smoke cell on the H100 (what ``run_dryrun``
    gives, less its wall time), with the same trace's report on the
    reference's chip under ``on_v5e``."""
    k, s, b = CELLS[kind]
    spec = RunSpec(arch=arch, workload="dryrun", mesh=mesh, smoke=True,
                   precision=precision or PrecisionPolicy(), options=options or {})
    sess = Session(spec, device="cpu")
    cell = ShapeSpec(f"smoke_{kind}", seq_len or s, batch or b, k)
    rec, meta = sess.trace(cell)
    rep = analyze_trace(rec, arch=arch, shape=cell.name, mesh_name=mesh,
                        n_devices=meta["n_devices"],
                        model_flops_global=model_flops(sess.cfg, k, cell.seq_len,
                                                       cell.global_batch))
    return {**rep.to_dict(), **meta, "on_v5e": analyze_trace(
        rec, arch=arch, shape=cell.name, mesh_name=mesh, n_devices=meta["n_devices"],
        model_flops_global=rep.model_flops_global, chip=TPU_V5E).to_dict()}


def named(by_site: dict) -> dict:
    """The port's dot FLOPs and bf16 bytes by the named functions."""
    out = {p: [0.0, 0.0] for p in NAMED}
    for site, (flops, nbytes) in by_site.items():
        for p in NAMED:
            if site.startswith(p):
                out[p][0] += flops
                out[p][1] += nbytes
    return out


def xent_recompute(cfg, batch: int, seq: int) -> tuple[float, float]:
    """D3: one logits dot (x (B*S, D) @ w (D, V)), FLOPs and bf16 bytes."""
    from repro_torch.models.transformer import padded_vocab_local

    n, d, v = batch * seq, cfg.d_model, padded_vocab_local(cfg, 1)
    return 2.0 * n * d * v, 2.0 * (n * d + d * v + n * v)


#: D4 at the smoke cells (batch 2, sequence 16; H 8, P 16, N 16, Q 8, two
#: SSD layers): the port's ``_ssd_scan`` less the reference's, dot FLOPs and
#: bf16 bytes.  The reference's three-operand einsums (``Sc``, ``y_inter``)
#: make their decay factor a dot_general whose transposes are dots
#: contracting P or N (three more per layer); the port multiplies by the
#: factor and sums, and contracts in another order.
SSD_DELTA = {"mamba2-780m": (-49152.0, -115712.0),
             "jamba-1.5-large-398b": (-49152.0, -115712.0)}


def assert_matches(got: dict, want: dict, arch: str, kind: str, cfg, batch=2, seq=16):
    """``got`` (the port's report) equals ``want`` (the reference's) once
    the named differences are taken out, and they are exactly D3 and D4."""
    mine = named(got["by_site"])
    theirs = want["by_function"]
    rest = lambda d, parts, i: d - sum(v[i] for v in parts.values())  # noqa: E731
    assert rest(got["flops_per_device"], mine, 0) == rest(want["flops_per_device"], theirs, 0)
    assert rest(got["bytes_per_device"], mine, 1) == rest(want["bytes_per_device"], theirs, 1)
    xf, xb = (xent_recompute(cfg, batch, seq) if kind == "train" else (0.0, 0.0))
    assert mine["fused_vocab_xent"][0] - theirs["fused_vocab_xent"][0] == xf
    assert mine["fused_vocab_xent"][1] - theirs["fused_vocab_xent"][1] == xb
    sf, sb = SSD_DELTA.get(arch, (0.0, 0.0)) if kind == "train" else (0.0, 0.0)
    assert mine["_ssd_scan"][0] - theirs["_ssd_scan"][0] == sf
    assert mine["_ssd_scan"][1] - theirs["_ssd_scan"][1] == sb
    assert got["model_flops_global"] == want["model_flops_global"]
    assert got["useful_flops_ratio"] == want["model_flops_global"] / got["flops_per_device"]
    if not (xf or sf):
        assert got["flops_per_device"] == want["flops_per_device"]
        assert got["bytes_per_device"] == want["bytes_per_device"]
        assert got["useful_flops_ratio"] == want["useful_flops_ratio"]
    assert got["collective_bytes"] == want["collective_bytes"] == 0.0


# ---------------------------------------------------------------------------
# The reference at 2x1 and 4x1, one subprocess started with the module
# ---------------------------------------------------------------------------

_REFERENCE = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, %(tests)r)
import repro  # the jax shims before any mesh API
from repro.api import PrecisionPolicy
from roofline_reference import reference_cell
out = {}
for mesh, kw in %(meshes)r.items():
    kw = dict(kw)
    b = kw.pop("batch")
    out[mesh] = reference_cell("yi-6b", "train", mesh, PrecisionPolicy(**kw), batch=b)
print("RESULT " + json.dumps(out))
""" % {"tests": os.path.dirname(os.path.abspath(__file__)), "meshes": MESHES}


@pytest.fixture(autouse=True, scope="module")
def _reference_meshes():
    """Started when the module's first test starts, so that its compiles
    overlap the tests before the one that waits for it."""
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
                                 "JAX_PLATFORMS": "cpu"})
    yield proc
    proc.kill()
    proc.communicate()


# ---------------------------------------------------------------------------
# 1x1: yi-6b live, the other families from the fixture
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_yi6b_smoke_cells_match_the_reference(kind):
    want = reference_cell("yi-6b", kind)
    got = port_cell("yi-6b", kind)
    cfg = Session(RunSpec("yi-6b", workload="dryrun"), device="cpu").cfg
    assert_matches(got, want, "yi-6b", kind, cfg)
    assert got["collective_breakdown"]["bytes"].get("all-reduce", 0.0) == 0.0
    v5e = got["on_v5e"]
    assert v5e["dominant"] == want["dominant"]
    for term in ("compute_s", "memory_s"):      # the reference's convention on its chip
        if kind != "train":
            assert v5e[term] == pytest.approx(want[term], rel=1e-12)


with open(FIXTURE) as _f:
    _FIXTURE = json.load(_f)


@pytest.mark.parametrize("key", sorted(_FIXTURE))
def test_families_match_the_reference_fixture(key):
    arch, kind = key.split("|")
    want = _FIXTURE[key]
    got = port_cell(arch, kind)
    assert_matches(got, want, arch, kind, Session(RunSpec(arch), device="cpu").cfg)
    assert got["on_v5e"]["dominant"] == want["dominant"]


def test_fixture_is_the_reference_here():
    """The cheapest fixture entry, rerun with the reference, bit for bit."""
    assert reference_cell("mamba2-780m", "decode") == _FIXTURE["mamba2-780m|decode"]


def test_xent_recompute_counts_alike_past_one_chunk():
    """D3 is XLA merging the one chunk's recomputed logits with the forward
    ones: at two chunks (S 1024) both packages count the recomputation."""
    want = reference_cell("yi-6b", "train", seq_len=1024, batch=1)
    got = port_cell("yi-6b", "train", seq_len=1024, batch=1)
    assert got["flops_per_device"] == want["flops_per_device"]
    assert got["bytes_per_device"] == want["bytes_per_device"]
    assert named(got["by_site"])["fused_vocab_xent"] == want["by_function"]["fused_vocab_xent"]


# ---------------------------------------------------------------------------
# Dx1: collectives per device
# ---------------------------------------------------------------------------


def test_collective_bytes_per_kind_match_at_2x1_and_4x1(_reference_meshes):
    out, err = _reference_meshes.communicate(timeout=600)
    assert _reference_meshes.returncode == 0, out[-3000:] + err[-3000:]
    ref = json.loads(out.split("RESULT ", 1)[1])
    cfg = Session(RunSpec("yi-6b"), device="cpu").cfg
    for mesh, kw in MESHES.items():
        kw = dict(kw)
        b = kw.pop("batch")
        got = port_cell("yi-6b", "train", mesh, PrecisionPolicy(**kw), batch=b)
        want = ref[mesh]
        assert got["collective_breakdown"]["bytes"] == want["collective_breakdown"]["bytes"]
        assert got["collective_bytes"] == want["collective_bytes"]
        # per device: one client's share (local batch b / D), D3 aside
        xf = xent_recompute(cfg, b // int(mesh[0]), 16)[0]
        assert got["flops_per_device"] - want["flops_per_device"] == xf
        assert (named(got["by_site"])["fused_vocab_xent"][0]
                - want["by_function"]["fused_vocab_xent"][0]) == xf
        assert got["dominant"] == "collective" and want["dominant"] == "collective"
    # D5: XLA combines the all-reduces (12 at 4x1); the port records each one
    # the reference's program issues before combining (32)
    assert want["collective_breakdown"]["counts"]["all-reduce"] == 12
    assert got["collective_breakdown"]["counts"]["all-reduce"] == 32


def test_wire_and_host_read_are_recorded():
    """The 4x1 comm-8 step: one K2 call counted at 1/4 a device (its row of
    the wire), the K1 inline calls of the device's own client at share 1,
    and the wire's one host read with its call site."""
    got = port_cell("yi-6b", "train", "4x1", PrecisionPolicy(weights=8, comm=8), batch=4)
    assert got["kernels"]["K2"]["calls"] == 1 and got["kernels"]["K2"]["per_device"] == 0.25
    k1 = got["kernels"]["K1"]
    assert k1["per_device"] == k1["calls"] > 0
    assert [h["what"] for h in got["host_reads"]] == ["the wire's non-finite count"]
    assert "dist/collectives.py" in got["host_reads"][0]["site"]
    assert got["bound_s"] == pytest.approx(
        max(got["compute_s"], got["memory_s"], got["collective_s"]) + got["kernel_s"])


def test_gather_bf16_halves_the_raw_gather_bytes():
    """The ``gather_bf16`` variant casts the FSDP leaves before their gather:
    the raw all-gather and reduce-scatter bytes halve, the bf16-equivalent
    ones stay."""
    plain = port_cell("yi-6b", "train", "2x1", batch=2)
    bf16 = port_cell("yi-6b", "train", "2x1", batch=2,
                     options={"variant": {"gather_bf16": True}})
    gathers = plain["collective_breakdown"]["bytes"]
    halved = gathers["all-gather"] + gathers["reduce-scatter"]     # bf16-equivalent = raw / 2
    assert bf16["collective_bytes_raw"] == plain["collective_bytes_raw"] - halved
    assert bf16["collective_breakdown"] == plain["collective_breakdown"]


def test_pod_meshes_trace_one_device():
    """A pod mesh's dry run (item 14) traces one device of it: a decode cell
    on 2x16x16 prices one device of 512 with its model group's all-reduces,
    and the session's own axes still need a process group for T > 1."""
    spec = RunSpec("yi-6b", workload="dryrun", mesh="2x16x16", smoke=False,
                   options={"shape": "decode_32k"})
    sess = Session(spec, device="cpu")
    d = sess.run()
    assert d["status"] == "ok" and d["n_devices"] == 512
    assert d["collective_breakdown"]["bytes"]["all-reduce"] > 0
    with pytest.raises(ValueError, match="torchrun"):
        sess.axes


def test_sweep_runs_a_dx1_dryrun_cell():
    from repro_torch.sweep.report import roofline_row
    from repro_torch.sweep.runner import execute_cell

    spec = RunSpec("yi-6b", workload="dryrun", mesh="2x1", smoke=True,
                   options={"shape": "decode_32k"})
    m = execute_cell(spec, "cpu")
    assert m["status"] == "ok" and m["kind"] == "decode"
    row = roofline_row({"spec": spec.to_dict(), "metrics": m})
    assert row["dominant"] == m["dominant"]
    json.dumps(m)


# ---------------------------------------------------------------------------
# Other cases
# ---------------------------------------------------------------------------


def test_model_flops_equal_for_every_arch_and_shape():
    for arch in J_ARCH_NAMES:
        jcfg, cfg = j_get_config(arch), get_config(arch)
        cells = [(s.kind, s.seq_len, s.global_batch) for s in shapes_for(cfg)]
        assert cells == [(s.kind, s.seq_len, s.global_batch) for s in j_shapes_for(jcfg)]
        for kind, seq, batch in cells + [("prefill", 4096, 8)]:
            assert model_flops(cfg, kind, seq, batch) == j_model_flops(jcfg, kind, seq, batch)


def _kernel_calls(dev, fake=False):
    """Every ``kernels/ops`` entry on tensors of ``dev`` (``fake``: empty
    tensors made under ``FakeTensorMode``)."""
    g = torch.Generator().manual_seed(0)

    def t(shape, dtype=torch.float32, values=None):
        if fake:
            return torch.empty(shape, dtype=dtype, device=dev)
        if values is not None:
            return torch.tensor(values, dtype=dtype)
        if dtype == torch.int8:
            return torch.randint(-7, 8, shape, generator=g).to(dtype)
        return torch.rand(shape, generator=g).to(dtype)

    x, codes, q = t((4, 64)), t((64, 32), torch.int8), t((2, 2, 16, 16))
    pages = t((8, 4, 2, 16))
    pt = t((2, 3), torch.int32, [[0, 1, -1], [2, 3, 4]])
    lengths = t((2,), torch.int32, [6, 11])
    w, w1, u = t((3, 8)), t((1, 8)), t((2, 24))
    delta, delta1 = t((2,), values=[0.1, 0.2]), t((1,), values=[0.1])
    offsets = t((3,), torch.int32, [0, 10, 24])
    return [
        ops.quant_matmul(x, codes, t((), values=0.01)),
        ops.flash_attention(q, q, q, causal=True),
        *ops.flash_paged_decode(t((2, 2, 4, 16)), pages, pages, pt, lengths),
        ops.sr_quantize_inline(w, delta1, 7, torch.bfloat16),
        ops.sr_quantize_segments(t((24,)), offsets, t((2,), values=[1.0, 1.0]), delta, u),
        ops.sr_quantize_segments_keyed([w, w1], delta, 7),
        ops.sr_pack_segments(u, offsets, t((2,), values=[0.1, 0.1]), u, 7, torch.int8),
        *ops.sr_pack_keyed([[w, w], [w1, w1]], 7, 7, torch.int8),
        *ops.sr_pack_keyed_scales([[w], [w1]]),
        *ops.sr_pack_keyed_scaled([[w], [w1]], t((2,), values=[0.5, 0.5]),
                                  t((1, 2), values=[[0.5, 0.5]]), 7, 7, torch.int16, c0=1),
    ]


def test_real_tensor_calls_take_no_trace_route():
    """Inside a recording, real-tensor calls run the plain versions: no
    kernel node, no launch."""
    before = dict(LAUNCHES)
    with count.recording() as rec:
        outs = _kernel_calls("cpu")
    assert not [n for n in rec.nodes if n.kernel] and dict(LAUNCHES) == before
    assert all(not count.is_traced(o) for o in outs)


def test_trace_route_records_each_kernel_alike_on_fake_cpu_and_cuda():
    """The trace route on fake tensors: every entry's outputs have the plain
    versions' shapes and dtypes, one node a kernel call, and the record does
    not depend on the fake device."""
    want = _kernel_calls("cpu")
    records = []
    for dev in ("cpu", "cuda"):
        with FakeTensorMode(), count.recording(computation="ops", decode_len=8) as rec:
            got = _kernel_calls(dev, fake=True)
        assert [(o.shape, o.dtype) for o in got] == [(o.shape, o.dtype) for o in want]
        records.append([(n.op, n.kernel, n.flops, n.int_ops, n.bytes, n.shape)
                        for n in rec.nodes if n.kernel])
    assert records[0] == records[1]
    assert [k for _op, k, *_ in records[0]] == ["K3", "K4", "K5", "K1", "K1", "K1", "K2", "K2",
                                                "K2", "K2"]


def test_full_width_cell_traces_with_nothing_allocated():
    """yi-6b's decode_32k at full width (6 B parameters, a 137 GB cache) on
    1x1: the trace's high-water mark is the cell's, the process's memory
    does not grow by it."""
    def rss() -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    before = rss()
    d = Session(RunSpec("yi-6b", workload="dryrun", smoke=False),
                device="cpu").run_dryrun(shape="decode_32k", verbose=False)
    assert d["status"] == "ok" and d["n_devices"] == 1
    assert d["memory_stats"]["peak_estimate"] > 100e9
    assert rss() - before < 1e9
    assert d["flops_per_device"] > 0 and d["model_flops_global"] > 0


#: PERF.md §6's bound column (ms on H100_SXM) at the rows' shapes
PERF_BOUNDS = [
    ("K1 inline 4096x11008", count.sr_quant_inline_cost(4096 * 11008, torch.bfloat16),
     0.0808, "bytes"),
    ("K2 keyed 4 x 69,632 int16", count.sr_pack_keyed_cost(69632, 4, 3, torch.int16),
     0.00050, "bytes"),
    ("K3 decode M 4", count.quant_matmul_cost(4, 4096, 11008, torch.bfloat16, torch.int8),
     0.0135, "bytes"),
    ("K3 prefill M 512",
     count.quant_matmul_cost(512, 4096, 11008, torch.bfloat16, torch.int8), 0.0467,
     "operations"),
    ("K4 bf16 BH 128 S 128 D 128",
     count.flash_attention_cost(128, 128, 128, torch.bfloat16, True), 0.0050, "bytes"),
    ("K5 yi-6b decode",
     count.flash_decode_cost(4, 4, 8, 128, torch.bfloat16, torch.float32, 16, 397),
     0.00052, "bytes"),
    ("K1 keyed mobilenet round 8 x 976", count.sr_quant_keyed_cost(976, 8), 0.0000105,
     "bytes"),
    ("K2 keyed wide int8", count.sr_pack_keyed_cost(4096 * 11008, 4, 1, torch.int8),
     0.2692, "bytes"),
    ("K4 f32 S 513 non-causal", count.flash_attention_cost(128, 513, 128, torch.float32,
                                                            False), 0.0401, "bytes"),
    ("K2 pass 1, a rank's wire row", count.sr_pack_keyed_scales_cost(69632, 1, 3),
     0.000083, "bytes"),
    ("K2 pass 2, a rank's wire row", count.sr_pack_keyed_scaled_cost(69632, 1, 3, torch.int16),
     0.000125, "bytes"),
    ("K2 pass 1, a rank's 4096x11008 row", count.sr_pack_keyed_scales_cost(4096 * 11008, 1, 1),
     0.0538, "bytes"),
    ("K2 pass 2, a rank's 4096x11008 row",
     count.sr_pack_keyed_scaled_cost(4096 * 11008, 1, 1, torch.int16), 0.0808, "bytes"),
]


@pytest.mark.parametrize("label,cost,ms,by", PERF_BOUNDS, ids=[r[0] for r in PERF_BOUNDS])
def test_kernel_costs_reproduce_the_perf_table_bounds(label, cost, ms, by):
    s, got_by = cost.bound_s(H100_SXM)
    digits = len(f"{ms:.10f}".rstrip("0").split(".")[1])
    assert round(s * 1e3, digits) == ms and got_by == by


def test_decode_tokens_follow_the_lengths():
    """K5's token count at chip_smoke's yi-6b row: slot 1's hole is skipped,
    a slot of length 0 reads nothing."""
    rows = [[0] * 16, [1, -1, 2, 3] + [-1] * 12, list(range(7)) + [-1] * 9, [5, 6] + [-1] * 14]
    assert count.decode_tokens(rows, [253, 60, 100, 0], 16) == 397


def test_analyze_trace_prices_dtypes_on_the_h100():
    """An f32 dot at the FP32 peak and bf16 one at the bf16 peak on the
    H100; the reference's chip prices both at its bf16 peak."""
    with FakeTensorMode(), count.recording() as rec:
        a32 = torch.empty(256, 512)
        a16 = a32.to(torch.bfloat16)
        a32 @ a32.T
        a16 @ a16.T
    kw = dict(arch="x", shape="y", mesh_name="1x1", n_devices=1, model_flops_global=1.0)
    h = analyze_trace(rec, **kw)
    f = 2.0 * 256 * 256 * 512
    assert h.flops_per_device == 2 * f
    assert h.compute_s == pytest.approx(f / 67e12 + f / 989e12)
    v = analyze_trace(rec, chip=TPU_V5E, **kw)
    assert v.compute_s == pytest.approx(2 * f / TPU_V5E.peak_flops_bf16)
    assert v.memory_s == pytest.approx(h.bytes_per_device / TPU_V5E.hbm_bw)
