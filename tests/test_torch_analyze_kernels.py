"""The port's kernel launch-grid checker, wire lint, allowlist, baseline and
``python -m repro_torch`` against the JAX reference where it has a
counterpart.

* kernel.*: the shipped specs are clean at the reference's dims, one
  finding per seeded defect, and every spec's grid and tiles are the
  launcher's plan at the same shape;
* wire.*: the same collective records (the reference's HLO fixtures and the
  cases of tests/test_analyze.py) through both packages' ``lint_module``
  and ``check_comm_report`` give the same ``(rule, key, severity)``;
* allowlist and baseline: round trip, reasonless entries refused,
  ``meta.dead_allowlist`` once, ``analyze_torch.toml`` parses, and the
  baseline file is byte-equal to the reference's ``write_baseline``;
* ``python -m repro_torch``: each subcommand reaches its main, ``dryrun``
  prints ``1/1 cells OK`` for a pod cell, and ``analyze --preset ci-tiny``
  runs on the CPU, its two 16x16 dry-run cells traced.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (installs the jax compat shims)
from repro.analyze import baseline as ref_baseline
from repro.analyze import wire_lint as ref_wire
from repro.analyze.findings import Finding as RefFinding
from repro.api.precision import PrecisionPolicy as RefPolicy
from repro.roofline.hlo_parse import ModuleCosts, parse_module
from repro.roofline.hlo_parse import CollectiveOp as RefCollectiveOp
from repro_torch.analyze import allowlist as AL
from repro_torch.analyze import baseline as BL
from repro_torch.analyze import wire_lint as W
from repro_torch.analyze.findings import Finding
from repro_torch.analyze.kernel_check import (
    check_kernel_spec,
    round_robin_pages,
    shipped_kernel_specs,
)
from repro_torch.api import PrecisionPolicy
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import quant_matmul as qm
from repro_torch.kernels.spec import BlockOperand, KernelSpec, ScratchSpec
from repro_torch.roofline import count

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HLO = os.path.join(ROOT, "tests", "fixtures", "hlo")


# ---------------------------------------------------------------------------
# kernel.* — the launch-grid checker
# ---------------------------------------------------------------------------

SHIPPED = shipped_kernel_specs()


@pytest.mark.parametrize("spec", SHIPPED, ids=[f"{s.name}-{s.path}" for s in SHIPPED])
def test_shipped_specs_are_clean(spec):
    assert check_kernel_spec(spec) == [], spec.name


def test_every_path_of_k3_and_k4_has_a_shipped_spec():
    paths = {(s.name, s.path) for s in SHIPPED}
    assert {("quant_matmul", p) for p in qm.PATHS} <= paths
    assert {("flash_attention", p) for p in fa.ATTN_PATHS} <= paths
    assert ("flash_decode", "split") in paths
    assert all(s.scalars for s in SHIPPED if s.name == "flash_decode")


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("dims", [dict(), dict(d_model=4096, d_ff=11008, heads=32,
                                                   head_dim=128, seq=17, page=16, n_pool=64)],
                         ids=["reference-dims", "yi-6b-dims"])
def test_each_spec_is_the_launchers_plan(dims):
    for spec in shipped_kernel_specs(**dims):
        x = spec.inputs[0]
        if spec.name == "quant_matmul":
            (M, K), N = x.shape, spec.outputs[0].shape[1]
            xd = torch.bfloat16 if spec.path == "wgmma" else torch.float32
            p = qm.plan(M, K, N, xd, torch.int8)
            assert spec.plan == p and spec.path == p.path
            want = {"cluster": (p.split, _cdiv(N, p.tile_n)),
                    "ragged": (p.split, _cdiv(N, p.tile_n)),
                    "wgmma": (_cdiv(M, p.tile_m), _cdiv(N, p.tile_n)),
                    "tiled": (_cdiv(N, 128), _cdiv(M, 128))}[p.path]
            assert spec.grid[:2] == want
            assert spec.outputs[0].block == (p.tile_m, p.tile_n)
            if p.path == "cluster":
                assert spec.smem_bytes == qm.cluster_layout(M, K, N, p, 4, 1)["smem"]
            if p.path == "ragged":
                assert spec.smem_bytes == qm.ragged_layout(K, p, 1)["smem"]
        elif spec.name == "flash_attention":
            BH, S, D = x.shape
            dt = torch.bfloat16 if spec.path == "wgmma" else torch.float32
            p = fa.plan_attention(BH, S, D, dt, spec.causal)
            assert spec.plan == p and spec.grid[:2] == (_cdiv(S, p.block_q), BH)
            assert (x.block[1], spec.inputs[1].block[1]) == (p.block_q, p.block_k)
            assert spec.smem_bytes == fa.attention_smem_bytes(p.path, D, p.block_q, p.block_k)
        else:
            B, KV, G, hd = x.shape
            page, n_pmax = spec.inputs[1].block[1], len(spec.scalars[0].values) // B
            p = fa.plan_decode(B, KV, G, hd, page, n_pmax, torch.float32, torch.float32)
            assert spec.plan == p
            assert spec.grid == (p.split, KV * _cdiv(G, p.group), B, p.pages_per_block)
            assert spec.smem_bytes == fa.decode_smem_bytes(p.group, hd, torch.float32)


def test_an_encoder_adds_k4_non_causal_and_its_walk_covers_every_key():
    from repro_torch.analyze.runner import _kernel_cells
    from repro_torch.api import RunSpec, Session

    spec = RunSpec.from_dict({"arch": "seamless-m4t-large-v2", "workload": "serve",
                              "smoke": True, "batch": 2, "seq": 256,
                              "options": {"prompt_len": 64}})
    cells = _kernel_cells(Session(spec, device="cpu"))
    k4 = [s for s in cells if s.name == "flash_attention"]
    assert sorted((s.path, s.causal) for s in k4) == [
        ("wgmma", False), ("wgmma", True), ("wgmma_split", False), ("wgmma_split", True)]
    for s in k4:
        assert check_kernel_spec(s) == [], (s.path, s.causal)
        nq, BH, nk = s.grid
        kv = s.inputs[1]
        walked = {(x, t) for x in range(nq) for t in range(nk) if kv.index_map(x, 0, t)}
        if s.causal:       # q tile nq-1-x reads key tiles up to its diagonal only
            assert len(walked) < nq * nk
        else:
            assert len(walked) == nq * nk


def _replace_input(spec, i, **kw):
    ins = list(spec.inputs)
    ins[i] = dataclasses.replace(ins[i], **kw)
    return dataclasses.replace(spec, inputs=tuple(ins))


def test_map_skipping_the_last_k_step_is_one_coverage_gap():
    spec = qm.kernel_spec(37, 513, 256)                  # the tiled path: a K walk
    assert spec.path == "tiled" and spec.grid[2] == 65
    broken = _replace_input(spec, 0, index_map=lambda jn, im, t: (im, min(t, 63)))
    found = check_kernel_spec(broken, cell="seeded")
    assert len(found) == 1
    f = found[0]
    assert (f.rule, f.key) == ("kernel.coverage_gap", "quant_matmul:x")
    assert f"quant_matmul.cu:{qm.KERNEL_LINES['tiled']}" in f.where


#: decode shapes TMA cannot address: (M, K, N, x dtype, code dtype, aligned)
_RAGGED = [(M, K, N, torch.bfloat16, torch.int8, True) for M in (1, 4, 16)
           for K, N in ((64, 2), (1536, 12), (1000, 300), (1536, 12570), (1536, 50280),
                        (1024, 256206))] + [
    (4, 1536, 301, torch.float32, torch.int16, True),
    (13, 1001, 4096, torch.bfloat16, torch.int8, True),
    (4, 4096, 4096, torch.bfloat16, torch.int8, False)]


@pytest.mark.parametrize("shape", _RAGGED, ids=lambda s: "x".join(map(str, s[:3])) + (
    f"-{str(s[4])[6:]}" if s[4] != torch.int8 else "") + ("" if s[5] else "-unaligned"))
def test_ragged_spec_writes_every_output_once_and_reads_every_k_row(shape):
    """The ragged path's spec: clean under the checker, its grid the
    cluster's split by column tiles, each output tile written by one column
    tile's cluster and every row of K read by exactly one of its ranks, and
    its shared memory the launch's layout restated (csrc: ragged_geom)."""
    M, K, N, xd, cd, aligned = shape
    spec = qm.kernel_spec(M, K, N, x_dtype=xd, code_dtype=cd, aligned=aligned)
    p = spec.plan
    assert spec.path == "ragged" and check_kernel_spec(spec) == [], spec
    assert spec.grid == (p.split, _cdiv(N, p.tile_n))
    x, codes = spec.inputs[:2]
    out = spec.outputs[0]
    kpb = x.block[1]
    assert codes.block == (kpb, p.tile_n) and out.block == (p.tile_m, p.tile_n)
    for j in range(spec.grid[1]):                 # one column tile's cluster
        blocks = [codes.index_map(r, j) for r in range(p.split)]
        ks = [k for kb, jj in blocks for k in range(kb * kpb, min(K, (kb + 1) * kpb))]
        assert {jj for _, jj in blocks} == {j} and ks == list(range(K))
        assert all(kb * kpb < K for kb, _ in blocks)          # no rank without rows
        assert {out.index_map(r, j) for r in range(p.split)} == {(0, j)}
    assert x.index_map(0, 0) == (0, 0) and out.shape == (M, N)
    sz = 2 if cd == torch.int16 else 1
    lanes = p.tile_n // (64 // p.tile_m)
    pitch = 16 * (_cdiv(p.tile_n * sz, 16) + 1)
    rows = _cdiv(_cdiv(8192, pitch), 256 // lanes) * (256 // lanes)
    xc = min(max(1, 16384 // (4 * p.tile_m) // rows) * rows, _cdiv(kpb, rows) * rows)
    assert kpb == _cdiv(K, p.split)
    assert spec.smem_bytes == 16 + max(8 * rows * pitch, 32768) + 4 * p.tile_m * xc + 8 * 16
    assert rows * pitch >= 8192 and spec.smem_bytes <= 200 * 1024   # csrc: CL_MAX_SMEM
    assert f"quant_matmul.cu:{qm.KERNEL_LINES['ragged']}" in spec.source


def test_unguarded_overrun_is_one_oob_and_a_guarded_partial_tile_is_legal():
    def spec(guarded):
        x = BlockOperand("x", (8, 130), (8, 128), lambda i, k: (i, k), guarded=guarded)
        return KernelSpec("k", "k.cu:1", (1, 2), (x,), ())

    found = check_kernel_spec(spec(False))
    assert [(f.rule, f.key) for f in found] == [("kernel.oob_dma", "k:x")]
    assert check_kernel_spec(spec(True)) == []
    assert check_kernel_spec(spec((False, True))) == []


def test_block_misaligned_only_on_an_unguarded_dim():
    def spec(guarded):
        x = BlockOperand("x", (130,), (128,), lambda i: (0,), guarded=guarded)
        return KernelSpec("k", "k.cu:1", (1,), (x,), ())

    assert [f.rule for f in check_kernel_spec(spec(False))] == ["kernel.block_misaligned"]
    # guarded: the partial second tile is legal, but nothing visits it
    assert [f.rule for f in check_kernel_spec(spec(True))] == ["kernel.coverage_gap"]


def test_scratch_that_does_not_match_its_operand_is_one_finding():
    spec = qm.kernel_spec(4, 512, 2048)
    acc = next(sc for sc in spec.scratch if sc.binds == "out")
    others = tuple(sc for sc in spec.scratch if sc is not acc)
    found = check_kernel_spec(dataclasses.replace(
        spec, scratch=others + (dataclasses.replace(acc, shape=(8, 8)),)))
    assert [f.rule for f in found] == ["kernel.scratch_shape"]
    found = check_kernel_spec(dataclasses.replace(
        spec, scratch=others + (dataclasses.replace(acc, dtype="bfloat16"),)))
    assert [f.rule for f in found] == ["kernel.scratch_dtype"]


def test_shared_memory_over_the_request_or_the_limit_is_one_finding():
    spec = attention = fa.attention_spec(32, 160, 64, dtype=torch.bfloat16)
    huge = ScratchSpec("extra", (fa.MAX_SMEM + 1,), "uint8", space="smem", accumulates=False)
    found = check_kernel_spec(dataclasses.replace(spec, scratch=spec.scratch + (huge,)))
    assert [f.rule for f in found] == ["kernel.scratch_smem"]
    # regions and request agree, but above what a block can have
    found = check_kernel_spec(dataclasses.replace(
        attention, scratch=spec.scratch + (huge,), smem_bytes=spec.smem_bytes + huge.nbytes))
    assert [f.rule for f in found] == ["kernel.smem_limit"]


def _decode(pt, lengths, n_pool=6):
    return fa.decode_spec(4, 2, 4, 64, page=8, n_pool=n_pool, page_table=pt,
                          lengths=np.asarray(lengths, np.int32))


def test_page_table_entry_outside_the_pool_is_one_finding():
    pt, lengths = round_robin_pages(4, 4, 6, 8)
    assert check_kernel_spec(_decode(pt, lengths)) == []
    pt = pt.copy()
    pt[3, 1] = 6                                        # one past the pool
    found = check_kernel_spec(_decode(pt, lengths))
    assert [(f.rule, f.key) for f in found] == [("kernel.scalar_oob",
                                                 "flash_decode:page_table")]
    assert "page_table" in found[0].message


def test_length_past_the_owned_pages_is_one_finding():
    pt, lengths = round_robin_pages(4, 4, 6, 8)
    lengths[0] = 4 * 8 + 1
    found = check_kernel_spec(_decode(pt, lengths))
    assert [f.rule for f in found] == ["kernel.scalar_oob"]


def test_decode_spec_reads_no_unallocated_or_out_of_length_page():
    pt, lengths = round_robin_pages(4, 4, 6, 8)
    spec = _decode(pt, lengths)
    k = spec.inputs[1]
    import itertools

    read = {(b, k.index_map(r, y, b, t)[0])
            for r, y, b, t in itertools.product(*map(range, spec.grid))
            if k.index_map(r, y, b, t) is not None}
    want = {(b, int(pt[b, j])) for b in range(4) for j in range(4)
            if pt[b, j] >= 0 and j * 8 < lengths[b]}
    assert read == want


# ---------------------------------------------------------------------------
# wire.* — the same records through both packages
# ---------------------------------------------------------------------------


def _fixture(name):
    with open(os.path.join(HLO, name)) as f:
        return parse_module(f.read()).collectives


def _rec(kind, dtype, elems, group=4):
    return RefCollectiveOp(kind=kind, dtype=dtype, elems=elems, bytes=0.0, wire_bytes=0.0,
                           group_size=group, mult=1.0, name=f"%{kind}.0",
                           computation="%main.0")


_LINT_CASES = {
    "f32-allreduce": (lambda: _fixture("allreduce_f32.txt"), {}),
    "f32-allreduce-decode": (lambda: _fixture("allreduce_f32.txt"), {"kind": "decode"}),
    "f32-allreduce-one-client": (lambda: _fixture("allreduce_f32.txt"), {"n_clients": 1}),
    "f32-allreduce-comm32": (lambda: _fixture("allreduce_f32.txt"), {"comm": 32}),
    "degenerate-group": (lambda: _fixture("degenerate_group.txt"), {}),
    "narrow-allreduce": (lambda: [_rec("all-reduce", "s8", 4096)], {}),
    "wide-allreduce": (lambda: [_rec("all-reduce", "s32", 4096)], {}),
    "matching-allreduce": (lambda: [_rec("all-reduce", "s16", 4096)], {}),
    "packed-gather": (lambda: [_rec("all-gather", "s8", 4096, 2)],
                      {"kind": "decode", "fsdp": 2, "gathers": dict(fsdp=2, tp=1, packed=True)}),
    "unexpected-gather": (lambda: [_rec("all-gather", "f16", 4096, 2)],
                          {"kind": "decode", "fsdp": 2,
                           "gathers": dict(fsdp=2, tp=1, packed=True)}),
    "pure-dp-gather": (lambda: [_rec("all-gather", "f32", 4096)], {}),
    "narrow-reduce-scatter": (lambda: [_rec("reduce-scatter", "s8", 4096)], {}),
    "wide-reduce-scatter": (lambda: [_rec("reduce-scatter", "s32", 4096)], {}),
    "matching-reduce-scatter": (lambda: [_rec("reduce-scatter", "s16", 4096)], {}),
    "fsdp-reduce-scatter": (lambda: [_rec("reduce-scatter", "f32", 4096)], {}),
    "unknown-collective": (lambda: _fixture("unknown_collective.txt"), {}),
}


def _contexts(kw):
    comm = kw.get("comm", 8)
    g = kw.get("gathers")
    base = dict(kind=kw.get("kind", "train"), n_clients=kw.get("n_clients", 4),
                fsdp=kw.get("fsdp", 1))
    ref = ref_wire.WireContext(
        policy=RefPolicy(comm=comm), **base,
        expected_gather_dtypes=ref_wire.expected_gathers(**g) if g else frozenset())
    port = W.WireContext(
        policy=PrecisionPolicy(comm=comm), **base,
        expected_gather_dtypes=W.expected_gathers(**g) if g else frozenset())
    return ref, port


def _port_records(refs):
    return count.Record(collectives=[count.CollectiveOp(**r.to_dict()) for r in refs])


def _ids(findings):
    return [(f.rule, f.key, f.severity) for f in findings]


@pytest.mark.parametrize("case", sorted(_LINT_CASES))
def test_wire_lint_equals_the_references_on_the_same_records(case):
    make, kw = _LINT_CASES[case]
    refs = make()
    ctx_ref, ctx_port = _contexts(kw)
    mc = ModuleCosts(0, 0, 0, {}, {}, 0, collectives=list(refs))
    want = _ids(ref_wire.lint_module(mc, ctx_ref, cell="t"))
    got = _ids(W.lint_module(_port_records(refs), ctx_port, cell="t"))
    assert got == want
    if case in ("f32-allreduce", "narrow-allreduce", "unknown-collective"):
        assert got, "the seeded case must give its finding"


@pytest.mark.parametrize("fixture,report", [
    ("allreduce_tuple.txt", {"wire_dtype": "int32", "replicated_elems": 256}),
    ("allreduce_tuple.txt", {"wire_dtype": "int32", "replicated_elems": 300}),
    ("allreduce_f32.txt", {"wire_dtype": "none"}),
    ("allreduce_f32.txt", {"wire_dtype": "float32"}),
])
def test_comm_report_check_equals_the_references(fixture, report):
    refs = _fixture(fixture)
    mc = ModuleCosts(0, 0, 0, {}, {}, 0, collectives=list(refs))
    want = _ids(ref_wire.check_comm_report(mc, report, cell="t"))
    assert _ids(W.check_comm_report(_port_records(refs), report, cell="t")) == want
    assert bool(want) == (report.get("replicated_elems") == 300)


# ---------------------------------------------------------------------------
# allowlist + baseline
# ---------------------------------------------------------------------------


def _finding(**kw):
    kw.setdefault("rule", "precision.eager_dequant")
    kw.setdefault("severity", "error")
    kw.setdefault("message", "m")
    kw.setdefault("key", "ops.py:expert_dispatch")
    return Finding(**kw)


def test_allowlist_round_trip_and_gate(tmp_path):
    from repro_torch.analyze.findings import at_or_above

    p = tmp_path / "a.toml"
    p.write_text('[[allow]]\nrule = "precision.*"\nkey = "ops.py:*"\nreason = "why"\n')
    entries = AL.load_allowlist(str(p))
    assert entries == [AL.AllowEntry("precision.*", "ops.py:*", "why")]
    out = AL.apply_allowlist([_finding(), _finding(key="layers.py:mlp")], entries)
    assert [f.allowed for f in out] == [True, False]
    assert len(at_or_above(out, "error")) == 1
    assert AL.load_allowlist(str(tmp_path / "missing.toml")) == []


def test_reasonless_entries_are_refused(tmp_path):
    p = tmp_path / "a.toml"
    p.write_text('[[allow]]\nrule = "wire.*"\nkey = "*"\n')
    with pytest.raises(ValueError, match="reason"):
        AL.load_allowlist(str(p))


def test_dead_allowlist_reported_once():
    entries = [AL.AllowEntry("numerics.*", "ssm.py:*", "why"),
               AL.AllowEntry("precision.*", "gone.py:*", "stale")]
    live = [_finding(rule="numerics.unguarded", key="ssm.py:_ssd_scan", severity="warn")]
    out = AL.dead_allowlist_findings(live, entries, path="analyze_torch.toml")
    assert [f.rule for f in out] == ["meta.dead_allowlist"]
    assert "gone.py:*" in out[0].message and out[0].where == "analyze_torch.toml"


def test_repo_allowlist_parses_with_reasons():
    entries = AL.load_allowlist(os.path.join(ROOT, "analyze_torch.toml"))
    assert entries and all(len(e.reason) > 40 for e in entries)


def test_baseline_file_is_byte_equal_to_the_references(tmp_path):
    fields = [dict(rule="wire.f32_allreduce", severity="error", message="m—x",
                   key="train:step", where="a.py:10", cell="dryrun:train_4k"),
              dict(rule="numerics.unguarded", severity="warn", message="n", key="ssm.py:f",
                   cell="train:train_step", allowed=True, allow_reason="r")]
    port = [Finding(**f) for f in fields]
    ref = [RefFinding(**f) for f in fields]
    extra = {("a", "b", "c")}
    BL.write_baseline(port, str(tmp_path / "p.json"), extra_identities=extra)
    ref_baseline.write_baseline(ref, str(tmp_path / "r.json"), extra_identities=extra)
    assert (tmp_path / "p.json").read_bytes() == (tmp_path / "r.json").read_bytes()
    base = BL.load_baseline(str(tmp_path / "p.json"))
    assert BL.diff_against_baseline([dataclasses.replace(port[0], where="a.py:99")],
                                    base) == []
    assert BL.finding_identity(port[1]) == ("numerics.unguarded", "ssm.py:f",
                                            "train:train_step")


def test_committed_port_baseline_parses():
    idents = BL.load_baseline(os.path.join(ROOT, "results", "torch", "analyze_baseline.json"))
    assert idents and all(len(i) == 3 for i in idents)
    assert ("analyze.skipped", "fl-sim:resnet", "fl-sim:resnet") in idents


def test_rule_selection():
    from repro_torch.analyze.runner import ALL_RULE_FAMILIES, normalize_rules

    assert normalize_rules(None) is None
    assert set(ALL_RULE_FAMILIES) == {"precision", "wire", "kernel", "overflow", "numerics"}
    assert normalize_rules("overflow,numerics") == frozenset({"overflow", "numerics"})
    with pytest.raises(ValueError, match="unknown rule"):
        normalize_rules("overflow,typo")


# ---------------------------------------------------------------------------
# python -m repro_torch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cmd,module", [
    ("train", "repro_torch.launch.train"), ("serve", "repro_torch.launch.serve"),
    ("fl", "repro_torch.launch.fl"), ("sweep", "repro_torch.sweep.cli"),
    ("analyze", "repro_torch.analyze.cli"), ("dryrun", "repro_torch.launch.dryrun")])
def test_each_subcommand_reaches_its_main(cmd, module, monkeypatch):
    import importlib

    from repro_torch.__main__ import main

    mod = importlib.import_module(module)
    seen = []
    monkeypatch.setattr(mod, "main", lambda argv: seen.append(argv) or 0)
    assert main([cmd, "--flag", "x"]) == 0
    assert seen == [["--flag", "x"]]


def test_dryrun_cli_runs_and_help_runs(capsys):
    from repro_torch.__main__ import main

    assert main(["dryrun", "--device", "cpu", "--arch", "yi-6b", "--shape", "decode_32k"]) == 0
    assert "1/1 cells OK" in capsys.readouterr().out
    assert main(["--help"]) == 0 and "analyze" in capsys.readouterr().out
    assert main(["nope"]) == 2
    with pytest.raises(SystemExit) as e:
        main(["analyze", "--help"])
    assert e.value.code == 0


def test_analyze_ci_tiny_runs_on_the_cpu(capsys):
    from repro_torch.__main__ import main

    rc = main(["analyze", "--preset", "ci-tiny", "--device", "cpu", "--no-compile", "--json",
               "--allowlist", os.path.join(ROOT, "analyze_torch.toml"), "--fail-on", "error"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0
    by_rule = {}
    for f in doc["findings"]:
        by_rule.setdefault(f["rule"], []).append(f)
    # the two 16x16 dry-run cells are traced (one device each): mamba2's
    # exponentials are the reference's baseline findings, allowlisted
    assert "analyze.not_ported" not in by_rule
    unguarded = by_rule["numerics.unguarded"]
    assert {f["key"] for f in unguarded} == {"ssm.py:_dt_and_decay_rate", "ssm.py:_ssd_scan"}
    assert all(f["allowed"] and f["cell"] == "dryrun:train_4k" for f in unguarded)
    assert not [f for f in doc["findings"] if f["severity"] == "error" and not f["allowed"]]
    assert {f["cell"] for f in by_rule["analyze.skipped"]} == {"fl-sim:resnet"}
    assert doc["proofs"] and all(p["ok"] for p in doc["proofs"])


@pytest.mark.parametrize("arch,mesh", [("olmoe-1b-7b", "16x16"), ("yi-6b", "2x16x16")])
def test_a_pod_cell_outside_ci_tiny_passes_the_gate(arch, mesh):
    """Any cell with a model axis above 1 is traced as one device of it: a
    pod decode cell outside ci-tiny analyzes with no ``analyze.not_ported``;
    its greedy pick's int32 ``pmin`` over the model group is no
    accumulator, so no overflow is found, and nothing at error passes the
    gate unallowlisted."""
    from repro_torch.analyze.findings import at_or_above
    from repro_torch.api import RunSpec, Session

    spec = RunSpec.from_dict({"arch": arch, "workload": "dryrun", "mesh": mesh,
                              "smoke": False, "options": {"shape": "decode_32k"}})
    proofs: list = []
    found = Session(spec, device="cpu").analyze(
        allowlist=os.path.join(ROOT, "analyze_torch.toml"), check_kernels=False,
        rules=["overflow", "precision"], proofs=proofs)
    assert not [f for f in found if f.rule == "analyze.not_ported"]
    assert [f for f in at_or_above(found, "error") if not f.allowed] == []
    assert not [f for f in found if f.rule.startswith("overflow.")]


def test_the_gate_keeps_the_named_workloads():
    """``--workloads`` keeps only a preset's cells of those workloads."""
    import argparse

    from repro_torch.analyze.cli import _cells

    args = argparse.Namespace(arch="", preset="ci-tiny", workloads="")
    every = [s.workload for s in _cells(args)]
    args.workloads = "serve,fl-sim"
    kept = [s.workload for s in _cells(args)]
    assert every.count("dryrun") == 2 and set(kept) == {"serve", "fl-sim"}
    assert sorted(kept) == sorted(w for w in every if w != "dryrun")
