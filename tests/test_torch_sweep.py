"""The port's sweep layer (``repro_torch.sweep``) and analytic proofs
(``repro_torch.analyze.static_proofs``) against the JAX package's.

Cells keep the reference's content-hash keys, labels and order, so the port
finds the committed rows in ``results/sweep_*.jsonl``; the port's tables over
those stores equal the reference's below the header line (the ``analyze``
column included); the store and the marker splicing behave as the
reference's; a tiny fl-sim grid interrupted and resumed on the CPU renders
the same tables as an uninterrupted run; the subprocess path reproduces
committed exact facts; failures become rows; the CLI writes under
``results/torch/`` only; and a cell asks for CUDA unless told otherwise.
"""

import hashlib
import json
import os
import subprocess
import sys

import pytest
import torch

from repro import sweep as R
from repro.analyze import static_proofs as RP
from repro_torch import sweep as T
from repro_torch.analyze import static_proofs as TP
from repro_torch.sweep import cli as tcli
from repro_torch.sweep.grid import set_field

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(ROOT, "results")
PRESETS = tuple(T.PRESETS)
STORED = tuple(p for p in PRESETS if p != "ci-tiny")    # ci-tiny has no store


def committed(preset: str) -> T.ResultsStore:
    return T.ResultsStore(os.path.join(RESULTS, f"sweep_{preset}.jsonl"))


def committed_cell(preset: str, key: str):
    return next(c for c in T.get_preset(preset).cells() if c.key == key)


def tiny_fl_sweep(name="tiny", rounds=1):
    """3-cell mobilenet fl-sim grid, seconds on the CPU (schemes that skip
    the GBD solve: the fixed-bit baselines)."""
    return T.Sweep(
        name=name,
        base={"arch": "mobilenet", "workload": "fl-sim", "rounds": rounds,
              "batch": 8,
              "options": {"n_clients": 4, "lr": 0.1, "eval_every": 0}},
        axes=(T.Axis("options.scheme",
                     ("full_precision", "unified_q", "rand_q")),))


def smoke_serve_sweep(name, **options):
    return T.Sweep(name=name, base={
        "arch": "yi-6b", "workload": "serve", "smoke": True, "batch": 2, "seq": 32,
        "options": {"steps": 4, "quiet": True, **options}})


# ---------------------------------------------------------------------------
# (a) keys, labels and order; the committed stores hold every cell
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", PRESETS)
def test_cells_have_the_reference_keys_labels_and_order(preset):
    mine, ref = T.get_preset(preset).cells(), R.get_preset(preset).cells()
    assert [(c.key, c.label, c.sweep) for c in mine] == \
        [(c.key, c.label, c.sweep) for c in ref]
    assert [c.spec.to_dict() for c in mine] == [c.spec.to_dict() for c in ref]
    if preset in STORED:
        store = committed(preset)
        assert all(store.has_ok(c.key) for c in mine), preset


def test_key_hashes_resolved_spec_not_spelling():
    from repro_torch.api import RunSpec

    sparse = T.Sweep(name="s", base={"arch": "mobilenet", "workload": "fl-sim"})
    dense = T.Sweep(name="s", base=RunSpec(arch="mobilenet", workload="fl-sim").to_dict())
    assert sparse.cells()[0].key == dense.cells()[0].key
    a = {"arch": "yi-6b", "options": {"x": 1, "y": 2}, "seed": 0}
    b = {"seed": 0, "options": {"y": 2, "x": 1}, "arch": "yi-6b"}
    assert T.cell_key(a) == T.cell_key(b) == R.cell_key(a)


def test_dict_axis_values_merge():
    d = {"precision": {"kv_cache": 16}}
    set_field(d, "precision", {"weights": 7, "lazy": True})
    assert d["precision"] == {"kv_cache": 16, "weights": 7, "lazy": True}


# ---------------------------------------------------------------------------
# (b) tables over the committed stores; the analytic proofs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", STORED)
def test_tables_over_committed_store_equal_the_reference(preset):
    path = os.path.join(RESULTS, f"sweep_{preset}.jsonl")
    mine = T.render_tables(T.get_preset(preset), T.ResultsStore(path))
    ref = R.render_tables(R.get_preset(preset), R.ResultsStore(path))
    head, body = mine.split("\n", 1)
    assert body == ref.split("\n", 1)[1]
    assert "python -m repro_torch.sweep.cli run" in head
    assert "Incomplete" not in body


@pytest.mark.parametrize("preset", PRESETS)
def test_prove_spec_gives_the_reference_records(preset):
    for mine, ref in zip(T.get_preset(preset).cells(), R.get_preset(preset).cells()):
        for rules in (("overflow", "precision"), ("overflow",)):
            rec, fs = TP.prove_spec(mine.spec, rules=rules, cell=mine.label)
            rrec, rfs = RP.prove_spec(ref.spec, rules=rules, cell=ref.label)
            assert rec == rrec, mine.label
            assert [f.to_dict() for f in fs] == [f.to_dict() for f in rfs]


@pytest.mark.parametrize("bits,n,force", [(8, 4, None), (16, 2, None), (8, 4, "int8"),
                                          (31, 4, None), (32, 8, None), (4, 1, None)])
def test_wire_accumulator_proof_equals_the_reference(bits, n, force):
    mine = TP.prove_wire_accumulator(bits, n, force_dtype=force, cell="c")
    ref = RP.prove_wire_accumulator(bits, n, force_dtype=force, cell="c")
    assert mine[0] == ref[0]
    assert [f.to_dict() for f in mine[1]] == [f.to_dict() for f in ref[1]]


def test_overflow_margin_table_equals_the_reference():
    assert TP.overflow_margin_table() == RP.overflow_margin_table()
    assert TP.overflow_margin_rows(("fl-adaptive-grid", "ci-tiny")) == \
        RP.overflow_margin_rows(("fl-adaptive-grid", "ci-tiny"))


def test_error_budget_flags_an_infeasible_policy():
    from repro.api import PrecisionPolicy as RPol

    from repro_torch.api import PrecisionPolicy as TPol

    for lam in (0.05, 1e-9):
        mine = TP.check_error_budget(TPol(weights=4), 8, lam=lam, d=1 << 20)
        ref = RP.check_error_budget(RPol(weights=4), 8, lam=lam, d=1 << 20)
        assert mine[0] == ref[0]
        assert [f.to_dict() for f in mine[1]] == [f.to_dict() for f in ref[1]]
    assert not mine[0]["ok"] and mine[1]


# ---------------------------------------------------------------------------
# (c) the store; the markers
# ---------------------------------------------------------------------------


def test_store_append_reload_last_wins(tmp_path):
    p = str(tmp_path / "s.jsonl")
    st = T.ResultsStore(p)
    st.append({"key": "k1", "status": "error", "metrics": {}})
    st.append({"key": "k1", "status": "ok", "metrics": {"v": 1, "x": float("nan")}})
    st2 = T.ResultsStore(p)
    assert st2.has_ok("k1") and st2.get("k1")["metrics"] == {"v": 1, "x": None}
    assert len(st2.rows()) == 1


def test_store_drops_a_torn_tail_line(tmp_path):
    p = str(tmp_path / "s.jsonl")
    st = T.ResultsStore(p)
    st.append({"key": "k1", "status": "ok", "metrics": {}})
    with open(p, "a") as f:
        f.write('{"key": "k2", "status": "o')     # crash mid-write
    st2 = T.ResultsStore(p)
    assert st2.has_ok("k1") and st2.get("k2") is None


def test_store_for_sweep_defaults_to_results_torch(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    st = T.ResultsStore.for_sweep(tiny_fl_sweep())
    assert st.path == os.path.join("results", "torch", "sweep_tiny.jsonl")
    assert (tmp_path / "results" / "torch").is_dir()


@pytest.mark.parametrize("text", ["# EXPERIMENTS\n\n## §Roofline\n\nprose stays\n", "",
                                  "no newline"])
def test_markers_insert_then_replace(text):
    t1 = T.update_markers(text, "x", "TABLE v1")
    assert t1 == R.update_markers(text, "x", "TABLE v1")
    assert "TABLE v1" in t1 and text.strip() in t1
    t2 = T.update_markers(t1, "x", "TABLE v2")
    assert "TABLE v2" in t2 and "TABLE v1" not in t2
    assert t2 == T.update_markers(t2, "x", "TABLE v2")


def test_markers_replace_in_place():
    text = "head\n<!-- sweep:x:begin -->\nold\n<!-- sweep:x:end -->\ntail\n"
    assert T.update_markers(text, "x", "new") == (
        "head\n<!-- sweep:x:begin -->\nnew\n<!-- sweep:x:end -->\ntail\n")


@pytest.mark.parametrize("text", ["head\n<!-- sweep:x:begin -->\nold\nprose\n",
                                  "<!-- sweep:x:end -->\nmid\n<!-- sweep:x:begin -->\n",
                                  "prose\n<!-- sweep:x:end -->\n"])
def test_markers_refuse_a_dangling_pair(text):
    with pytest.raises(ValueError):
        T.update_markers(text, "x", "new")


# ---------------------------------------------------------------------------
# (d) interrupt, resume; tables byte-identical
# ---------------------------------------------------------------------------


def test_interrupt_resume_skips_completed_and_tables_identical(tmp_path):
    sweep = tiny_fl_sweep()
    ref_store = T.ResultsStore(str(tmp_path / "ref.jsonl"))
    ref = T.SweepRunner(sweep, ref_store, quiet=True, device="cpu").run()
    assert len(ref["ran"]) == 3, ref_store.rows()

    store = T.ResultsStore(str(tmp_path / "cut.jsonl"))
    first = T.SweepRunner(sweep, store, quiet=True, device="cpu").run(max_cells=2)
    assert len(first["ran"]) == 2 and not first["skipped"]
    frozen = {k: json.dumps(store.get(k), sort_keys=True) for k in first["ran"]}
    partial = T.render_tables(sweep, store)
    assert "Incomplete cells" in partial and "pending" in partial

    store2 = T.ResultsStore(str(tmp_path / "cut.jsonl"))       # a fresh process
    second = T.SweepRunner(sweep, store2, quiet=True, device="cpu").run()
    assert sorted(second["skipped"]) == sorted(first["ran"])
    assert len(second["ran"]) == 1
    for k, blob in frozen.items():
        assert json.dumps(store2.get(k), sort_keys=True) == blob
    assert T.render_tables(sweep, store2) == T.render_tables(sweep, ref_store)
    a, b = str(tmp_path / "a.md"), str(tmp_path / "b.md")
    T.write_experiments(a, sweep, store2)
    T.write_experiments(b, sweep, ref_store)
    assert open(a, "rb").read() == open(b, "rb").read()
    # every metrics dict is strict JSON of plain Python values
    for row in store2.rows():
        json.dumps(row["metrics"], allow_nan=False)
        assert row["spec"]["workload"] == "fl-sim" and row["status"] == "ok"
    again = T.SweepRunner(sweep, store2, quiet=True, device="cpu").run(max_cells=0)
    assert len(again["skipped"]) == 3 and not again["ran"]


# ---------------------------------------------------------------------------
# (e) committed exact facts through the subprocess path
# ---------------------------------------------------------------------------

#: the serve facts that are host arithmetic (byte counts, scheduling)
SERVE_FACTS = ("bytes_per_step_packed", "bytes_per_step_f32", "packed_vs_f32", "kv_bytes",
               "kv_bytes_contiguous", "decode_steps", "decoded_tokens", "completed",
               "admitted", "capacity_stops", "deferred_admissions", "prompt_buckets")


@pytest.mark.parametrize("preset,key", [("grad-comm-wire", "c150ed63d5eb042d"),
                                        ("serve-precision-ablation", "1d3e3f3f9a1c23fd")])
def test_subprocess_cell_reproduces_the_committed_facts(tmp_path, preset, key):
    cell = committed_cell(preset, key)
    sweep = T.Sweep(name=preset, base=cell.spec.to_dict())
    assert sweep.cells()[0].key == key
    store = T.ResultsStore(str(tmp_path / "s.jsonl"))
    out = T.SweepRunner(sweep, store, timeout_s=600, quiet=True, device="cpu").run()
    assert out["ran"] == [key], store.rows()
    got, want = store.get(key)["metrics"], committed(preset).get(key)["metrics"]
    assert store.get(key)["launches"] == {}        # the CPU runs the plain versions
    if preset == "grad-comm-wire":
        assert (got["rounds"], got["total_energy_j"], got["bits_last"]) == \
            (want["rounds"], want["total_energy_j"], want["bits_last"])
        # the committed row predates the reference's per-round wire records:
        # every key it holds is equal
        assert {k: got["wire"][k] for k in want["wire"]} == want["wire"]
        assert want["wire"]["replicated_bytes_wire"] == 164520
    else:
        assert cell.spec.precision.weights == 7 and cell.spec.opt("kv_layout") == "paged"
        assert {k: got[k] for k in SERVE_FACTS} == {k: want[k] for k in SERVE_FACTS}
        assert got["device"] == "cpu" and len(got["sample"]) == len(want["sample"])


# ---------------------------------------------------------------------------
# (f) failures become rows
# ---------------------------------------------------------------------------


def test_subprocess_crash_and_timeout_are_failed_rows(tmp_path):
    crashy = T.Sweep(name="crashy", base=smoke_serve_sweep("c").base,
                     axes=(T.Axis("options.attn_impl", ("bogus", "ref")),))
    store = T.ResultsStore(str(tmp_path / "c.jsonl"))
    out = T.SweepRunner(crashy, store, timeout_s=600, quiet=True, device="cpu").run()
    assert len(out["failed"]) == 1 and len(out["ran"]) == 1
    rec = store.get(out["failed"][0])
    assert rec["status"] == "error" and rec["metrics"]["returncode"] != 0
    assert "attn_impl" in rec["metrics"]["stderr"]
    assert store.get(out["ran"][0])["status"] == "ok"

    slow = smoke_serve_sweep("slow")
    store = T.ResultsStore(str(tmp_path / "t.jsonl"))
    out = T.SweepRunner(slow, store, timeout_s=0.5, quiet=True, device="cpu").run()
    assert out["failed"] and not out["ran"]
    rec = store.get(out["failed"][0])
    assert rec["status"] == "timeout" and rec["metrics"]["timeout_s"] == 0.5
    assert "stderr" in rec["metrics"]


def test_in_process_crash_is_an_error_row_and_dryrun_ok(tmp_path):
    """An in-process crash is an error row; ci-tiny's yi-6b dry-run cell (a
    16x16 pod) is an ok row of the reference's metrics."""
    dry_cell = next(c for c in T.get_preset("ci-tiny").cells()
                    if c.spec.workload == "dryrun" and c.spec.arch == "yi-6b")
    bad = T.Sweep(name="bad", base={"arch": "no-such-arch", "workload": "fl-sim",
                                    "rounds": 1, "options": {"n_clients": 2}},
                  extra_cells=(dry_cell.spec.to_dict(),))
    store = T.ResultsStore(str(tmp_path / "bad.jsonl"))
    out = T.SweepRunner(bad, store, quiet=True, device="cpu").run()
    assert len(out["failed"]) == 1 and out["ran"] == [dry_cell.key]
    crash, dry = store.get(out["failed"][0]), store.get(dry_cell.key)
    assert crash["status"] == "error" and "Traceback" in crash["metrics"]["traceback"]
    assert dry["spec"]["workload"] == "dryrun" and dry["status"] == "ok"
    assert dry["metrics"]["mesh"] == "16x16" and dry["metrics"]["n_devices"] == 256
    assert dry["metrics"]["shape"] == "train_4k" and dry["metrics"]["flops_per_device"] > 0
    out2 = T.SweepRunner(bad, store, quiet=True, device="cpu").run(rerun_failed=False)
    assert sorted(out2["skipped"]) == sorted(out["failed"] + out["ran"]) and not out2["failed"]


# ---------------------------------------------------------------------------
# (g) the CLI writes under results/torch/ only
# ---------------------------------------------------------------------------


def _digest(paths) -> dict:
    return {p: hashlib.sha256(open(p, "rb").read()).hexdigest() for p in paths}


def test_cli_defaults_write_under_results_torch(tmp_path, monkeypatch, capsys):
    guarded = sorted(os.path.join(RESULTS, n) for n in os.listdir(RESULTS)
                     if n.startswith("sweep_")) + [os.path.join(ROOT, "EXPERIMENTS.md")]
    before = _digest(guarded)
    monkeypatch.chdir(tmp_path)
    assert tcli.main(["list"]) == 0
    assert "grad-comm-wire" in capsys.readouterr().out
    assert tcli.main(["run", "grad-comm-wire", "--device", "cpu", "--limit", "1"]) == 0
    assert tcli.main(["report", "grad-comm-wire"]) == 0
    written = sorted(str(p.relative_to(tmp_path)) for p in tmp_path.rglob("*") if p.is_file())
    assert written == [os.path.join("results", "torch", "EXPERIMENTS.md"),
                       os.path.join("results", "torch", "sweep_grad-comm-wire.jsonl")]
    store = T.ResultsStore(os.path.join("results", "torch", "sweep_grad-comm-wire.jsonl"))
    (row,) = store.rows()
    assert row["status"] == "ok" and row["key"] == "02d0953ec8721bbf"
    md = open(os.path.join("results", "torch", "EXPERIMENTS.md")).read()
    assert "<!-- sweep:grad-comm-wire:begin -->" in md and "Incomplete cells" in md
    assert _digest(guarded) == before


# ---------------------------------------------------------------------------
# (h) a cell asks for CUDA unless told otherwise
# ---------------------------------------------------------------------------


def test_cells_ask_for_cuda_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    grid = T.Sweep(name="cuda", base=tiny_fl_sweep().spec_dicts()[1],
                   extra_cells=(smoke_serve_sweep("s").base,))
    store = T.ResultsStore(str(tmp_path / "c.jsonl"))
    out = T.SweepRunner(grid, store, quiet=True).run()
    assert len(out["failed"]) == 2 and not out["ran"]
    for k in out["failed"]:
        assert "CUDA was asked for" in store.get(k)["metrics"]["error"]


def test_one_cell_entry_asks_for_cuda_by_default(tmp_path):
    cell = tmp_path / "cell.json"
    cell.write_text(json.dumps(smoke_serve_sweep("s").cells()[0].spec.to_dict()))
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "",
           "PYTHONPATH": os.path.join(ROOT, "src")}
    proc = subprocess.run([sys.executable, "-m", "repro_torch.sweep.runner", "--one",
                           str(cell), "--out", str(tmp_path / "m.json")],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "CUDA was asked for" in proc.stderr
    assert not (tmp_path / "m.json").exists()


# ---------------------------------------------------------------------------
# the fault grid: corruption lands where the reference puts it
# ---------------------------------------------------------------------------


def test_corruption_damages_the_reference_positions():
    """A fault plan damages each flagged client's update in the reference's
    flattened-payload view (jax's leaf order, conv kernels HWIO), so the same
    plan damages the same parameters in both packages."""
    import jax
    import numpy as np

    from repro.faults.executor import inject_corruption
    from repro.models import cnn as rcnn
    from repro_torch.faults.executor import UpdateFaults
    from repro_torch.fed.simulation import damage_updates
    from repro_torch.models.convert import cnn_params_from_jax

    C, kinds = 4, np.array([0, 2, 1, 2])
    shapes = jax.eval_shape(rcnn.resnet(depth_blocks=(1, 1), width=8).init,
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    ref = jax.tree_util.tree_map(
        lambda sd: (1e-2 * rng.standard_normal((C,) + sd.shape)).astype(np.float32), shapes)
    per_client = [cnn_params_from_jax(jax.tree_util.tree_map(lambda a: a[c], ref))
                  for c in range(C)]
    grads = {p: torch.stack([t[p] for t in per_client]) for p in per_client[0]}

    leaves, treedef = jax.tree_util.tree_flatten(ref)
    leaves = [np.array(a) for a in leaves]
    want_norms, want_finite = np.zeros(C), np.ones(C, bool)
    for ci in np.flatnonzero(kinds):        # the reference's own loop
        vec = np.concatenate([a[ci].ravel() for a in leaves])
        vec = inject_corruption(vec, int(kinds[ci]), np.random.default_rng(10 + ci))
        off = 0
        for a in leaves:
            a[ci] = vec[off:off + a[ci].size].reshape(a[ci].shape)
            off += a[ci].size
        with np.errstate(over="ignore", invalid="ignore"):
            want_norms[ci] = float(sum(np.sum(a[ci].astype(np.float64) ** 2) for a in leaves))
        want_finite[ci] = all(np.isfinite(a[ci]).all() for a in leaves)
    want = jax.tree_util.tree_unflatten(treedef, leaves)

    faults = UpdateFaults(kinds=kinds, rngs=tuple(np.random.default_rng(10 + ci)
                                                  for ci in range(C)))
    norms, finite = np.zeros(C), np.ones(C, bool)
    got = damage_updates(grads, faults, norms, finite)
    assert list(got) == list(grads)                 # the port's own leaf order
    for c in range(C):
        conv = cnn_params_from_jax(jax.tree_util.tree_map(lambda a: a[c], want))
        for p, t in got.items():
            np.testing.assert_array_equal(t[c].numpy(), conv[p].numpy(), err_msg=p)
    flagged = kinds > 0
    np.testing.assert_array_equal(norms[flagged], want_norms[flagged])
    np.testing.assert_array_equal(finite, want_finite)
    assert not finite[2] and norms[1] > 1e50


def test_reference_rerun_differs_from_the_committed_rows_in_last_bits_only():
    """ROADMAP §3 D1: the reference's own rerun of every fl-sim cell on the
    CPU (``tests/sweep_reference_rerun.py``; the fixture the sweep check on
    the card holds the port to) gives the committed rows' integers, lists
    and dicts exactly, and their float sums within a few units in the last
    place: the committed rows were written in another environment."""
    import math

    with open(os.path.join(ROOT, "tests", "fixtures", "sweep_reference_rerun.json")) as f:
        reruns = json.load(f)
    fl_cells = {c.key: name for name in ("fl-codesign-grid", "fl-fault-grid", "fl-adaptive-grid")
                for c in T.get_preset(name).cells()}
    assert {k: r["sweep"] for k, r in reruns.items()} == fl_cells
    n_float_differ = 0
    for key, rerun in reruns.items():
        want = committed(rerun["sweep"]).get(key)["metrics"]
        for k, v in rerun.items():
            if k == "sweep" or k not in want:
                continue
            if isinstance(v, float):
                assert abs(v - want[k]) <= 4 * math.ulp(want[k]), (key, k, v, want[k])
                n_float_differ += v != want[k]
            else:
                assert v == want[k], (key, k, v, want[k])
    assert n_float_differ > 0


def test_int16_cell_shapes_are_what_the_card_check_times(monkeypatch):
    """The 12-bit serve cell calls K3 on int16 codes at exactly the shapes
    and counts ``chip_smoke.K3_INT16_CELL_SHAPES`` times on the card."""
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke

    from repro_torch.kernels import ops

    calls: dict = {}
    real = ops.quant_matmul

    def counting(x, codes, scale):
        assert codes.dtype == torch.int16 and x.dtype == torch.float32
        k = (x.shape[0], x.shape[1], codes.shape[1])
        calls[k] = calls.get(k, 0) + 1
        return real(x, codes, scale)

    monkeypatch.setattr(ops, "quant_matmul", counting)
    cell = committed_cell("serve-precision-ablation", "bdc1ff13700f4928")
    assert cell.spec.precision.weights == 12
    T.execute_cell(cell.spec, "cpu")
    assert sorted((*k, n) for k, n in calls.items()) == sorted(chip_smoke.K3_INT16_CELL_SHAPES)
