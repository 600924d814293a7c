"""Sweep results -> typed rows -> marker-delimited EXPERIMENTS.md tables.

Each workload has a row adapter that pulls the table-worthy numbers out of a
stored cell record; :func:`render_tables` assembles them into GitHub
markdown, and :func:`update_markers` splices the rendered block between

    <!-- sweep:<name>:begin -->
    ...
    <!-- sweep:<name>:end -->

replacing whatever was there (or appending a new section when the markers
don't exist yet).  Rows follow the sweep's declared cell order and contain
only run-deterministic columns by default, so regenerating a table from an
interrupted-then-resumed store is byte-identical to an uninterrupted run —
the property ``tests/test_torch_sweep.py`` pins.
"""

from __future__ import annotations

import math

from repro_torch.sweep.grid import Sweep
from repro_torch.sweep.runner import ResultsStore

MARK_BEGIN = "<!-- sweep:{name}:begin -->"
MARK_END = "<!-- sweep:{name}:end -->"


def _f(x, spec="{:.3e}") -> str:
    if x is None or (isinstance(x, float) and math.isnan(x)):
        return "-"
    return spec.format(x)


# ---------------------------------------------------------------------------
# Per-workload row adapters: stored record -> ordered (column, value) rows
# ---------------------------------------------------------------------------


def roofline_row(rec: dict) -> dict:
    s, m = rec["spec"], rec["metrics"]
    return {
        "arch x shape x mesh":
            f"{s['arch']} x {s['options'].get('shape')} x {s['mesh']}",
        "compute_s": _f(m.get("compute_s")),
        "memory_s": _f(m.get("memory_s")),
        "collective_s": _f(m.get("collective_s")),
        "dominant": m.get("dominant", "-"),
        "useful FLOPs": _f(m.get("useful_flops_ratio"), "{:.3f}"),
    }


def serving_row(rec: dict) -> dict:
    s, m = rec["spec"], rec["metrics"]
    p = s["precision"]
    layout = m.get("kv_layout", "contiguous")
    if layout == "paged":
        layout = f"paged/{m.get('page_size', '?')}"
    kv_bytes = m.get("kv_bytes")
    kv_contig = m.get("kv_bytes_contiguous") or 0
    return {
        "arch": s["arch"],
        "weights": "f32" if p["weights"] >= 32 else f"{p['weights']}b packed",
        "kv cache": "bf16" if p["kv_cache"] == 16 else "f32",
        "kv layout": layout,
        "kv KB": "-" if kv_bytes is None else f"{kv_bytes / 1e3:,.1f}",
        "kv vs contig": ("-" if not kv_bytes or not kv_contig
                         else f"{kv_bytes / kv_contig:.2f}"),
        "bytes/step": f"{m['bytes_per_step_packed']:,}",
        "vs f32": _f(m.get("packed_vs_f32"), "{:.3f}"),
        "tokens": str(m.get("decoded_tokens", "-")),
        "done/admitted": f"{m.get('completed')}/{m.get('admitted')}",
    }


def _analyze_col(spec_dict: dict) -> str:
    """Overflow-proof summary recomputed from the SPEC at render time.

    Deterministic host math (no store field, no tracing), so tables
    regenerated from pre-existing stores gain the column without rerunning
    any cell; the weakest accumulator across the cell's bit lattice is
    shown with its headroom.
    """
    from repro_torch.analyze.static_proofs import prove_spec
    from repro_torch.api.spec import RunSpec

    records, findings = prove_spec(RunSpec.from_dict(spec_dict),
                                   rules=("overflow",))
    if findings:
        return "**OVERFLOW**"
    accum = [r for r in records if r["kind"] == "wire_accumulator"]
    if not accum:
        return "exact f32"
    worst = min(accum, key=lambda r: r["headroom_bits"])
    return f"{worst['dtype']} ok +{worst['headroom_bits']}b"


def fl_row(rec: dict) -> dict:
    s, m = rec["spec"], rec["metrics"]
    return {
        "scheme": s["options"].get("scheme", "fwq"),
        "rounds": str(m.get("rounds", "-")),
        "final loss": _f(m.get("final_loss"), "{:.4f}"),
        "final acc": _f(m.get("final_acc"), "{:.3f}"),
        "energy (J)": _f(m.get("total_energy_j"), "{:.2f}"),
        "time (s)": _f(m.get("total_time_s"), "{:.1f}"),
        "bits mix": ",".join(str(b) for b in m.get("bits_mix", [])) or "-",
        "analyze": _analyze_col(s),
    }


def train_row(rec: dict) -> dict:
    s, m = rec["spec"], rec["metrics"]
    w = m.get("wire", {})
    return {
        "arch": s["arch"],
        "comm bits": str(s["precision"].get("comm", 32)),
        "rounds": str(m.get("rounds", "-")),
        "final loss": _f(m.get("final_loss"), "{:.4f}"),
        "wire dtype": w.get("wire_dtype", "-"),
        "grad wire MB/round": _f(w.get("replicated_bytes_wire", 0) / 1e6,
                                 "{:.2f}"),
        "vs f32 wire": _f(w.get("wire_ratio"), "{:.2f}"),
        "analyze": _analyze_col(s),
    }


def fl_fault_row(rec: dict) -> dict:
    s, m = rec["spec"], rec["metrics"]
    faults = s["options"].get("faults") or {}
    level = ("none" if not faults else
             " ".join(f"{k.split('_')[0]}={v:g}"
                      for k, v in sorted(faults.items())))
    return {
        "scheme": s["options"].get("scheme", "fwq"),
        "faults": level,
        "final loss": _f(m.get("final_loss"), "{:.4f}"),
        "energy (J)": _f(m.get("total_energy_j"), "{:.2f}"),
        "retx": str(m.get("retransmissions", 0)),
        "retx (J)": _f(m.get("retx_energy_j"), "{:.3f}"),
        "rejected": str(m.get("rejected_updates", 0)),
        "undelivered": str(m.get("undelivered", 0)),
        "dropped": str(m.get("dropped_midround", 0)),
    }


def fl_adaptive_row(rec: dict) -> dict:
    s, m = rec["spec"], rec["metrics"]
    prog = m.get("program") or {}
    pp = s["options"].get("precision_program")
    kind = (pp.get("kind") if isinstance(pp, dict) else pp) or "static"
    budget = prog.get("budget_j") or (pp.get("budget_j")
                                      if isinstance(pp, dict) else None)
    within = ("yes" if prog.get("within_budget")
              else "NO" if prog.get("within_budget") is False else "-")
    return {
        "program": kind,
        "faults": "severe" if s["options"].get("faults") else "none",
        "final loss": _f(m.get("final_loss"), "{:.4f}"),
        "energy (J)": _f(m.get("total_energy_j"), "{:.2f}"),
        "budget (J)": _f(budget, "{:.0f}") if budget else "-",
        "within": within,
        "demotions": str(prog.get("demotions", 0)),
        "restores": str(prog.get("restores", 0)),
        "bits": "/".join(str(b) for b in m.get("bits_mix", [])),
        "comm bits": "/".join(str(b) for b in m.get("comm_bits_mix", [])),
        "retx (J)": _f(m.get("retx_energy_j"), "{:.2f}"),
    }


_ROW_ADAPTERS = {
    "dryrun": roofline_row,
    "serve": serving_row,
    "fl-sim": fl_row,
    "train": train_row,
    "fl-orchestrate": train_row,
}

#: Sweep-specific overrides: some grids want columns the generic workload
#: adapter doesn't carry (the fault grid's resilience counters).
_SWEEP_ROW_ADAPTERS = {
    "fl-fault-grid": {"fl-sim": fl_fault_row},
    "fl-adaptive-grid": {"fl-sim": fl_adaptive_row},
}


# ---------------------------------------------------------------------------
# Table rendering + marker splicing
# ---------------------------------------------------------------------------


def _md_table(rows: list[dict]) -> str:
    cols = list(rows[0].keys())
    out = ["| " + " | ".join(cols) + " |",
           "| " + " | ".join("-" * max(len(c), 3) for c in cols) + " |"]
    out += ["| " + " | ".join(str(r[c]) for c in cols) + " |" for r in rows]
    return "\n".join(out)


def render_tables(sweep: Sweep, store: ResultsStore) -> str:
    """Markdown for every completed cell, grouped by workload, in cell order.

    Cells not yet in the store (or recorded failing) are summarized in a
    trailing line rather than silently dropped — a partial grid must read
    as partial.
    """
    by_workload: dict[str, list[dict]] = {}
    missing = []
    for cell in sweep.cells():
        rec = store.get(cell.key)
        if rec is None or rec.get("status") != "ok":
            missing.append(f"{cell.label} "
                           f"({'pending' if rec is None else rec['status']})")
            continue
        adapter = (_SWEEP_ROW_ADAPTERS.get(sweep.name, {})
                   .get(cell.spec.workload, _ROW_ADAPTERS[cell.spec.workload]))
        by_workload.setdefault(cell.spec.workload, []).append(adapter(rec))
    parts = [f"*Generated by `python -m repro_torch.sweep.cli run {sweep.name}` "
             f"— do not edit between the markers.*"]
    for wl, rows in by_workload.items():
        if len(by_workload) > 1:
            parts.append(f"**{wl}**")
        parts.append(_md_table(rows))
    if missing:
        parts.append("Incomplete cells: " + "; ".join(missing) + ".")
    return "\n\n".join(parts)


def update_markers(text: str, name: str, body: str) -> str:
    """Replace (or append) the ``sweep:<name>`` marker block in ``text``.

    A half-present marker pair is refused rather than guessed at: splicing
    from a dangling mid-file ``begin`` to an ``end`` appended later would
    silently delete everything in between.
    """
    begin, end = MARK_BEGIN.format(name=name), MARK_END.format(name=name)
    block = f"{begin}\n{body}\n{end}"
    has_begin, has_end = begin in text, end in text
    if has_begin != has_end or (
            has_begin and text.index(end) < text.index(begin)):
        raise ValueError(
            f"unmatched or mis-ordered sweep:{name} markers; restore the "
            f"'{begin}' / '{end}' pair before regenerating")
    if has_begin:
        head = text[: text.index(begin)]
        tail = text[text.index(end) + len(end):]
        return head + block + tail
    if text and not text.endswith("\n"):
        text += "\n"
    return text + f"\n## §Sweep — {name}\n\n{block}\n"


def write_experiments(path: str, sweep: Sweep, store: ResultsStore) -> str:
    """Refresh ``path``'s marker block for ``sweep`` from ``store``."""
    try:
        with open(path) as f:
            text = f.read()
    except FileNotFoundError:
        text = "# EXPERIMENTS\n"
    body = render_tables(sweep, store)
    new = update_markers(text, sweep.name, body)
    with open(path, "w") as f:
        f.write(new)
    return new
