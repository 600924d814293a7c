"""Rerun the JAX reference's fl-sim sweep cells on the CPU and record their
exact facts (``tests/fixtures/sweep_reference_rerun.json``).

The committed stores (``results/sweep_fl-*.jsonl``) were written in another
environment, and their float sums (energy, time, retransmission energy)
differ from what the reference computes here in the last 1-3 bits.  The
port's sweep check on the card (``chip_smoke.py`` phases ``grids`` and
``grids_all``) holds every fl-sim fact to these reruns, and
``tests/test_torch_fl.py`` reruns one cell to pin them.  Run from the
repository root (a few minutes a cell; ``--presets`` splits the work)::

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/sweep_reference_rerun.py \
        --presets fl-codesign-grid,fl-fault-grid,fl-adaptive-grid
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "sweep_reference_rerun.json")
#: the fl-sim facts the port's sweep check compares exactly
FL_FACTS = ("rounds", "total_energy_j", "total_time_s", "mean_cohort", "bits_mix",
            "comm_bits_mix", "retransmissions", "retx_energy_j", "rejected_updates",
            "undelivered", "dropped_midround", "program")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--presets", default="fl-codesign-grid,fl-fault-grid,fl-adaptive-grid")
    ap.add_argument("--out", default=FIXTURE)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro.sweep import get_preset
    from repro.sweep.runner import _json_sanitize, execute_cell

    out = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            out = json.load(f)
    for name in args.presets.split(","):
        for cell in get_preset(name).cells():
            if cell.spec.workload != "fl-sim":
                continue
            m = _json_sanitize(execute_cell(cell.spec))
            out[cell.key] = {"sweep": name, **{k: m[k] for k in FL_FACTS}}
            print(f"{name} {cell.key} {cell.label}: {out[cell.key]}", flush=True)
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1, sort_keys=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
