"""``python -m repro_torch.sweep.cli`` — the port's sweep front door.

Usage::

    python -m repro_torch.sweep.cli list
    python -m repro_torch.sweep.cli run grad-comm-wire          # on the card
    python -m repro_torch.sweep.cli run fl-fault-grid --device cpu --limit 2
    python -m repro_torch.sweep.cli report serve-precision-ablation

``run`` executes every cell of a named preset that its JSONL store
(``results/torch/sweep_<name>.jsonl``) doesn't already hold, then refreshes
the sweep's marker-delimited table block in ``results/torch/EXPERIMENTS.md``.
Interrupt it at any point and re-run: completed cells are skipped by content
hash.  Cells run on CUDA unless ``--device`` names another device; the JAX
package's stores (``results/sweep_*.jsonl``) and ``EXPERIMENTS.md`` are never
written.
"""

from __future__ import annotations

import argparse
import os
import sys

from repro_torch.sweep.runner import DEFAULT_STORE_DIR


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.sweep.cli",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="list the named sweep presets")
    for c in ("run", "report"):
        p = sub.add_parser(c)
        p.add_argument("preset")
        p.add_argument("--store-dir", default=DEFAULT_STORE_DIR)
        p.add_argument("--experiments",
                       default=os.path.join(DEFAULT_STORE_DIR, "EXPERIMENTS.md"),
                       help="markdown file to refresh ('' disables)")
        if c == "run":
            p.add_argument("--device", default=None,
                           help="torch device of every cell (default: CUDA)")
            p.add_argument("--limit", type=int, default=0,
                           help="execute at most N cells this invocation")
            p.add_argument("--timeout", type=float, default=1800.0,
                           help="per-cell subprocess timeout (seconds)")
            p.add_argument("--keep-failed", action="store_true",
                           help="do not re-run error/timeout cells")
            p.add_argument("--force", action="store_true",
                           help="re-run every cell, ignoring the store")
    args = ap.parse_args(argv)

    from repro_torch.sweep.grid import PRESETS, get_preset

    if args.cmd == "list":
        for name in PRESETS:
            sweep = get_preset(name)
            print(f"{name:28s} {len(sweep.cells()):3d} cells "
                  f"({sweep.base.get('workload', 'mixed')})")
        return 0

    sweep = get_preset(args.preset)
    from repro_torch.sweep.report import write_experiments
    from repro_torch.sweep.runner import ResultsStore, SweepRunner

    store = ResultsStore.for_sweep(sweep, args.store_dir)
    if args.cmd == "run":
        runner = SweepRunner(sweep, store, timeout_s=args.timeout,
                             device=args.device)
        summary = runner.run(max_cells=args.limit or None,
                             rerun_failed=not args.keep_failed,
                             force=args.force)
        print(f"\n{sweep.name}: {len(summary['ran'])} ran, "
              f"{len(summary['skipped'])} skipped, "
              f"{len(summary['failed'])} failed "
              f"of {summary['n_cells']} cells")
    if args.experiments:
        os.makedirs(os.path.dirname(args.experiments) or ".", exist_ok=True)
        write_experiments(args.experiments, sweep, store)
        print(f"refreshed sweep:{sweep.name} tables in {args.experiments}")
    if args.cmd == "run" and summary["failed"]:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
