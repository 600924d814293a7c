"""``python -m repro_torch analyze`` — the port's static-lint gate.

Usage::

    python -m repro_torch analyze                  # ci-tiny grid, analyze_torch.toml
    python -m repro_torch analyze --preset ci-tiny --fail-on error   # the gate
    python -m repro_torch analyze --preset ci-tiny --workloads serve,fl-sim
    python -m repro_torch analyze --rules overflow,numerics,precision \
        --preset grad-comm-wire
    python -m repro_torch analyze --arch yi-6b --workload serve --precision lazy_int8
    python -m repro_torch analyze --device cpu --no-compile --json
    python -m repro_torch analyze --write-baseline results/torch/analyze_baseline.json
    python -m repro_torch analyze --baseline results/torch/analyze_baseline.json

Runs :func:`repro_torch.analyze.runner.analyze_session` over every cell of
a named sweep preset (default ``ci-tiny``), or over one ad-hoc RunSpec built
from ``--arch``/``--workload`` flags.  The steps are traced on fake tensors
of ``--device`` (default ``cuda``: on the card; ``cpu`` here), nothing
executed.  Findings matching ``analyze_torch.toml`` stay visible but don't
gate; allowlist entries that matched nothing across the WHOLE run surface as
``meta.dead_allowlist`` warnings.  With ``--baseline`` the gate is
*differential*: only findings absent from the committed snapshot count, so
rule families can be broadened without allowlist churn.  Counterpart of
``repro/analyze/cli.py`` (without its host-device flag: the port needs no
fake devices; with ``--workloads``, which keeps a preset's cells of the
named workloads).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _cells(args) -> list:
    if args.arch:
        from repro_torch.api.spec import RunSpec

        precision = {}
        if args.precision == "lazy_int8":
            precision = {"weights": 7, "lazy": True}
        elif args.precision:
            precision = json.loads(args.precision)
        d = {"arch": args.arch, "workload": args.workload,
             "mesh": args.mesh, "smoke": True, "batch": args.batch,
             "seq": args.seq}
        if precision:
            d["precision"] = precision
        return [RunSpec.from_dict(d)]
    from repro_torch.sweep.grid import PRESETS, get_preset

    names = ([p for p in args.preset.split(",") if p]
             if args.preset != "all" else sorted(PRESETS))
    workloads = {w for w in args.workloads.split(",") if w}
    specs, seen = [], set()
    for name in names:
        for c in get_preset(name).cells():
            if c.key in seen:          # presets share cells (ci-tiny does)
                continue
            if workloads and c.spec.workload not in workloads:
                continue
            seen.add(c.key)
            specs.append(c.spec)
    return specs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch analyze", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", default="ci-tiny",
                    help="sweep preset(s) naming the spec matrix to analyze "
                         "(comma-separated, or 'all'; duplicate cells "
                         "dedupe by content hash)")
    ap.add_argument("--workloads", default="",
                    help="keep only the preset's cells of these workloads "
                         "(comma-separated; '' = all)")
    ap.add_argument("--arch", default="",
                    help="analyze one ad-hoc RunSpec instead of a preset")
    ap.add_argument("--workload", default="serve")
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--precision", default="lazy_int8",
                    help="'lazy_int8' or a PrecisionPolicy JSON dict")
    ap.add_argument("--rules", default="",
                    help="comma-separated rule families to run "
                         "(precision,wire,kernel,overflow,numerics; "
                         "'' = all)")
    ap.add_argument("--fail-on", choices=("error", "warn", "never"),
                    default="error",
                    help="exit non-zero when an unallowlisted finding at or "
                         "above this severity exists")
    ap.add_argument("--device", default="cuda",
                    help="the device whose fake tensors the steps are traced on "
                         "(cuda: on the card; cpu)")
    ap.add_argument("--allowlist", default="analyze_torch.toml",
                    help="per-rule allowlist file ('' disables)")
    ap.add_argument("--baseline", default="",
                    help="committed findings snapshot: gate only on findings "
                         "NOT already in it (differential mode)")
    ap.add_argument("--write-baseline", default="",
                    help="write this run's findings as a new baseline "
                         "snapshot and exit 0")
    ap.add_argument("--no-compile", action="store_true",
                    help="skip the wire lint over the traced collective records")
    ap.add_argument("--json", action="store_true",
                    help="emit findings (and proofs) as JSON on stdout")
    ap.add_argument("--json-out", default="",
                    help="also write the findings+proofs JSON to this path "
                         "(the CI artifact)")
    args = ap.parse_args(argv)

    specs = _cells(args)

    from repro_torch.analyze.allowlist import dead_allowlist_findings, load_allowlist
    from repro_torch.analyze.baseline import (
        diff_against_baseline,
        load_baseline,
        write_baseline,
    )
    from repro_torch.analyze.findings import at_or_above
    from repro_torch.analyze.runner import normalize_rules
    from repro_torch.api.session import Session

    rules = normalize_rules(args.rules) if args.rules else None
    allowlist = args.allowlist or None
    findings, proofs = [], []
    for spec in specs:
        label = f"{spec.arch}:{spec.workload}"
        if not args.json:
            print(f"== analyzing {label} (mesh {spec.mesh}) ==",
                  flush=True)
        findings.extend(Session(spec, device=args.device).analyze(
            compile=not args.no_compile, allowlist=allowlist,
            rules=rules, proofs=proofs))

    # dead-allowlist detection runs over the AGGREGATE: an entry is alive
    # if any cell of the whole run still triggers it
    if allowlist:
        entries = load_allowlist(allowlist)
        findings.extend(dead_allowlist_findings(findings, entries,
                                                path=allowlist))

    if args.write_baseline:
        extra = (load_baseline(args.baseline) if args.baseline
                 and os.path.exists(args.baseline) else ())
        doc = write_baseline(findings, args.write_baseline,
                             extra_identities=extra)
        print(f"baseline written: {args.write_baseline} "
              f"({len(findings)} findings, "
              f"{len(doc['identities'])} identities)")
        return 0

    gated = findings
    if args.baseline:
        gated = diff_against_baseline(findings, load_baseline(args.baseline))

    doc = {"findings": [f.to_dict() for f in findings],
           "proofs": proofs,
           "new_findings": ([f.to_dict() for f in gated]
                            if args.baseline else None)}
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True)
            fh.write("\n")
    if args.json:
        print(json.dumps(doc, indent=2, sort_keys=True))
    else:
        for f in findings:
            print(f.format())
        n_err = sum(1 for f in findings
                    if f.severity == "error" and not f.allowed)
        n_warn = sum(1 for f in findings
                     if f.severity == "warn" and not f.allowed)
        n_allowed = sum(1 for f in findings if f.allowed)
        n_proved = sum(1 for p in proofs if p.get("ok"))
        print(f"-- {len(findings)} findings: {n_err} errors, {n_warn} "
              f"warnings, {n_allowed} allowlisted; {n_proved}/{len(proofs)} "
              "proofs hold --")
        if args.baseline:
            print(f"-- differential vs {args.baseline}: "
                  f"{len(gated)} new finding(s) --")

    if args.fail_on != "never" and at_or_above(gated, args.fail_on):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
