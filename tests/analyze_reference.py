"""Rerun the JAX reference's static analysis on the CPU for three smoke
specs and record what it finds (``tests/fixtures/analyze_reference.json``).

``tests/test_torch_analyze_session.py`` holds the port's
``Session.analyze`` to these records: each finding's identity
``rule|key|cell`` with its severity, and each proof record of the abstract
interpreter.  The specs:

* ``serve``: yi-6b smoke serve, 1x1, ``lazy_int8(7)`` (batch 2, seq 32);
* ``train``: yi-6b smoke train, 4x1, comm 8 (batch 1, seq 16);
* ``mamba``: mamba2-780m smoke train, 1x1 (batch 1, seq 16).

Each runs ``Session(spec).analyze(compile=True, allowlist=None,
proofs=[])``, which traces, compiles and lints without executing.  Run from
the repository root (a minute or so)::

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/analyze_reference.py

The script forces four host devices before jax starts; ``--only NAME``
prints one entry as JSON instead of writing the file.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "analyze_reference.json")
#: the three specs, as ``RunSpec.from_dict`` takes them
SPECS = {
    "serve": {"arch": "yi-6b", "workload": "serve", "mesh": "1x1", "smoke": True,
              "batch": 2, "seq": 32, "precision": {"weights": 7, "lazy": True}},
    "train": {"arch": "yi-6b", "workload": "train", "mesh": "4x1", "smoke": True,
              "batch": 1, "seq": 16, "precision": {"comm": 8}},
    "mamba": {"arch": "mamba2-780m", "workload": "train", "mesh": "1x1", "smoke": True,
              "batch": 1, "seq": 16},
}
#: the proof fields held to the port's (``where`` is a file:line and drifts)
PROOF_FIELDS = ("kind", "dtype", "n", "bound", "worst_sum", "capacity", "headroom_bits",
                "ok", "key")


def entry(findings, proofs) -> dict:
    """The fixture's record of one analysis."""
    return {
        "findings": sorted({f"{f.rule}|{f.key}|{f.cell}": f.severity
                            for f in findings}.items()),
        "proofs": sorted(({k: p.get(k) for k in PROOF_FIELDS} for p in proofs),
                         key=lambda p: json.dumps(p, sort_keys=True)),
    }


def run(name: str) -> dict:
    import repro  # noqa: F401  (installs the jax compat shims)
    from repro.api.session import Session
    from repro.api.spec import RunSpec

    proofs: list = []
    findings = Session(RunSpec.from_dict(SPECS[name])).analyze(
        compile=True, allowlist=None, proofs=proofs)
    return entry(findings, proofs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="", help="print this entry as JSON, write nothing")
    args = ap.parse_args(argv)
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = f"{flags} --xla_force_host_platform_device_count=4".strip()
    if args.only:
        print(json.dumps(run(args.only), sort_keys=True))
        return 0
    doc = {"specs": SPECS, "entries": {name: run(name) for name in SPECS}}
    with open(FIXTURE, "w") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")
    print(f"wrote {FIXTURE}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
