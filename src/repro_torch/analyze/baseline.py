"""Differential findings gate: fail CI only on NEW unallowlisted findings.

A baseline is the committed snapshot of one full analyze run (the port's
is ``results/torch/analyze_baseline.json``; the reference's
``results/analyze_baseline.json`` is its own): the findings list plus the
identity set the differ matches against.  The file is byte-equal to what
the reference's ``write_baseline`` writes for the same findings.  A finding's identity is
``(rule, key, cell)`` — deliberately line-number-free (``where`` drifts
with every edit) so broadening a rule family or moving code does not churn
the gate; only a genuinely new (rule, site) pair does.

Workflow::

    python -m repro_torch analyze --preset ci-tiny \
        --write-baseline results/torch/analyze_baseline.json
    # commit the file; from then on
    python -m repro_torch analyze --preset ci-tiny \
        --baseline results/torch/analyze_baseline.json
    # exits non-zero iff an unallowlisted finding at --fail-on severity
    # exists that the baseline does not contain

Fixed findings age out silently (the differ never fails on disappearance);
refresh the snapshot with ``--write-baseline`` whenever the accepted set
shrinks so the file stays an honest record.
"""

from __future__ import annotations

import json


def finding_identity(f) -> tuple[str, str, str]:
    """The stable triple the differ matches on: (rule, key, cell)."""
    return (f.rule, f.key, f.cell)


def write_baseline(findings, path: str, extra_identities=()) -> dict:
    """Snapshot ``findings`` (allowlisted ones included, marked) to JSON.

    ``extra_identities`` unions in identities from a previous snapshot —
    the CLI passes the loaded ``--baseline`` set so a multi-invocation
    regeneration (ci-tiny with compile, then the heavy presets without)
    accumulates instead of clobbering.
    """
    idents = {"|".join(finding_identity(f)) for f in findings}
    idents |= {"|".join(i) for i in extra_identities}
    doc = {
        "version": 1,
        "identities": sorted(idents),
        "findings": [f.to_dict() for f in findings],
    }
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return doc


def load_baseline(path: str) -> set[tuple[str, str, str]]:
    """Identity set of a committed baseline file."""
    with open(path) as fh:
        doc = json.load(fh)
    out = set()
    for ident in doc.get("identities", []):
        parts = ident.split("|")
        if len(parts) == 3:
            out.add(tuple(parts))
    # tolerate hand-written baselines that only carry raw findings
    for f in doc.get("findings", []):
        out.add((f.get("rule", ""), f.get("key", ""), f.get("cell", "")))
    return out


def diff_against_baseline(findings, baseline: set) -> list:
    """Findings whose identity the baseline does not contain."""
    return [f for f in findings if finding_identity(f) not in baseline]
