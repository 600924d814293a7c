"""The ``analyze_torch.toml`` allowlist: known-legitimate findings, with reasons.

The port's allowlist has the format of the reference's ``analyze.toml``
(``repro/analyze/allowlist.py``), one ``[[allow]]`` table per entry::

    [[allow]]
    rule   = "precision.eager_dequant"     # fnmatch pattern over rule ids
    key    = "ops.py:expert_dispatch"      # fnmatch pattern over finding keys
    reason = "per-channel scale rows: the kernel's scalar-scale ABI …"

A finding is allowlisted when BOTH patterns match; it stays in the report
(flagged ``allowed``, with the reason) but no longer counts toward the
``--fail-on`` gate.  Entries without a reason are rejected: the file is
the audit trail for every deliberate fast-path exception.
"""

from __future__ import annotations

import dataclasses
import fnmatch


@dataclasses.dataclass(frozen=True)
class AllowEntry:
    rule: str
    key: str
    reason: str

    def matches(self, finding) -> bool:
        return (fnmatch.fnmatchcase(finding.rule, self.rule)
                and fnmatch.fnmatchcase(finding.key, self.key))


def load_allowlist(path) -> list[AllowEntry]:
    """Parse an allowlist file -> entries.  Missing file -> empty list."""
    import os

    if not path or not os.path.exists(path):
        return []
    try:
        import tomllib as toml                     # py311+
    except ImportError:                            # pragma: no cover
        try:
            import tomli as toml                   # the baked-in backport
        except ImportError as e:
            raise RuntimeError(
                f"cannot parse {path}: no tomllib/tomli in this "
                "environment") from e
    with open(path, "rb") as f:
        doc = toml.load(f)
    entries = []
    for i, raw in enumerate(doc.get("allow", [])):
        if not raw.get("reason"):
            raise ValueError(
                f"{path}: allow entry #{i + 1} ({raw.get('rule', '?')} / "
                f"{raw.get('key', '?')}) has no reason; every allowlisted "
                "fallback must say why it is legitimate")
        entries.append(AllowEntry(rule=str(raw.get("rule", "*")),
                                  key=str(raw.get("key", "*")),
                                  reason=str(raw["reason"])))
    return entries


def apply_allowlist(findings, entries):
    """Return findings with matching ones re-flagged as allowed."""
    if not entries:
        return list(findings)
    out = []
    for f in findings:
        hit = next((e for e in entries if e.matches(f)), None)
        if hit is not None and not f.allowed:
            f = dataclasses.replace(f, allowed=True, allow_reason=hit.reason)
        out.append(f)
    return out


def dead_entries(findings, entries) -> list[AllowEntry]:
    """Allowlist entries whose patterns matched zero findings.

    A dead entry means the code it excused moved or was fixed — the audit
    trail is stale.  Call over the FULL run's findings (all cells), never
    per cell: an entry is alive if ANY cell still triggers it.
    """
    return [e for e in entries
            if not any(e.matches(f) for f in findings)]


def dead_allowlist_findings(findings, entries, *, path: str = ""):
    """``meta.dead_allowlist`` warnings for :func:`dead_entries`."""
    from repro_torch.analyze.findings import Finding

    out = []
    for e in dead_entries(findings, entries):
        out.append(Finding(
            rule="meta.dead_allowlist", severity="warn",
            message=(f"allowlist entry (rule={e.rule!r}, key={e.key!r}) "
                     "matched no finding in this run — the exception it "
                     "excused is gone; delete the entry"
                     + (f" from {path}" if path else "")),
            key=f"allow:{e.rule}:{e.key}", where=path))
    return out
