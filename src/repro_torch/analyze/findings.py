"""The structured lint result type shared by every rule family."""

from __future__ import annotations

import dataclasses

SEVERITIES = ("error", "warn", "info")

_RANK = {s: i for i, s in enumerate(SEVERITIES)}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint result.

    ``key`` is the STABLE identity the allowlist matches against — built
    from file + function (``"layers.py:vocab_embed"``) or kernel + operand
    (``"quant_matmul:codes"``), never from line numbers.  ``where`` is the
    human-facing provenance (``file:line`` / instruction name) and may
    drift freely.
    """

    rule: str                     # "precision.eager_dequant", "wire.…", …
    severity: str                 # "error" | "warn" | "info"
    message: str
    key: str                      # allowlist identity
    where: str = ""               # file:line / instruction provenance
    cell: str = ""                # lint cell (workload x shape) it came from
    allowed: bool = False
    allow_reason: str = ""

    def __post_init__(self):
        assert self.severity in SEVERITIES, self.severity

    def format(self) -> str:
        mark = "ALLOWED " if self.allowed else ""
        cell = f"[{self.cell}] " if self.cell else ""
        where = f"  ({self.where})" if self.where else ""
        tail = f"  -- allowed: {self.allow_reason}" if self.allowed else ""
        return (f"{cell}{mark}{self.severity.upper():5s} {self.rule} "
                f"{self.key}: {self.message}{where}{tail}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def worst_severity(findings, *, include_allowed: bool = False) -> str | None:
    """Most severe unallowlisted severity present, or None."""
    worst = None
    for f in findings:
        if f.allowed and not include_allowed:
            continue
        if worst is None or _RANK[f.severity] < _RANK[worst]:
            worst = f.severity
    return worst


def at_or_above(findings, threshold: str):
    """Unallowlisted findings at/above a severity threshold."""
    cut = _RANK[threshold]
    return [f for f in findings
            if not f.allowed and _RANK[f.severity] <= cut]


def source_key(op) -> tuple[str, str]:
    """(allowlist key, provenance) of a traced operation (a
    :class:`~repro_torch.roofline.count.GraphOp`).

    Key is ``basename:function`` of the port function that ran it —
    stable across line drift; provenance is ``path:line``.  Both are
    ``"?"`` where no port frame was on the stack.  The reference's takes a
    jaxpr equation's ``source_info``.
    """
    return getattr(op, "key", "?"), getattr(op, "where", "?")
