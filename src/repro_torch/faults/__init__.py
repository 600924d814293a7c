"""Deterministic fault injection + resilient round execution for FL runs."""

from repro_torch.faults.executor import (
    TransmissionOutcome,
    UpdateFaults,
    gate_mask,
    inject_corruption,
    transmit_update,
)
from repro_torch.faults.plan import FaultPlan, FaultSchedule, RoundFaults

__all__ = [
    "FaultPlan",
    "FaultSchedule",
    "RoundFaults",
    "TransmissionOutcome",
    "UpdateFaults",
    "gate_mask",
    "inject_corruption",
    "transmit_update",
]
