"""Static precision / wire lint: the analytic half.

Ported so far (the modules the sweep report needs):

* :mod:`repro_torch.analyze.findings` — the :class:`Finding` record every
  rule family returns.
* :mod:`repro_torch.analyze.static_proofs` — closed-form, spec-level proofs
  (pure host arithmetic): the SR wire's integer accumulator holds its
  worst-case code sum, and the policy's quantization error fits the
  convergence-bound budget GBD optimizes against.

The graph half of the reference's ``analyze/`` — the abstract interpreter
and value ranges (``absint``, ``ranges``), precision-flow taint, the wire
lint, the kernel launch-grid check, the allowlist, the baseline gate and the
CLI — is ROADMAP item 13.
"""

from repro_torch.analyze.findings import Finding, at_or_above, worst_severity
from repro_torch.analyze.static_proofs import (
    check_error_budget,
    overflow_margin_table,
    prove_spec,
    prove_wire_accumulator,
)

__all__ = ["Finding", "at_or_above", "check_error_budget", "overflow_margin_table",
           "prove_spec", "prove_wire_accumulator", "worst_severity"]
