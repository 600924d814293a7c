"""Static precision / wire / kernel / value-range lint over traced steps.

Five rule families, none of which execute the step:

* ``precision.*`` (:mod:`repro_torch.analyze.precision_flow`,
  :mod:`repro_torch.analyze.static_proofs`) — walks a traced step's
  operation graph (``roofline.count.recording(graph=True)``) tracking which
  matmuls consume QTensor codes that were eagerly dequantized instead of
  riding K3 (``quant_matmul`` / ``expert_dispatch``), and certifies the
  error budget: the quantization error the policy's bits imply must fit the
  convergence-bound term GBD optimizes against.
* ``overflow.*`` / ``numerics.*`` (:mod:`repro_torch.analyze.absint`,
  :mod:`repro_torch.analyze.ranges`) — a forward interval interpreter over
  the same graph, propagating value intervals, integer exactness and
  quantization-error bounds (K2's codes lie in ``[-lim, lim]`` by the
  kernel's contract): proves every integer all-reduce accumulator holds its
  worst-case code sum (recording headroom), and flags exp/log/div/rsqrt
  consuming unguarded zero-crossing or unbounded intervals.
  :mod:`repro_torch.analyze.static_proofs` adds the closed-form per-cell
  complement (works for ``fl-sim`` cells with no graph).
* ``wire.*`` (:mod:`repro_torch.analyze.wire_lint`) — reads the
  per-collective records (``count.CollectiveOp``) a traced step keeps and
  flags f32 all-reduces under a low-bit ``PrecisionPolicy.comm``,
  mis-sized integer wire dtypes (all-reduce and reduce-scatter), unmodeled
  collectives, all-gathers the sharding rules don't predict, and drift
  against ``Session.comm_report()``.
* ``kernel.*`` (:mod:`repro_torch.analyze.kernel_check`) — enumerates every
  K3-K5 launch grid from the :class:`repro_torch.kernels.spec.KernelSpec`
  metadata the launchers export from their own plans (coverage,
  out-of-bounds tiles, shared-memory regions against the launch's request)
  and range-checks scalar operands (page-table entries within the pool,
  lengths within the owned pages).

Front doors: ``Session.analyze()``, ``python -m repro_torch analyze``
(:mod:`repro_torch.analyze.cli`), the ``analyze_torch.toml`` allowlist for
the known-legitimate exceptions (stale entries surface as
``meta.dead_allowlist``), and the differential baseline gate
(:mod:`repro_torch.analyze.baseline`, ``results/torch/analyze_baseline.json``).
Counterpart of ``repro/analyze``.
"""

from repro_torch.analyze.absint import abstract_eval, interpret_jaxpr
from repro_torch.analyze.allowlist import (
    apply_allowlist,
    dead_allowlist_findings,
    dead_entries,
    load_allowlist,
)
from repro_torch.analyze.baseline import (
    diff_against_baseline,
    finding_identity,
    load_baseline,
    write_baseline,
)
from repro_torch.analyze.findings import Finding, at_or_above, source_key, worst_severity
from repro_torch.analyze.kernel_check import check_kernel_spec, shipped_kernel_specs
from repro_torch.analyze.precision_flow import lint_jaxpr
from repro_torch.analyze.ranges import AbsVal
from repro_torch.analyze.runner import ALL_RULE_FAMILIES, analyze_session
from repro_torch.analyze.static_proofs import (
    check_error_budget,
    overflow_margin_table,
    prove_spec,
    prove_wire_accumulator,
)
from repro_torch.analyze.wire_lint import WireContext, check_comm_report, lint_module

__all__ = [
    "ALL_RULE_FAMILIES", "AbsVal", "Finding", "WireContext", "abstract_eval",
    "analyze_session", "apply_allowlist", "at_or_above", "check_comm_report",
    "check_error_budget", "check_kernel_spec", "dead_allowlist_findings",
    "dead_entries", "diff_against_baseline", "finding_identity",
    "interpret_jaxpr", "lint_jaxpr", "lint_module", "load_allowlist",
    "load_baseline", "overflow_margin_table", "prove_spec",
    "prove_wire_accumulator", "shipped_kernel_specs", "source_key",
    "worst_severity", "write_baseline",
]
