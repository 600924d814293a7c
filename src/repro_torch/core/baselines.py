"""Comparison schemes from the paper's evaluation (§5.1-3).

* **Full Precision** — every device computes at 32 bits; only the bandwidth
  allocation is optimized (the primal with q = 32).
* **Unified Q**      — one common bit-width for all devices (paper uses 16),
  regardless of per-device budgets; bandwidth optimized by the primal.
* **Rand Q**         — each device draws a random memory-feasible bit-width,
  ignoring the learning-performance constraint (23); bandwidth optimized.

Each returns the same structure as :func:`repro_torch.core.gbd.run_gbd` so the
benchmarks can compare energy like-for-like (paper Fig. 2-4).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.gbd import GBDResult
from repro_torch.core.master import MasterSpec
from repro_torch.core.primal import PrimalData, solve_primal


def _finish(data: PrimalData, q: np.ndarray, name: str) -> GBDResult:
    sol = solve_primal(data, q)
    if not sol.feasible:
        return GBDResult(q=q, bandwidth=None, t_rounds=None, energy=np.inf,
                         lower_bound=np.inf, gap=0.0, iterations=1,
                         converged=False, trace=[{"scheme": name, "feasible": False}])
    return GBDResult(q=q, bandwidth=sol.bandwidth, t_rounds=sol.t_rounds,
                     energy=sol.value, lower_bound=sol.value, gap=0.0,
                     iterations=1, converged=True,
                     trace=[{"scheme": name, "feasible": True}])


def full_precision(data: PrimalData, spec: MasterSpec) -> GBDResult:
    q = np.full(spec.n_devices, 32, dtype=int)
    return _finish(data, q, "full_precision")


def unified_q(data: PrimalData, spec: MasterSpec, bits: int = 16) -> GBDResult:
    if bits not in spec.bits_options:
        raise ValueError(f"bits={bits} not in {spec.bits_options}")
    q = np.full(spec.n_devices, bits, dtype=int)
    return _finish(data, q, f"unified_q{bits}")


def rand_q(data: PrimalData, spec: MasterSpec, *, seed: int = 0) -> GBDResult:
    rng = np.random.default_rng(seed)
    allowed = spec.allowed()
    bits = np.asarray(spec.bits_options)
    q = np.array([int(rng.choice(bits[allowed[i]])) for i in range(spec.n_devices)])
    return _finish(data, q, "rand_q")


SCHEMES = {
    "full_precision": full_precision,
    "unified_q": unified_q,
    "rand_q": rand_q,
}
