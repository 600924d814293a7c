"""Convergence bounds for FWQ federated learning (paper §3).

Implements the closed forms of Theorem 1 and Corollaries 1–2 so that

* the optimization layer can turn a learning-performance tolerance ``lambda``
  into the quantization-error budget of constraint (23),
* tests/benchmarks can compare the empirical average squared gradient norm
  against the theoretical envelope.

Notation (paper):
    L       gradient Lipschitz constant (Assumption 1)
    tau_i   per-device SGD variance bound (Assumption 2); tau = sum_i tau_i^2
    phi     cross-device gradient dissimilarity bound (Assumption 3)
    M       mini-batch size, N devices, R rounds, d model dimension
    delta_i = s * Delta_{q_i} = s / (2**q_i - 1)   quantization noise (Lemma 3)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class ProblemConstants:
    """Constants of Assumptions 1–3 plus run geometry."""

    L: float          # smoothness
    tau_sq: float     # sum_i tau_i^2  (Assumption 2, aggregated)
    phi: float        # Assumption 3
    M: int            # mini-batch size
    N: int            # number of participating devices
    d: int            # model dimension
    F0_minus_Fstar: float  # E[F(w^0)] - F*

    def validate(self) -> None:
        if min(self.L, self.tau_sq, self.M, self.N, self.d) < 0:
            raise ValueError("constants must be non-negative")


def quant_noise(bits: Sequence[int] | np.ndarray, scale: float | np.ndarray = 1.0) -> np.ndarray:
    """delta_i = s / (2**q_i - 1); q>=32 => 0 (full precision)."""
    bits = np.asarray(bits, dtype=np.float64)
    s = np.asarray(scale, dtype=np.float64)
    denom = np.exp2(np.minimum(bits, 31.0)) - 1.0
    return np.where(bits >= 32, 0.0, s / denom)


def corollary1_lr(c: ProblemConstants, R: int) -> float:
    """Learning rate of Corollary 1: eta = 1/(4L + sqrt(R tau/(MN)) + phi sqrt(R))."""
    return 1.0 / (4.0 * c.L + math.sqrt(R * c.tau_sq / (c.M * c.N)) + c.phi * math.sqrt(R))


def quantization_error_floor(c: ProblemConstants, delta: np.ndarray) -> float:
    """eps_q = (9 d L^2 / N) * sum_i delta_i^2 — the irreducible floor (Cor. 1/2)."""
    delta = np.asarray(delta, dtype=np.float64)
    return float(9.0 * c.d * c.L**2 / c.N * np.sum(delta**2))


def corollary1_bound(c: ProblemConstants, R: int, delta: np.ndarray) -> float:
    """RHS of Corollary 1: bound on (1/R) sum_r E||grad F(w^r)||^2."""
    c.validate()
    K = 4.0 * c.F0_minus_Fstar
    term_opt = 4.0 * c.L * K / R
    term_quant = quantization_error_floor(c, delta)
    term_var = (K + 4.0 * c.L) * math.sqrt(c.tau_sq) / math.sqrt(c.M * c.N * R)
    term_hetero = (K + 8.0 * c.L) * c.phi / math.sqrt(R)
    return term_opt + term_quant + term_var + term_hetero


def theorem1_H(c: ProblemConstants, eta: float, delta: np.ndarray) -> float:
    """Per-round slack H of Theorem 1 (Eq. 8)."""
    delta = np.asarray(delta, dtype=np.float64)
    t_quant = (eta * c.L**2 * c.d + 8.0 * eta**2 * c.L**3 * c.d) / (8.0 * c.N) * np.sum(delta**2)
    t_var = 2.0 * c.L * eta**2 * c.tau_sq / (c.M * c.N)
    t_het = 4.0 * c.L * eta**2 * c.phi**2
    return float(t_quant + t_var + t_het)


def theorem1_bound(c: ProblemConstants, eta: float, R: int, delta: np.ndarray) -> float:
    """Bound on (1/R) sum_r E||grad F||^2 from Theorem 1 for a given eta."""
    coeff = (eta - 2.0 * c.L * eta**2) / 2.0
    if coeff <= 0:
        raise ValueError("eta too large: eta - 2 L eta^2 must be positive")
    return (c.F0_minus_Fstar + R * theorem1_H(c, eta, delta)) / (coeff * R)


def corollary2_rounds(c: ProblemConstants, eps: float) -> int:
    """R_eps: rounds to reach (eps + eps_q)-accuracy (Cor. 2 exact root, Eq. 15).

    Solves  eps*sqrt(MNR) - (rho1 sqrt(tau) + rho2 phi sqrt(MN)) sqrt(R)
            - 4 L chi^2 sqrt(MN) = 0    for sqrt(R), taking chi^2 = 4(F0-F*).
    """
    chi_sq = 4.0 * c.F0_minus_Fstar
    rho1 = chi_sq + 4.0 * c.L
    rho2 = chi_sq + 8.0 * c.L
    mn = math.sqrt(c.M * c.N)
    # quadratic a x^2 - b x - c0 = 0 in x = sqrt(R)
    a = eps * mn
    b = rho1 * math.sqrt(c.tau_sq) + rho2 * c.phi * mn
    c0 = 4.0 * c.L * chi_sq * mn
    x = (b + math.sqrt(b * b + 4.0 * a * c0)) / (2.0 * a)
    return int(math.ceil(x * x))


def error_budget_bound(lam: float, e2: float, d: int, N: int) -> float:
    """Constraint (23) rearranged: sum_i delta_i^2 <= lam * N / (e2 * d)."""
    if lam <= 0 or e2 <= 0:
        raise ValueError("lambda and e2 must be positive")
    return lam * N / (e2 * d)


def feasible_bits_budget(
    bits_options: Sequence[int],
    N: int,
    budget_sum_delta_sq: float,
    scale: float = 1.0,
) -> bool:
    """Whether assigning the *largest* bit-width everywhere satisfies (23).

    Sanity helper for the optimizer: if even max-bits violates the budget the
    instance is infeasible.
    """
    dmax = quant_noise([max(bits_options)] * N, scale)
    return float(np.sum(dmax**2)) <= budget_sum_delta_sq


def estimate_constants_from_trace(
    grad_sq_norms: Sequence[float],
    losses: Sequence[float],
    d: int,
    M: int,
    N: int,
) -> ProblemConstants:
    """Crude empirical fit of (L, tau, phi) from a training trace.

    Used by benchmarks to anchor the theory curves to a real run; not part of
    the algorithm itself (the paper measures these offline as well).
    """
    losses = np.asarray(losses, np.float64)
    g = np.asarray(grad_sq_norms, np.float64)
    L = float(np.clip(np.max(g) / max(2.0 * (losses[0] - losses.min()), 1e-9), 1e-3, 1e3))
    tau_sq = float(np.var(g) + 1e-12) * N
    phi = float(np.sqrt(np.mean(np.abs(np.diff(g)))) + 1e-6)
    return ProblemConstants(
        L=L, tau_sq=tau_sq, phi=phi, M=M, N=N, d=d,
        F0_minus_Fstar=float(losses[0] - losses.min()),
    )
