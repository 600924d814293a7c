"""GBD primal problem: optimal bandwidth allocation for fixed bit-widths.

For a fixed integer assignment ``q`` the remaining problem (paper Eq. 32-34)

    v(q) = min_{B, T}  sum_r sum_i  alpha1_{i,r} / B_{i,r}   (+ const comp energy)
           s.t.  sum_i B_{i,r} <= B_max                      for every round r
                 alpha2_{i,r} / B_{i,r} <= T_r - a_i(q)      for every i, r
                 sum_r T_r <= T_max,   B > 0

with ``a_i(q) = beta1_i + beta2_i q_i`` (compute time) is convex.  We solve it
by a three-level dual decomposition, each level a monotone bisection,
vectorized across rounds:

  * inner  (omega1_r):  per-round water-filling
        B_{i,r}(w1) = max(Bmin_{i,r}, sqrt(alpha1_{i,r}/w1)),
        Bmin_{i,r} = alpha2_{i,r}/(t_r - a_i); bisect w1 so sum_i B = B_max.
        (The objective strictly decreases in B so (24) is always active.)
  * middle (t_r): round latency; by the envelope theorem
        dE_r/dt = -sum_i omega2_{i,r}   with
        omega2_{i,r} = max(0, w1_r B^2 - alpha1)/alpha2  (KKT stationarity),
        bisect t_r so that sum_i omega2_{i,r}(t_r) = omega3.
  * outer  (omega3): bisect so sum_r t_r = T_max (Eq. 27 is always active
        because energy strictly decreases in every t_r).

Feasibility of q: the minimum achievable round time t_r^min solves
``sum_i alpha2_{i,r}/(t - a_i) = B_max``; the instance is feasible iff
``sum_r t_r^min <= T_max``.  ``t^min`` is the partial minimization of ``t``
over the convex set {(t,a): sum_i alpha2_i/(t-a_i) <= B_max}, hence convex in
``a`` (and in q, which enters affinely); its supporting hyperplane is the
feasibility cut returned to the Benders master (the specialization of
Geoffrion's L2 cut, Eq. 41-42).

All math is numpy (host-side); the trainer is never blocked on this.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_BISECT_ITERS = 60


@dataclasses.dataclass(frozen=True)
class PrimalData:
    """Per-instance coefficients.  Shapes: (R, N) unless noted."""

    alpha1: np.ndarray      # J * Hz   (comm energy numerator, Eq. 30)
    alpha2: np.ndarray      # s * Hz   (comm time numerator)
    beta1: np.ndarray       # (N,) s   compute-time intercept
    beta2: np.ndarray       # (N,) s/bit
    p_comp: np.ndarray      # (N,) W   GPU runtime power (Eq. 16)
    b_max: float            # Hz
    t_max: float            # s  total training deadline

    @property
    def n_rounds(self) -> int:
        return self.alpha1.shape[0]

    @property
    def n_devices(self) -> int:
        return self.alpha1.shape[1]

    def comp_times(self, q: np.ndarray) -> np.ndarray:
        """a_i(q) = beta1 + beta2 q  (N,)."""
        return self.beta1 + self.beta2 * np.asarray(q, np.float64)

    def comp_energy(self, q: np.ndarray) -> float:
        """Total compute energy over the horizon (constant w.r.t. B)."""
        return float(self.n_rounds * np.sum(self.p_comp * self.comp_times(q)))


@dataclasses.dataclass
class PrimalSolution:
    feasible: bool
    value: float                 # v(q): total energy (comm + comp), J
    comm_energy: float
    comp_energy: float
    bandwidth: np.ndarray | None  # (R, N) Hz
    t_rounds: np.ndarray | None   # (R,) s
    omega1: np.ndarray | None     # (R,)
    omega2: np.ndarray | None     # (R, N)
    omega3: float
    # Feasibility-cut data (valid when feasible=False):
    tmin_total: float = np.inf
    tmin_grad_q: np.ndarray | None = None  # (N,) d(sum_r t_r^min)/d q_i


def _waterfill(alpha1_r, bmin_r, b_max):
    """Per-round bandwidth water-filling, vectorized over rounds.

    alpha1_r, bmin_r: (R, N).  Returns (B, omega1): (R,N), (R,).
    Assumes sum_i bmin < b_max (feasible)."""
    # Numerical safety: if sum bmin marginally exceeds b_max (bisection
    # tolerance at t ~= t_min), scale bmin down to fit — the latency slack
    # this introduces is O(bisection tolerance).
    over = bmin_r.sum(axis=1) / b_max
    bmin_r = np.where(over[:, None] > 1.0, bmin_r / over[:, None] * (1 - 1e-12), bmin_r)
    # omega1 bounds: B(w1)=max(bmin, sqrt(a1/w1)); sum B decreasing in w1.
    hi = np.max(alpha1_r / np.maximum(bmin_r, 1e-30) ** 2, axis=1)  # all at bmin
    lo = np.full_like(hi, 1e-30)
    for _ in range(_BISECT_ITERS):
        mid = np.sqrt(lo * hi)  # log-space bisection
        B = np.maximum(bmin_r, np.sqrt(alpha1_r / mid[:, None]))
        too_big = B.sum(axis=1) > b_max
        lo = np.where(too_big, mid, lo)
        hi = np.where(too_big, hi, mid)
    omega1 = np.sqrt(lo * hi)
    B = np.maximum(bmin_r, np.sqrt(alpha1_r / omega1[:, None]))
    # Renormalize tiny slack onto unconstrained devices for exactness.
    free = B > bmin_r * (1 + 1e-9)
    slack = b_max - B.sum(axis=1)
    nfree = np.maximum(free.sum(axis=1), 1)
    B = B + free * (slack / nfree)[:, None]
    B = np.maximum(B, bmin_r)
    return B, omega1


def _round_tmin(alpha2, a, b_max):
    """t_r^min: root of sum_i alpha2_i/(t - a_i) = b_max, vectorized (R,N)->(R,)."""
    lo = np.max(a) + 1e-12 + np.zeros(alpha2.shape[0])
    hi = np.max(a) + np.sum(alpha2, axis=1) / b_max + 1e-9  # generous upper bound
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        need = np.sum(alpha2 / (mid[:, None] - a[None, :]), axis=1)
        lo = np.where(need > b_max, mid, lo)
        hi = np.where(need > b_max, hi, mid)
    return 0.5 * (lo + hi)


def _tmin_gradient(alpha2, a, tmin, beta2):
    """d(t_r^min)/dq_i summed over rounds — supporting hyperplane coefficients.

    Implicit differentiation of sum_i alpha2_i/(t - a_i) = B_max:
      dt/da_i = [alpha2_i/(t-a_i)^2] / sum_j [alpha2_j/(t-a_j)^2];  da_i/dq_i = beta2_i.
    """
    gap = tmin[:, None] - a[None, :]
    wgt = alpha2 / np.maximum(gap, 1e-30) ** 2
    dt_da = wgt / wgt.sum(axis=1, keepdims=True)
    return (dt_da * beta2[None, :]).sum(axis=0)


def _omega2(alpha1, alpha2, B, omega1):
    """KKT: omega2 = max(0, omega1 B^2 - alpha1)/alpha2 (binding devices)."""
    return np.maximum(0.0, omega1[:, None] * B**2 - alpha1) / alpha2


def solve_primal(data: PrimalData, q: np.ndarray) -> PrimalSolution:
    """Solve Eq. (32)-(34) for fixed q.  Returns solution + Benders data."""
    q = np.asarray(q, np.float64)
    a = data.comp_times(q)                    # (N,)
    comp_e = data.comp_energy(q)
    R = data.n_rounds

    tmin = _round_tmin(data.alpha2, a, data.b_max)        # (R,)
    tmin_total = float(tmin.sum())
    if tmin_total > data.t_max:
        return PrimalSolution(
            feasible=False, value=np.inf, comm_energy=np.inf, comp_energy=comp_e,
            bandwidth=None, t_rounds=None, omega1=None, omega2=None, omega3=0.0,
            tmin_total=tmin_total,
            tmin_grad_q=_tmin_gradient(data.alpha2, a, tmin, data.beta2),
        )

    def solve_rounds_at(omega3: float):
        """For multiplier omega3, find t_r with sum_i omega2(t_r) = omega3."""
        lo = tmin * (1 + 1e-9)
        # upper bound: with t huge, omega2 -> 0.
        hi = tmin + data.t_max  # generous
        for _ in range(_BISECT_ITERS):
            mid = 0.5 * (lo + hi)
            bmin = data.alpha2 / np.maximum(mid[:, None] - a[None, :], 1e-30)
            B, w1 = _waterfill(data.alpha1, bmin, data.b_max)
            w2sum = _omega2(data.alpha1, data.alpha2, B, w1).sum(axis=1)
            # sum omega2 decreases in t; want it == omega3.
            lo = np.where(w2sum > omega3, mid, lo)
            hi = np.where(w2sum > omega3, hi, mid)
        t = 0.5 * (lo + hi)
        bmin = data.alpha2 / np.maximum(t[:, None] - a[None, :], 1e-30)
        B, w1 = _waterfill(data.alpha1, bmin, data.b_max)
        return t, B, w1

    # Outer bisection on omega3 >= 0 so that sum_r t_r = T_max.
    w3_lo, w3_hi = 0.0, 1.0
    for _ in range(80):  # grow hi until sum t <= T_max
        t, _, _ = solve_rounds_at(w3_hi)
        if t.sum() <= data.t_max:
            break
        w3_hi *= 8.0
    for _ in range(_BISECT_ITERS):
        w3_mid = 0.5 * (w3_lo + w3_hi)
        t, _, _ = solve_rounds_at(w3_mid)
        if t.sum() > data.t_max:
            w3_lo = w3_mid
        else:
            w3_hi = w3_mid
    # Use the feasible side (sum t <= T_max) and hand the residual slack out
    # additively: growing any t_r preserves feasibility (t_r stays >= t_r^min)
    # and can only reduce energy.  Multiplicative rescaling is NOT safe — it
    # can push a near-minimum round below t^min and blow the band budget.
    omega3 = w3_hi
    t, B, w1 = solve_rounds_at(omega3)
    t = t + (data.t_max - t.sum()) / R
    bmin = data.alpha2 / np.maximum(t[:, None] - a[None, :], 1e-30)
    B, w1 = _waterfill(data.alpha1, bmin, data.b_max)
    w2 = _omega2(data.alpha1, data.alpha2, B, w1)

    comm_e = float(np.sum(data.alpha1 / B))
    return PrimalSolution(
        feasible=True, value=comm_e + comp_e, comm_energy=comm_e,
        comp_energy=comp_e, bandwidth=B, t_rounds=t, omega1=w1, omega2=w2,
        omega3=omega3, tmin_total=tmin_total,
        tmin_grad_q=_tmin_gradient(data.alpha2, a, tmin, data.beta2),
    )


def optimality_cut(data: PrimalData, q_bar: np.ndarray, sol: PrimalSolution):
    """phi >= c0 + g . q   from the Lagrangian (Eq. 35, linear in q).

    L1(q) = v(q_bar) + sum_i beta2_i (R p_i - sum_r omega2_{i,r}) (q_i - q_bar_i)
    """
    q_bar = np.asarray(q_bar, np.float64)
    grad = data.beta2 * (data.n_rounds * data.p_comp - sol.omega2.sum(axis=0))
    c0 = sol.value - float(grad @ q_bar)
    return c0, grad


def feasibility_cut(data: PrimalData, q_bar: np.ndarray, sol: PrimalSolution):
    """sum_r t_r^min(q) <= T_max linearized at q_bar:  g . q <= rhs."""
    q_bar = np.asarray(q_bar, np.float64)
    g = sol.tmin_grad_q
    rhs = data.t_max - sol.tmin_total + float(g @ q_bar)
    return g, rhs


def solve_primal_slsqp(data: PrimalData, q: np.ndarray, x0: np.ndarray | None = None) -> float:
    """Cross-check of v(q) via scipy SLSQP (tests only; slow).

    SLSQP on this problem is sensitive to initialization; pass ``x0``
    (e.g. the fast solver's solution) to use it as a *polish* step.
    """
    from scipy.optimize import minimize

    R, N = data.alpha1.shape
    a = data.comp_times(q)
    tmin = _round_tmin(data.alpha2, a, data.b_max)
    if tmin.sum() > data.t_max:
        return np.inf
    if x0 is None:
        t0 = tmin + (data.t_max - tmin.sum()) / R
        b0 = np.maximum(data.alpha2 / (t0[:, None] - a[None, :]), data.b_max / (2 * N))
        b0 *= 0.98 * data.b_max / b0.sum(axis=1, keepdims=True)
        x0 = np.concatenate([b0.ravel(), t0])

    def unpack(x):
        return x[: R * N].reshape(R, N), x[R * N :]

    def obj(x):
        B, _ = unpack(x)
        return np.sum(data.alpha1 / B)

    cons = [
        {"type": "ineq", "fun": lambda x: data.b_max - unpack(x)[0].sum(axis=1)},
        {"type": "ineq",
         "fun": lambda x: (unpack(x)[1][:, None] - a[None, :]
                           - data.alpha2 / unpack(x)[0]).ravel()},
        {"type": "ineq", "fun": lambda x: data.t_max - unpack(x)[1].sum()},
    ]
    bounds = [(1e-3, None)] * (R * N) + [(1e-9, None)] * R
    res = minimize(obj, x0, method="SLSQP", bounds=bounds, constraints=cons,
                   options={"maxiter": 400, "ftol": 1e-12})
    return float(res.fun) + data.comp_energy(q)
