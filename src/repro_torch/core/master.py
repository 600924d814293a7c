"""GBD master problem (paper Eq. 43-46): integer bit-width selection.

Bit-widths are one-hot encoded: ``x[i, b] = 1`` iff device ``i`` uses
``bits_options[b]``.  Everything the master sees is then *linear* in ``x``:

    q_i          = sum_b  bits_b          x[i,b]
    delta_i^2    = sum_b  (s/(2^b - 1))^2 x[i,b]
    memory (25)  : x[i,b] = 0 whenever c3(b) * U_i > C_i   (variable fixing)
    error  (23)  : sum_i delta_i^2 <= budget
    optimality cuts (44):  phi >= c0_k + g_k . q
    feasibility cuts (45): g_k . q <= rhs_k

Solved exactly with scipy's HiGHS MILP; a marginal-cost greedy provides both a
warm start and a fallback if the solver is unavailable.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.convergence import quant_noise


@dataclasses.dataclass
class MasterSpec:
    bits_options: tuple[int, ...]        # e.g. (8, 16, 32)
    n_devices: int
    error_budget: float                  # sum_i delta_i^2 <= budget  (Eq. 23)
    mem_capacity_bytes: np.ndarray       # (N,) C_i
    model_bytes_fp: float                # U_i (same model for all devices)
    weight_scale: float = 1.0            # s in delta_i = s/(2^q - 1)

    def allowed(self) -> np.ndarray:
        """(N, B) bool mask of memory-feasible options (constraint 25)."""
        bits = np.asarray(self.bits_options, np.float64)
        need = bits / 32.0 * self.model_bytes_fp           # c3(q) * U_i
        return need[None, :] <= self.mem_capacity_bytes[:, None] + 1e-9

    def delta_sq(self) -> np.ndarray:
        """(B,) quantization-noise squares per option."""
        return quant_noise(self.bits_options, self.weight_scale) ** 2


@dataclasses.dataclass
class Cut:
    kind: str              # "opt" | "feas"
    c0: float              # opt: phi >= c0 + g.q    feas: g.q <= c0
    grad: np.ndarray       # (N,)


@dataclasses.dataclass
class MasterSolution:
    status: str
    q: np.ndarray | None
    phi: float             # lower bound (valid when status == "ok")


def _validate(spec: MasterSpec) -> None:
    allowed = spec.allowed()
    if not allowed.any(axis=1).all():
        bad = np.where(~allowed.any(axis=1))[0]
        raise ValueError(f"devices {bad} cannot store the model at any bit-width")


def solve_master_milp(spec: MasterSpec, cuts: Sequence[Cut]) -> MasterSolution:
    """Exact master via scipy.optimize.milp (HiGHS branch-and-bound)."""
    from scipy.optimize import Bounds, LinearConstraint, milp

    _validate(spec)
    N, B = spec.n_devices, len(spec.bits_options)
    nx = N * B
    bits = np.asarray(spec.bits_options, np.float64)
    # variables: [x (N*B), phi]
    c = np.zeros(nx + 1)
    c[-1] = 1.0

    lb = np.zeros(nx + 1)
    ub = np.ones(nx + 1)
    allowed = spec.allowed().ravel()
    ub[:nx] = np.where(allowed, 1.0, 0.0)     # memory fixing (Eq. 25)
    lb[-1], ub[-1] = 0.0, np.inf              # phi >= 0 keeps LB finite pre-cuts

    constraints = []
    # one-hot: sum_b x[i,b] == 1
    A = np.zeros((N, nx + 1))
    for i in range(N):
        A[i, i * B : (i + 1) * B] = 1.0
    constraints.append(LinearConstraint(A, 1.0, 1.0))
    # error budget (Eq. 23)
    row = np.zeros((1, nx + 1))
    row[0, :nx] = np.tile(spec.delta_sq(), N)
    constraints.append(LinearConstraint(row, -np.inf, spec.error_budget))
    # Benders cuts (q_i = sum_b bits_b x[i,b])
    for cut in cuts:
        row = np.zeros((1, nx + 1))
        per_dev = cut.grad[:, None] * bits[None, :]       # (N, B)
        row[0, :nx] = per_dev.ravel()
        if cut.kind == "opt":
            row[0, -1] = -1.0                              # g.q - phi <= -c0
            constraints.append(LinearConstraint(row, -np.inf, -cut.c0))
        else:                                              # feas: g.q <= c0
            constraints.append(LinearConstraint(row, -np.inf, cut.c0))

    integrality = np.concatenate([np.ones(nx), np.zeros(1)])
    res = milp(c=c, constraints=constraints, integrality=integrality,
               bounds=Bounds(lb, ub))
    if res.status != 0 or res.x is None:
        return MasterSolution(status="infeasible" if res.status == 2 else "failed",
                              q=None, phi=np.inf)
    x = res.x[:nx].reshape(N, B)
    q = bits[np.argmax(x, axis=1)].astype(int)
    return MasterSolution(status="ok", q=q, phi=float(res.x[-1]))


def solve_master_greedy(spec: MasterSpec, cuts: Sequence[Cut]) -> MasterSolution:
    """Fallback/warm-start heuristic.

    Start every device at its smallest memory-feasible bit-width (cheapest
    compute); raise bit-widths by steepest error-reduction per unit cut-cost
    until the error budget (23) holds; evaluate phi as the max over optimality
    cuts; reject if any feasibility cut is violated (then raise offenders).
    """
    _validate(spec)
    N = spec.n_devices
    bits = np.asarray(spec.bits_options)
    allowed = spec.allowed()
    dsq = spec.delta_sq()

    idx = np.array([np.flatnonzero(allowed[i])[0] for i in range(N)])

    def total_err(ix):
        return float(np.sum(dsq[ix]))

    guard = 0
    while total_err(idx) > spec.error_budget and guard < 32 * N:
        guard += 1
        best, best_gain = None, -np.inf
        for i in range(N):
            nxt = idx[i] + 1
            while nxt < len(bits) and not allowed[i, nxt]:
                nxt += 1
            if nxt >= len(bits):
                continue
            gain = dsq[idx[i]] - dsq[nxt]
            if gain > best_gain:
                best, best_gain = (i, nxt), gain
        if best is None:
            return MasterSolution(status="infeasible", q=None, phi=np.inf)
        idx[best[0]] = best[1]

    # enforce feasibility cuts by raising... (cuts have positive grads in q ->
    # raising q makes them *worse*; instead lower q where possible)
    q = bits[idx].astype(float)
    for cut in cuts:
        if cut.kind != "feas":
            continue
        guard = 0
        while float(cut.grad @ q) > cut.c0 and guard < 32 * N:
            guard += 1
            order = np.argsort(-cut.grad * q)  # biggest contributor first
            moved = False
            for i in order:
                prev = idx[i] - 1
                while prev >= 0 and not allowed[i, prev]:
                    prev -= 1
                if prev < 0:
                    continue
                trial = idx.copy()
                trial[i] = prev
                if total_err(trial) <= spec.error_budget:
                    idx = trial
                    q = bits[idx].astype(float)
                    moved = True
                    break
            if not moved:
                return MasterSolution(status="infeasible", q=None, phi=np.inf)

    phi = 0.0
    for cut in cuts:
        if cut.kind == "opt":
            phi = max(phi, cut.c0 + float(cut.grad @ q))
    return MasterSolution(status="ok", q=bits[idx].astype(int), phi=phi)


def solve_master(spec: MasterSpec, cuts: Sequence[Cut], *, use_milp: bool = True) -> MasterSolution:
    if use_milp:
        try:
            sol = solve_master_milp(spec, cuts)
            if sol.status != "failed":
                return sol
        except Exception:  # pragma: no cover - scipy missing / HiGHS failure
            pass
    return solve_master_greedy(spec, cuts)
