"""Generalized Benders' Decomposition driver (paper Algorithm 2).

Couples the convex primal (:mod:`repro_torch.core.primal`) and the integer master
(:mod:`repro_torch.core.master`):

    repeat z = 1..Z_max:
        master  -> q^(z), phi^(z);   LB = phi^(z)
        primal(q^(z)):
            feasible   -> UB = min(UB, v(q)), add optimality cut
            infeasible -> add feasibility cut
    until UB - LB <= eps

The master's optimum is non-decreasing (cuts accumulate) and the primal gives
valid upper bounds, so the gap is monotone; with the finite bit-width lattice
termination is guaranteed (each master visit of a repeated q adds its exact
value cut).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable

import numpy as np

from repro_torch.core.master import Cut, MasterSpec, MasterSolution, solve_master
from repro_torch.core.primal import (
    PrimalData,
    PrimalSolution,
    feasibility_cut,
    optimality_cut,
    solve_primal,
)

log = logging.getLogger(__name__)


@dataclasses.dataclass
class GBDResult:
    q: np.ndarray                # chosen bit-widths (N,)
    bandwidth: np.ndarray        # (R, N) Hz
    t_rounds: np.ndarray         # (R,)
    energy: float                # total J (upper bound at termination)
    lower_bound: float
    gap: float
    iterations: int
    converged: bool
    trace: list                  # per-iteration dicts (UB, LB, q)


def run_gbd(
    data: PrimalData,
    spec: MasterSpec,
    *,
    eps: float = 1e-3,
    rel_eps: float = 1e-4,
    max_rounds: int = 50,
    use_milp: bool = True,
    q0: np.ndarray | None = None,
    on_iteration: Callable[[dict], None] | None = None,
) -> GBDResult:
    """Algorithm 2.  ``eps``/``rel_eps``: absolute/relative UB-LB stopping gap.

    ``q0`` warm-starts the decomposition from an incumbent bit assignment
    (e.g. the previous strategy when re-solving after channel drift): the
    first primal solve evaluates ``q0`` instead of the conservative max-bits
    seed, so a still-good incumbent converges in one or two cuts.
    """
    cuts: list[Cut] = []
    ub = np.inf
    lb = -np.inf
    best: tuple[np.ndarray, PrimalSolution] | None = None
    trace: list[dict] = []

    # Round 0: seed with the most conservative memory-feasible q (max bits)
    # so the master starts with at least one cut (paper: B^1 init).
    allowed = spec.allowed()
    bits = np.asarray(spec.bits_options)
    q = np.array([bits[np.flatnonzero(allowed[i])[-1]] for i in range(spec.n_devices)])
    if q0 is not None:
        q0 = np.asarray(q0)
        if q0.shape != (spec.n_devices,):
            raise ValueError(f"q0 must have shape ({spec.n_devices},), "
                             f"got {q0.shape}")
        # project the incumbent onto each device's memory-feasible lattice,
        # then accept it only if it also respects the error budget — the
        # master never proposes budget-violating points, so neither may the
        # warm seed (its primal value would be an invalid upper bound)
        qw = np.empty_like(q)
        ix = np.empty(spec.n_devices, dtype=int)
        for i in range(spec.n_devices):
            opts = np.flatnonzero(allowed[i])
            ix[i] = opts[np.argmin(np.abs(bits[opts] - q0[i]))]
            qw[i] = bits[ix[i]]
        if float(np.sum(spec.delta_sq()[ix])) <= spec.error_budget:
            q = qw

    z = 0
    converged = False
    for z in range(1, max_rounds + 1):
        sol = solve_primal(data, q)
        if sol.feasible:
            if sol.value < ub:
                ub = sol.value
                best = (q.copy(), sol)
            c0, grad = optimality_cut(data, q, sol)
            cuts.append(Cut(kind="opt", c0=c0, grad=grad))
        else:
            g, rhs = feasibility_cut(data, q, sol)
            cuts.append(Cut(kind="feas", c0=rhs, grad=g))

        ms: MasterSolution = solve_master(spec, cuts, use_milp=use_milp)
        if ms.status != "ok":
            log.warning("master %s at iter %d; stopping with UB=%s", ms.status, z, ub)
            break
        lb = max(lb, ms.phi)
        rec = {"iter": z, "ub": ub, "lb": lb, "q": q.copy(),
               "feasible": sol.feasible, "next_q": ms.q.copy()}
        trace.append(rec)
        if on_iteration:
            on_iteration(rec)
        gap = ub - lb
        if gap <= eps or (np.isfinite(ub) and gap <= rel_eps * abs(ub)):
            converged = True
            break
        if best is not None and np.array_equal(ms.q, q):
            # Master re-proposes the incumbent: its exact cut is already in,
            # so LB == UB on that point; we are done.
            converged = True
            break
        q = ms.q

    if best is None:
        raise RuntimeError("GBD found no feasible bit-width assignment "
                           "(deadline/bandwidth/error budget too tight)")
    q_best, sol_best = best
    return GBDResult(
        q=q_best,
        bandwidth=sol_best.bandwidth,
        t_rounds=sol_best.t_rounds,
        energy=ub,
        lower_bound=lb,
        gap=float(ub - lb),
        iterations=z,
        converged=converged,
        trace=trace,
    )


def exhaustive_best(data: PrimalData, spec: MasterSpec) -> tuple[np.ndarray, float]:
    """Brute-force optimum over the bit lattice (tests; exponential in N)."""
    import itertools

    allowed = spec.allowed()
    bits = np.asarray(spec.bits_options)
    dsq = spec.delta_sq()
    best_q, best_v = None, np.inf
    choices = [np.flatnonzero(allowed[i]) for i in range(spec.n_devices)]
    for combo in itertools.product(*choices):
        ix = np.array(combo)
        if float(np.sum(dsq[ix])) > spec.error_budget:
            continue
        q = bits[ix]
        sol = solve_primal(data, q)
        if sol.feasible and sol.value < best_v:
            best_q, best_v = q, sol.value
    if best_q is None:
        raise RuntimeError("no feasible assignment")
    return best_q, best_v
