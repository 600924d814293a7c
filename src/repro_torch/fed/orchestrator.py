"""FL round orchestrator: the paper's full control loop, production-shaped.

Per round r:
  1. channel realization  h_{i,r}  (block fading, :mod:`repro_torch.core.channel`)
  2. co-design            q, B <- GBD (or a baseline scheme) under the
     energy/latency/learning constraints (paper §4); strategies are re-solved
     every ``resolve_every`` rounds (gains are re-drawn each round, the
     optimizer horizon uses the measured gain window)
  3. cohort control       straggler deadline (Eq. 26): clients whose
     comp+comm time exceeds the round budget are dropped THIS round;
     random client failures (node loss) are masked the same way
  4. training             one FWQ round on the surviving cohort
  5. accounting           energy/latency bookkeeping per device
  6. persistence          checkpoint every k rounds (crash => the resumed
     run equals the uninterrupted one: all randomness is seeded from
     (seed, round), and the completed rounds' planning is replayed)

Elasticity: the cohort size may change between rounds (clients join/leave);
the simulator's round is sized by each round's batch and caches no shape.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable

import numpy as np

from repro_torch.api.precision import PrecisionPolicy
from repro_torch.api.program import Observation, PrecisionProgram, build_program
from repro_torch.ckpt import CheckpointManager
from repro_torch.core import baselines as baselines_mod
from repro_torch.core.channel import ChannelModel, gain_drift_db
from repro_torch.core.convergence import error_budget_bound
from repro_torch.core.energy import (
    CommParams,
    DeviceProfile,
    alpha_coefficients,
    reference_rate_bps,
)
from repro_torch.core.gbd import run_gbd
from repro_torch.core.master import MasterSpec
from repro_torch.core.primal import PrimalData
from repro_torch.faults import FaultPlan, UpdateFaults, transmit_update

log = logging.getLogger("repro_torch.fed")


@dataclasses.dataclass
class OrchestratorConfig:
    n_devices: int
    n_rounds: int
    scheme: str = "fwq"              # fwq | full_precision | unified_q | rand_q
    precision: PrecisionPolicy | None = None  # bit lattice + tensor roles
    unified_bits: int = 16
    b_max_hz: float = 20e6
    t_max_s: float = 0.0             # 0 => auto (t_factor x min feasible)
    t_factor: float = 1.5
    error_tolerance: float = 0.05    # lambda (constraint 23)
    e2: float = 9.0                  # big-O constant of eps_q
    model_dim_d: int = 1 << 20       # d in constraint (23)
    resolve_every: int = 5
    horizon: int = 4                 # rounds of gains per optimization
    dropout_prob: float = 0.0        # random client failure rate
    straggler_slack: float = 1.25    # per-round deadline = slack * planned T_r
    seed: int = 0
    ckpt_dir: str = ""
    ckpt_every: int = 25
    faults: FaultPlan | dict | None = None  # seeded fault injection plan
    resolve_drift_db: float = 0.0    # warm re-solve when measured gains drift
    #                                  past this (dB, 0 => disabled)
    program: "PrecisionProgram | dict | str | None" = None
    #                                  per-round precision controller
    #                                  (repro_torch.api.program); None = constant

    def __post_init__(self):
        if isinstance(self.faults, dict):
            self.faults = FaultPlan.from_dict(self.faults)
        if self.precision is None:
            self.precision = PrecisionPolicy()
        self.program = build_program(self.program)


class FLOrchestrator:
    def __init__(self, cfg: OrchestratorConfig, fleet: list[DeviceProfile],
                 mem_capacity_bytes: np.ndarray, grad_bytes: float,
                 weight_scale: float = 1.0):
        self.cfg = cfg
        self.fleet = fleet
        self.comm = CommParams(b_max_hz=cfg.b_max_hz, grad_bytes=grad_bytes)
        self.channel = ChannelModel(n_devices=cfg.n_devices, seed=cfg.seed)
        self.spec = MasterSpec(
            bits_options=cfg.precision.bit_options,
            n_devices=cfg.n_devices,
            error_budget=error_budget_bound(cfg.error_tolerance, cfg.e2,
                                            cfg.model_dim_d, cfg.n_devices),
            mem_capacity_bytes=mem_capacity_bytes,
            model_bytes_fp=4.0 * cfg.model_dim_d,
            weight_scale=weight_scale,
        )
        self._beta1 = np.array([d.beta1 for d in fleet])
        self._beta2 = np.array([d.beta2 for d in fleet])
        self._p_comp = np.array([d.runtime_power() for d in fleet])
        self._p_comm = np.array([d.p_comm for d in fleet])
        self._strategy: dict | None = None
        self.program: PrecisionProgram = cfg.program
        self.energy_log: list[dict] = []
        self._energy_cum = 0.0    # running sum of energy_log rounds: the
        #                           controller observation (O(1) per round,
        #                           rebuilt identically on resume replay)
        self.ckpt = (CheckpointManager(cfg.ckpt_dir, every=cfg.ckpt_every)
                     if cfg.ckpt_dir else None)
        self.faults = (cfg.faults.schedule(cfg.seed, cfg.n_devices)
                       if cfg.faults is not None and cfg.faults.active
                       else None)

    # ------------------------------------------------------------------
    def _primal_data(self, round_idx: int,
                     gains0: np.ndarray | None = None) -> PrimalData:
        gains = np.stack([self.channel.gains(round_idx + h)
                          for h in range(self.cfg.horizon)])
        if gains0 is not None:
            # re-solve against the *measured* (fault-faded) current gains;
            # future-horizon rounds keep the nominal channel prediction
            gains = gains.copy()
            gains[0] = gains0
        a1 = np.zeros_like(gains)
        a2 = np.zeros_like(gains)
        for r in range(self.cfg.horizon):
            a1[r], a2[r] = alpha_coefficients(gains[r], self._p_comm, self.comm)
        if self.cfg.t_max_s:
            t_max = self.cfg.t_max_s * self.cfg.horizon / max(self.cfg.n_rounds, 1)
        else:
            from repro_torch.core.primal import _round_tmin
            tmin = _round_tmin(a2, self._beta1 + 32 * self._beta2, self.cfg.b_max_hz)
            t_max = float(self.cfg.t_factor * tmin.sum())
        return PrimalData(alpha1=a1, alpha2=a2, beta1=self._beta1,
                          beta2=self._beta2, p_comp=self._p_comp,
                          b_max=self.cfg.b_max_hz, t_max=t_max)

    def resolve(self, round_idx: int, *, warm: bool = False,
                gains0: np.ndarray | None = None) -> dict:
        """(Re-)run the co-design and cache the strategy.

        ``warm=True`` seeds the GBD from the incumbent strategy's q — used
        for drift-triggered mid-cadence re-solves, where the previous
        assignment is usually near-optimal for the perturbed channel.
        """
        data = self._primal_data(round_idx, gains0)
        scheme = self.cfg.scheme
        if scheme == "fwq":
            q0 = (self._strategy["q"] if warm and self._strategy is not None
                  else None)
            res = run_gbd(data, self.spec, max_rounds=30, q0=q0)
        elif scheme == "full_precision":
            res = baselines_mod.full_precision(data, self.spec)
        elif scheme == "unified_q":
            res = baselines_mod.unified_q(data, self.spec, bits=self.cfg.unified_bits)
        elif scheme == "rand_q":
            res = baselines_mod.rand_q(data, self.spec, seed=self.cfg.seed + round_idx)
        else:
            raise ValueError(scheme)
        # The solver's chosen bits enter the stack ONLY as a PrecisionPolicy:
        # the same object the trainer's traced delta and the serving packer
        # consume (per-device heterogeneous weights role).
        policy = PrecisionPolicy.from_gbd(
            res, comm=self.cfg.precision.comm,
            kv_cache=self.cfg.precision.kv_cache,
            bit_options=self.cfg.precision.bit_options)
        self._strategy = {"policy": policy,
                          "q": policy.bits_vector(self.cfg.n_devices),
                          "bandwidth": res.bandwidth,
                          "t_rounds": res.t_rounds, "energy_plan": res.energy,
                          "resolved_at": round_idx,
                          "gains0": (gains0 if gains0 is not None
                                     else self.channel.gains(round_idx)),
                          "warm": bool(warm)}
        return self._strategy

    def observe(self, round_idx: int, drift: float = 0.0) -> Observation:
        """The measured state the precision program decides from."""
        last = self.energy_log[-1] if self.energy_log else None
        return Observation(
            round=round_idx, rounds_total=self.cfg.n_rounds,
            energy_cum_j=self._energy_cum,
            energy_round_j=float(last["energy_round"]) if last else 0.0,
            gain_drift_db=float(drift))

    # ------------------------------------------------------------------
    def plan_round(self, round_idx: int) -> dict:
        """Strategy + cohort survival for this round.

        Returns dict with q (bits), surviving cohort mask, per-device energy
        and the round latency (Eq. 26 bookkeeping).  With a fault plan
        active the round is *executed* against the realized faults: faded
        gains, throttled compute, and a per-client retransmission loop whose
        every attempt is billed real transmit energy.

        The proposed strategy (cadence / drift re-solved GBD or baseline)
        passes through ``cfg.program.policy_for_round`` before any energy is
        modeled, so an adaptive controller's bit clamps feed the same
        ``e_comp = p_comp (beta1 + beta2 q)`` bookkeeping the static path
        uses.  The default constant program returns the proposal unchanged.
        """
        rf = (self.faults.round_faults(round_idx)
              if self.faults is not None else None)
        gains = self.channel.gains(round_idx)
        eff_gains = gains * rf.fade_lin if rf is not None else gains

        drift = 0.0
        resolved = False
        if (self._strategy is None
                or round_idx - self._strategy["resolved_at"] >= self.cfg.resolve_every):
            # cadence re-solve: cold start, nominal gains (legacy behavior)
            self.resolve(round_idx,
                         gains0=eff_gains if rf is not None else None)
            resolved = True
        elif self.cfg.resolve_drift_db > 0 or self.program.uses_drift:
            drift = gain_drift_db(self._strategy["gains0"], eff_gains)
            legacy = (self.cfg.resolve_drift_db > 0
                      and drift > self.cfg.resolve_drift_db)
            if legacy or self.program.wants_resolve(
                    self.observe(round_idx, drift)):
                self.resolve(round_idx, warm=True, gains0=eff_gains)
                resolved = True
        st = self._strategy
        # the controller's round decision: clamp/keep the proposed policy
        policy = self.program.policy_for_round(
            round_idx, st["policy"], self.observe(round_idx, drift))
        q = (st["q"] if policy is st["policy"]
             else policy.bits_vector(self.cfg.n_devices))
        h = self._strategy["resolved_at"]
        B = st["bandwidth"][min(round_idx - h, st["bandwidth"].shape[0] - 1)]
        a1, a2 = alpha_coefficients(eff_gains, self._p_comm, self.comm)

        t_comp = self._beta1 + self._beta2 * q
        if rf is not None:
            t_comp = t_comp * rf.slow
        t_comm = a2 / B
        e_comp = self._p_comp * t_comp
        e_comm = a1 / B            # lossless planned optimum
        t_total = t_comp + t_comm

        planned = st["t_rounds"][min(round_idx - h, len(st["t_rounds"]) - 1)]
        deadline = self.cfg.straggler_slack * planned
        rng = np.random.default_rng((self.cfg.seed, round_idx, 77))
        alive = rng.random(self.cfg.n_devices) >= self.cfg.dropout_prob
        on_time = t_total <= deadline

        if rf is None:
            cohort = alive & on_time
            if not cohort.any():        # never lose the round entirely
                cohort = alive if alive.any() else np.ones_like(alive)
            rec = {
                "round": round_idx, "policy": policy,
                "q": q.copy(), "comm_bits": int(policy.comm),
                "bandwidth": B.copy(),
                "t_comp": t_comp, "t_comm": t_comm,
                "t_round": float(np.max(np.where(cohort, t_total, 0.0))),
                "e_comp": e_comp, "e_comm": e_comm,
                "energy_round": float(np.sum(np.where(cohort, e_comp + e_comm, 0.0))),
                "cohort": cohort, "n_stragglers": int((~on_time).sum()),
                "n_failed": int((~alive).sum()),
            }
        else:
            rec = self._execute_faulty_round(
                round_idx, rf, policy, q, B, eff_gains, alive, deadline,
                t_comp, t_comm, e_comp, e_comm, drift, resolved)
        self.energy_log.append(rec)
        self._energy_cum += rec["energy_round"]
        return rec

    def _execute_faulty_round(self, round_idx, rf, policy, q, B, eff_gains,
                              alive, deadline, t_comp, t_comm, e_comp,
                              e_comm, drift, resolved) -> dict:
        """Realize one round under faults: who delivers, and at what cost.

        Energy semantics: every *alive* client computes (mid-round dropout
        happens after local training), and every client that attempts the
        uplink pays for each transmission attempt — delivered or not.
        ``e_comm`` stays the lossless plan; ``e_comm_actual`` is the bill.
        """
        from repro_torch.dist.wire import wire_scale

        n = self.cfg.n_devices
        plan = self.faults.plan
        # the uplink carries the SR-compressed payload: comm demotion (an
        # adaptive program's lever) shrinks every retransmission attempt.
        # wire_scale is exactly 1.0 at comm=32, so static runs are untouched.
        payload_bits = (8.0 * self.comm.grad_bytes
                        * wire_scale(int(policy.comm), n))
        rate = reference_rate_bps(B, eff_gains, self._p_comm, self.comm)

        delivered = np.zeros(n, dtype=bool)
        e_comm_act = np.zeros(n)
        t_comm_act = np.zeros(n)
        attempts = np.zeros(n, dtype=int)
        retx = np.zeros(n, dtype=int)
        e_retx = np.zeros(n)
        uploads = alive & ~rf.drop
        for i in np.flatnonzero(uploads):
            out = transmit_update(
                payload_bits, float(rate[i]), float(self._p_comm[i]),
                rf.loss_prob, self.faults.chunk_rng(round_idx, i), plan,
                budget_s=max(0.0, deadline - float(t_comp[i])))
            delivered[i] = out.delivered
            e_comm_act[i] = out.e_comm_j
            t_comm_act[i] = out.t_comm_s
            attempts[i] = out.attempts
            retx[i] = out.retransmissions
            e_retx[i] = out.e_retx_j

        cohort = delivered
        forced = False
        if not cohort.any():
            # nobody made the deadline: rather than lose the round, extend
            # it for the best-effort cohort (energy already billed above)
            forced = True
            cohort = (uploads if uploads.any()
                      else (alive if alive.any() else np.ones(n, dtype=bool)))

        t_active = np.where(cohort, t_comp + t_comm_act, 0.0)
        # alive clients all burn compute (dropout strikes after training);
        # uplink attempts are billed whether or not they delivered
        billed = float(np.sum(np.where(alive, e_comp, 0.0)) + e_comm_act.sum())
        return {
            "round": round_idx, "policy": policy,
            "q": q.copy(), "comm_bits": int(policy.comm),
            "bandwidth": B.copy(),
            "t_comp": t_comp, "t_comm": t_comm,
            "t_round": float(np.max(t_active)) if t_active.size else 0.0,
            "e_comp": e_comp, "e_comm": e_comm,
            "e_comm_actual": e_comm_act,
            "energy_round": billed,
            "cohort": cohort,
            "n_stragglers": int((uploads & ~delivered).sum()),
            "n_failed": int((~alive).sum()),
            "dropped_midround": int((alive & rf.drop).sum()),
            "undelivered": int((uploads & ~delivered).sum()),
            "attempts": int(attempts.sum()),
            "retransmissions": int(retx.sum()),
            "retx_energy_j": float(e_retx.sum()),
            "corrupt_kind": rf.corrupt_kind.copy(),
            "fade_db": rf.fade_db.copy(),
            "drift_db": float(drift),
            "resolved": bool(resolved),
            "warm_resolve": bool(self._strategy.get("warm", False)),
            "forced_cohort": forced,
        }

    # ------------------------------------------------------------------
    def run(self, sim, batch_fn: Callable[[int, np.ndarray], dict],
            *, eval_fn: Callable | None = None, eval_every: int = 0) -> dict:
        """Drive ``sim`` (FLSimulation) for n_rounds with full bookkeeping."""
        start = 0
        plan_dict = (self.faults.plan.to_dict()
                     if self.faults is not None else None)
        if self.ckpt is not None:
            state, start, _ = self.ckpt.restore_or(
                sim.state(), expect_extra={"faults": plan_dict})
            if start:
                sim.load_state(state, start)
                log.info("resumed from round %d", start)
                # replay planning for the completed rounds: pure host math
                # (seeded solver cadence, fault realizations, energy log), so
                # the resumed run's strategy state and bookkeeping equal the
                # uninterrupted run's at round `start`
                for r in range(start):
                    self.plan_round(r)
        evals = []
        for r in range(start, self.cfg.n_rounds):
            plan = self.plan_round(r)
            cohort_idx = np.flatnonzero(plan["cohort"])
            batch = batch_fn(r, cohort_idx)
            # per-device bits reach the simulator only through the round's
            # PrecisionPolicy (built by PrecisionPolicy.from_gbd in resolve)
            bits = plan["policy"].bits_vector(self.cfg.n_devices)[cohort_idx]
            upd = None
            if self.faults is not None:
                upd = UpdateFaults(
                    kinds=plan["corrupt_kind"][cohort_idx],
                    rngs=tuple(self.faults.corrupt_rng(r, int(i))
                               for i in cohort_idx),
                    gate_factor=self.faults.plan.gate_norm_factor)
            # elastic cohort: the simulator round is sized by the batch
            rec = sim.run_round(batch, bits, faults=upd,
                                comm_bits=plan["comm_bits"])
            rec.update(energy=plan["energy_round"], t_round=plan["t_round"],
                       cohort_size=len(cohort_idx))
            if upd is not None:
                plan["n_rejected"] = rec.get("n_rejected", 0)
                rec.update(retransmissions=plan["retransmissions"],
                           retx_energy_j=plan["retx_energy_j"])
            if eval_fn is not None and eval_every and (r + 1) % eval_every == 0:
                evals.append({"round": r, **eval_fn(sim)})
            if self.ckpt is not None:
                self.ckpt.maybe_save(r + 1, sim.state(),
                                     extra={"round": r + 1, "faults": plan_dict})
        total_energy = float(sum(e["energy_round"] for e in self.energy_log))
        total_time = float(sum(e["t_round"] for e in self.energy_log))
        out = {"history": sim.history, "energy_log": self.energy_log,
               "evals": evals, "total_energy_j": total_energy,
               "total_time_s": total_time}
        prog = self.program.summary()
        if prog.get("kind", "constant") != "constant":
            if "budget_j" in prog:
                prog["within_budget"] = total_energy <= prog["budget_j"]
            out["program"] = prog
        if self.faults is not None:
            out.update(
                total_retransmissions=int(sum(
                    e.get("retransmissions", 0) for e in self.energy_log)),
                total_retx_energy_j=float(sum(
                    e.get("retx_energy_j", 0.0) for e in self.energy_log)),
                total_rejected=int(sum(
                    h.get("n_rejected", 0) for h in sim.history)),
                total_undelivered=int(sum(
                    e.get("undelivered", 0) for e in self.energy_log)),
                total_dropped_midround=int(sum(
                    e.get("dropped_midround", 0) for e in self.energy_log)),
            )
        return out
