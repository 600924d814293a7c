"""Per-round precision control: the program layer over PrecisionPolicy.

:class:`~repro.api.precision.PrecisionPolicy` stays the immutable per-round
value object every consumer reads; a :class:`PrecisionProgram` is the
*controller* that produces that value each round from measured state.  The
split closes the co-design loop the paper solves once up front (§IV,
Algorithm 1): energy-optimal bits depend on channel state and energy
budgets, so the bits should be re-decided as conditions drift — the move
Doubly Adaptive Quantization (arXiv:2402.12957) makes per round.

Contract
--------
Each round the caller (``FLOrchestrator.plan_round`` or
``Session.fl_round``) builds an :class:`Observation` of what was *measured*
so far — cumulative ``energy_log`` spend, channel ``gain_drift_db``,
gradient wire bytes, paged-KV pool pressure — and asks the program::

    policy = program.policy_for_round(r, proposed, obs)

``proposed`` is whatever the static path would have used (the spec policy,
or the GBD solution), so programs compose with the solver instead of
replacing it.  The returned policy is a plain frozen
:class:`PrecisionPolicy`; downstream consumers are unchanged.

Controllers
-----------
* ``constant``      — returns ``proposed`` unchanged (the identity wrap of
  any static policy; bitwise-equal to the pre-program stack by
  construction, pinned by ``tests/test_program.py``).
* ``energy_budget`` — walks a cap down/up the policy's ``bit_options``
  lattice: when cumulative measured energy tracks over the pro-rata budget
  pace, weight/comm bits are clamped one lattice step down; when spend
  falls back under pace, the cap is restored one step.
* ``channel_gbd``   — generalizes the drift re-solve that used to live as
  ``resolve_drift_db``: ``wants_resolve`` fires a warm GBD re-solve when
  measured gains drift past a dB threshold.

Because a program makes its decision from the observation sequence alone
(no wall clock, no private RNG), checkpoint-resume replay of
``plan_round(0..start)`` reconstructs the controller state bit-identically.

``kv_watermark`` (any controller) arms the serving-side lever: when paged
KV pool pressure crosses the watermark, ``Session.serve`` demotes the
f32 pools to bf16 (``models.attention.demote_kv_cache``) instead of
deferring admissions forever.
"""

from __future__ import annotations

import dataclasses

from repro_torch.api.precision import PrecisionPolicy


@dataclasses.dataclass(frozen=True)
class Observation:
    """What one round's controller decision may depend on — all *measured*.

    ``energy_cum_j`` is the billed spend of rounds ``< round`` (the
    orchestrator's ``energy_log``); ``gain_drift_db`` compares the current
    (fault-faded) gains against the strategy's solve-time gains;
    ``wire_bytes_round`` is the previous round's gradient bytes on the wire
    (``grad_wire_report``); ``pool_pressure`` is used/total KV pages
    (1.0 = a request is blocked on reclaim).
    """

    round: int
    rounds_total: int = 0
    energy_cum_j: float = 0.0
    energy_round_j: float = 0.0
    gain_drift_db: float = 0.0
    wire_bytes_round: float = 0.0
    pool_pressure: float = 0.0


class PrecisionProgram:
    """Base controller: identity policy, no re-solves, optional KV lever."""

    kind = "constant"

    def __init__(self, *, kv_watermark: float | None = None):
        self.kv_watermark = (None if kv_watermark is None
                             else float(kv_watermark))

    # -- the per-round decision ----------------------------------------
    def policy_for_round(self, round_idx: int, proposed: PrecisionPolicy,
                         obs: Observation) -> PrecisionPolicy:
        return proposed

    def wants_resolve(self, obs: Observation) -> bool:
        """Ask for a warm GBD re-solve this round (channel controllers)."""
        return False

    @property
    def uses_drift(self) -> bool:
        """Whether the caller must measure ``gain_drift_db`` for us."""
        return False

    def kv_demote(self, obs: Observation) -> bool:
        """Serving lever: demote f32 KV pools to bf16 under pool pressure."""
        return (self.kv_watermark is not None
                and obs.pool_pressure >= self.kv_watermark)

    # -- schedule envelope (static analysis) ---------------------------
    def comm_envelope(self, base: PrecisionPolicy) -> tuple[int, ...]:
        """Every comm bit-width this program could emit over a run.

        The analyzer proves ``overflow.wire_accumulator`` for each member,
        so the certificate covers the whole schedule, not one policy.
        """
        return (int(base.comm),)

    def weight_envelope(self, base: PrecisionPolicy) -> tuple[int, ...]:
        """Every weight bit-width this program could emit (sorted)."""
        w = base.weights if base.heterogeneous else (base.weights,)
        return tuple(sorted({int(b) for b in w}))

    # -- bookkeeping ----------------------------------------------------
    def reset(self) -> None:
        """Forget controller state (a fresh run over the same instance)."""

    def summary(self) -> dict:
        """JSON-safe counters for result rows / sweep tables."""
        return {"kind": self.kind}

    # -- serialization --------------------------------------------------
    def to_dict(self) -> dict:
        d = {"kind": self.kind}
        if self.kv_watermark is not None:
            d["kv_watermark"] = self.kv_watermark
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "PrecisionProgram":
        d = dict(d)
        kind = d.pop("kind", "constant")
        if kind not in PROGRAMS:
            raise ValueError(f"unknown precision program kind {kind!r}; "
                             f"options: {sorted(PROGRAMS)}")
        return PROGRAMS[kind](**d)

    def __repr__(self):
        return f"{type(self).__name__}({self.to_dict()})"


class ConstantProgram(PrecisionProgram):
    """The identity wrap: whatever the static path proposes, runs."""

    kind = "constant"


class EnergyBudgetProgram(PrecisionProgram):
    """Demote bits along the lattice when measured energy tracks over budget.

    Controller law (evaluated at the START of round ``r`` from rounds
    ``< r``'s billed energy): the pro-rata pace is
    ``budget_j * r / rounds_total``.  Spend above ``slack * pace`` drops the
    bit cap one ``bit_options`` step (weights and/or comm, per the
    ``demote_*`` flags); spend below ``restore * pace`` raises it one step.
    One step per round keeps the policy schedule K-valued with K tiny —
    which is exactly what the session's compiled-variant cache amortizes.

    Physics note: with the paper's energy model the lever that matters is
    the *weights* role — ``e_comp = p_comp * (beta1 + beta2 * q)`` is affine
    in the weight bits q, while ``e_comm = alpha1 / B`` is independent of
    comm bits (the uplink payload D_g is the f32 gradient either way).
    Comm demotion still shrinks the pod-trainer bytes on the wire, so both
    default on.
    """

    kind = "energy_budget"

    def __init__(self, budget_j: float, *, slack: float = 1.05,
                 restore: float = 0.90, demote_weights: bool = True,
                 demote_comm: bool = True, kv_watermark: float | None = None):
        super().__init__(kv_watermark=kv_watermark)
        self.budget_j = float(budget_j)
        if self.budget_j <= 0:
            raise ValueError(f"budget_j must be > 0, got {budget_j}")
        self.slack = float(slack)
        self.restore = float(restore)
        if not self.restore <= self.slack:
            raise ValueError(f"restore ({restore}) must be <= slack "
                             f"({slack}) or the cap oscillates every round")
        self.demote_weights = bool(demote_weights)
        self.demote_comm = bool(demote_comm)
        self.reset()

    def reset(self) -> None:
        self._cap_idx: int | None = None   # index into the sorted lattice
        self.demotions = 0
        self.restores = 0
        self.cap_bits: int | None = None

    # ------------------------------------------------------------------
    def _lattice(self, proposed: PrecisionPolicy) -> tuple[int, ...]:
        return tuple(sorted({int(b) for b in proposed.bit_options}))

    def policy_for_round(self, round_idx: int, proposed: PrecisionPolicy,
                         obs: Observation) -> PrecisionPolicy:
        lattice = self._lattice(proposed)
        if self._cap_idx is None or self._cap_idx >= len(lattice):
            self._cap_idx = len(lattice) - 1
        pace = (self.budget_j * obs.round / obs.rounds_total
                if obs.rounds_total > 0 else 0.0)
        if obs.round > 0 and pace > 0:
            if obs.energy_cum_j > self.slack * pace and self._cap_idx > 0:
                self._cap_idx -= 1
                self.demotions += 1
            elif (obs.energy_cum_j < self.restore * pace
                  and self._cap_idx < len(lattice) - 1):
                self._cap_idx += 1
                self.restores += 1
        cap = lattice[self._cap_idx]
        self.cap_bits = cap
        return self._clamp(proposed, cap)

    def _clamp(self, proposed: PrecisionPolicy,
               cap: int) -> PrecisionPolicy:
        changes = {}
        if self.demote_weights:
            if proposed.heterogeneous:
                w = tuple(min(int(b), cap) for b in proposed.weights)
                if w != proposed.weights:
                    changes["weights"] = w
            elif int(proposed.weights) > cap:
                changes["weights"] = cap
        if self.demote_comm and int(proposed.comm) > cap:
            changes["comm"] = cap
        if not changes:
            return proposed      # identity: the constant-equivalence path
        return dataclasses.replace(proposed, **changes)

    # ------------------------------------------------------------------
    def comm_envelope(self, base: PrecisionPolicy) -> tuple[int, ...]:
        bits = {int(base.comm)}
        if self.demote_comm:
            bits.update(b for b in base.bit_options if b < base.comm)
        return tuple(sorted(bits))

    def weight_envelope(self, base: PrecisionPolicy) -> tuple[int, ...]:
        bits = set(super().weight_envelope(base))
        if self.demote_weights:
            top = max(bits)
            bits.update(b for b in base.bit_options if b < top)
        return tuple(sorted(bits))

    def summary(self) -> dict:
        return {"kind": self.kind, "budget_j": self.budget_j,
                "demotions": self.demotions, "restores": self.restores,
                "cap_bits": self.cap_bits}

    def to_dict(self) -> dict:
        d = super().to_dict()
        d.update(budget_j=self.budget_j, slack=self.slack,
                 restore=self.restore, demote_weights=self.demote_weights,
                 demote_comm=self.demote_comm)
        return d


class ChannelGBDProgram(PrecisionProgram):
    """Warm GBD re-solve when measured channel gains drift past a threshold.

    The program form of the orchestrator's ``resolve_drift_db`` knob: the
    observation carries ``gain_drift_db`` (current fault-faded gains vs. the
    strategy's solve-time gains, :func:`repro.core.channel.gain_drift_db`)
    and ``wants_resolve`` fires the same ``resolve(warm=True, gains0=...)``
    path.  Policy values pass through untouched — the *solver* is the
    controller here.
    """

    kind = "channel_gbd"

    def __init__(self, drift_db: float, *, kv_watermark: float | None = None):
        super().__init__(kv_watermark=kv_watermark)
        self.drift_db = float(drift_db)
        if self.drift_db <= 0:
            raise ValueError(f"drift_db must be > 0, got {drift_db}")
        self.reset()

    def reset(self) -> None:
        self.resolves = 0

    @property
    def uses_drift(self) -> bool:
        return True

    def wants_resolve(self, obs: Observation) -> bool:
        if obs.gain_drift_db > self.drift_db:
            self.resolves += 1
            return True
        return False

    def summary(self) -> dict:
        return {"kind": self.kind, "drift_db": self.drift_db,
                "resolves": self.resolves}

    def to_dict(self) -> dict:
        d = super().to_dict()
        d["drift_db"] = self.drift_db
        return d


PROGRAMS: dict[str, type] = {
    "constant": ConstantProgram,
    "energy_budget": EnergyBudgetProgram,
    "channel_gbd": ChannelGBDProgram,
}


def build_program(obj) -> PrecisionProgram:
    """The one coercion funnel: None / kind string / dict / instance.

    ``None`` means "no program" and builds the identity
    :class:`ConstantProgram`, so every caller can hold a program
    unconditionally and the static path stays the zero-configuration
    default.
    """
    if obj is None:
        return ConstantProgram()
    if isinstance(obj, PrecisionProgram):
        return obj
    if isinstance(obj, str):
        return PrecisionProgram.from_dict({"kind": obj})
    if isinstance(obj, dict):
        return PrecisionProgram.from_dict(obj)
    raise TypeError(f"cannot build a PrecisionProgram from {type(obj).__name__}")
