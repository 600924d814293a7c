"""Deterministic fault planning: (seed, round, client) -> what breaks.

The paper's setting is FL over *unreliable* mobile devices on a fading
uplink; this module is the seeded source of truth for everything that goes
wrong in a simulated deployment.  A :class:`FaultPlan` declares fault
*intensities* (probabilities + magnitudes); a :class:`FaultSchedule` turns a
plan plus a seed into concrete per-round realizations.

Determinism is the design contract: every draw is keyed by
``(seed, salt, round[, client])`` through ``np.random.default_rng`` — never
by call order or wall clock — so

* the same ``RunSpec`` seed produces the identical schedule, and
* a run killed at round *k* and resumed replays rounds ``k..R`` against the
  exact fault realizations the uninterrupted run would have seen (the
  bitwise-resume property ``tests/test_faults.py`` pins).

Fault taxonomy (all per client per round unless noted):

* **mid-round dropout** — the client computes its update, then vanishes
  before upload (battery death, app backgrounded).  Compute energy is spent;
  nothing is delivered.
* **channel fade**   — a deep fade attenuates the gain by
  ``fade_depth_db`` (scaled by a seeded draw in [0.5, 1.5)), cutting the
  achievable rate for the whole round; the drift can trip the
  orchestrator's warm-started GBD re-solve.
* **packet loss**    — each uplink payload chunk is lost i.i.d. with
  ``packet_loss`` probability per transmission *attempt*; lost chunks are
  retransmitted with exponential backoff and every attempt is billed real
  transmission energy (:mod:`repro_torch.faults.executor`).
* **compute slowdown** — thermal throttling: ``T^comp`` multiplied by
  ``slowdown_factor`` (can push the client past the round deadline).
* **corrupted update** — the payload arrives but its contents are damaged:
  kind 1 poisons values with NaN, kind 2 is an exponent-scale bit-flip
  (entries blown up by 2^106).  Both are *detectable by construction* by the
  aggregation gate's finite-check + norm bound.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: rng salts: one stream per fault family, never shared
_SALT_ROUND = 0xFA17
_SALT_CHUNK = 0xC4A7
_SALT_CORRUPT = 0xB17F


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Fault intensities + retry policy (JSON round-trip, sweep-hashable)."""

    dropout_prob: float = 0.0       # mid-round client loss (post-compute)
    fade_prob: float = 0.0          # deep-fade event probability
    fade_depth_db: float = 12.0     # nominal fade attenuation
    packet_loss: float = 0.0        # per-chunk per-attempt loss probability
    chunk_bytes: float = 64e3       # payload chunking for retransmission
    slowdown_prob: float = 0.0      # compute-throttling probability
    slowdown_factor: float = 2.5    # T^comp multiplier when throttled
    corrupt_prob: float = 0.0       # damaged-payload probability
    corrupt_nan_frac: float = 0.5   # P(kind=NaN | corrupt); rest bit-flip
    max_retries: int = 4            # extra attempts per chunk before giving up
    backoff_base_s: float = 0.01    # backoff after attempt k waits base*2^k
    gate_norm_factor: float = 50.0  # norm bound = factor * median survivor norm

    def __post_init__(self):
        for f in ("dropout_prob", "fade_prob", "packet_loss",
                  "slowdown_prob", "corrupt_prob", "corrupt_nan_frac"):
            p = getattr(self, f)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{f} must be a probability, got {p}")
        if self.packet_loss >= 1.0:
            raise ValueError("packet_loss=1.0 can never deliver; use <1")
        if self.chunk_bytes <= 0:
            raise ValueError("chunk_bytes must be positive")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")

    @property
    def active(self) -> bool:
        """Whether any fault family can actually fire."""
        return any(p > 0 for p in (self.dropout_prob, self.fade_prob,
                                   self.packet_loss, self.slowdown_prob,
                                   self.corrupt_prob))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        known = {f.name for f in dataclasses.fields(cls)}
        bad = set(d) - known
        if bad:
            raise ValueError(f"unknown FaultPlan fields {sorted(bad)}; "
                             f"known: {sorted(known)}")
        return cls(**d)

    def schedule(self, seed: int, n_devices: int) -> "FaultSchedule":
        return FaultSchedule(plan=self, seed=int(seed),
                             n_devices=int(n_devices))


@dataclasses.dataclass(frozen=True)
class RoundFaults:
    """One round's realization over the whole fleet (index = device id)."""

    drop: np.ndarray          # (n,) bool — mid-round dropout
    fade_db: np.ndarray       # (n,) float — gain attenuation (0 = clear)
    slow: np.ndarray          # (n,) float — T^comp multiplier (1 = nominal)
    corrupt_kind: np.ndarray  # (n,) int — 0 clean, 1 NaN, 2 bit-flip
    loss_prob: float          # per-chunk per-attempt packet loss

    @property
    def fade_lin(self) -> np.ndarray:
        """Multiplicative linear gain factor of the fade (<= 1)."""
        return 10.0 ** (-self.fade_db / 10.0)

    @property
    def any_fault(self) -> bool:
        return bool(self.drop.any() or (self.fade_db > 0).any()
                    or (self.slow > 1).any() or (self.corrupt_kind > 0).any()
                    or self.loss_prob > 0)


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """Seeded realization stream: pure function of (plan, seed, round)."""

    plan: FaultPlan
    seed: int
    n_devices: int

    def round_faults(self, round_idx: int) -> RoundFaults:
        p, n = self.plan, self.n_devices
        rng = np.random.default_rng((self.seed, _SALT_ROUND, int(round_idx)))
        # one fixed-size draw per family, in a fixed order, so each family's
        # realization is independent of the other probabilities
        u_drop = rng.random(n)
        u_fade = rng.random(n)
        depth = rng.random(n)
        u_slow = rng.random(n)
        u_corr = rng.random(n)
        u_kind = rng.random(n)
        fade_db = np.where(u_fade < p.fade_prob,
                           p.fade_depth_db * (0.5 + depth), 0.0)
        corrupt = u_corr < p.corrupt_prob
        kind = np.where(corrupt,
                        np.where(u_kind < p.corrupt_nan_frac, 1, 2), 0)
        return RoundFaults(
            drop=u_drop < p.dropout_prob,
            fade_db=fade_db,
            slow=np.where(u_slow < p.slowdown_prob, p.slowdown_factor, 1.0),
            corrupt_kind=kind.astype(np.int64),
            loss_prob=float(p.packet_loss),
        )

    def chunk_rng(self, round_idx: int, device: int) -> np.random.Generator:
        """Per-(round, device) stream for packet-loss draws: the number of
        draws a client consumes (retries vary!) never perturbs anyone else."""
        return np.random.default_rng(
            (self.seed, _SALT_CHUNK, int(round_idx), int(device)))

    def corrupt_rng(self, round_idx: int, device: int) -> np.random.Generator:
        """Per-(round, device) stream for payload-corruption placement."""
        return np.random.default_rng(
            (self.seed, _SALT_CORRUPT, int(round_idx), int(device)))
