"""Resilient uplink execution: retransmission, corruption, aggregation gate.

This is the host-side half of the resilient round.  Everything here is plain
numpy on concrete values — the jitted training round never sees a fault, it
only sees the surviving cohort and (possibly) corrupted-then-gated updates.

Energy semantics (the point of the whole exercise): the paper's
``E^comm = alpha1 / B`` is the *lossless optimum* — one error-free pass over
the payload.  Under packet loss the device pays for every attempt, so the
billed energy is ``(total attempts / chunks) x`` the optimum.  Backoff waits
cost wall-clock latency (they count against the round deadline) but no
transmit energy: the radio is idle while waiting.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.faults.plan import FaultPlan


@dataclasses.dataclass(frozen=True)
class TransmissionOutcome:
    """What one client's uplink actually cost this round."""

    delivered: bool
    chunks: int             # payload chunks (1 error-free attempt each, ideally)
    attempts: int           # total transmission attempts across all chunks
    retransmissions: int    # attempts - chunks_attempted (pure waste)
    t_comm_s: float         # wall-clock on air + backoff waits
    e_comm_j: float         # billed transmit energy (every attempt pays)
    e_retx_j: float         # energy of the retransmitted attempts alone


def transmit_update(payload_bits: float, rate_bps: float, p_comm_w: float,
                    loss_prob: float, rng: np.random.Generator,
                    plan: FaultPlan, budget_s: float = math.inf,
                    ) -> TransmissionOutcome:
    """Push one quantized update uplink, chunk by chunk, retrying losses.

    Each chunk is attempted up to ``1 + plan.max_retries`` times; attempt k's
    failure waits ``backoff_base_s * 2^k`` before the retry.  Delivery fails
    if any chunk exhausts its retries or the cumulative wall-clock exceeds
    ``budget_s`` (the round deadline) — either way the energy already spent
    stays spent.
    """
    if rate_bps <= 0:
        return TransmissionOutcome(False, 0, 0, 0, 0.0, 0.0, 0.0)
    chunk_bits = plan.chunk_bytes * 8.0
    n_chunks = max(1, int(math.ceil(payload_bits / chunk_bits)))
    t_chunk = (payload_bits / n_chunks) / rate_bps
    e_chunk = p_comm_w * t_chunk

    t = 0.0
    e = 0.0
    attempts = 0
    retx = 0
    for _ in range(n_chunks):
        for attempt in range(1 + plan.max_retries):
            if t + t_chunk > budget_s:
                return TransmissionOutcome(False, n_chunks, attempts, retx,
                                           t, e, retx * e_chunk)
            attempts += 1
            t += t_chunk
            e += e_chunk
            if attempt > 0:
                retx += 1
            if loss_prob <= 0 or rng.random() >= loss_prob:
                break  # chunk through
            if attempt < plan.max_retries:
                t += plan.backoff_base_s * (2.0 ** attempt)
        else:
            # chunk exhausted its retries: the update is lost this round
            return TransmissionOutcome(False, n_chunks, attempts, retx,
                                       t, e, retx * e_chunk)
    return TransmissionOutcome(True, n_chunks, attempts, retx,
                               t, e, retx * e_chunk)


# ----------------------------------------------------------------------
# payload corruption + aggregation gate
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class UpdateFaults:
    """Per-cohort-client corruption instructions handed to the simulator.

    ``kinds[i]`` is 0 (clean), 1 (NaN poisoning) or 2 (exponent-scale
    bit-flip); ``rngs[i]`` decides *where* in the flattened update the
    damage lands.  ``gate_factor`` parameterizes the aggregation gate.
    """

    kinds: np.ndarray                     # (cohort,) int
    rngs: tuple                           # (cohort,) np.random.Generator
    gate_factor: float = 50.0

    @property
    def any_corrupt(self) -> bool:
        return bool((self.kinds > 0).any())


def inject_corruption(flat: np.ndarray, kind: int,
                      rng: np.random.Generator) -> np.ndarray:
    """Damage ~1% (at least 1 entry) of a flattened update.

    kind 1: NaN poisoning (torn write / failed decode).
    kind 2: exponent bit-flip — entries scaled by 2^106, the effect of
    flipping a high exponent bit in an f32.  Both are guaranteed detectable:
    kind 1 trips the finite check, kind 2 the norm bound (any nonzero entry
    at 2^106 dwarfs a trained gradient's norm by many orders of magnitude).
    """
    if kind == 0:
        return flat
    out = np.array(flat, copy=True)
    n = out.size
    k = max(1, n // 100)
    idx = rng.choice(n, size=k, replace=False)
    if kind == 1:
        out[idx] = np.nan
    else:
        out[idx] = out[idx] * (2.0 ** 106) + 2.0 ** 40
    return out


def gate_mask(norms_sq: np.ndarray, finite: np.ndarray,
              factor: float) -> np.ndarray:
    """Accept mask over cohort updates: finite AND within the norm bound.

    The bound is relative — ``factor x median`` of the *finite* survivors'
    update norms — so it self-calibrates as gradients shrink over training
    instead of hard-coding a scale.  With no finite survivor the mask is all
    False and the caller must skip aggregation for the round.
    """
    finite = np.asarray(finite, dtype=bool)
    norms_sq = np.asarray(norms_sq, dtype=np.float64)
    accept = finite.copy()
    if not accept.any():
        return accept
    med = float(np.median(np.sqrt(norms_sq[accept])))
    if med > 0 and np.isfinite(med):
        accept &= np.sqrt(np.where(finite, norms_sq, np.inf)) <= factor * med
    return accept
