"""Wireless channel simulation for the 5G uplink (paper §2.2 / §4.1.2).

Block Rayleigh fading: the channel gain ``h_{i,r}`` of device ``i`` is redrawn
every global round ``r`` (the paper assumes gains are estimated in advance of
each round; estimation itself is out of scope there and here).

Gains combine a distance-dependent path loss with an exponential (Rayleigh
power) fast-fading term.  Devices can be organized in gain groups
``g1 <= g2 <= g3 <= g4`` to reproduce Fig. 5.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ChannelModel:
    """Path loss + Rayleigh block fading."""

    n_devices: int
    seed: int = 0
    cell_radius_m: float = 120.0
    min_dist_m: float = 10.0
    path_loss_exp: float = 3.76          # urban macro
    ref_loss_db: float = 35.3            # loss at 1 m
    shadowing_std_db: float = 8.0
    n_groups: int = 4                    # Fig. 5 gain groups

    def _rng(self, salt: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, salt))

    def distances(self) -> np.ndarray:
        """Static device placement: group g sits in ring g (g1 farthest)."""
        rng = self._rng(0)
        groups = np.arange(self.n_devices) % self.n_groups
        # group 0 -> outer ring (worst gain) ... group n-1 -> inner ring
        ring_hi = self.cell_radius_m * (1.0 - groups / self.n_groups)
        ring_lo = np.maximum(self.min_dist_m, ring_hi - self.cell_radius_m / self.n_groups)
        return rng.uniform(ring_lo, ring_hi)

    def path_gain(self) -> np.ndarray:
        """Linear average power gain per device (path loss + lognormal shadow)."""
        rng = self._rng(1)
        d = self.distances()
        loss_db = self.ref_loss_db + 10.0 * self.path_loss_exp * np.log10(d)
        loss_db = loss_db + rng.normal(0.0, self.shadowing_std_db, self.n_devices)
        return 10 ** (-loss_db / 10.0)

    def gains(self, round_idx: int) -> np.ndarray:
        """h_{i,r}: per-round realization (Rayleigh power fading ~ Exp(1))."""
        rng = self._rng(1000 + round_idx)
        fading = rng.exponential(1.0, self.n_devices)
        return self.path_gain() * fading

    def gain_matrix(self, n_rounds: int) -> np.ndarray:
        """(n_rounds, n_devices) gain table for the optimizer horizon."""
        return np.stack([self.gains(r) for r in range(n_rounds)])

    def group_of(self) -> np.ndarray:
        return np.arange(self.n_devices) % self.n_groups


def gain_drift_db(ref_gains: np.ndarray, gains: np.ndarray) -> float:
    """Mean absolute per-device gain drift between two realizations, in dB.

    The orchestrator compares the gains its current strategy was solved
    against with this round's *measured* (possibly fault-faded) gains; a
    drift past ``resolve_drift_db`` triggers a warm-started GBD re-solve.
    """
    ref = np.maximum(np.asarray(ref_gains, dtype=np.float64), 1e-300)
    cur = np.maximum(np.asarray(gains, dtype=np.float64), 1e-300)
    return float(np.mean(np.abs(10.0 * np.log10(cur / ref))))
