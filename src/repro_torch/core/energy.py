"""Energy models for computation (Eq. 16–18) and communication (Eq. 19–21).

Everything in this module is host-side simulation math (numpy): it models the
*mobile fleet* the co-design layer optimizes over, not the accelerator that runs
the learning simulation (see DESIGN.md §2).

Computation (paper §4.1.1, mobile-GPU DVFS model):
    p_i^comp = p0 + zeta_mem * f_mem + zeta_core * V_core^2 * f_core      (16)
    T_i^comp(q) = t0 + c1(q) theta_mem / f_mem + c2(q) theta_core / f_core (17)
    E_i^comp(q) = p_i^comp * T_i^comp(q)                                   (18)
with c1, c2 linear in the bit-width q, so T^comp(q) = beta1 + beta2 * q
(the paper's simplification in §4.3).

Communication (paper §4.1.2, OFDMA uplink):
    gamma_i,r = B_i,r * ln(1 + h_i,r p_i^comm / sigma^2)                   (19)
    T_i^comm  = D_g / gamma_i,r                                            (20)
    E_i^comm  = p_i^comm * T_i^comm                                        (21)
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """Per-device hardware parameters (Eq. 16/17 coefficients).

    Frequencies in Hz, voltages in V, powers in W, cycle counts per mini-batch.
    """

    name: str = "generic-mobile-gpu"
    p_g0: float = 1.0            # static power (W)
    zeta_mem: float = 1.2e-9     # W per Hz of memory clock
    zeta_core: float = 1.6e-9    # W per (V^2 * Hz) of core clock
    v_core: float = 0.9          # core voltage (V)
    f_core: float = 1.4e9        # core frequency (Hz)
    f_mem: float = 2.0e9         # memory frequency (Hz)
    t0: float = 1e-3             # task-independent latency (s)
    theta_mem: float = 4.0e8     # memory cycles per mini-batch (32-bit ref)
    theta_core: float = 1.3e9    # core cycles per mini-batch (32-bit ref)
    c1_slope: float = 1.0 / 32.0  # c1(q) = c1_slope * q  (linear, c1(32)=1)
    c2_slope: float = 1.0 / 32.0  # c2(q) = c2_slope * q
    p_comm: float = 0.1          # transmit power (W); paper: 2..20 dBm

    def runtime_power(self) -> float:
        """Eq. (16)."""
        return (
            self.p_g0
            + self.zeta_mem * self.f_mem
            + self.zeta_core * self.v_core**2 * self.f_core
        )

    def exec_time(self, bits: np.ndarray | float) -> np.ndarray:
        """Eq. (17) with linear c1/c2 — returns seconds."""
        q = np.asarray(bits, dtype=np.float64)
        return (
            self.t0
            + self.c1_slope * q * self.theta_mem / self.f_mem
            + self.c2_slope * q * self.theta_core / self.f_core
        )

    # --- affine form used by the optimizer (paper §4.3) ------------------
    @property
    def beta1(self) -> float:
        """T^comp(q) = beta1 + beta2*q : intercept."""
        return self.t0

    @property
    def beta2(self) -> float:
        """T^comp(q) = beta1 + beta2*q : slope (s per bit)."""
        return (
            self.c1_slope * self.theta_mem / self.f_mem
            + self.c2_slope * self.theta_core / self.f_core
        )

    def comp_energy(self, bits: np.ndarray | float) -> np.ndarray:
        """Eq. (18)."""
        return self.runtime_power() * self.exec_time(bits)


def heterogeneous_fleet(
    n: int,
    *,
    seed: int = 0,
    min_core_mhz: float = 1400.0,
    group_step_mhz: float = 0.0,
    n_groups: int = 4,
    p_comm_dbm_range: tuple[float, float] = (2.0, 20.0),
    mem_capacity_mb_range: tuple[float, float] = (64.0, 2048.0),
) -> list[DeviceProfile]:
    """Build N heterogeneous device profiles (paper §5 setting).

    ``group_step_mhz`` reproduces the Fig. 4 heterogeneity knob: devices are
    split into ``n_groups`` groups with core clocks
    ``C, C+5L, C+15L, C+20L`` MHz where ``L = group_step_mhz``.
    """
    rng = np.random.default_rng(seed)
    offsets_units = np.array([0.0, 5.0, 15.0, 20.0])[:n_groups]
    fleet = []
    for i in range(n):
        g = i % n_groups
        f_core = (min_core_mhz + offsets_units[g] * group_step_mhz) * 1e6
        p_dbm = rng.uniform(*p_comm_dbm_range)
        fleet.append(
            dataclasses.replace(
                DeviceProfile(name=f"dev{i}-g{g}"),
                f_core=f_core,
                f_mem=rng.uniform(1.6e9, 2.4e9),
                theta_mem=rng.uniform(0.8, 1.2) * 4.0e8,
                theta_core=rng.uniform(0.8, 1.2) * 1.3e9,
                p_comm=10 ** (p_dbm / 10.0) / 1000.0,  # dBm -> W
            )
        )
    return fleet


def memory_capacities(n: int, *, seed: int = 1, lo_mb: float = 64.0, hi_mb: float = 2048.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(lo_mb, hi_mb, size=n)


# ---------------------------------------------------------------------------
# Communication (Eq. 19-21)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CommParams:
    """OFDMA uplink parameters shared across devices."""

    noise_dbm_per_hz: float = -174.0  # N0 (paper §5)
    b_max_hz: float = 20e6            # total bandwidth (Fig. 5: 20..38 MHz)
    grad_bytes: float = 0.0           # D_g: gradient payload (set per model)

    def noise_power(self, bandwidth_hz: np.ndarray | float) -> np.ndarray:
        """sigma^2 = N0 * B (thermal noise over the allocated band)."""
        n0_w_per_hz = 10 ** (self.noise_dbm_per_hz / 10.0) / 1000.0
        return n0_w_per_hz * np.asarray(bandwidth_hz, dtype=np.float64)


def rate_bps(bandwidth_hz, gain, p_comm_w, comm: CommParams) -> np.ndarray:
    """Achievable rate, Eq. (19): gamma = B ln(1 + h p / sigma^2) (nats/s)."""
    b = np.asarray(bandwidth_hz, dtype=np.float64)
    snr = np.asarray(gain) * np.asarray(p_comm_w) / comm.noise_power(b)
    return b * np.log1p(snr)


def comm_time_s(bandwidth_hz, gain, p_comm_w, comm: CommParams) -> np.ndarray:
    """Eq. (20): T = D_g / gamma, with D_g in bits."""
    return 8.0 * comm.grad_bytes / rate_bps(bandwidth_hz, gain, p_comm_w, comm)


def comm_energy_j(bandwidth_hz, gain, p_comm_w, comm: CommParams) -> np.ndarray:
    """Eq. (21): E = p_comm * T."""
    return np.asarray(p_comm_w) * comm_time_s(bandwidth_hz, gain, p_comm_w, comm)


def reference_rate_bps(bandwidth_hz, gain, p_comm_w, comm: CommParams) -> np.ndarray:
    """Rate under the alpha-reformulation convention (sigma^2 at B_max).

    One lossless pass over ``D_g`` at this rate costs exactly
    ``T = alpha2/B`` and ``E = alpha1/B`` — the optimizer's plan.  The
    retransmission executor (:mod:`repro_torch.faults.executor`) bills every
    transmission attempt at this rate, so a fault-free run reproduces the
    planned comm energy to the bit and every retry shows up as a measured
    surcharge on top of it.
    """
    sigma2 = comm.noise_power(comm.b_max_hz)
    b = np.asarray(bandwidth_hz, dtype=np.float64)
    return b * np.log1p(np.asarray(gain) * np.asarray(p_comm_w) / sigma2)


def alpha_coefficients(
    gains: np.ndarray, p_comm_w: np.ndarray, comm: CommParams
) -> tuple[np.ndarray, np.ndarray]:
    """The paper's alpha^1_{i,r}, alpha^2_{i,r} (reformulation (30)).

    With sigma^2 = N0*B the SNR depends on B, which would break the paper's
    1/B separable form; following the paper (and standard practice in this
    literature) sigma^2 is evaluated at the *reference* full band B_max so
    that  E^comm = alpha1 / B  and  T^comm = alpha2 / B  exactly.

    Returns (alpha1, alpha2): alpha1 in J*Hz, alpha2 in s*Hz.
    """
    sigma2 = comm.noise_power(comm.b_max_hz)
    log_term = np.log1p(np.asarray(gains) * np.asarray(p_comm_w) / sigma2)
    d_bits = 8.0 * comm.grad_bytes
    alpha2 = d_bits / log_term
    alpha1 = np.asarray(p_comm_w) * alpha2
    return alpha1, alpha2


def round_energy(
    bits: np.ndarray,
    bandwidth_hz: np.ndarray,
    fleet: Sequence[DeviceProfile],
    gains: np.ndarray,
    comm: CommParams,
) -> dict:
    """Total per-round energy/latency breakdown for a cohort (Eq. 22/26)."""
    bits = np.asarray(bits, np.float64)
    p_comm = np.array([d.p_comm for d in fleet])
    alpha1, alpha2 = alpha_coefficients(gains, p_comm, comm)
    e_comp = np.array([d.comp_energy(b) for d, b in zip(fleet, bits)])
    t_comp = np.array([d.exec_time(b) for d, b in zip(fleet, bits)])
    e_comm = alpha1 / bandwidth_hz
    t_comm = alpha2 / bandwidth_hz
    return {
        "e_comp": e_comp,
        "e_comm": e_comm,
        "t_comp": t_comp,
        "t_comm": t_comm,
        "energy_total": float(np.sum(e_comp + e_comm)),
        "t_round": float(np.max(t_comp + t_comm)),  # Eq. (26)
    }


def model_bytes_full_precision(n_params: int) -> float:
    """U_i: model size at 32-bit full precision, in bytes."""
    return 4.0 * n_params


def c3(bits: np.ndarray | float) -> np.ndarray:
    """Constraint (25) ratio of bit-width to full precision: c3(q) = q/32."""
    return np.asarray(bits, np.float64) / 32.0
