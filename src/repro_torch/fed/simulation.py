"""FWQ-FL simulator (the paper-experiment path).

One round = Algorithm 1 exactly: per-client SR tree-quantization at the
clients' resolutions (one K1 launch for the whole cohort), gradients at the
quantized weights, full-precision server SGD.  Clients are the leading
dimension of the round's batch; the pod trainer is the multi-device twin of
this (a later slice of the port).

Randomness: K1 draws the round's SR uniforms in the kernel from
:meth:`FLSimulation.round_key`, the 64-bit key ``(seed, round)`` gives;
:meth:`FLSimulation.round_uniforms` returns those same uniforms as a ``(C,
P)`` tensor.  PyTorch cannot reproduce the reference's threefry bits, so
that method is the one place a test replaces to feed the reference's own
draws: a round whose ``round_uniforms`` was replaced (on the class or the
instance) takes its uniforms as given.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.api.session import resolve_device
from repro_torch.core.fwq import (
    delta_for_clients,
    make_fwq_apply,
    make_fwq_client_grads,
    make_fwq_round,
    site_key,
)
from repro_torch.core.quantization import quantizable_size
from repro_torch.faults.executor import UpdateFaults, gate_mask, inject_corruption
from repro_torch.kernels.ref import philox_streams_plain
from repro_torch.optim import Optimizer, build_optimizer


def _payload_view(w: np.ndarray) -> np.ndarray:
    """One client's update leaf in the reference's layout: conv kernels
    (the CNNs' only 4-D leaves) as HWIO, where the port holds
    ``(out, in/groups, kh, kw)``."""
    return w.transpose(2, 3, 1, 0) if w.ndim == 4 else w


def damage_updates(grads: dict, faults: UpdateFaults, norms_sq: np.ndarray,
                   finite: np.ndarray) -> dict:
    """The fault plan's corruption of the flagged clients' updates.

    Pulls the ``(C, ...)`` update leaves to the host and damages each flagged
    client's flattened payload with :func:`inject_corruption`, in the
    reference's view of it: leaves in nested-key order (``jax.tree_util``'s
    flattening) and conv kernels HWIO.  So the same plan damages the same
    parameters in both packages, and the gate meets the same damage.
    Updates the flagged clients' ``norms_sq`` and ``finite`` in place and
    returns the damaged leaves, in ``grads``' own order, on the host."""
    paths = sorted(grads, key=lambda p: p.split("/"))
    leaves = {p: grads[p].cpu().numpy().copy() for p in paths}
    kinds = np.asarray(faults.kinds)
    for ci in np.flatnonzero(kinds):
        views = [_payload_view(leaves[p][ci]) for p in paths]
        vec = np.concatenate([v.ravel() for v in views])
        vec = inject_corruption(vec, int(kinds[ci]), faults.rngs[ci])
        off = 0
        for p, v in zip(paths, views):
            v[...] = vec[off:off + v.size].reshape(v.shape)    # writes leaves[p][ci]
            off += v.size
        with np.errstate(over="ignore", invalid="ignore"):
            norms_sq[ci] = float(sum(np.sum(v.astype(np.float64) ** 2) for v in views))
        finite[ci] = all(np.isfinite(v).all() for v in views)
    return {p: torch.from_numpy(leaves[p]) for p in grads}


@dataclasses.dataclass
class SimConfig:
    n_clients: int
    lr: float = 0.05
    optimizer: str = "sgd"
    momentum: float = 0.0
    seed: int = 0


@contextlib.contextmanager
def ieee_f32():
    """f32 convolutions in full f32 on the card: cuDNN would otherwise run
    them in TF32 (about three decimal digits), which the reference does not."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class FLSimulation:
    """Stateful wrapper: holds params/opt, steps one FL round at a time."""

    def __init__(self, loss_fn: Callable, init_fn: Callable, cfg: SimConfig, *,
                 device=None):
        """loss_fn(params, batch, rng) -> (loss, aux); init_fn(generator,
        device) -> params.  ``device`` defaults to CUDA (raises without it)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.opt: Optimizer = build_optimizer(cfg.optimizer, cfg.lr,
                                              **({"momentum": cfg.momentum}
                                                 if cfg.optimizer == "sgd" else {}))
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.params = init_fn(gen, self.device)
        self.opt_state = self.opt.init(self.params)
        self._loss_fn = loss_fn
        self._round = make_fwq_round(loss_fn, self.opt.update)
        self._gated = None  # (grads_fn, apply_fn) — built on first fault use
        self.round_idx = 0
        self.history: list[dict] = []

    def state(self):
        return {"params": self.params, "opt": self.opt_state}

    def load_state(self, state, round_idx: int):
        self.params, self.opt_state = state["params"], state["opt"]
        self.round_idx = round_idx

    def round_key(self, round_idx: int) -> int:
        """The round's 64-bit SR key: the first word of
        ``SeedSequence((seed, round_idx))``'s state."""
        return site_key(self.cfg.seed, int(round_idx))

    def round_uniforms(self, round_idx: int, n_clients: int) -> torch.Tensor:
        """The round's SR uniforms as K1 draws them from :meth:`round_key`:
        ``(n_clients, P)`` over the quantizable leaves in leaf order, client
        ``c``'s row stream ``c``."""
        return philox_streams_plain(self.round_key(round_idx), n_clients,
                                    quantizable_size(self.params)[0], self.device)

    def run_round(self, batch, bits, *, faults: UpdateFaults | None = None,
                  comm_bits: int | None = None) -> dict:
        """batch: tensors with leading dim n_clients; bits: (n_clients,) ints
        or a :class:`repro_torch.api.precision.PrecisionPolicy` whose weights
        role covers exactly this round's cohort.

        ``faults`` (from the resilient orchestrator) switches to the gated
        two-phase round: per-client grads -> host-side payload corruption ->
        aggregation gate (finite check + relative norm bound) -> masked
        server step.  ``faults=None`` is the plain round.

        ``comm_bits`` records this round's gradient wire bit-width in the
        history row; it does not change the simulator's math (the round
        aggregates in full precision per Algorithm 1).
        """
        n = next(iter(batch.values())).shape[0]
        if hasattr(bits, "bits_vector"):  # PrecisionPolicy
            if comm_bits is None:
                comm_bits = int(bits.comm)
            if bits.heterogeneous and len(bits.weights) != n:
                # a device-indexed policy cannot be positionally mapped onto
                # an elastic sub-cohort: the caller must select the cohort's
                # bits itself (see FLOrchestrator.run)
                raise ValueError(
                    f"policy carries {len(bits.weights)} per-device bits but "
                    f"the round batch has {n} clients; pass the cohort's own "
                    "bits (policy.bits_vector(n_devices)[cohort_idx])")
            bits = bits.bits_vector(n)
        delta = delta_for_clients(np.asarray(bits)).to(self.device)
        if getattr(self.round_uniforms, "__func__", None) is _ROUND_UNIFORMS:
            u, key = None, self.round_key(self.round_idx)     # drawn in K1
        else:                                   # a replaced seam: its uniforms as given
            u, key = self.round_uniforms(self.round_idx, n), None
        with ieee_f32():
            if faults is None:
                self.params, self.opt_state, m = self._round(
                    self.params, self.opt_state, batch, delta, u, key=key)
                rec = {
                    "round": self.round_idx,
                    "loss": float(m.loss),
                    "grad_norm_sq": float(m.grad_norm_sq),
                    "client_loss": m.client_loss.cpu().numpy(),
                    "bits": np.asarray(bits).copy(),
                }
            else:
                rec = self._run_gated_round(batch, delta, u, key, bits, faults)
        if comm_bits is not None:
            rec["comm_bits"] = int(comm_bits)
        self.history.append(rec)
        self.round_idx += 1
        return rec

    def _run_gated_round(self, batch, delta, u, key, bits, faults: UpdateFaults) -> dict:
        if self._gated is None:
            self._gated = (make_fwq_client_grads(self._loss_fn),
                           make_fwq_apply(self.opt.update))
        grads_fn, apply_fn = self._gated
        losses, grads, gsqs, finite = grads_fn(self.params, batch, delta, u, key=key)
        norms_sq = gsqs.cpu().numpy().astype(np.float64)
        finite = finite.cpu().numpy().astype(bool)

        if (np.asarray(faults.kinds) > 0).any():
            grads = {p: g.to(self.device)
                     for p, g in damage_updates(grads, faults, norms_sq, finite).items()}

        accept = gate_mask(norms_sq, finite, faults.gate_factor)
        n_rejected = int((~accept).sum())
        if accept.any():
            self.params, self.opt_state, gnorm = apply_fn(
                self.params, self.opt_state, grads,
                torch.from_numpy(accept.astype(np.float32)).to(self.device))
            gnorm = float(gnorm)
            skipped = False
        else:
            # every update rejected: hold the global model for this round
            gnorm = 0.0
            skipped = True
        return {
            "round": self.round_idx,
            "loss": float(losses.mean()),
            "grad_norm_sq": gnorm,
            "client_loss": losses.cpu().numpy(),
            "bits": np.asarray(bits).copy(),
            "accepted": accept,
            "n_rejected": n_rejected,
            "gate_skipped": skipped,
        }

    @torch.no_grad()
    def evaluate(self, loss_fn, batch) -> dict:
        with ieee_f32():
            loss, aux = loss_fn(self.params, batch, None)
        out = {"loss": float(loss)}
        out.update({k: float(v) for k, v in aux.items()})
        return out


#: The round's own draws, kept at import: ``run_round`` takes K1's keyed
#: entry while ``round_uniforms`` is still this function.
_ROUND_UNIFORMS = FLSimulation.round_uniforms
