"""FWQ — Flexible Weight-Quantized federated learning (paper Algorithm 1).

A round:

    1.  server broadcasts full-precision ``w^r``                     (line 2)
    2.  client i quantizes:  ``w~_i = Q_i(w^r)``  (SR, bit-width q_i) (line 4)
    3.  client i computes    ``g_i = (1/M) sum grad f(w~_i)``         (line 6)
        — the gradient is *evaluated at* the quantized weights; SR is
        piecewise-constant so there is no gradient through Q itself.
    4.  server aggregates    ``G = (1/N) sum_i g_i``  in full precision
        and applies          ``w^{r+1} = w^r - eta * G``         (lines 10-11)

The per-client resolutions arrive as a tensor ``delta[i] = 1/(2**q_i - 1)``,
so one round function serves every strategy the GBD layer emits.

Step 2 runs for all clients at once: :func:`quantize_clients
<repro_torch.core.quantization.quantize_clients>` rounds every (client,
leaf) segment in one K1 call, its uniforms drawn in the kernel from the
round's key (or taken from a ``(C, P)`` tensor the caller draws).  Step 3 then differentiates each client's loss with respect to
its quantized values, which under the straight-through estimator is the
gradient with respect to ``w``.  The clients run one after another (a loop,
not ``vmap``): their leading dimension may change from round to round
(elastic cohorts), and nothing here depends on it being fixed.

The round functions therefore take the *plain* loss
``loss_fn(params, batch, rng) -> (loss, aux)`` and quantize themselves; the
reference's take a client loss that quantizes inside its ``vmap``.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import quantization as quantlib

Params = dict
Batch = Any


class FWQMetrics(NamedTuple):
    loss: torch.Tensor               # mean client loss
    grad_norm_sq: torch.Tensor       # ||G||^2 of the aggregated gradient
    client_grad_norm_sq: torch.Tensor  # (n_clients,) per-client ||g_i||^2
    client_loss: torch.Tensor        # (n_clients,)


def make_tree_quant_loss(plain_loss_fn: Callable, *, exempt=quantlib.default_exempt):
    """One client's loss that tree-quantizes first:
    ``client_loss(params, batch, delta, u)`` with ``u`` the ``{path:
    uniforms}`` of ``quantize_tree``."""

    def client_loss(params, batch, delta, u):
        qparams = quantlib.quantize_tree(params, delta, u, exempt=exempt)
        return plain_loss_fn(qparams, batch, None)

    return client_loss


def _sq_norm(leaves) -> torch.Tensor:
    return sum((g * g).sum() for g in leaves)


def make_fwq_client_grads(plain_loss_fn: Callable, *, exempt=quantlib.default_exempt):
    """Phase 1 of a round: per-client losses/grads, no aggregation.

    ``grads_fn(params, batch, delta, u=None, *, key=None) -> (losses (C,),
    grads {path: (C, ...)}, gsq (C,), finite (C,))``.  ``batch`` leaves and
    ``delta`` have the cohort size C as leading dim; ``u`` is ``(C, P)``
    uniforms or ``key`` the round's key (see :func:`quantize_clients
    <repro_torch.core.quantization.quantize_clients>`).
    Pairing it with :func:`make_fwq_apply` splits the round at the uplink
    boundary of Algorithm 1 (between lines 6 and 10), where the resilient
    executor damages and gates updates.
    """

    def grads_fn(params, batch, delta, u=None, *, key=None):
        paths, _ = quantlib._flatten_with_paths(params)
        qs = quantlib.quantize_clients(params, delta, u, key=key, exempt=exempt)
        losses, grads = [], {p: [] for p in paths}
        for c in range(delta.shape[0]):
            leaves = {p: (qs[p][c] if p in qs else params[p]).detach().requires_grad_()
                      for p in paths}
            loss, _aux = plain_loss_fn(leaves, {k: v[c] for k, v in batch.items()}, None)
            for p, g in zip(paths, torch.autograd.grad(loss, [leaves[p] for p in paths])):
                grads[p].append(g)
            losses.append(loss.detach())
        grads = {p: torch.stack(v) for p, v in grads.items()}
        flat = [g.to(torch.float32).flatten(1) for g in grads.values()]
        gsqs = sum((g * g).sum(dim=1) for g in flat)
        finite = torch.stack([torch.isfinite(g).all(dim=1) for g in flat]).all(dim=0)
        return torch.stack(losses), grads, gsqs, finite

    return grads_fn


def _step(params, opt_state, G, opt_update):
    updates, opt_state = opt_update(G, opt_state, params)
    params = {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}
    return params, opt_state, _sq_norm(G.values())


def make_fwq_round(plain_loss_fn: Callable, opt_update: Callable, *,
                   exempt=quantlib.default_exempt):
    """The FWQ round function.

    Returns ``round_fn(params, opt_state, batch, delta, u=None, *, key=None)
    -> (params, opt_state, FWQMetrics)`` where ``batch`` leaves have leading
    dim ``n_clients``, ``delta`` is ``(n_clients,)`` f32 (0 = full
    precision), and the SR draws are ``u``, the ``(n_clients, P)`` uniforms,
    or drawn in K1 from the round's ``key``.
    """
    grads_fn = make_fwq_client_grads(plain_loss_fn, exempt=exempt)

    def round_fn(params, opt_state, batch, delta, u=None, *, key=None):
        losses, grads, gsqs, _finite = grads_fn(params, batch, delta, u, key=key)
        # server aggregation, full precision (line 10)
        G = {k: g.to(torch.float32).mean(dim=0) for k, g in grads.items()}
        params, opt_state, gnorm = _step(params, opt_state, G, opt_update)
        return params, opt_state, FWQMetrics(loss=losses.mean(), grad_norm_sq=gnorm,
                                             client_grad_norm_sq=gsqs, client_loss=losses)

    return round_fn


def make_fwq_apply(opt_update: Callable):
    """Phase 2 of a gated round: masked aggregation + server step.

    ``accept`` is an (n_clients,) 0/1 mask from the aggregation gate;
    rejected clients are excluded via ``where`` *before* the sum (a NaN
    times zero is still NaN) and survivors are reweighted by 1/n_accepted —
    the unbiased mean over the cohort that actually delivered valid updates.
    """

    def apply_fn(params, opt_state, grads, accept):
        w = accept.to(torch.float32)
        denom = torch.clamp(w.sum(), min=1.0)

        def agg(g):
            gf = g.to(torch.float32)
            mask = w.reshape((-1,) + (1,) * (gf.ndim - 1))
            return torch.where(mask > 0, gf, torch.zeros_like(gf)).sum(dim=0) / denom

        G = {k: agg(g) for k, g in grads.items()}
        return _step(params, opt_state, G, opt_update)

    return apply_fn


def delta_for_clients(bits, *, scale: float = 1.0,
                      n_clients: int | None = None) -> torch.Tensor:
    """(n_clients,) f32 resolutions ``s * Delta_{q_i}`` from a bit vector.

    ``bits`` is a per-client bit vector, or a
    :class:`repro_torch.api.precision.PrecisionPolicy` (pass ``n_clients``
    then — the policy's ``weights`` role supplies the per-device bits).
    ``scale`` defaults to 1.0 because ``sr_quantize`` applies the per-tensor
    ``s = ||w||_inf`` itself.
    """
    if hasattr(bits, "bits_vector"):  # PrecisionPolicy
        if n_clients is None:
            raise ValueError("delta_for_clients(policy) needs n_clients=")
        bits = bits.bits_vector(n_clients)
    d = quantlib.delta_from_bits(torch.as_tensor(np.asarray(bits)))
    return (torch.tensor(scale, dtype=torch.float32) * d).to(torch.float32)


# ---------------------------------------------------------------------------
# Inline mode: weight transform threaded through model forward passes.
# ---------------------------------------------------------------------------


def make_inline_quantizer(delta, seed: int = 0, *, exempt=quantlib.default_exempt,
                          uniforms=None, keys=None, out_dtype=None):
    """A ``param_transform(path, w) -> w_q`` callback for inline-mode models.

    ``delta``/``seed`` belong to one client.  Each call site's SR key is
    :func:`site_key` of ``(seed, _stable_hash(path))``, so quantization noise
    is independent across tensors but deterministic per (client, round) — as
    the reference's ``fold_in(rng, _stable_hash(path))``.  The path carries
    no layer index, so every layer of a stacked weight gets the same draws,
    in the reference and here.  A weight use is one call of K1's inline
    entry (:func:`~repro_torch.core.quantization.sr_quantize_keyed`: scale,
    uniforms drawn in the kernel, the straight-through value in
    ``out_dtype``, default ``w``'s).  ``keys(path) -> int`` replaces the
    seeded keys; ``uniforms(path, w) -> u`` takes the rounding from given
    uniforms instead (:func:`~repro_torch.core.quantization.sr_quantize`;
    the tests pass the reference's draws).
    """
    if keys is None:
        keys = functools.lru_cache(maxsize=None)(
            lambda path: site_key(seed, _stable_hash(path)))

    def transform(path: str, w: torch.Tensor) -> torch.Tensor:
        if exempt is not None and exempt(path, w):
            return w
        if uniforms is not None:
            q = quantlib.sr_quantize(w, delta, uniforms(path, w))
            return q if out_dtype is None else q.to(out_dtype)
        return quantlib.sr_quantize_keyed(w, delta, keys(path), out_dtype=out_dtype)

    return transform


def site_key(*entropy: int) -> int:
    """The 64-bit SR key of a call site: the first word of
    ``numpy.random.SeedSequence(entropy)``'s state."""
    return int(np.random.SeedSequence(tuple(int(e) for e in entropy))
               .generate_state(1, np.uint64)[0])


@functools.lru_cache(maxsize=4096)
def _stable_hash(path: str) -> int:
    h = 2166136261
    for ch in path.encode():
        h = ((h ^ ch) * 16777619) & 0x7FFFFFFF
    return h
