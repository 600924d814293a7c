"""Stochastic-rounding weight quantization (paper Eq. 1), packed integer
codes and the serving storage helpers.

A weight tensor ``w`` with per-tensor scale ``s = ||w||_inf`` is rounded onto
a uniform grid of pitch ``s * Delta_q``, ``Delta_q = 1 / (2**q - 1)``, by
*stochastic rounding* (SR, unbiased: ``E[Q(w)] = w``).  ``q = 32`` means
bypass (``Delta = 0``, ``Q(w) = w``).

Randomness is a tensor of uniforms ``u ~ U[0, 1)`` of the weight's shape,
supplied by the caller: the same ``u`` gives the same result on every device
and in the reference.  The rounding itself is the K1 kernel
(:func:`repro_torch.kernels.ops.sr_quantize_segments`): on a CUDA tensor it
launches ``csrc/sr_quant.cu``, on a CPU tensor it runs the plain version.
The trainer's inline weight uses take :func:`sr_quantize_keyed` instead: the
same function with the uniforms drawn inside K1 from a 64-bit site key
(Philox4x32-10), in one call that also takes the scale and casts to the
compute dtype.
Packing onto integer codes (:func:`pack_quantize`) is the K2 kernel
(:func:`repro_torch.kernels.ops.sr_pack_segments`), routed the same way.

Parameters are flat dicts ``{"stem/w": Tensor, ...}``.  Their leaf order is
the reference's (JAX sorts dict keys at every level), so leaf ``idx`` here is
leaf ``idx`` there: the per-leaf uniforms and the exemptions land on the same
tensors in both packages.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable

import torch

from repro_torch.kernels import ops

FULL_PRECISION_BITS = 32
#: Bit-widths the paper allows (powers of two, 8..32; 32 = no quantization).
PAPER_BITWIDTHS = (8, 16, 32)
#: Extended set used in some ablations (paper notes >=1 bit is feasible).
EXTENDED_BITWIDTHS = (4, 8, 16, 32)


def delta_from_bits(bits) -> torch.Tensor:
    """Quantization resolution ``Delta_q = 1/(2**q - 1)`` in f32; 0 for full
    precision.  Accepts ints or int tensors/arrays (per-client vectors).

    ``2**q`` is formed exactly (an integer shift), then ``- 1`` and the
    reciprocal round in f32.  The reference takes ``jnp.exp2``, which XLA's
    CPU backend computes a few ulp off for some q >= 13 (13, 15, 17, ...):
    there the two differ in the last bits (ROADMAP §3).
    """
    bits = torch.as_tensor(bits).to(torch.int64)
    full = bits >= FULL_PRECISION_BITS
    denom = (torch.ones_like(bits) << torch.clamp(bits, max=31)).to(torch.float32) - 1.0
    return torch.where(full, torch.zeros_like(denom), 1.0 / denom)


def tensor_scale(w: torch.Tensor) -> torch.Tensor:
    """Per-tensor scale ``s = ||w||_inf`` (paper Eq. 1); 1.0 for an all-zero
    tensor, whose scale is irrelevant."""
    s = w.abs().amax()
    return torch.where(s > 0, s, torch.ones_like(s)).to(torch.float32)


def channel_scale(w: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Per-channel variant of the scale (beyond-paper option, keepdims)."""
    s = w.abs().amax(dim=axis, keepdim=True)
    return torch.where(s > 0, s, torch.ones_like(s)).to(torch.float32)


def sr_quantize(w: torch.Tensor, delta, u: torch.Tensor, *,
                scale: torch.Tensor | None = None) -> torch.Tensor:
    """Fake-quantize ``w`` on the SR grid with resolution ``delta`` (Eq. 1).

    ``u`` holds one uniform per element of ``w``.  ``delta == 0`` returns
    ``w`` exactly.  The forward value is the reference's straight-through
    form ``w + (Q(w) - w)``; the gradient with respect to ``w`` is the
    identity (Algorithm 1 evaluates the gradient AT ``Q(w)`` and applies it
    to the full-precision ``w``).
    """
    wf = w.to(torch.float32)
    s = tensor_scale(wf.detach()) if scale is None else torch.as_tensor(
        scale, dtype=torch.float32, device=w.device)
    delta = torch.as_tensor(delta, dtype=torch.float32, device=w.device)
    n = wf.numel()
    offsets = torch.tensor([0, n], dtype=torch.int32, device=w.device)
    q = ops.sr_quantize_segments(wf.detach().reshape(-1), offsets, s.reshape(1),
                                 delta.reshape(1), u.to(torch.float32).reshape(1, n))
    q = q.reshape(w.shape)
    if wf.requires_grad:                  # identity gradient, value unchanged
        q = q + (wf - wf.detach())
    return q.to(w.dtype)


class _KeyedSR(torch.autograd.Function):
    """K1's inline entry forward; the identity backward of the
    straight-through estimator (the incoming gradient cast to ``w``'s
    dtype)."""

    @staticmethod
    def forward(ctx, w, delta, key, out_dtype):
        ctx.w_dtype = w.dtype
        return ops.sr_quantize_inline(w, delta, key, out_dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.w_dtype), None, None, None


def sr_quantize_keyed(w: torch.Tensor, delta, key: int, *,
                      out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """:func:`sr_quantize` of ``w`` with its uniforms drawn inside K1 from
    ``key`` (:func:`~repro_torch.kernels.ref.philox_uniforms_plain`),
    returned in ``out_dtype`` (default ``w.dtype``).

    Equal, bit for bit, to ``sr_quantize(w, delta, philox_uniforms_plain(key,
    w.numel()).reshape(w.shape)).to(out_dtype)``, and its gradient too; on
    the card one call of K1's inline entry, with ``delta`` read where it
    lies (keep it on ``w``'s device: a host value is copied there first).
    """
    delta = torch.as_tensor(delta, dtype=torch.float32, device=w.device)
    return _KeyedSR.apply(w, delta, int(key), out_dtype or w.dtype)


def nearest_quantize(w: torch.Tensor, delta) -> torch.Tensor:
    """Deterministic round-to-nearest on the same grid (biased; for ablations).

    Straight-through gradient, like :func:`sr_quantize`."""
    wf = w.to(torch.float32)
    s = tensor_scale(wf.detach())
    step = torch.as_tensor(delta, dtype=torch.float32, device=w.device) * s
    safe_step = torch.where(step > 0, step, torch.ones_like(step))
    q = torch.clamp(torch.round(wf.detach() / safe_step) * safe_step, -s, s)
    out = torch.where(step > 0, q, wf.detach())
    out = wf + (out - wf.detach()).detach()
    return out.to(w.dtype)


def storage_dtype(bits: int) -> torch.dtype:
    """Smallest signed integer dtype that holds codes in [-(2^b -1), 2^b -1]."""
    if bits <= 7:
        return torch.int8
    if bits <= 15:
        return torch.int16
    return torch.int32


# ---------------------------------------------------------------------------
# Packed (real) quantization: integer codes + scale.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PackedTensor:
    """Integer codes + scale.  ``w ~= codes * (scale * delta)``."""

    codes: torch.Tensor  # int8 (bits<=7), int16 (bits<=15) or int32
    scale: torch.Tensor  # f32 scalar or per-channel (keepdims) scale
    bits: int

    @property
    def delta(self) -> float:
        return 1.0 / (2.0**self.bits - 1.0)

    def nbytes(self) -> int:
        return self.codes.numel() * self.codes.element_size() + self.scale.numel() * 4


def pack_quantize(w: torch.Tensor, bits: int, u: torch.Tensor, *,
                  per_channel: bool = False, axis: int = -1) -> PackedTensor:
    """Really quantize: SR onto integer codes with ``2**bits - 1`` resolution.

    ``u`` holds one uniform per element of ``w``.  The pitch is ``s * Delta``
    (per tensor, or per channel along ``axis``); each channel is one segment
    of one K2 call, so the codes are the reference's for the same ``u``.
    """
    if bits >= FULL_PRECISION_BITS:
        raise ValueError("pack_quantize is for bits < 32; use the raw tensor.")
    if u.shape != w.shape:
        raise ValueError(f"pack_quantize: u {tuple(u.shape)} must have w's shape "
                         f"{tuple(w.shape)}")
    wf = w.to(torch.float32)
    s = channel_scale(wf, axis) if per_channel else tensor_scale(wf)
    delta = torch.tensor(1.0 / (2.0**bits - 1.0), dtype=torch.float32, device=w.device)
    step = s * delta
    dtype = storage_dtype(bits)
    lim = 2**bits - 1
    if per_channel:
        # the scale is shared along `axis`: moved last, each row is a segment
        rows = wf.movedim(axis, -1)
        n = rows.numel() // max(rows.shape[-1], 1)
        offsets = torch.arange(0, n + 1, dtype=torch.int32, device=w.device) * rows.shape[-1]
        codes = ops.sr_pack_segments(
            rows.reshape(1, -1), offsets, step.movedim(axis, -1).reshape(-1),
            u.to(torch.float32).movedim(axis, -1).reshape(1, -1), lim, dtype)
        codes = codes.reshape(rows.shape).movedim(-1, axis)
    else:
        offsets = torch.tensor([0, wf.numel()], dtype=torch.int32, device=w.device)
        codes = ops.sr_pack_segments(wf.reshape(1, -1), offsets, step.reshape(1),
                                     u.to(torch.float32).reshape(1, -1), lim, dtype)
        codes = codes.reshape(w.shape)
    return PackedTensor(codes=codes, scale=s, bits=bits)


def dequantize(p: PackedTensor, dtype=torch.float32) -> torch.Tensor:
    delta = torch.tensor(p.delta, dtype=torch.float32, device=p.codes.device)
    return (p.codes.to(torch.float32) * (p.scale * delta)).to(dtype)


# ---------------------------------------------------------------------------
# Parameter dicts with exemptions.
# ---------------------------------------------------------------------------

ExemptFn = Callable[[str, torch.Tensor], bool]

#: Substrings of parameter path names never quantized.
DEFAULT_EXEMPT_SUBSTRINGS = (
    "norm",        # RMSNorm / LayerNorm scales
    "/ln",         # block layer-norm scales (stacked: ndim 2)
    "ln_",
    "a_log",       # Mamba2 recurrence
    "dt_bias",
    "d_skip",
    "conv_",       # depthwise conv kernels (tiny, recurrence-adjacent)
    "router",      # MoE routing tables
    "bias",
)
# NOTE: vlm cross-attn gates are (L,)-scalars — exempted by the ndim<=1 rule.
# "w_gate" MLP projections are real weights and MUST stay quantizable.


def default_exempt(path: str, value: torch.Tensor) -> bool:
    low = path.lower()
    if value.ndim <= 1:  # vectors (biases, norm scales) — negligible size
        return True
    return any(sub in low for sub in DEFAULT_EXEMPT_SUBSTRINGS)


def _flatten_with_paths(params: dict):
    """``(paths, leaves)`` in the reference's leaf order: keys sorted level
    by level, as JAX flattens a nested dict."""
    paths = sorted(params, key=lambda p: tuple(p.split("/")))
    return paths, [params[p] for p in paths]


def quantizable_paths(params: dict, exempt: ExemptFn | None = default_exempt):
    """``[(leaf_index, path)]`` of the leaves SR touches, in leaf order."""
    paths, leaves = _flatten_with_paths(params)
    return [(i, p) for i, (p, v) in enumerate(zip(paths, leaves))
            if not (exempt is not None and exempt(p, v))]


def quantize_tree(params: dict, delta, u, *,
                  exempt: ExemptFn | None = default_exempt) -> dict:
    """Fake-quantize every non-exempt leaf at resolution ``delta``; ``u``
    maps each such leaf's path to uniforms of its shape."""
    out = dict(params)
    for _idx, path in quantizable_paths(params, exempt):
        out[path] = sr_quantize(params[path], delta, u[path])
    return out


def quantize_clients(params: dict, delta: torch.Tensor, u: torch.Tensor | None = None, *,
                     key: int | None = None,
                     exempt: ExemptFn | None = default_exempt) -> dict:
    """One round's per-client quantized copies, in ONE K1 call.

    ``delta`` (C,) per-client resolutions; ``u`` (C, P) uniforms over the
    quantizable leaves concatenated in leaf order (P elements in all), or,
    with ``u=None``, the round's 64-bit ``key``: K1's keyed segment entry
    then reads the leaves where they lie, makes their scales on the card and
    draws client ``c``'s row as stream ``c`` of
    :func:`~repro_torch.kernels.ref.philox_uniforms_plain` under ``key``.
    Returns ``{path: (C, *shape)}`` for every quantizable leaf.  The values
    are the reference's ``w + (Q_c(w) - w)`` and carry no gradient: the
    caller differentiates with respect to them directly, which under the
    straight-through estimator is the gradient with respect to ``w``.
    """
    if (u is None) == (key is None):
        raise ValueError("quantize_clients: pass exactly one of the uniforms u and a key")
    qpaths = [p for _i, p in quantizable_paths(params, exempt)]
    if not qpaths:
        return {}
    leaves = [params[p].detach().to(torch.float32) for p in qpaths]
    sizes = [leaf.numel() for leaf in leaves]
    C = delta.shape[0]
    if u is None:
        q = ops.sr_quantize_segments_keyed(leaves, delta, key)
    else:
        dev = leaves[0].device
        w = torch.cat([leaf.reshape(-1) for leaf in leaves])
        offsets = torch.tensor([0, *itertools.accumulate(sizes)], dtype=torch.int32,
                               device=dev)
        s = torch.stack([tensor_scale(leaf) for leaf in leaves])
        if u.shape != (C, w.numel()):
            raise ValueError(f"uniforms {tuple(u.shape)} for {C} clients x "
                             f"{w.numel()} quantizable elements")
        q = ops.sr_quantize_segments(w, offsets, s, delta.to(torch.float32), u)
    out = {}
    for path, leaf, chunk in zip(qpaths, leaves, q.split(sizes, dim=1)):
        out[path] = chunk.reshape(C, *leaf.shape)
    return out


def quantizable_size(params: dict,
                     exempt: ExemptFn | None = default_exempt) -> tuple[int, int]:
    """(quantizable_elements, total_elements) under the exemption policy."""
    paths, leaves = _flatten_with_paths(params)
    total = sum(int(v.numel()) for v in leaves)
    quant = sum(int(params[p].numel()) for _i, p in quantizable_paths(params, exempt))
    return quant, total


def expected_quant_mse(w: torch.Tensor, bits: int) -> float:
    """Upper bound ``(d/4) * delta^2`` from Lemma 3 (per-tensor, real units)."""
    wf = w.to(torch.float32)
    s = float(tensor_scale(wf))
    delta = float(delta_from_bits(bits))
    return wf.numel() / 4.0 * (s * delta) ** 2
