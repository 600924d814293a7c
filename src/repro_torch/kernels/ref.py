"""Plain PyTorch versions of every kernel of the port (the comparison targets).

Each computes the same function as its CUDA kernel with ordinary tensor
operations.  The CPU path runs these, and the chip checks hold each kernel
against them on the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

#: Finite "minus infinity" of the reference kernels: an empty softmax row
#: reports ``m = -1e30, l = 0``.
NEG_INF = -1e30


def sr_quant_fake_plain(w: torch.Tensor, u: torch.Tensor, step) -> torch.Tensor:
    """Stochastic rounding onto a grid of pitch ``step`` (paper Eq. 1).

    ``w``, ``u`` f32 of one shape (``u ~ U[0,1)`` supplied by the caller, so
    kernel and plain version share the randomness); ``step`` f32, a scalar or
    broadcastable to ``w`` (``s * Delta_q``); ``step == 0`` returns ``w``.
    No clip: the callers clamp to ``[-s, s]``.
    """
    step = torch.as_tensor(step, dtype=torch.float32, device=w.device)
    safe = torch.where(step > 0, step, torch.ones_like(step))
    t = w / safe
    lower = torch.floor(t)
    q = (lower + (u < (t - lower)).to(w.dtype)) * safe
    return torch.where(step > 0, q, w)


def f32_reciprocal(k: int) -> float:
    """``fl32(1 / k)``, the f32 reciprocal rounded to nearest, as a Python
    float (a tensor times it multiplies by that f32 value).  XLA compiles
    the reference's divisions by a constant (``s / lim``, ``/ n``,
    ``pmean``, the FSDP mean) into multiplications by the constant's f32
    reciprocal, so the port multiplies by it too (bit-equal as it runs)."""
    return float(np.float32(1) / np.float32(k))


def saturate_nonfinite(g: torch.Tensor) -> torch.Tensor:
    """The SR wire's ``"saturate"`` guard on ``g``, one leaf stacked over
    the clients ``(C, ...)``: NaN -> 0 and +-Inf -> +- the client's largest
    finite |g| in the leaf (0 where it has none); finite values pass
    unchanged."""
    if g.numel() == 0:
        return g
    dims = tuple(range(1, g.ndim))
    fin = torch.where(torch.isfinite(g), g.abs(), torch.zeros_like(g))
    fmax = fin.amax(dim=dims, keepdim=True) if dims else fin
    return torch.clamp(torch.where(torch.isnan(g), torch.zeros_like(g), g), -fmax, fmax)


#: Philox4x32-10's multipliers and key increments (Salmon et al., SC'11;
#: Random123's ``philox4x32``).
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF


def _mulhilo32(a: int, b: torch.Tensor):
    """``(hi, lo)`` 32-bit words of ``a * b`` for ``b`` int64 in [0, 2^32).
    The 64-bit product would overflow int64, so ``a`` goes in 16-bit halves
    (each partial product < 2^48)."""
    p_lo, p_hi = b * (a & 0xFFFF), b * (a >> 16)
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & _MASK32


def philox4x32_plain(ctr, key):
    """Philox4x32-10 of counters ``ctr`` (four int64 tensors of 32-bit
    words) under ``key`` (two ints, or two such tensors): four int64
    tensors of 32-bit words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo32(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo32(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + PHILOX_W[0]) & _MASK32, (k1 + PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def philox_uniforms_plain(key: int, n: int, device=None, stream: int = 0,
                          start: int = 0) -> torch.Tensor:
    """The ``n`` uniforms the keyed kernels draw under the 64-bit ``key``
    at columns ``start`` .. ``start + n - 1``: element ``i`` of column ``p
    = start + i`` is ``(x >> 8) * 2^-24`` with ``x`` word ``p % 4`` of
    Philox4x32-10 at counter ``(p // 4, p // 4 >> 32, stream, 0)``, key
    ``(key & 0xFFFFFFFF, key >> 32)``.  K1's inline entry draws stream 0;
    the keyed segment entries draw client ``c``'s row as stream ``c``."""
    g = torch.arange(start // 4, (start + n + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros_like(g)
    words = philox4x32_plain((g & _MASK32, g >> 32, torch.full_like(g, int(stream)), zero),
                             (int(key) & _MASK32, (int(key) >> 32) & _MASK32))
    x = torch.stack(words, dim=1).reshape(-1)[start % 4:start % 4 + n]
    return (x >> 8).to(torch.float32) * 2.0**-24


def philox_streams_plain(key: int, n_streams: int, n: int, device=None,
                         start: int = 0, c0: int = 0) -> torch.Tensor:
    """``(n_streams, n)``: row ``c`` is :func:`philox_uniforms_plain` stream
    ``c0 + c`` under ``key`` from column ``start``, client ``c0 + c``'s draws
    in the keyed segment entries (``c0``: the first client a rank holds)."""
    return torch.stack([philox_uniforms_plain(key, n, device, stream=c0 + c, start=start)
                        for c in range(n_streams)])


#: Float codes saturate to their integer type's range (as XLA's float-to-int
#: conversion does): the largest float of the range, and for int32 2^31 and
#: above go to INT32_MAX (2^31 - 1 is not a float).
_CODE_RANGE = {torch.int8: (-128.0, 127.0), torch.int16: (-32768.0, 32767.0),
               torch.int32: (-2.0**31, 2.0**31 - 128.0)}


def saturate_codes(codes: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Integer-valued f32 ``codes`` as ``dtype``, saturating (a NaN gives 0)."""
    lo, hi = _CODE_RANGE[dtype]
    c = torch.where(torch.isnan(codes), torch.zeros_like(codes), codes)
    out = torch.clamp(c, lo, hi).to(dtype)
    if dtype == torch.int32:
        out = torch.where(c >= 2.0**31, torch.full_like(out, 2**31 - 1), out)
    return out


def sr_quant_pack_plain(w: torch.Tensor, u: torch.Tensor, step, lim: int,
                        dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """Integer codes version: ``clip(floor(w/step) + [u < frac], -lim, lim)``
    as ``dtype`` (int8, int16 or int32, saturating).  ``step`` f32, a scalar
    or broadcastable to ``w``; ``step <= 0`` divides by 1."""
    step = torch.as_tensor(step, dtype=torch.float32, device=w.device)
    safe = torch.where(step > 0, step, torch.ones_like(step))
    t = w / safe
    lower = torch.floor(t)
    codes = lower + (u < (t - lower)).to(w.dtype)
    return saturate_codes(torch.clamp(codes, -float(lim), float(lim)), dtype)


def quant_matmul_ref(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                     out_dtype=torch.float32) -> torch.Tensor:
    """x (M,K) @ dequant(codes (K,N) int8/int16; w = codes*scale) -> (M,N)."""
    w = codes.to(torch.float32) * scale.to(torch.float32)
    return (x.to(torch.float32) @ w).to(out_dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q,k,v: (..., S, D).  Full-softmax reference, fp32 accumulation."""
    scale = q.shape[-1] ** -0.5
    s = (q.to(torch.float32) @ k.to(torch.float32).transpose(-1, -2)) * scale
    if causal:
        S = q.shape[-2]
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return (p @ v.to(torch.float32)).to(q.dtype)


def flash_decode_ref(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                     page_table: torch.Tensor, lengths: torch.Tensor):
    """Paged one-token attention, returning UNNORMALIZED ``(acc, m, l)``.

    ``q`` (B, KV, G, hd); pools (N_pool, page, KV, hd) f32/bf16;
    ``page_table`` (B, n_pmax) with -1 for unallocated pages; ``lengths``
    (B,) valid tokens per slot.  Keys in unallocated pages or at positions
    ``>= lengths[b]`` are masked; a slot with no valid key returns
    ``m = -1e30, l = 0, acc = 0``.  Normalize with ``acc / max(l, eps)``.
    """
    B, KV, G, hd = q.shape
    page = k_pages.shape[1]
    n_pmax = page_table.shape[1]
    pt = page_table.to(torch.long)
    pids = pt.clamp(min=0)
    kview = k_pages[pids].to(torch.float32).reshape(B, n_pmax * page, KV, hd)
    vview = v_pages[pids].to(torch.float32).reshape(B, n_pmax * page, KV, hd)
    pos = torch.arange(n_pmax * page, device=q.device)
    valid = ((pos[None, :] < lengths.to(torch.long)[:, None])
             & torch.repeat_interleave(pt >= 0, page, dim=1))        # (B, S)
    s = torch.einsum("bkgd,bskd->bkgs", q.to(torch.float32) * hd ** -0.5, kview)
    vmask = valid[:, None, None, :]
    s = torch.where(vmask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(vmask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgs,bskd->bkgd", p, vview)
    return acc, m, l
