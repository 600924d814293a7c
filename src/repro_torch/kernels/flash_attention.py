"""K4 flash attention (prefill) and K5 paged flash-decode, CUDA kernels for Hopper.

K4 replaces ``repro/kernels/flash_attention.py:flash_attention_kernel`` and
K5 replaces ``flash_decode_kernel`` in the same file.  Both kernels live in
``csrc/flash_attention.cu``; its notes say what bounds each on an H100 and
what the design does about it (K4: shared-memory K/V tiles with an online
softmax that stops at the causal diagonal; K5: one block per (KV head,
slot) whose warps walk the page table in parallel, never reading an
unallocated or out-of-length page, and merge their partial softmaxes).

``*_cuda`` launch the kernels; ``*_plain`` are the plain PyTorch versions.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref as flash_attention_plain  # noqa: F401
from repro_torch.kernels.ref import flash_decode_ref as flash_decode_plain  # noqa: F401

HEAD_DIMS = (16, 32, 64, 128)
_FLOATS = (torch.float32, torch.bfloat16)
_DECODE_MAX_G = 16            # csrc: FD_MAXG (queries per KV head)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """q, k, v (BH, S, D) f32/bf16 -> (BH, S, D) in q's dtype."""
    name = "flash_attention"
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q, k, v must share one (BH, S, D) shape")
    if q.dtype not in _FLOATS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k, v must all be f32 or all bf16")
    BH, S, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not in {HEAD_DIMS}")
    _build.require_cuda(name, q, k, v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = _build.lib().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _build.DTYPE_CODES[q.dtype], BH, S, D, int(bool(causal)),
        _build.stream_of(q))
    _build.check_launch(name, err)
    _build.LAUNCHES[name] += 1
    return out


def flash_decode_cuda(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                      page_table: torch.Tensor, lengths: torch.Tensor):
    """One query token per slot against a paged pool -> f32 ``(acc, m, l)``.

    ``q`` (B, KV, G, hd) f32/bf16; pools (N_pool, page, KV, hd) f32/bf16;
    ``page_table`` (B, n_pmax) int32 holding -1 or a row of the pool;
    ``lengths`` (B,) int32.
    """
    name = "flash_decode"
    if q.ndim != 4 or k_pages.ndim != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"{name}: q (B,KV,G,hd) and pools (N,page,KV,hd) expected")
    B, KV, G, hd = q.shape
    _n_pool, page, kv_p, hd_p = k_pages.shape
    if (kv_p, hd_p) != (KV, hd):
        raise ValueError(f"{name}: pool heads/dim {(kv_p, hd_p)} != q's {(KV, hd)}")
    if page_table.ndim != 2 or page_table.shape[0] != B or lengths.shape != (B,):
        raise ValueError(f"{name}: page_table (B, n_pmax) and lengths (B,) expected")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError(f"{name}: page_table and lengths must be int32")
    if q.dtype not in _FLOATS or k_pages.dtype not in _FLOATS or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"{name}: q and pools must be f32 or bf16")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} not in {HEAD_DIMS}")
    if G > _DECODE_MAX_G:
        raise ValueError(f"{name}: {G} queries per KV head exceeds {_DECODE_MAX_G}")
    _build.require_cuda(name, q, k_pages, v_pages, page_table, lengths)
    n_pmax = page_table.shape[1]
    acc = torch.empty((B, KV, G, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((B, KV, G, 1), dtype=torch.float32, device=q.device)
    l = torch.empty((B, KV, G, 1), dtype=torch.float32, device=q.device)
    if acc.numel() == 0:
        return acc, m, l
    err = _build.lib().repro_flash_decode(
        q.data_ptr(), _build.DTYPE_CODES[q.dtype], k_pages.data_ptr(),
        v_pages.data_ptr(), _build.DTYPE_CODES[k_pages.dtype],
        page_table.data_ptr(), lengths.data_ptr(), acc.data_ptr(), m.data_ptr(),
        l.data_ptr(), B, KV, G, hd, page, n_pmax, _build.stream_of(q))
    _build.check_launch(name, err)
    _build.LAUNCHES[name] += 1
    return acc, m, l
