"""K4 flash attention (prefill) and K5 paged flash-decode, CUDA kernels for Hopper.

K4 replaces ``repro/kernels/flash_attention.py:flash_attention_kernel`` and
K5 replaces ``flash_decode_kernel`` in the same file.  Both kernels live in
``csrc/flash_attention.cu``; its notes say what bounds each on an H100 and
what the design does about it (K4: both products on the bf16 wgmma tensor
cores fed by TMA, f32 inputs as three split bf16 products; K5: a
slot's pages split across the blocks of a thread-block cluster, each
streaming its pages through a cp.async ring without reading an unallocated
or out-of-length page, the partial softmaxes merged in rank order through
distributed shared memory).

:func:`plan_attention` picks K4's path and tiles and :func:`plan_decode`
K5's split, from the shapes alone; ``*_cuda`` launch the kernels; ``*_plain``
are the plain PyTorch versions.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref as flash_attention_plain  # noqa: F401
from repro_torch.kernels.ref import flash_decode_ref as flash_decode_plain  # noqa: F401

#: Head dims both kernels take (the C dispatchers' cases).
HEAD_DIMS = (16, 32, 64, 128, 256)
_FLOATS = (torch.float32, torch.bfloat16)
# K5's constants (csrc/flash_attention.cu: FD_*), kept in sync by hand
DECODE_MAX_G = 16             # queries per KV head
DECODE_GROUP = 8              # queries a block takes at most
MAX_CLUSTER = 16              # blocks of a cluster the kernel takes (above 8: non-portable)
MAX_DECODE_SPLIT = 12         # the plan's split at most
MAX_SMEM = 232_448            # dynamic shared memory a block can have
_FD_WARPS = 8
_FD_T = 16                    # tokens of one walk step (a page of 16)
_FD_RING_BYTES = 96 * 1024    # the cp.async ring: 2-8 stages of K and V
MAX_DECODE_PAGES = 512        # pages a block's range holds at most
_FD_SMALL_WORDS = (2 * MAX_DECODE_PAGES + _FD_WARPS + 8 * _FD_WARPS * DECODE_GROUP
                   + 3 * MAX_CLUSTER * DECODE_GROUP)


#: K4's paths (csrc/flash_attention.cu: AttnPath): bf16 on ``wgmma``, f32 on
#: ``wgmma_split`` (three bf16 products a matrix product).
ATTN_PATHS = ("wgmma", "wgmma_split")
#: (block_q, block_k) the wgmma path takes, by head dim (csrc: dispatch_fw_tile):
#: one or two warpgroups of 64 query rows by 64 or 128 keys a tile at head
#: dims 64 and 128; head dim 256 takes one warpgroup by 64 keys, its output
#: accumulator alone holding 128 registers a thread (two warpgroups would
#: spill).  Head dim 16 takes 64 by 64 and the one alternative that wins an
#: ``attn_sweep`` row (128 by 64 at S 128), head dim 32 the plan's tile only.
_FW_TILES = ((64, 64), (64, 128), (128, 64), (128, 128))
ATTN_TILES = {16: ((64, 64), (128, 64)), 32: ((64, 64),), 64: _FW_TILES, 128: _FW_TILES,
              256: ((64, 64),)}
#: The plan's wgmma tile: the fastest, or within 4% of it, at each row of
#: ``chip_smoke.py`` phase ``attn_sweep`` on an H100 (PERF.md §6).
ATTN_TILE = (64, 64)
_FA_STAGES = 2                # the wgmma path's K/V ring
#: (block_q, block_k) the split path takes, by head dim (csrc:
#: dispatch_fs_tile): one warpgroup of 64 query rows by 32 keys, or by 64
#: up to head dim 64; two warpgroups (128 rows) sharing each 64-key tile at
#: head dims 64 and 128 (a 64-key tile does not fit at 256).
ATTN_SPLIT_TILES = {16: ((64, 64), (64, 32)), 32: ((64, 64), (64, 32)),
                    64: ((64, 64), (64, 32), (128, 64)), 128: ((128, 64), (64, 32)),
                    256: ((64, 32),)}
#: The plan's split tile by head dim: the fastest at each f32 row of
#: ``chip_smoke.py`` phase ``attn_sweep`` on an H100 (PERF.md §6); at head
#: dim 64, where no tile is fastest at both S 128 and S 513, the one that
#: loses least to the fastest at either (7%).
ATTN_SPLIT_TILE = {16: (64, 64), 32: (64, 64), 64: (128, 64), 128: (128, 64), 256: (64, 32)}


def attention_smem_bytes(path: str, D: int, block_q: int, block_k: int) -> int:
    """K4's dynamic shared memory a block, its mbarriers and 1024 bytes to
    align the swizzle atoms included.  wgmma (csrc: FwTiles::SMEM): the bf16
    q tile and a two-stage ring of bf16 K and V tiles; wgmma_split (csrc:
    FsTiles::SMEM): bf16 q hi and lo (the f32 output tile at the end), the
    four split K and V tiles (or the f32 q tile, if larger), one f32 K and
    V tile."""
    if path == "wgmma":
        return (2 * block_q * D + _FA_STAGES * 2 * 2 * block_k * D
                + (2 * _FA_STAGES + 1) * 8 + 1024)
    if path == "wgmma_split":
        return (2 * 2 * block_q * D + max(4 * 2 * block_k * D, 4 * block_q * D)
                + 2 * 4 * block_k * D + 3 * 8 + 1024)
    raise ValueError(f"unknown K4 path {path!r}")


class AttentionPlan(NamedTuple):
    """One launch of K4: ``path`` (``"wgmma"`` or ``"wgmma_split"``),
    ``block_q`` query rows and ``block_k`` keys a tile, ``smem`` bytes of
    shared memory a block and ``blocks`` in the grid."""
    path: str
    block_q: int
    block_k: int
    smem: int
    blocks: int


def attention_plan_for(path: str, BH: int, S: int, D: int, block_q: int,
                       block_k: int) -> AttentionPlan:
    """The :class:`AttentionPlan` of one tile choice (``attn_sweep`` times
    each)."""
    return AttentionPlan(path, block_q, block_k,
                         attention_smem_bytes(path, D, block_q, block_k),
                         BH * -(-S // block_q))


@functools.lru_cache(maxsize=None)
def plan_attention(BH: int, S: int, D: int, dtype: torch.dtype, causal: bool,
                   num_sms: int = _build.H100_SMS) -> AttentionPlan:
    """K4's launch, from the shapes and type alone.

    It reads no tensor, so a prefill plans without waiting for the card
    (and could be captured in a CUDA graph).  bf16 takes the wgmma path at
    :data:`ATTN_TILE` (64 query rows, one warpgroup, by 64 keys a tile);
    f32 takes the split path at :data:`ATTN_SPLIT_TILE` of its head dim.
    ``causal`` and ``num_sms`` do not change the launch; they complete the
    key.
    """
    del causal, num_sms
    if dtype == torch.bfloat16 and D in ATTN_TILES:
        return attention_plan_for("wgmma", BH, S, D, *ATTN_TILE)
    if dtype == torch.float32 and D in ATTN_SPLIT_TILES:
        return attention_plan_for("wgmma_split", BH, S, D, *ATTN_SPLIT_TILE[D])
    raise ValueError(f"flash_attention: no K4 path for {dtype} at head dim {D}")


def decode_smem_bytes(group: int, hd: int, pool_dtype: torch.dtype) -> int:
    """K5's dynamic shared memory a block (csrc: fd_smem_bytes): the ring of
    K and V stages (32 rows a stage, 16 above 512-byte rows), which the
    warps' partial accumulators reuse; the output slices the cluster's
    blocks send; the small arrays (the range's valid pages among them)."""
    es = torch.empty((), dtype=pool_dtype).element_size()
    stage = 2 * (2 * _FD_T if hd * es <= 512 else _FD_T) * hd * es
    ring = min(8, max(2, _FD_RING_BYTES // stage)) * stage
    warps = _FD_WARPS * group * hd * 4
    return max(ring, warps) + 4 * (group * hd + 4 * MAX_CLUSTER) + 4 * _FD_SMALL_WORDS


class DecodePlan(NamedTuple):
    """One launch of K5.  A block takes ``group`` queries of one KV head (G
    padded up to a power of two, at most 8, whose q and accumulators live in
    registers); the page axis is split over ``split`` blocks of a cluster,
    block r taking pages ``[r * pages_per_block, (r + 1) * pages_per_block)``
    (the last range cut at n_pmax).  ``smem`` bytes of shared memory a
    block, ``blocks`` in the grid."""
    split: int
    pages_per_block: int
    group: int
    smem: int
    blocks: int


@functools.lru_cache(maxsize=None)
def plan_decode(B: int, KV: int, G: int, hd: int, page: int, n_pmax: int,
                q_dtype: torch.dtype, pool_dtype: torch.dtype,
                num_sms: int = _build.H100_SMS) -> DecodePlan:
    """K5's launch, from the shapes and types alone.

    It never reads the lengths or the page table, so a decode step plans
    without waiting for the card (and could be captured in a CUDA graph).
    The (slot, KV head, query group) triples take enough blocks each to give
    about two blocks an SM (two fit, by shared memory), at most
    :data:`MAX_DECODE_SPLIT` and at most one a page; the split then drops
    to the number of ranges the pages fill, so every block has a non-empty
    range.  Splits above 8 run as non-portable clusters; 12 is the largest
    the plan takes, the best measured on an H100 at 256 pages (``chip_smoke.py``
    phase ``decode_sweep``, PERF.md).  ``page`` and ``q_dtype`` do not
    change the launch; they complete its key.
    """
    del page, q_dtype
    group = 1
    while group < min(G, DECODE_GROUP):
        group *= 2
    units = max(1, B * KV * -(-G // group))
    split = max(1, min(MAX_DECODE_SPLIT, n_pmax, -(-2 * num_sms // units)))
    per = max(1, -(-n_pmax // split))
    split = max(1, -(-n_pmax // per))
    if per > MAX_DECODE_PAGES:
        raise ValueError(f"flash_decode: {n_pmax} pages a slot exceed "
                         f"{split * MAX_DECODE_PAGES}")
    return DecodePlan(split, per, group, decode_smem_bytes(group, hd, pool_dtype),
                      split * B * KV * -(-G // group))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True,
                         attn_plan: AttentionPlan | None = None) -> torch.Tensor:
    """q, k, v (BH, S, D) f32/bf16 -> (BH, S, D) in q's dtype.

    The launch follows :func:`plan_attention`; ``attn_plan`` overrides it
    (to time the alternatives), and the launcher refuses a plan its kernels
    do not take.
    """
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
    p = attn_plan or plan_attention(BH, S, D, q.dtype, bool(causal),
                                    _build.sm_count(q.device))
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: q, k and v must start on 16-byte boundaries (TMA)")
    err = _build.lib().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _build.DTYPE_CODES[q.dtype], BH, S, D, int(bool(causal)),
        _build.stream_of(q), ATTN_PATHS.index(p.path), p.block_q, p.block_k)
    _build.check_launch(name, err)
    _build.LAUNCHES[name] += 1
    return out


def flash_decode_cuda(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                      page_table: torch.Tensor, lengths: torch.Tensor,
                      decode_plan: DecodePlan | None = None):
    """One query token per slot against a paged pool -> f32 ``(acc, m, l)``.

    ``q`` (B, KV, G, hd) f32/bf16; pools (N_pool, page, KV, hd) f32/bf16;
    ``page_table`` (B, n_pmax) int32 holding -1 or a row of the pool;
    ``lengths`` (B,) int32.  The launch follows :func:`plan_decode`;
    ``decode_plan`` overrides it (to time the alternatives), and the
    launcher refuses a plan its kernels do not take.
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
    if G > DECODE_MAX_G:
        raise ValueError(f"{name}: {G} queries per KV head exceeds {DECODE_MAX_G}")
    _build.require_cuda(name, q, k_pages, v_pages, page_table, lengths)
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError(f"{name}: the pools must start on 16-byte boundaries")
    n_pmax = page_table.shape[1]
    acc = torch.empty((B, KV, G, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((B, KV, G, 1), dtype=torch.float32, device=q.device)
    l = torch.empty((B, KV, G, 1), dtype=torch.float32, device=q.device)
    if acc.numel() == 0:
        return acc, m, l
    p = decode_plan or plan_decode(B, KV, G, hd, page, n_pmax, q.dtype, k_pages.dtype,
                                   _build.sm_count(q.device))
    err = _build.lib().repro_flash_decode(
        q.data_ptr(), _build.DTYPE_CODES[q.dtype], k_pages.data_ptr(),
        v_pages.data_ptr(), _build.DTYPE_CODES[k_pages.dtype],
        page_table.data_ptr(), lengths.data_ptr(), acc.data_ptr(), m.data_ptr(),
        l.data_ptr(), B, KV, G, hd, page, n_pmax, _build.stream_of(q), p.split,
        p.pages_per_block, p.group)
    _build.check_launch(name, err)
    _build.LAUNCHES[name] += 1
    return acc, m, l
