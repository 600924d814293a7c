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
are the plain PyTorch versions; :func:`attention_spec` and :func:`decode_spec`
state a launch's grid, tiles and shared memory for the static checker
(``repro_torch.analyze.kernel_check``), from the same plans.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref as flash_attention_plain  # noqa: F401
from repro_torch.kernels.ref import flash_decode_ref as flash_decode_plain  # noqa: F401
from repro_torch.kernels.spec import BlockOperand, KernelSpec, ScalarOperand, ScratchSpec

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


# ---------------------------------------------------------------------------
# Launch-grid metadata (kernels/spec.py): each map restates the kernel's
# block-to-tile arithmetic at the cited line of csrc/flash_attention.cu
# ---------------------------------------------------------------------------

_SRC = "src/repro_torch/csrc/flash_attention.cu"


def _attention_maps(n_qtiles: int, S: int, block_q: int, block_k: int, causal: bool):
    """K4's maps over the grid ``(q tiles, BH, key-tile walk)``.

    :297 ``flash_attention_wgmma`` and :558 ``flash_attention_split``: block
    ``x`` of head ``bh = blockIdx.y`` takes the q tile ``n_tiles - 1 - x``
    (the longest causal rows first), rows ``q0 = (gridDim.x - 1 - x) * BQ``,
    and walks key tiles ``t < ceil(kend / BK)`` with ``kend = min(S, q0 +
    BQ)`` causal, ``S`` not; TMA clips rows past ``S``."""

    def q_map(x, bh, t):
        return (bh, n_qtiles - 1 - x, 0)

    def kv_map(x, bh, t):
        q0 = (n_qtiles - 1 - x) * block_q
        kend = min(S, q0 + block_q) if causal else S
        return (bh, t, 0) if t < -(-kend // block_k) else None

    return q_map, kv_map


def attention_spec(BH: int, S: int, D: int, *, dtype: torch.dtype = torch.float32,
                   causal: bool = True, num_sms: int = _build.H100_SMS) -> KernelSpec:
    """K4's launch at ``q, k, v (BH, S, D)`` as a :class:`KernelSpec`, from
    the same :func:`plan_attention` call :func:`flash_attention_cuda` makes.
    ``S`` is the real sequence length: the kernel masks keys and rows past
    it.  The shared-memory regions restate ``FwTiles`` (wgmma) or
    ``FsTiles`` (wgmma_split) and add up to :func:`attention_smem_bytes`."""
    p = plan_attention(BH, S, D, dtype, bool(causal), num_sms)
    bq, bk = p.block_q, p.block_k
    nq = -(-S // bq)
    q_map, kv_map = _attention_maps(nq, S, bq, bk, bool(causal))
    grid = (nq, BH, -(-S // bk))
    guard = (False, True, False)
    ins = (BlockOperand("q", (BH, S, D), (1, bq, D), q_map, guarded=guard),
           BlockOperand("k", (BH, S, D), (1, bk, D), kv_map, guarded=guard),
           BlockOperand("v", (BH, S, D), (1, bk, D), kv_map, guarded=guard))
    outs = (BlockOperand("out", (BH, S, D), (1, bq, D), q_map, guarded=guard),)

    def smem(name, shape, dt):
        return ScratchSpec(name, shape, dt, space="smem", accumulates=False)

    if p.path == "wgmma":
        regions = (smem("q", (bq, D), "bfloat16"),
                   smem("k_ring", (_FA_STAGES, bk, D), "bfloat16"),
                   smem("v_ring", (_FA_STAGES, bk, D), "bfloat16"),
                   smem("barriers", (2 * _FA_STAGES + 1,), "uint64"))
        line = 297
    else:
        regions = (smem("q_hi_lo", (2, bq, D), "bfloat16"),
                   smem("kv_split_or_q_f32", (max(4 * 2 * bk * D, 4 * bq * D),), "uint8"),
                   smem("kv_f32", (2, bk, D), "float32"),
                   smem("barriers", (3,), "uint64"))
        line = 558
    scratch = regions + (smem("align", (1024,), "uint8"),
                         ScratchSpec("m", (bq, 1), "float32"),
                         ScratchSpec("l", (bq, 1), "float32"),
                         ScratchSpec("acc", (bq, D), "float32", binds="out"))
    return KernelSpec("flash_attention", f"{_SRC}:{line}", grid, ins, outs, scratch,
                      path=p.path, smem_bytes=p.smem, plan=p, causal=bool(causal))


def _decode_maps(n_heads_groups: int, page: int, per: int, page_table, lengths):
    """K5's maps over the grid ``(split, KV * ceil(G / GB), B, page walk)``.

    :872 ``flash_decode_split``: block ``(r, y, b)`` is rank ``r`` of the
    cluster of KV head ``h = y / ngh``, queries ``[g0, g0 + GB)`` with ``g0 =
    (y % ngh) * GB``, slot ``b``; it walks pages ``j = r * pages_per_block +
    t`` of the slot's table, reading pool row ``page_table[b, j]`` only where
    the entry is >= 0 and the page starts before the length; the cluster's
    ranks write slices of the slot's output tile (stated at rank 0)."""

    def q_map(r, y, b, t):
        return (b, y // n_heads_groups, y % n_heads_groups, 0)

    def out_map(r, y, b, t):
        return q_map(r, y, b, t) if r == 0 and t == 0 else None

    def kv_map(r, y, b, t):
        j = r * per + t
        if j >= len(page_table[b]) or j * page >= lengths[b] or page_table[b][j] < 0:
            return None
        return (page_table[b][j], 0, y // n_heads_groups, 0)

    return q_map, out_map, kv_map


def decode_spec(B: int, KV: int, G: int, hd: int, *, page: int, n_pool: int, page_table,
                lengths, q_dtype: torch.dtype = torch.float32,
                pool_dtype: torch.dtype = torch.float32,
                num_sms: int = _build.H100_SMS) -> KernelSpec:
    """K5's launch as a :class:`KernelSpec`, from the same
    :func:`plan_decode` call :func:`flash_decode_cuda` makes.

    ``page_table`` (B, n_pmax) / ``lengths`` (B,) are CONCRETE int arrays:
    the checker enumerates the same table-dereferencing map the kernel
    walks, and the scalar ranges (an entry in ``[-1, n_pool)``, a length at
    most the slot's pages) are what its addressing is safe under.  G is not
    padded: the queries past G of the last group are masked."""
    import numpy as np

    pt = np.asarray(page_table, dtype=np.int64)
    ln = np.asarray(lengths, dtype=np.int64)
    n_pmax = pt.shape[1]
    p = plan_decode(B, KV, G, hd, page, n_pmax, q_dtype, pool_dtype, num_sms)
    ngh = -(-G // p.group)
    q_map, out_map, kv_map = _decode_maps(ngh, page, p.pages_per_block, pt.tolist(),
                                          ln.tolist())
    grid = (p.split, KV * ngh, B, p.pages_per_block)
    g_guard = (False, False, True, False)
    steer = ("page_table", "lengths")
    ins = (BlockOperand("q", (B, KV, G, hd), (1, 1, p.group, hd), q_map, guarded=g_guard),
           BlockOperand("k_pages", (n_pool, page, KV, hd), (1, page, 1, hd), kv_map,
                        coverage="any", steered_by=steer),
           BlockOperand("v_pages", (n_pool, page, KV, hd), (1, page, 1, hd), kv_map,
                        coverage="any", steered_by=steer))
    outs = (BlockOperand("acc", (B, KV, G, hd), (1, 1, p.group, hd), out_map,
                         guarded=g_guard),
            BlockOperand("m", (B, KV, G, 1), (1, 1, p.group, 1), out_map, guarded=g_guard),
            BlockOperand("l", (B, KV, G, 1), (1, 1, p.group, 1), out_map, guarded=g_guard))
    es = torch.empty((), dtype=pool_dtype).element_size()
    stage = 2 * (2 * _FD_T if hd * es <= 512 else _FD_T) * hd * es
    ring = min(8, max(2, _FD_RING_BYTES // stage)) * stage
    warps = _FD_WARPS * p.group * hd * 4

    def smem(name, shape, dt):
        return ScratchSpec(name, shape, dt, space="smem", accumulates=False)

    scratch = (smem("ring_or_warp_acc", (max(ring, warps),), "uint8"),
               smem("rank_slices", (p.group * hd + 4 * MAX_CLUSTER,), "float32"),
               smem("small", (_FD_SMALL_WORDS,), "int32"),
               ScratchSpec("m_run", (p.group, 1), "float32"),
               ScratchSpec("l_run", (p.group, 1), "float32"),
               ScratchSpec("acc_run", (p.group, hd), "float32", binds="acc"))
    scalars = (ScalarOperand("page_table", pt.reshape(-1), -1, n_pool - 1,
                             note=f"-1 = unallocated (never read); valid pool rows are "
                                  f"[0, {n_pool})"),
               ScalarOperand("lengths", ln, 0, n_pmax * page,
                             note=f"{n_pmax} pages x {page} slots owned at most"))
    return KernelSpec("flash_decode", f"{_SRC}:872", grid, ins, outs, scratch, scalars,
                      path="split", smem_bytes=p.smem, plan=p)


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
