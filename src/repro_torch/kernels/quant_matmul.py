"""K3: int8/int16-weight dequantize-matmul, a CUDA kernel for Hopper.

Replaces the Pallas kernel ``repro/kernels/quant_matmul.py:quant_matmul_kernel``
(``x @ (codes * scale)`` with the weight streamed as integer codes and
dequantized tile by tile).  The kernel is ``csrc/quant_matmul.cu``; its notes
say what bounds it on an H100 (weight bytes at decode, operations at
prefill) and how each path is shaped for that.

:func:`plan` picks the path and its tile from the shapes and types;
:func:`quant_matmul_cuda` launches it with that plan; :func:`quant_matmul_plain`
is the plain PyTorch version of the same function; :func:`kernel_spec` states
the launch's grid, tiles and shared memory for the static checker
(``repro_torch.analyze.kernel_check``), from the same plan.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import quant_matmul_ref as quant_matmul_plain  # noqa: F401
from repro_torch.kernels.spec import BlockOperand, KernelSpec, ScratchSpec

NAME = "quant_matmul"

#: Path tags of the C launcher (csrc/quant_matmul.cu: enum Path).
PATHS = {"cluster": 0, "wgmma": 1, "tiled": 2, "ragged": 3}
#: Streaming multiprocessors of an H100 SXM (the plan's default).
H100_SMS = _build.H100_SMS
#: Blocks of one thread-block cluster at most (the portable size).
MAX_CLUSTER = 8
_CL_ACC = 64          # accumulators a thread on the cluster path
_CL_MIN_ROWS = 64     # K rows a block of a cluster keeps at least
_CL_BLOCKS_PER_SM = 1.5
#: a ragged-path block's fixed cost (filling its pipeline, loading x, the
#: tree and the merge) in code bytes streamed: the timings of every tile and
#: split at the unembeds' shapes on an H100 (PERF.md, K3 ragged) rank best so
_RG_FIXED_BYTES = 131072
_RG_BLOCKS_PER_SM = 2   # the kernel's __launch_bounds__ (its smem fits twice)
_GPCS = 8               # an H100's GPCs, whose SMs a cluster's blocks share
#: (rows, columns) output tiles of the wgmma path, each with its device time
#: per output element relative to 128 x 128 at full occupancy (measured on
#: an H100 at yi-6b's shapes: PERF.md).
WGMMA_TILES = {(128, 256): 0.8, (128, 128): 1.0, (64, 128): 1.26, (64, 64): 1.2}


class Plan(NamedTuple):
    """One launch of K3.

    ``cluster`` and ``ragged``: ``tile_m`` rows of accumulators (4, 8 or
    16), ``tile_n`` columns a block, K split over ``split`` blocks of one
    cluster.  ``wgmma``: a ``tile_m`` x ``tile_n`` output tile a block.
    ``tiled``: 128 x 128.
    """
    path: str
    tile_m: int
    tile_n: int
    split: int

    def blocks(self, M: int, N: int) -> int:
        return _cdiv(M, self.tile_m) * _cdiv(N, self.tile_n) * self.split


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def plan(M: int, K: int, N: int, x_dtype: torch.dtype, code_dtype: torch.dtype,
         num_sms: int = H100_SMS, aligned: bool = True) -> Plan:
    """The path and tile for ``x (M,K) @ codes (K,N)``.

    ``aligned``: x and codes start on 16-byte boundaries.  TMA, which feeds
    the cluster and wgmma paths, needs that and 16-byte row strides; other
    shapes take the ragged path at M <= 16 and the tiled path above.
    Cached: a decode step asks for the same few shapes 225 times.
    """
    size = 1 if code_dtype == torch.int8 else 2
    x_size = 2 if x_dtype == torch.bfloat16 else 4
    if M <= 16:
        maxm = 4 if M <= 4 else 8 if M <= 8 else 16
        if aligned and N * size % 16 == 0 and K * x_size % 16 == 0:
            return _plan_cluster(maxm, K, N, size, num_sms)
        return _plan_ragged(maxm, K, N, size, num_sms)
    if (M > 16 and x_dtype == torch.bfloat16 and code_dtype == torch.int8 and K % 8 == 0
            and N % 16 == 0 and aligned):
        # least time: waves of blocks x a tile's time (one block an SM)
        bm, bn = min((t for t in WGMMA_TILES if M > 64 or t[0] == 64),
                     key=lambda t: (_cdiv(_cdiv(M, t[0]) * _cdiv(N, t[1]), num_sms)
                                    * t[0] * t[1] * WGMMA_TILES[t], -t[1]))
        return Plan("wgmma", bm, bn, 1)
    return Plan("tiled", 128, 128, 1)


def _plan_cluster(maxm: int, K: int, N: int, size: int, num_sms: int) -> Plan:
    """Column tile and cluster size of the decode path.

    Blocks as near ``_CL_BLOCKS_PER_SM`` per SM as the shapes allow, never
    fewer than one per SM; then the smaller cluster, then the wider tile.
    One block per SM leaves the SM with too few TMA bytes in flight; two
    per SM in large clusters do not all fit on the card at once (measured
    on an H100: PERF.md).  The column tile narrows from 32 lanes down to a
    16-byte row of codes (TMA's least box row); K splits over 1-8 blocks of
    a cluster, each keeping at least ``_CL_MIN_ROWS`` rows.
    """
    cpl = _CL_ACC // maxm
    max_split = max(1, min(MAX_CLUSTER, K // _CL_MIN_ROWS))
    ranked = []
    lanes = 32
    while lanes >= 1 and lanes * cpl * size >= 16:
        tiles = _cdiv(N, lanes * cpl)
        for split in range(1, max_split + 1):
            blocks = tiles * split
            key = ((0, abs(blocks - _CL_BLOCKS_PER_SM * num_sms), split, -lanes)
                   if blocks >= num_sms else (1, -blocks, split, -lanes))
            ranked.append((key, Plan("cluster", maxm, lanes * cpl, split)))
        lanes //= 2
    return min(ranked)[1]


def _plan_ragged(maxm: int, K: int, N: int, size: int, num_sms: int) -> Plan:
    """Column tile and cluster size of the ragged path: the least estimate
    of waves of clusters times a block's bytes (its K rows of staged code
    rows, ``pitch`` bytes each, one 16-byte chunk more than the tile's
    codes) and its fixed cost; then the smaller cluster, the fewer lanes in
    all, the wider tile.  A wave is as many clusters as fit at two blocks an
    SM (the kernel's ``__launch_bounds__``), a cluster's blocks on the SMs of
    one GPC: a cluster of 5 takes 6 of a GPC's 32 slots, not 6.4 (timings of
    every tile and split on an H100: PERF.md).  The column tile
    narrows to one lane (64 / ``maxm`` columns), so a narrow shape still
    splits K over up to 8 blocks, each keeping at least ``_CL_MIN_ROWS``
    rows.
    """
    cpl = _CL_ACC // maxm
    max_split = max(1, min(MAX_CLUSTER, K // _CL_MIN_ROWS))
    slots = _RG_BLOCKS_PER_SM * (num_sms // _GPCS)     # a GPC's block slots
    ranked = []
    for lanes in (32, 16, 8, 4, 2, 1):
        tiles = _cdiv(N, lanes * cpl)
        if tiles > 65535:
            continue
        pitch = _ragged_pitch(lanes * cpl, size)
        for split in range(1, max_split + 1):
            waves = _cdiv(tiles, _GPCS * (slots // split))
            est = waves * (_cdiv(K, split) * pitch + _RG_FIXED_BYTES)
            ranked.append(((est, split, tiles * lanes, -lanes),
                           Plan("ragged", maxm, lanes * cpl, split)))
    if not ranked:
        raise ValueError(f"{NAME}: N={N} has more column tiles than a grid holds")
    return min(ranked)[1]


def _ragged_pitch(cols: int, size: int) -> int:
    """A staged code row of the ragged path (csrc: ragged_geom): the 16-byte
    chunks that cover ``cols`` codes at any offset."""
    return 16 * (_cdiv(cols * size, 16) + 1)


# ---------------------------------------------------------------------------
# Launch-grid metadata (kernels/spec.py): each map restates the block-to-tile
# arithmetic of the kernel it names in csrc/quant_matmul.cu
# ---------------------------------------------------------------------------

#: the line of each path's ``__global__`` declaration in csrc/quant_matmul.cu
#: (a spec's ``source``)
KERNEL_LINES = {"cluster": 226, "wgmma": 750, "tiled": 633, "ragged": 450}

#: the cluster path's stage ring and tree (csrc: CL_STAGES, CL_STAGE_BYTES,
#: CL_THREADS, CL_TREE_BYTES)
_CL_STAGES, _CL_STAGE_BYTES, _CL_THREADS = 8, 8192, 256
_CL_TREE_BYTES = _CL_ACC * (_CL_THREADS // 2) * 4
#: the wgmma path's k step and bf16 code buffers (csrc: WG_BK, WG_BBUF), and
#: its ring's stages by tile (csrc: launch)
_WG_BK, _WG_BBUF = 64, 3
_WG_STAGES = {(128, 256): 3, (128, 128): 4, (64, 128): 3, (64, 64): 4}
#: the tiled path's k step (csrc: TB_K)
_TB_K = 8
#: the ragged path's ring and x chunk (csrc: RG_STAGES, RG_STAGE_BYTES,
#: RG_X_BYTES)
_RG_STAGES, _RG_STAGE_BYTES, _RG_X_BYTES = 8, 8192, 16384


def _cluster_x_map(r, j):
    """``qmm_cluster`` and ``qmm_ragged``: block rank ``r`` reads K rows ``[r *
    k_per_block, (r + 1) * k_per_block)`` of every row of x (``kb0 = rank *
    k_per_block``)."""
    return (0, r)


def _cluster_codes_map(r, j):
    """The same: those K rows of the column tile ``blockIdx.y`` (``tile0 =
    blockIdx.y * cols``)."""
    return (r, j)


def _cluster_out_map(r, j):
    """The same: the cluster's ranks write slices of the output column tile
    ``blockIdx.y`` (``m < M && n < N``, ``merge_cluster``)."""
    return (0, j)


def _wgmma_x_map(i, j, t):
    """``qmm_wgmma``: rows ``m0 = blockIdx.x * BM``, k step ``t``."""
    return (i, t)


def _wgmma_codes_map(i, j, t):
    """``qmm_wgmma``: k step ``t`` of columns ``n0 = blockIdx.y * BN``."""
    return (t, j)


def _wgmma_out_map(i, j, t):
    """``qmm_wgmma``: the ``BM x BN`` tile at ``(m0, n0)`` (``r < M``, ``col < N``)."""
    return (i, j)


def _tiled_x_map(jn, im, t):
    """``qmm_tiled``: rows ``m0 = blockIdx.y * 128``, k step ``t``
    (``m < M && k < K``)."""
    return (im, t)


def _tiled_codes_map(jn, im, t):
    """``qmm_tiled``: k step ``t`` of columns ``n0 = blockIdx.x * 128``."""
    return (t, jn)


def _tiled_out_map(jn, im, t):
    """``qmm_tiled``: the 128 x 128 tile at ``(m0, n0)``."""
    return (im, jn)


def _scale_map(*grid_ids):
    """Every block reads the one scale."""
    return (0,)


def cluster_layout(M: int, K: int, N: int, p: Plan, x_size: int, code_size: int) -> dict:
    """The cluster path's stage geometry as ``launch_cluster`` computes it:
    ``rows`` of K a stage, ``k_per_block``, the stage bytes, the shared
    memory the launch requests (``smem``: 128 bytes of alignment, the ring
    or the tree, whichever is larger, and the barriers)."""
    lanes = p.tile_n // (_CL_ACC // p.tile_m)
    groups = _CL_THREADS // lanes
    rows = _CL_STAGE_BYTES // (p.tile_n * code_size)
    rows = max(groups, min(256, rows)) // groups * groups
    k_per_block = _cdiv(_cdiv(K, p.split), rows) * rows
    stage = rows * p.tile_n * code_size + ((M * rows * x_size + 127) & ~127)
    area = max(_CL_STAGES * stage, _CL_TREE_BYTES)
    return {"rows": rows, "k_per_block": k_per_block, "stage_bytes": stage, "area": area,
            "smem": 128 + area + 2 * _CL_STAGES * 8}


def ragged_layout(K: int, p: Plan, code_size: int) -> dict:
    """The ragged path's geometry as ``launch_ragged`` computes it: the
    staged row's ``pitch``, ``rows`` of K a stage, ``k_per_block``, x's
    chunk ``xc`` (rows of K), the ring or the tree (``area``), and the
    shared memory the launch requests (``smem``: 16 bytes of alignment, the
    area, x's chunk as f32, the barriers)."""
    lanes = p.tile_n // (_CL_ACC // p.tile_m)
    groups = _CL_THREADS // lanes
    pitch = _ragged_pitch(p.tile_n, code_size)
    rows = _cdiv(_cdiv(_RG_STAGE_BYTES, pitch), groups) * groups
    k_per_block = _cdiv(K, p.split)
    cap = max(1, _RG_X_BYTES // (4 * p.tile_m) // rows) * rows
    xc = min(cap, _cdiv(k_per_block, rows) * rows)
    area = max(_RG_STAGES * rows * pitch, _CL_TREE_BYTES)
    return {"pitch": pitch, "rows": rows, "k_per_block": k_per_block, "xc": xc, "area": area,
            "smem": 16 + area + 4 * p.tile_m * xc + 2 * _RG_STAGES * 8}


def kernel_spec(M: int, K: int, N: int, *, x_dtype: torch.dtype = torch.float32,
                code_dtype: torch.dtype = torch.int8, num_sms: int = H100_SMS,
                aligned: bool = True, tile_plan: Plan | None = None) -> KernelSpec:
    """K3's launch at ``x (M,K) @ codes (K,N)`` as a :class:`KernelSpec`,
    from the same :func:`plan` call :func:`quant_matmul_cuda` makes (or
    ``tile_plan``).  Operands keep their real shapes: every path guards its
    ragged edges in the kernel (TMA zero-fills a box past the tensor; the
    stores check ``m < M``, ``n < N``).  ``smem_bytes`` restates what the
    launch requests a block; the library's ``repro_quant_matmul_smem``
    reports the launch's own figure (``chip_smoke.py`` holds them equal)."""
    p = tile_plan or plan(M, K, N, x_dtype, code_dtype, num_sms, aligned=aligned)
    xs = 2 if x_dtype == torch.bfloat16 else 4
    cs = 1 if code_dtype == torch.int8 else 2
    scale = BlockOperand("scale", (1,), (1,), _scale_map, coverage="any")
    src = f"src/repro_torch/csrc/quant_matmul.cu:{KERNEL_LINES[p.path]}"
    if p.path == "cluster":
        lay = cluster_layout(M, K, N, p, xs, cs)
        kpb = lay["k_per_block"]
        grid = (p.split, _cdiv(N, p.tile_n))
        ins = (BlockOperand("x", (M, K), (p.tile_m, kpb), _cluster_x_map, guarded=True),
               BlockOperand("codes", (K, N), (kpb, p.tile_n), _cluster_codes_map,
                            guarded=True), scale)
        outs = (BlockOperand("out", (M, N), (p.tile_m, p.tile_n), _cluster_out_map,
                             guarded=True),)
        scratch = (ScratchSpec("align", (128,), "uint8", space="smem", accumulates=False),
                   ScratchSpec("ring_or_tree", (lay["area"],), "uint8", space="smem",
                               accumulates=False),
                   ScratchSpec("barriers", (2 * _CL_STAGES,), "uint64", space="smem",
                               accumulates=False),
                   ScratchSpec("acc", (p.tile_m, p.tile_n), "float32", binds="out"))
        return KernelSpec("quant_matmul", src, grid, ins, outs, scratch, path=p.path,
                          smem_bytes=lay["smem"], plan=p)
    if p.path == "ragged":
        lay = ragged_layout(K, p, cs)
        kpb = lay["k_per_block"]
        grid = (p.split, _cdiv(N, p.tile_n))
        ins = (BlockOperand("x", (M, K), (p.tile_m, kpb), _cluster_x_map, guarded=True),
               BlockOperand("codes", (K, N), (kpb, p.tile_n), _cluster_codes_map,
                            guarded=True), scale)
        outs = (BlockOperand("out", (M, N), (p.tile_m, p.tile_n), _cluster_out_map,
                             guarded=True),)
        scratch = (ScratchSpec("align", (16,), "uint8", space="smem", accumulates=False),
                   ScratchSpec("ring_or_tree", (lay["area"],), "uint8", space="smem",
                               accumulates=False),
                   ScratchSpec("x_chunk", (p.tile_m, lay["xc"]), "float32", space="smem",
                               accumulates=False),
                   ScratchSpec("barriers", (2 * _RG_STAGES,), "uint64", space="smem",
                               accumulates=False),
                   ScratchSpec("acc", (p.tile_m, p.tile_n), "float32", binds="out"))
        return KernelSpec("quant_matmul", src, grid, ins, outs, scratch, path=p.path,
                          smem_bytes=lay["smem"], plan=p)
    if p.path == "wgmma":
        bm, bn = p.tile_m, p.tile_n
        st = _WG_STAGES[(bm, bn)]
        grid = (_cdiv(M, bm), _cdiv(N, bn), _cdiv(K, _WG_BK))
        ins = (BlockOperand("x", (M, K), (bm, _WG_BK), _wgmma_x_map, guarded=True),
               BlockOperand("codes", (K, N), (_WG_BK, bn), _wgmma_codes_map, guarded=True),
               scale)
        outs = (BlockOperand("out", (M, N), (bm, bn), _wgmma_out_map, guarded=True),)
        scratch = (ScratchSpec("x_ring", (st, bm, _WG_BK), "bfloat16", space="smem",
                               accumulates=False),
                   ScratchSpec("code_ring", (st, _WG_BK, bn), "int8", space="smem",
                               accumulates=False),
                   ScratchSpec("bf16_codes", (_WG_BBUF, _WG_BK, bn), "bfloat16",
                               space="smem", accumulates=False),
                   ScratchSpec("barriers", (2 * st,), "uint64", space="smem",
                               accumulates=False),
                   ScratchSpec("align", (1024,), "uint8", space="smem", accumulates=False),
                   ScratchSpec("acc", (bm, bn), "float32", binds="out"))
        smem = (st * bm * _WG_BK * 2 + st * _WG_BK * bn + _WG_BBUF * _WG_BK * bn * 2
                + 2 * st * 8 + 1024)
        return KernelSpec("quant_matmul", src, grid, ins, outs, scratch, path=p.path,
                          smem_bytes=smem, plan=p)
    grid = (_cdiv(N, p.tile_n), _cdiv(M, p.tile_m), _cdiv(K, _TB_K))
    ins = (BlockOperand("x", (M, K), (p.tile_m, _TB_K), _tiled_x_map, guarded=True),
           BlockOperand("codes", (K, N), (_TB_K, p.tile_n), _tiled_codes_map, guarded=True),
           scale)
    outs = (BlockOperand("out", (M, N), (p.tile_m, p.tile_n), _tiled_out_map, guarded=True),)
    scratch = (ScratchSpec("As", (_TB_K, p.tile_m), "float32", space="smem",
                           accumulates=False),
               ScratchSpec("Bs", (_TB_K, p.tile_n), "float32", space="smem",
                           accumulates=False),
               ScratchSpec("acc", (p.tile_m, p.tile_n), "float32", binds="out"))
    return KernelSpec("quant_matmul", src, grid, ins, outs, scratch, path=p.path,
                      smem_bytes=4 * _TB_K * (p.tile_m + p.tile_n), plan=p)


def quant_matmul_cuda(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                      tile_plan: Plan | None = None) -> torch.Tensor:
    """x (M,K) f32/bf16 @ (codes (K,N) int8/int16 * scale) -> (M,N) f32.

    ``scale`` is a one-element f32 tensor on the device; the kernel reads it
    there, so the call never waits for the host.  ``tile_plan`` overrides
    :func:`plan` (to time the alternatives); the launcher refuses a plan its
    kernels do not take.
    """
    if x.ndim != 2 or codes.ndim != 2 or x.shape[1] != codes.shape[0]:
        raise ValueError(f"{NAME}: shapes {tuple(x.shape)} @ {tuple(codes.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{NAME}: x must be f32 or bf16, got {x.dtype}")
    if codes.dtype not in (torch.int8, torch.int16):
        raise ValueError(f"{NAME}: codes must be int8 or int16, got {codes.dtype}")
    if scale.numel() != 1 or scale.dtype != torch.float32:
        raise ValueError(f"{NAME}: scale must be one f32 value, got "
                         f"{tuple(scale.shape)} {scale.dtype}")
    if not (x.is_contiguous() and codes.is_contiguous()):
        raise ValueError(f"{NAME}: x and codes must be dense row-major (contiguous); got "
                         f"strides {x.stride()} and {codes.stride()}")
    _build.require_cuda(NAME, x, codes, scale)
    M, K = x.shape
    N = codes.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if out.numel() == 0 or K == 0:
        return out.zero_()
    p = tile_plan or plan(M, K, N, x.dtype, codes.dtype, _build.sm_count(x.device),
                          aligned=x.data_ptr() % 16 == 0 and codes.data_ptr() % 16 == 0)
    err = _build.lib().repro_quant_matmul(
        x.data_ptr(), _build.DTYPE_CODES[x.dtype], codes.data_ptr(),
        _build.DTYPE_CODES[codes.dtype], scale.data_ptr(), out.data_ptr(),
        M, K, N, _build.stream_of(x), PATHS[p.path], p.tile_m, p.tile_n, p.split)
    _build.check_launch(NAME, err)
    _build.LAUNCHES[NAME] += 1
    return out
