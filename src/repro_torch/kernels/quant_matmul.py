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
PATHS = {"cluster": 0, "wgmma": 1, "tiled": 2}
#: Streaming multiprocessors of an H100 SXM (the plan's default).
H100_SMS = _build.H100_SMS
#: Blocks of one thread-block cluster at most (the portable size).
MAX_CLUSTER = 8
_CL_ACC = 64          # accumulators a thread on the cluster path
_CL_MIN_ROWS = 64     # K rows a block of a cluster keeps at least
_CL_BLOCKS_PER_SM = 1.5
#: (rows, columns) output tiles of the wgmma path, each with its device time
#: per output element relative to 128 x 128 at full occupancy (measured on
#: an H100 at yi-6b's shapes: PERF.md).
WGMMA_TILES = {(128, 256): 0.8, (128, 128): 1.0, (64, 128): 1.26, (64, 64): 1.2}


class Plan(NamedTuple):
    """One launch of K3.

    ``cluster``: ``tile_m`` rows of accumulators (4, 8 or 16), ``tile_n``
    columns a block, K split over ``split`` blocks of one cluster.
    ``wgmma``: a ``tile_m`` x ``tile_n`` output tile a block.  ``tiled``:
    128 x 128.
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
    shapes take the tiled path.  Cached: a decode step asks for the same
    few shapes 225 times.
    """
    size = 1 if code_dtype == torch.int8 else 2
    x_size = 2 if x_dtype == torch.bfloat16 else 4
    if M <= 16 and aligned and N * size % 16 == 0 and K * x_size % 16 == 0:
        maxm = 4 if M <= 4 else 8 if M <= 8 else 16
        return _plan_cluster(maxm, K, N, size, num_sms)
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


# ---------------------------------------------------------------------------
# Launch-grid metadata (kernels/spec.py): each map restates the kernel's
# block-to-tile arithmetic at the cited line of csrc/quant_matmul.cu
# ---------------------------------------------------------------------------

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


def _cluster_x_map(r, j):
    """:129 ``qmm_cluster``: block rank ``r`` reads K rows ``[r * k_per_block,
    (r + 1) * k_per_block)`` of every row of x (``kb0 = rank * k_per_block``)."""
    return (0, r)


def _cluster_codes_map(r, j):
    """:129: those K rows of the column tile ``blockIdx.y`` (``tile0 =
    blockIdx.y * cols``)."""
    return (r, j)


def _cluster_out_map(r, j):
    """:129: the cluster's ranks write slices of the output column tile
    ``blockIdx.y`` (``m < M && n < N``)."""
    return (0, j)


def _wgmma_x_map(i, j, t):
    """:429 ``qmm_wgmma``: rows ``m0 = blockIdx.x * BM``, k step ``t``."""
    return (i, t)


def _wgmma_codes_map(i, j, t):
    """:429: k step ``t`` of columns ``n0 = blockIdx.y * BN``."""
    return (t, j)


def _wgmma_out_map(i, j, t):
    """:429: the ``BM x BN`` tile at ``(m0, n0)`` (``r < M``, ``col < N``)."""
    return (i, j)


def _tiled_x_map(jn, im, t):
    """:312 ``qmm_tiled``: rows ``m0 = blockIdx.y * 128``, k step ``t``
    (``m < M && k < K``)."""
    return (im, t)


def _tiled_codes_map(jn, im, t):
    """:312: k step ``t`` of columns ``n0 = blockIdx.x * 128``."""
    return (t, jn)


def _tiled_out_map(jn, im, t):
    """:312: the 128 x 128 tile at ``(m0, n0)``."""
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
    src = "src/repro_torch/csrc/quant_matmul.cu"
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
        return KernelSpec("quant_matmul", f"{src}:129", grid, ins, outs, scratch,
                          path=p.path, smem_bytes=lay["smem"], plan=p)
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
        return KernelSpec("quant_matmul", f"{src}:429", grid, ins, outs, scratch,
                          path=p.path, smem_bytes=smem, plan=p)
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
    return KernelSpec("quant_matmul", f"{src}:312", grid, ins, outs, scratch, path=p.path,
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
