"""K3: int8/int16-weight dequantize-matmul, a CUDA kernel for Hopper.

Replaces the Pallas kernel ``repro/kernels/quant_matmul.py:quant_matmul_kernel``
(``x @ (codes * scale)`` with the weight streamed as integer codes and
dequantized tile by tile).  The kernel is ``csrc/quant_matmul.cu``; its notes
say what bounds it on an H100 (weight bytes at decode, operations at
prefill) and how each path is shaped for that.

:func:`plan` picks the path and its tile from the shapes and types;
:func:`quant_matmul_cuda` launches it with that plan; :func:`quant_matmul_plain`
is the plain PyTorch version of the same function.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import quant_matmul_ref as quant_matmul_plain  # noqa: F401

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
