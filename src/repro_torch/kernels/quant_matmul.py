"""K3: int8/int16-weight dequantize-matmul, a CUDA kernel for Hopper.

Replaces the Pallas kernel ``repro/kernels/quant_matmul.py:quant_matmul_kernel``
(``x @ (codes * scale)`` with the weight streamed as integer codes and
dequantized tile by tile).  The kernel is ``csrc/quant_matmul.cu``; its notes
say what bounds it on an H100 (weight bytes at decode, operations at
prefill) and how the decode and prefill paths are shaped for that.

:func:`quant_matmul_cuda` launches it; :func:`quant_matmul_plain` is the
plain PyTorch version of the same function.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import quant_matmul_ref as quant_matmul_plain  # noqa: F401

NAME = "quant_matmul"


def quant_matmul_cuda(x: torch.Tensor, codes: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """x (M,K) f32/bf16 @ (codes (K,N) int8/int16 * scale) -> (M,N) f32.

    ``scale`` is a one-element f32 tensor on the device; the kernel reads it
    there, so the call never waits for the host.
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
    err = _build.lib().repro_quant_matmul(
        x.data_ptr(), _build.DTYPE_CODES[x.dtype], codes.data_ptr(),
        _build.DTYPE_CODES[codes.dtype], scale.data_ptr(), out.data_ptr(),
        M, K, N, _build.stream_of(x))
    _build.check_launch(NAME, err)
    _build.LAUNCHES[NAME] += 1
    return out
