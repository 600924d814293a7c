"""Serving subset of the weight-quantization helpers.

Only what the packed serving path needs: the integer storage dtype for a
bit-width and the exemption policy that keeps norms and other small or
recurrence-adjacent leaves unpacked.  The stochastic-rounding quantizers
(paper Eq. 1) arrive with the fl-sim slice.
"""

from __future__ import annotations

from typing import Callable

import torch


def storage_dtype(bits: int) -> torch.dtype:
    """Smallest signed integer dtype that holds codes in [-(2^b -1), 2^b -1]."""
    if bits <= 7:
        return torch.int8
    if bits <= 15:
        return torch.int16
    return torch.int32


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
