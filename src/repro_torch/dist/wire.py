"""Gradient wire-byte accounting for the SR-quantized all-reduce.

The fl-sim slice needs only :func:`wire_scale`: the fault executor bills each
retransmission attempt against the f32 payload scaled to the wire's code
width.  The per-leaf byte reports of the pod trainer come with its slice.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.quantization import FULL_PRECISION_BITS
from repro_torch.dist.collectives import wire_dtype


def wire_scale(comm_bits: int, n_clients: int) -> float:
    """Fraction of the f32 payload that crosses the wire at ``comm_bits``.

    The SR all-reduce ships codes at :func:`wire_dtype`'s itemsize, so the
    factor is ``itemsize / 4`` (exactly ``1.0`` when uncompressed — callers
    that multiply a static f32 payload by it stay bit-identical).
    """
    if int(comm_bits) >= FULL_PRECISION_BITS:
        return 1.0
    return np.dtype(wire_dtype(comm_bits, n_clients)).itemsize / 4.0
