"""Single-device axis context: the port's stand-in for the mesh ``AxisCtx``.

Model code keeps the reference's collective call sites (``psum_model``,
``tp_index``, ``tp``) so that the multi-GPU slice can back them with
``torch.distributed`` without touching the layers.  This slice runs on one
device: the tensor-parallel size is 1, the rank 0 and the all-reduce the
identity — exactly what the reference's context degenerates to outside a
mesh.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class AxisCtx:
    """Named axes of one launch (all unbound on a single device)."""

    batch_axes: tuple[str, ...] = ()
    model_axis: str | None = None
    fsdp_axes: tuple[str, ...] = ()

    @property
    def tp(self) -> int:
        return 1

    def tp_index(self) -> int:
        return 0

    def psum_model(self, x):
        return x


def code_bound(bits: int) -> int:
    """Largest |code| a ``bits``-wide SR quantizer can emit: ``2^bits - 1``.

    The exactness contract of the SR-quantized gradient all-reduce: codes are
    clipped to ``±code_bound(bits)``, and ``n_clients * code_bound(bits)``
    must fit the accumulator (:func:`wire_dtype`).
    """
    return 2 ** int(bits) - 1


def wire_dtype(bits: int, n_clients: int):
    """Narrowest signed integer dtype whose sum of ``n_clients`` codes is exact.

    Per-client codes lie in ``[-code_bound(bits), code_bound(bits)]``; the
    all-reduce accumulator must hold ``n * code_bound(bits)``.  Returns a
    numpy dtype class (``np.int8`` / ``np.int16`` / ``np.int32``).
    """
    need = n_clients * code_bound(bits)
    for dt in (np.int8, np.int16, np.int32):
        if need <= np.iinfo(dt).max:
            return dt
    raise ValueError(
        f"comm bits={bits} with {n_clients} clients needs an accumulator "
        f"holding {need} > int32 max; lower the bit-width (<= 16 is always "
        "safe below 32768 clients) or use 32 (uncompressed)")
