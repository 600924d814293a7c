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
