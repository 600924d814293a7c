"""Mesh-spec parsing and the axis context of a launch.

Counterpart of ``repro/launch/mesh.py``.  The port runs a ``Dx1`` mesh on one
device: ``D`` data-parallel groups (the FL clients, run in a loop) and a
model axis of size 1.  There is no device mesh object; the spec string gives
the axis sizes and :func:`axis_ctx_for` the :class:`AxisCtx` that carries
them.  A model axis larger than 1 raises (tensor parallelism is not ported).
"""

from __future__ import annotations

from repro_torch.dist.collectives import AxisCtx

_AXES_FOR_RANK = {1: ("data",), 2: ("data", "model"), 3: ("pod", "data", "model")}


def parse_mesh(spec: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """``"DATAxMODEL"`` / ``"PODxDATAxMODEL"`` -> (shape, axis names)."""
    shape = tuple(int(x) for x in str(spec).lower().split("x"))
    if len(shape) not in _AXES_FOR_RANK:
        raise ValueError(f"mesh spec {spec!r} must have 1-3 'x'-separated dims")
    return shape, _AXES_FOR_RANK[len(shape)]


def axis_ctx_for(spec: str) -> AxisCtx:
    """The :class:`AxisCtx` of a mesh spec: batch (and FSDP) axes ``("pod",
    "data")`` or ``("data",)``, the model axis if named, and their sizes."""
    shape, names = parse_mesh(spec)
    batch = ("pod", "data") if "pod" in names else ("data",)
    model = "model" if "model" in names else None
    if dict(zip(names, shape)).get("model", 1) > 1:
        raise NotImplementedError(
            f"mesh {spec!r}: a model axis > 1 (tensor parallelism) is not ported; "
            "the port runs Dx1 meshes on one device (ROADMAP queue 1, item 9)")
    return AxisCtx(batch_axes=batch, model_axis=model, fsdp_axes=batch,
                   sizes=tuple(zip(names, shape)))
