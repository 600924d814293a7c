"""Declarative launch-grid metadata the kernels export for static checking.

Each CUDA kernel of this package (K3-K5) also publishes a
:class:`KernelSpec` restating exactly what one launch does for a given
problem size: the grid (with a kernel's own walk over K or key tiles or
pages as a last axis), every operand's real shape, the tile each grid point
reads or writes and the map from grid point to tile, the shared-memory
regions and register accumulators of a block, and the scalar operands that
steer its addressing.  ``repro_torch.analyze.kernel_check`` enumerates the
maps over the grid against these specs — coverage, out-of-bounds access,
scratch consistency, shared memory — without running the kernel.

A spec is built from the same plan call its launcher makes
(``quant_matmul.plan``, ``flash_attention.plan_attention``,
``plan_decode``), so the grid, the tiles and the path cannot drift from the
launch; the tile maps are module-level functions beside the launchers, each
citing the ``.cu`` line whose block-to-tile arithmetic it restates.

The reference (``repro/kernels/spec.py``) describes Pallas BlockSpecs on
operands the wrappers pad to whole blocks.  The port's kernels guard ragged
edges inside the kernel instead, so a spec states the real operand shape
and marks a dimension ``guarded`` where a partial (or empty) last tile is
masked in the kernel; the reference's VMEM scratch becomes the block's
shared-memory regions and register accumulators.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BlockOperand:
    """One operand of a launch: its real shape, the tile a grid point
    touches, and the map from grid point to tile index.

    ``index_map(*grid_ids)`` returns the tile's block indices, or None where
    the grid point touches nothing of this operand (a walk step past its
    range, an unallocated page).  ``coverage``: ``"full"`` — every tile of
    ``shape`` must be visited (weights, activations, outputs); ``"any"`` —
    partial or repeated visits are legal (pools addressed through a page
    table, a broadcast scalar).  ``guarded``: per dimension (or one bool for
    all), whether the kernel masks elements past the extent, so a partial
    or empty last tile is legal there.  ``steered_by``: the scalar operands
    whose values the map reads (an out-of-range scalar is reported once, on
    the scalar).
    """

    name: str
    shape: tuple
    block: tuple
    index_map: object               # callable (*grid_ids) -> block indices | None
    coverage: str = "full"
    guarded: object = False         # bool or tuple of bools, one a dim
    steered_by: tuple = ()

    def guard(self, d: int) -> bool:
        g = self.guarded
        return bool(g[d]) if isinstance(g, (tuple, list)) else bool(g)


@dataclasses.dataclass(frozen=True)
class ScalarOperand:
    """One scalar operand (page table, lengths) and the value range the
    kernel's addressing assumes.

    ``values`` is the CONCRETE integer array a launch would pass; ``lo``/
    ``hi`` are the inclusive bounds the kernel's addressing is safe under.
    """

    name: str
    values: object                  # concrete integer array (numpy is fine)
    lo: int
    hi: int
    note: str = ""                  # why the bounds are what they are


@dataclasses.dataclass(frozen=True)
class ScratchSpec:
    """One region of a block's working memory.

    ``space``: ``"smem"`` (shared memory, counted in the launch's request)
    or ``"registers"``.  ``binds``: the operand whose tile this region
    accumulates (its shape must equal that tile with 1-dims squeezed), or
    None.  ``accumulates``: the region sums partial products (which must be
    float32); staging buffers, barriers and alignment slack do not.
    """

    name: str
    shape: tuple
    dtype: str
    binds: str | None = None
    space: str = "registers"
    accumulates: bool = True

    @property
    def nbytes(self) -> int:
        size = {"float32": 4, "bfloat16": 2, "uint8": 1, "int8": 1, "uint64": 8,
                "int32": 4, "int16": 2}[self.dtype]
        n = 1
        for s in self.shape:
            n *= int(s)
        return n * size


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Static description of one kernel launch at a concrete problem size.

    ``path``: the plan's path (K3: cluster, wgmma or tiled; K4: wgmma or
    wgmma_split; K5: split); ``smem_bytes``: the dynamic (or static) shared
    memory the launcher requests a block, which the ``smem`` regions must
    add up to; ``plan``: the plan the launch follows; ``causal``: K4's
    mask (None for the kernels without one).
    """

    name: str
    source: str                     # "file.cu:line" of the kernel
    grid: tuple
    inputs: tuple                   # tuple[BlockOperand, ...]
    outputs: tuple                  # tuple[BlockOperand, ...]
    scratch: tuple = ()             # tuple[ScratchSpec, ...]
    scalars: tuple = ()             # tuple[ScalarOperand, ...]
    path: str = ""
    smem_bytes: int = 0
    plan: object = None
    causal: bool | None = None

    @property
    def operands(self):
        return self.inputs + self.outputs
