"""Kernel launch-grid checker: enumerate every tile map, statically.

For every :class:`repro_torch.kernels.spec.KernelSpec` the kernels export
(K3 ``quant_matmul.kernel_spec``, K4 ``flash_attention.attention_spec``, K5
``flash_attention.decode_spec``), walk the full grid and evaluate each
operand's tile map:

* ``kernel.oob_dma``       — a tile starts before the operand, or runs past
  its extent on a dimension the kernel does not guard (the load or store
  would leave the tensor);
* ``kernel.index_rank``    — the map returns the wrong number of indices;
* ``kernel.block_misaligned`` — a full-coverage operand whose tile does
  not divide its extent on an unguarded dimension (the last tile would
  overrun); a partial last tile the kernel masks is legal;
* ``kernel.coverage_gap``  — the grid never visits some tile of a
  full-coverage operand (e.g. a map that skips the last k step: part of the
  weight is silently never read / part of the output never written);
* ``kernel.scratch_shape`` / ``kernel.scratch_dtype`` — an accumulator
  bound to an operand must match that operand's tile (1-dims squeezed) and
  accumulate in float32;
* ``kernel.scratch_smem`` — the block's shared-memory regions do not add up
  to what the launcher requests;
* ``kernel.smem_limit``    — the request exceeds what a block can have on
  an H100 (``flash_attention.MAX_SMEM``);
* ``kernel.scalar_oob``    — a scalar operand's values (page-table entries,
  lengths) outside the range the kernel's addressing is safe under; the
  operands those scalars steer are not reported again.

At most one finding is reported per (kernel, operand): an out-of-bounds
tile usually implies a coverage gap too, and the contract is one finding per
seeded defect.  The reference (``repro/analyze/kernel_check.py``) checks
Pallas BlockSpecs over operands padded to whole blocks; the port's kernels
guard ragged edges inside, which the spec states per dimension.
"""

from __future__ import annotations

import itertools

from repro_torch.analyze.findings import Finding

_MAX_GRID_POINTS = 1_000_000


def _check_operand(spec, op, cell) -> Finding | None:
    ranges = [range(int(g)) for g in spec.grid]
    n_points = 1
    for r in ranges:
        n_points *= len(r)
    key = f"{spec.name}:{op.name}"
    if n_points > _MAX_GRID_POINTS:
        return Finding(rule="kernel.grid_too_large", severity="info",
                       message=f"grid {spec.grid} has {n_points} points; enumeration skipped",
                       key=key, where=spec.source, cell=cell)
    rank = len(op.block)
    seen = set()
    for g in itertools.product(*ranges):
        idx = op.index_map(*g)
        if idx is None:
            continue                            # this grid point touches nothing
        if not isinstance(idx, tuple):
            idx = (idx,)
        if len(idx) != rank:
            return Finding(rule="kernel.index_rank", severity="error",
                           message=f"tile map returned {len(idx)} indices for a "
                                   f"rank-{rank} tile at grid point {g}",
                           key=key, where=spec.source, cell=cell)
        ints = tuple(int(i) for i in idx)
        for d, (bi, b, s) in enumerate(zip(ints, op.block, op.shape)):
            off = bi * b
            if off < 0 or (off + b > s and not op.guard(d)):
                return Finding(rule="kernel.oob_dma", severity="error",
                               message=(f"grid point {g} maps dim {d} to tile "
                                        f"[{off}:{off + b}) of an extent-{s} operand with "
                                        "no guard in the kernel: out-of-bounds access"),
                               key=key, where=spec.source, cell=cell)
        seen.add(ints)
    if op.coverage != "full":
        return None
    for d, (b, s) in enumerate(zip(op.block, op.shape)):
        if s % b and not op.guard(d):
            return Finding(rule="kernel.block_misaligned", severity="error",
                           message=f"tile extent {b} does not divide operand extent {s} on "
                                   f"dim {d}, which the kernel does not guard (the last "
                                   "tile overruns)",
                           key=key, where=spec.source, cell=cell)
    tiles = [range(-(-s // b)) for b, s in zip(op.block, op.shape)]
    n_tiles = 1
    for t in tiles:
        n_tiles *= len(t)
    covered = sum(1 for t in seen if all(0 <= i < len(r) for i, r in zip(t, tiles)))
    if n_tiles <= _MAX_GRID_POINTS and covered < n_tiles:
        missing = next(t for t in itertools.product(*tiles) if t not in seen)
        return Finding(rule="kernel.coverage_gap", severity="error",
                       message=(f"{n_tiles - covered} of {n_tiles} tiles never visited "
                                f"(first missing: tile index {missing}) — part of the "
                                "operand is silently skipped"),
                       key=key, where=spec.source, cell=cell)
    return None


def _check_scratch(spec, sc, cell) -> Finding | None:
    key = f"{spec.name}:{sc.name}"
    if sc.accumulates and sc.dtype != "float32":
        return Finding(rule="kernel.scratch_dtype", severity="error",
                       message=f"scratch {sc.name} accumulates in {sc.dtype}; partial "
                               "products must accumulate in float32",
                       key=key, where=spec.source, cell=cell)
    if sc.binds:
        bound = next((o for o in spec.operands if o.name == sc.binds), None)
        if bound is None:
            return Finding(rule="kernel.scratch_shape", severity="error",
                           message=f"scratch {sc.name} binds unknown operand {sc.binds!r}",
                           key=key, where=spec.source, cell=cell)
        want = tuple(b for b in bound.block if b != 1) or (1,)
        have = tuple(s for s in sc.shape if s != 1) or (1,)
        if want != have:
            return Finding(rule="kernel.scratch_shape", severity="error",
                           message=(f"scratch {sc.name} shape {tuple(sc.shape)} does not "
                                    f"match operand {sc.binds!r} tile {tuple(bound.block)}"),
                           key=key, where=spec.source, cell=cell)
    return None


def _check_smem(spec, cell) -> list:
    from repro_torch.kernels.flash_attention import MAX_SMEM

    regions = [sc for sc in spec.scratch if sc.space == "smem"]
    total = sum(sc.nbytes for sc in regions)
    out = []
    if regions and total != spec.smem_bytes:
        out.append(Finding(
            rule="kernel.scratch_smem", severity="error",
            message=(f"the block's shared-memory regions "
                     f"({', '.join(f'{sc.name} {sc.nbytes}' for sc in regions)}) add up to "
                     f"{total} bytes, but the launcher requests {spec.smem_bytes}"),
            key=f"{spec.name}:smem", where=spec.source, cell=cell))
    if spec.smem_bytes > MAX_SMEM:
        out.append(Finding(
            rule="kernel.smem_limit", severity="error",
            message=(f"the launch requests {spec.smem_bytes} bytes of shared memory a "
                     f"block, above the {MAX_SMEM} an H100 block can have"),
            key=f"{spec.name}:smem_request", where=spec.source, cell=cell))
    return out


def _check_scalar(spec, sc, cell) -> Finding | None:
    """``kernel.scalar_oob`` — scalar values outside their range.

    Enumeration sees only tile maps; the VALUES a launch passes (page-table
    entries, lengths) steer those maps at run time, so each declared
    :class:`~repro_torch.kernels.spec.ScalarOperand` is range-checked
    against the bounds the kernel's addressing assumes.
    """
    import numpy as np

    vals = np.asarray(sc.values)
    if vals.size == 0:
        return None
    vmin, vmax = int(vals.min()), int(vals.max())
    if vmin < sc.lo or vmax > sc.hi:
        n_bad = int(np.sum((vals < sc.lo) | (vals > sc.hi)))
        return Finding(
            rule="kernel.scalar_oob", severity="error",
            message=(f"scalar operand {sc.name}: {n_bad} value(s) outside [{sc.lo}, "
                     f"{sc.hi}] (observed [{vmin}, {vmax}])"
                     + (f" — {sc.note}" if sc.note else "")),
            key=f"{spec.name}:{sc.name}", where=spec.source, cell=cell)
    return None


def check_kernel_spec(spec, cell: str = "") -> list[Finding]:
    """All kernel rules over one spec; at most one finding per operand."""
    findings, bad_scalars = [], set()
    for sc in getattr(spec, "scalars", ()):
        f = _check_scalar(spec, sc, cell)
        if f is not None:
            findings.append(f)
            bad_scalars.add(sc.name)
    for op in spec.operands:
        if bad_scalars & set(op.steered_by):
            continue                            # reported on the scalar
        f = _check_operand(spec, op, cell)
        if f is not None:
            findings.append(f)
    for sc in spec.scratch:
        f = _check_scratch(spec, sc, cell)
        if f is not None:
            findings.append(f)
    findings.extend(_check_smem(spec, cell))
    return findings


def shipped_kernel_specs(*, d_model: int = 512, d_ff: int = 2048, heads: int = 8,
                         head_dim: int = 64, batch: int = 4, seq: int = 160, page: int = 8,
                         n_pool: int = 6, n_pmax: int = 4) -> list:
    """The shipped kernels' specs at representative (ragged) serving dims,
    the reference's (``repro/analyze/kernel_check.py``), one spec a path:

    * K3 at a decode-sized f32 x (``batch`` rows): the cluster path;
    * K3 at M 3 and K ``d_model + 1`` (a row of x not a whole 16 bytes, so
      TMA cannot address it): the ragged path, and at M 17 the tiled path;
    * K3 at a prefill M (``batch * seq`` rows of bf16 x): the wgmma path;
    * K4 at ``S = seq`` (160, not a tile multiple) in f32: the wgmma_split
      path, and in bf16: the wgmma path;
    * K5 over a round-robin page table (slots own 1..``n_pmax`` pages, -1
      beyond; lengths end 3 tokens into the last page): the split path.
    """
    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention import attention_spec, decode_spec
    from repro_torch.kernels.quant_matmul import kernel_spec as qm_spec

    specs = [
        qm_spec(batch, d_model, d_ff),
        qm_spec(3, d_model + 1, d_ff),                 # ragged M and K
        qm_spec(17, d_model + 1, d_ff),                # ragged K past decode
        qm_spec(batch * seq, d_model, d_ff, x_dtype=torch.bfloat16),
        attention_spec(batch * heads, seq, head_dim, dtype=torch.float32),
        attention_spec(batch * heads, seq, head_dim, dtype=torch.bfloat16),
    ]
    pt, lengths = round_robin_pages(batch, n_pmax, n_pool, page)
    kv = max(heads // 4, 1)
    specs.append(decode_spec(batch, kv, max(heads // kv, 1), head_dim, page=page,
                             n_pool=n_pool, page_table=pt,
                             lengths=np.asarray(lengths, np.int32)))
    return specs


def round_robin_pages(batch: int, n_pmax: int, n_pool: int, page: int):
    """The shipped decode spec's page table (slot ``b`` owns ``b % n_pmax +
    1`` pages, pool rows handed out round-robin as the pager does, -1
    beyond) and lengths (3 tokens short of the owned pages)."""
    import numpy as np

    pt = -np.ones((batch, n_pmax), dtype=np.int32)
    nxt = 0
    lengths = []
    for b in range(batch):
        n_pages = (b % n_pmax) + 1
        for j in range(n_pages):
            pt[b, j] = nxt % n_pool
            nxt += 1
        lengths.append(n_pages * page - 3)
    return pt, lengths
