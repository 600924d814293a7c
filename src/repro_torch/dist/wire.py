"""Gradient wire-byte accounting for the SR-quantized all-reduce.

:func:`quantized_psum_batch <repro_torch.dist.collectives.quantized_psum_batch>`
compresses only the *replicated* gradient leaves: the reference's FSDP leaves
are reduce-scattered in f32 by the all-gather transpose.  :func:`grad_wire_report`
turns that split into the bytes one training round moves on one device at
``comm`` bits versus uncompressed f32; :func:`wire_scale` is the factor the
fault executor bills retransmissions with.  Host math, equal to the reference.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.quantization import FULL_PRECISION_BITS
from repro_torch.dist.collectives import wire_dtype


def grad_wire_report(params_tree: dict, *, fsdp: int, n_clients: int,
                     comm_bits: int) -> dict:
    """Per-round gradient wire bytes for one device, by reduction path.

    ``params_tree`` is the local (FSDP-sliced) parameter dict, or its meta
    tensors (:func:`repro_torch.launch.steps.local_param_shapes`).
    Replicated leaves cross the wire once per all-reduce at the code dtype
    (plus one f32 scale per leaf for the shared grid); FSDP leaves
    reduce-scatter in f32 regardless of ``comm``.
    """
    from repro_torch.models.common import QTensor, fsdp_plan

    _, leaves, plan = fsdp_plan(params_tree, fsdp, check_divisibility=False)
    repl_elems = fsdp_elems = n_repl_leaves = 0
    for leaf, dim in zip(leaves, plan):
        arr = leaf.codes if isinstance(leaf, QTensor) else leaf
        size = int(np.prod(tuple(arr.shape))) if arr.ndim else 1
        if dim is None:
            repl_elems += size
            n_repl_leaves += 1
        else:
            fsdp_elems += size

    if n_clients <= 1:
        # single client: every reduction is a no-op — nothing crosses a wire
        return {
            "n_clients": int(n_clients), "comm_bits": int(comm_bits),
            "wire_dtype": "none", "replicated_elems": int(repl_elems),
            "replicated_leaves": int(n_repl_leaves),
            "fsdp_elems": int(fsdp_elems), "replicated_bytes_f32": 0,
            "replicated_bytes_wire": 0, "fsdp_reduce_scatter_bytes": 0,
            "wire_ratio": 1.0,
        }
    # same gate as quantized_psum_batch's bypass: >= full precision is f32
    compressed = int(comm_bits) < FULL_PRECISION_BITS
    dt = wire_dtype(comm_bits, n_clients) if compressed else np.float32
    itemsize = np.dtype(dt).itemsize
    f32_bytes = repl_elems * 4
    wire_bytes = (repl_elems * itemsize + n_repl_leaves * 4 if compressed
                  else f32_bytes)
    return {
        "n_clients": int(n_clients),
        "comm_bits": int(comm_bits),
        "wire_dtype": np.dtype(dt).name if compressed else "float32",
        "replicated_elems": int(repl_elems),
        "replicated_leaves": int(n_repl_leaves),
        "fsdp_elems": int(fsdp_elems),
        "replicated_bytes_f32": int(f32_bytes),
        "replicated_bytes_wire": int(wire_bytes),
        "fsdp_reduce_scatter_bytes": int(fsdp_elems * 4),
        "wire_ratio": wire_bytes / max(f32_bytes, 1),
    }


def wire_scale(comm_bits: int, n_clients: int) -> float:
    """Fraction of the f32 payload that crosses the wire at ``comm_bits``.

    The SR all-reduce ships codes at :func:`wire_dtype`'s itemsize, so the
    factor is ``itemsize / 4`` (exactly ``1.0`` when uncompressed — callers
    that multiply a static f32 payload by it stay bit-identical).
    """
    if int(comm_bits) >= FULL_PRECISION_BITS:
        return 1.0
    return np.dtype(wire_dtype(comm_bits, n_clients)).itemsize / 4.0


def grad_wire_rounds(params_tree: dict, *, fsdp: int, n_clients: int,
                     comm_bits_seq) -> list[dict]:
    """Per-round wire rows for a (possibly adaptive) comm-bit schedule: the
    round index, its executed ``comm`` bits and :func:`grad_wire_report`'s
    bytes at those bits (each distinct bit-width computed once)."""
    cache: dict[int, dict] = {}
    rows = []
    for r, bits in enumerate(comm_bits_seq):
        bits = int(bits)
        if bits not in cache:
            cache[bits] = grad_wire_report(params_tree, fsdp=fsdp,
                                           n_clients=n_clients, comm_bits=bits)
        rep = cache[bits]
        rows.append({
            "round": r,
            "comm_bits": bits,
            "wire_dtype": rep["wire_dtype"],
            "replicated_bytes_wire": rep["replicated_bytes_wire"],
            "replicated_bytes_f32": rep["replicated_bytes_f32"],
            "wire_ratio": rep["wire_ratio"],
        })
    return rows
