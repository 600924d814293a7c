"""Unified per-tensor-role precision policy.

The paper's central object is a *per-device, per-round bit-width decision*
produced by the GBD co-design.  :class:`PrecisionPolicy` is the single typed
value that decision flows through — from ``GBDResult.q`` on the optimizer
side, through the FL orchestrator and the pod trainer's traced ``delta``
vector, down to the packed :class:`~repro.models.common.QTensor` storage the
``quant_matmul`` Pallas kernel streams on the serving side.

Roles (per-tensor-family bit assignment):

* ``weights``  — model weights.  An int (uniform) or a per-device tuple
  (heterogeneous, the paper's case).  32 = full precision.
* ``grads``    — server-side gradient aggregation precision.  The paper
  aggregates in full precision (Algorithm 1 line 10); only 32 is accepted.
* ``kv_cache`` — decode-cache storage: 32 → f32, 16 → bf16.
* ``comm``     — gradient wire bits for the SR-quantized all-reduce
  (:func:`repro.dist.collectives.quantized_psum_batch`); 32 = uncompressed.

``lazy`` selects the serving fast path: packed int8/int16 codes stay packed
through every dense projection (kernel-side dequantization) instead of being
expanded on use.  ``bit_options`` is the lattice the co-design searches — the
same tuple :class:`repro.core.master.MasterSpec` consumes.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

FULL_PRECISION_BITS = 32

#: Tensor roles a policy assigns bits to.
ROLES = ("weights", "grads", "kv_cache", "comm")


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    weights: int | tuple[int, ...] = FULL_PRECISION_BITS
    grads: int = FULL_PRECISION_BITS
    kv_cache: int = FULL_PRECISION_BITS
    comm: int = FULL_PRECISION_BITS
    lazy: bool = False
    bit_options: tuple[int, ...] = (8, 16, 32)

    def __post_init__(self):
        w = self.weights
        if isinstance(w, (list, np.ndarray)):
            w = tuple(int(b) for b in np.asarray(w).reshape(-1))
            object.__setattr__(self, "weights", w)
        elif not isinstance(w, tuple):
            object.__setattr__(self, "weights", int(w))
            w = self.weights
        object.__setattr__(self, "bit_options",
                           tuple(int(b) for b in self.bit_options))
        for b in (w if isinstance(w, tuple) else (w,)):
            if not 1 <= b <= FULL_PRECISION_BITS:
                raise ValueError(f"weight bits must be in [1, 32], got {b}")
        if self.grads != FULL_PRECISION_BITS:
            raise ValueError(
                "grads must be 32: the paper aggregates gradients in full "
                "precision (Algorithm 1 line 10); wire compression is the "
                "'comm' role")
        if self.kv_cache not in (16, FULL_PRECISION_BITS):
            raise ValueError(
                "kv_cache supports 32 (f32) or 16 (bf16) today; integer "
                f"KV-cache storage is not implemented (got {self.kv_cache})")
        if not 1 <= self.comm <= FULL_PRECISION_BITS:
            raise ValueError(f"comm bits must be in [1, 32], got {self.comm}")
        if self.lazy:
            if self.heterogeneous:
                raise ValueError("lazy (packed serving) needs a uniform "
                                 "weight bit-width, got per-device bits")
            if w >= FULL_PRECISION_BITS:
                raise ValueError("lazy packing needs weights < 32 bits")

    # -- constructors ---------------------------------------------------
    @classmethod
    def uniform(cls, bits: int, **kw) -> "PrecisionPolicy":
        """Every device / tensor at the same weight bit-width."""
        return cls(weights=int(bits), **kw)

    @classmethod
    def full_precision(cls, **kw) -> "PrecisionPolicy":
        return cls(weights=FULL_PRECISION_BITS, **kw)

    @classmethod
    def lazy_int8(cls, bits: int = 7, **kw) -> "PrecisionPolicy":
        """Serving fast path: int8-packed weights, kernel-side dequant."""
        return cls(weights=int(bits), lazy=True, **kw)

    @classmethod
    def from_gbd(cls, result: Any, **kw) -> "PrecisionPolicy":
        """Per-device weight bits from a co-design solution.

        ``result`` is a :class:`repro.core.gbd.GBDResult` (or any object with
        a ``.q`` bit-width vector, e.g. the baseline schemes' results), or a
        raw per-device bits array.  This is the ONLY sanctioned way the
        optimizer's chosen bits enter the training/serving stack.
        """
        q = getattr(result, "q", result)
        return cls(weights=tuple(int(b) for b in np.asarray(q).reshape(-1)),
                   **kw)

    # -- views ----------------------------------------------------------
    @property
    def heterogeneous(self) -> bool:
        return isinstance(self.weights, tuple)

    @property
    def serve_bits(self) -> int:
        """Uniform weight bit-width (the serving path packs one model)."""
        if self.heterogeneous:
            raise ValueError("serving needs a uniform policy; got per-device "
                             f"bits {self.weights}")
        return int(self.weights)

    @property
    def packed(self) -> bool:
        """Whether weights are stored as integer codes (QTensor)."""
        return not self.heterogeneous and self.serve_bits < FULL_PRECISION_BITS

    @property
    def grad_compression_bits(self) -> int:
        """Wire bits for the gradient all-reduce (0 = uncompressed)."""
        return 0 if self.comm >= FULL_PRECISION_BITS else int(self.comm)

    def bits_vector(self, n: int) -> np.ndarray:
        """(n,) per-device weight bits (heterogeneous tuples must cover n)."""
        if self.heterogeneous:
            if len(self.weights) < n:
                raise ValueError(f"policy carries {len(self.weights)} device "
                                 f"bit-widths but {n} were requested")
            return np.asarray(self.weights[:n], np.int64)
        return np.full((n,), int(self.weights), np.int64)

    def delta(self, n: int):
        """(n,) traced SR resolutions ``s * Delta_{q_i}`` for the trainer."""
        from repro_torch.core.fwq import delta_for_clients

        return delta_for_clients(self.bits_vector(n))

    def weight_storage_dtype(self):
        """Packed-code dtype the kernel sees (int8 / int16 / int32)."""
        from repro_torch.core.quantization import storage_dtype

        return storage_dtype(self.serve_bits)

    def kv_cache_dtype(self):
        import torch

        return torch.float32 if self.kv_cache >= FULL_PRECISION_BITS else torch.bfloat16

    # -- serialization --------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "weights": (list(self.weights) if self.heterogeneous
                        else int(self.weights)),
            "grads": int(self.grads),
            "kv_cache": int(self.kv_cache),
            "comm": int(self.comm),
            "lazy": bool(self.lazy),
            "bit_options": list(self.bit_options),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PrecisionPolicy":
        d = dict(d)
        w = d.get("weights", FULL_PRECISION_BITS)
        d["weights"] = tuple(w) if isinstance(w, (list, tuple)) else int(w)
        d["bit_options"] = tuple(d.get("bit_options", (8, 16, 32)))
        return cls(**d)
