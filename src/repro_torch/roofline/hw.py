"""Hardware constants for the port's roofline: one NVIDIA H100 SXM.

Counterpart of ``repro/roofline/hw.py``, which holds the reference's TPU.
The port runs on one H100 and carries no other chip: a test that needs the
reference's chip imports it from the reference.  Field names follow the
reference's where the meaning carries (``name``, ``peak_flops_bf16``,
``hbm_bw``, ``hbm_bytes``); NVLink's ``link_bw`` takes the ICI link's place,
and ``smem_bytes`` (an SM's shared memory) the vector memory's.

Figures: NVIDIA's H100 SXM datasheet (dense bf16 and FP32 tensor-core-free
peaks, 3.35 TB/s HBM3, 80 GB, NVLink 4 at 900 GB/s both ways) and the Hopper
whitepaper (64 INT32 lanes an SM a clock, 132 SMs at the 1.98 GHz boost
clock; 228 KB of shared memory an SM).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str                  # as nvidia-smi --query-gpu=name,power.limit prints it
    peak_flops_bf16: float     # FLOP/s, dense bf16 tensor cores
    peak_flops_f32: float      # FLOP/s, the FP32 pipes (no TF32)
    int32_ops: float           # INT32 operations/s (the lanes' issue rate)
    hbm_bw: float              # bytes/s
    link_bw: float             # bytes/s one way over NVLink
    hbm_bytes: float           # device memory
    smem_bytes: float          # shared memory an SM

    def peak(self, kind: str) -> float:
        """Operations/s at ``kind``: ``"bf16"``, ``"f32"`` or ``"int32"``."""
        return {"bf16": self.peak_flops_bf16, "f32": self.peak_flops_f32,
                "int32": self.int32_ops}[kind]


H100_SXM = ChipSpec(
    name="NVIDIA H100 80GB HBM3, 700.00 W",
    peak_flops_bf16=989e12,
    peak_flops_f32=67e12,
    int32_ops=132 * 64 * 1.98e9,
    hbm_bw=3.35e12,
    link_bw=450e9,
    hbm_bytes=80e9,
    smem_bytes=228 * 1024,
)
