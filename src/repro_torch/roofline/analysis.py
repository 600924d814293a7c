"""Roofline terms of one traced step.

Counterpart of ``repro/roofline/analysis.py``.  The reference derives its
terms from a compiled program (``analyze_compiled``); the port derives them
from a :class:`~repro_torch.roofline.count.Record` of the step run under
``FakeTensorMode`` (:func:`analyze_trace`).

Terms (seconds, per step, per device of the reference's mesh):
    compute    = dot-stream FLOPs / peak
    memory     = dot-stream bytes / hbm_bw
    collective = collective wire bytes / link bandwidth

On the port's own chip (:data:`~repro_torch.roofline.hw.H100_SXM`) every
node is priced as traced: f32 products at the FP32 peak, bf16 ones (and K4,
whose f32 path runs on the bf16 tensor cores) at the bf16 peak, bytes at
their dtype's size.  A chip without an f32 peak (the reference's
``TPU_V5E``, which tests import from the reference) is priced by the
reference's convention: every FLOP at the bf16 peak, bytes bf16-equivalent,
so ``dominant`` compares with the reference's.  Beside the three terms,
``kernel_s`` is the elementwise kernels' (K1, K2) own bounds, which the dot
stream leaves out, and ``bound_s`` = max(compute, memory, collective) +
kernel_s: the least time of the step on one device.  ``card_bound_s`` is the
same bound for the step as the port runs it on its one card: every node
whole, as many times as the card runs it (``Node.copies``: a ``Dx1`` train
step runs its D clients in one process, so the traced device's client
counts D times, and its FSDP leaves' grad norm is over whole leaves; on a
model axis above 1 the port runs one device of the mesh a rank, so the
traced device's step once), no collective.
"""

from __future__ import annotations

import dataclasses

from repro_torch.roofline.count import Record, costs
from repro_torch.roofline.hw import H100_SXM


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_per_device: float          # dot-stream FLOPs (dots and K3-K5)
    bytes_per_device: float          # dot-stream bytes, bf16-equivalent
    bytes_per_device_raw: float      # as traced
    collective_bytes: float          # wire-model bytes, bf16-equivalent
    collective_bytes_raw: float
    collective_breakdown: dict
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_global: float
    useful_flops_ratio: float        # MODEL_FLOPS / (FLOPs * devices)
    memory_stats: dict
    cost_analysis_flops: float | None   # XLA's own figure: no counterpart (None)
    note: str = ""
    chip: str = ""
    kernel_s: float = 0.0            # K1/K2 bounds, outside the dot stream
    bound_s: float = 0.0             # max(compute, memory, collective) + kernel_s
    card_bound_s: float | None = None   # the port's whole step on its one card
    kernels: dict = dataclasses.field(default_factory=dict)
    host_reads: list = dataclasses.field(default_factory=list)
    by_site: dict = dataclasses.field(default_factory=dict)   # port function: [FLOPs, bf16 bytes]

    def to_dict(self):
        return dataclasses.asdict(self)

    def summary_row(self):
        return (f"{self.arch},{self.shape},{self.mesh},{self.compute_s:.3e},"
                f"{self.memory_s:.3e},{self.collective_s:.3e},{self.dominant},"
                f"{self.useful_flops_ratio:.3f}")


def _priced_as_traced(chip) -> bool:
    return hasattr(chip, "peak_flops_f32")


def _link_bw(chip) -> float:
    return chip.link_bw if hasattr(chip, "link_bw") else chip.ici_link_bw


def analyze_trace(record: Record, *, arch: str, shape: str, mesh_name: str,
                  n_devices: int, model_flops_global: float, chip=H100_SXM,
                  note: str = "") -> RooflineReport:
    """The roofline report of a traced step on ``chip`` (see the module
    docstring for how each chip is priced)."""
    raw, b16 = costs(record), costs(record, bf16=True)
    dots = [n for n in record.nodes if n.stream == "dot"]
    elementwise = [n for n in record.nodes if n.stream != "dot"]
    if _priced_as_traced(chip):
        compute_s = sum(n.flops * n.share / chip.peak(n.peak) for n in dots)
        memory_s = raw.dot_bytes / chip.hbm_bw
        collective_s = raw.collective_bytes / _link_bw(chip)
        kernel_s = sum(n.bound_s(chip)[0] * n.share for n in elementwise)
    else:
        compute_s = raw.flops / chip.peak_flops_bf16
        memory_s = b16.dot_bytes / chip.hbm_bw
        collective_s = b16.collective_bytes / _link_bw(chip)
        kernel_s = sum(n.bytes_bf16 * n.share for n in elementwise) / chip.hbm_bw
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    card = _card_bound_s(record, chip) if _priced_as_traced(chip) else None
    useful = model_flops_global / max(raw.flops * n_devices, 1.0)
    kernels: dict = {}
    for n in record.nodes:
        if n.kernel is None:
            continue
        k = kernels.setdefault(n.kernel, {"calls": 0, "per_device": 0.0, "bound_s": 0.0})
        k["calls"] += 1
        k["per_device"] += n.share
        k["bound_s"] += n.bound_s(chip)[0] * n.share if _priced_as_traced(chip) else 0.0
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, n_devices=n_devices,
        flops_per_device=raw.flops,
        bytes_per_device=b16.dot_bytes, bytes_per_device_raw=raw.dot_bytes,
        collective_bytes=b16.collective_bytes, collective_bytes_raw=raw.collective_bytes,
        collective_breakdown={"bytes": b16.collective_by_kind,
                              "counts": raw.collective_counts},
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops_global=model_flops_global,
        useful_flops_ratio=useful,
        memory_stats={"argument_bytes": record.argument_bytes,
                      "output_bytes": record.output_bytes,
                      "temp_bytes": None, "alias_bytes": None,
                      "peak_estimate": record.peak_bytes},
        cost_analysis_flops=None, note=note, chip=chip.name,
        kernel_s=kernel_s, bound_s=max(terms.values()) + kernel_s, card_bound_s=card,
        kernels=kernels,
        host_reads=[dataclasses.asdict(h) for h in record.host_reads],
        by_site=record.by_site())


def _card_bound_s(record: Record, chip) -> float:
    """The bound of the step as the port runs it on its one card (see the
    module docstring): each node whole, ``copies`` times."""
    dots = [n for n in record.nodes if n.stream == "dot"]
    compute = sum(n.flops * n.copies / chip.peak(n.peak) for n in dots)
    memory = sum(n.bytes * n.copies for n in dots) / chip.hbm_bw
    return max(compute, memory) + sum(n.bound_s(chip)[0] * n.copies for n in record.nodes
                                      if n.stream != "dot")


def model_flops(cfg, shape_kind: str, seq_len: int, global_batch: int) -> float:
    """MODEL_FLOPS: 6·N·D for training, 2·N·D for inference (N = active params).

    D counts processed tokens: train/prefill -> batch*seq; decode -> batch*1.
    """
    n = cfg.active_param_count()
    if shape_kind == "train":
        return 6.0 * n * seq_len * global_batch
    if shape_kind == "prefill":
        return 2.0 * n * seq_len * global_batch
    return 2.0 * n * global_batch  # decode: one token per sequence
