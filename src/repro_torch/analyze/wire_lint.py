"""Wire lint: per-collective dtype/byte rules over a traced step's records.

Consumes the :class:`repro_torch.roofline.count.CollectiveOp` records a
traced step keeps (``Record.collectives``: one for every collective the
reference's device issues, with the fields the reference's
``hlo_parse.CollectiveOp`` has) and a :class:`WireContext` describing what
the RunSpec's policy and mesh imply should be on the wire.  The port
compiles nothing: where the reference parses the partitioned HLO, the port
reads the trace's records; XLA's combiner merges the reference's
all-reduces (ROADMAP §3, D5) but every rule is per record and the byte
check sums, so the two give the same findings.

* ``wire.f32_allreduce``   — a large float all-reduce in a train step whose
  ``PrecisionPolicy.comm`` < 32: the gradient reduction that was supposed
  to move SR-quantized codes is moving f32 (the regression that silently
  erases the paper's comm-energy term).
* ``wire.narrow_allreduce`` / ``wire.wide_allreduce`` — integer all-reduce
  whose element dtype is narrower (overflow!) / wider (wasted bytes) than
  ``wire_dtype(comm, n)`` implies.
* ``wire.unexpected_allgather`` — an all-gather whose element dtype the
  sharding rule table doesn't predict on this mesh (unintended resharding;
  on a pure-DP mesh ANY all-gather is unexpected).
* ``wire.narrow_reduce_scatter`` / ``wire.wide_reduce_scatter`` — the same
  accumulator contract applied to integer reduce-scatters (XLA rewrites
  sharded all-reduces into them); float reduce-scatters are the FSDP
  gradient path and pass.
* ``wire.unknown_collective`` — a record of a kind no wire rule models
  (``unknown:<opcode>``); the accounting cannot silently under-count.
* ``wire.comm_report_mismatch`` — the records' integer all-reduce +
  reduce-scatter bytes disagree with
  :func:`repro_torch.dist.wire.grad_wire_report` — the two byte accountings
  (lint vs ``Session.comm_report()``) must not drift.

Degenerate records (``group_size <= 1``) never fire rules: a collective
over one participant moves nothing.
"""

from __future__ import annotations

import dataclasses

from repro_torch.analyze.findings import Finding

_FLOAT_DTYPES = {"f64", "f32", "bf16", "f16"}
_INT_BYTES = {"s8": 1, "u8": 1, "s16": 2, "u16": 2, "s32": 4, "u32": 4,
              "s64": 8, "u64": 8}


@dataclasses.dataclass(frozen=True)
class WireContext:
    """What the policy + mesh predict for one lint cell's collectives."""

    policy: object                       # PrecisionPolicy
    kind: str                            # "train" | "prefill" | "decode"
    n_clients: int = 1                   # DP / FL-client world size
    fsdp: int = 1
    tp: int = 1
    expected_gather_dtypes: frozenset = frozenset()
    min_flagged_elems: int = 1024        # scalar/diagnostic reductions pass

    @property
    def compressed(self) -> bool:
        return (self.kind == "train" and self.n_clients > 1
                and getattr(self.policy, "grad_compression_bits", 0) > 0)


def expected_gathers(*, fsdp: int, tp: int, packed: bool,
                     gather_bf16: bool = False) -> frozenset:
    """Element dtypes the sharding rule table predicts for all-gathers.

    FSDP re-gathers parameters in their storage dtype (f32, bf16 when the
    ``fsdp_gather_dtype`` variant is on, int codes when serving packed);
    tensor/sequence parallelism gathers activations (f32/bf16) and token
    ids (s32).  ``fsdp == tp == 1`` predicts NO all-gathers at all.
    """
    out = set()
    if fsdp > 1:
        out |= {"f32"}
        if gather_bf16:
            out |= {"bf16"}
        if packed:
            out |= {"s8", "s16"}
    if tp > 1:
        out |= {"f32", "bf16", "s32"}
    return frozenset(out)


def lint_module(mc, ctx: WireContext, cell: str = "") -> list[Finding]:
    """Apply the wire rules to one traced step's collective records (a
    :class:`~repro_torch.roofline.count.Record` or anything with a
    ``collectives`` list)."""
    from repro_torch.dist.collectives import wire_dtype

    findings = []
    required = None
    if ctx.compressed:
        try:
            import numpy as np

            required = np.dtype(wire_dtype(ctx.policy.comm, ctx.n_clients))
        except Exception:
            required = None

    for rec in mc.collectives:
        if rec.group_size <= 1:
            continue
        key = f"{rec.kind}:{rec.dtype}"
        where = f"{rec.name} in {rec.computation}"

        if rec.kind == "all-reduce":
            if (ctx.compressed and rec.dtype in _FLOAT_DTYPES
                    and rec.elems >= ctx.min_flagged_elems):
                findings.append(Finding(
                    rule="wire.f32_allreduce", severity="error",
                    message=(f"{rec.dtype}[{rec.elems}] all-reduce "
                             f"(group {rec.group_size}) in a train step "
                             f"with comm={ctx.policy.comm} bits: gradient "
                             "codes should cross the wire as "
                             "SR-quantized ints, not floats"),
                    key=key, where=where, cell=cell))
            elif (required is not None and rec.dtype in _INT_BYTES):
                have = _INT_BYTES[rec.dtype]
                if have < required.itemsize:
                    findings.append(Finding(
                        rule="wire.narrow_allreduce", severity="error",
                        message=(f"{rec.dtype} all-reduce accumulator is "
                                 f"narrower than {required.name} = "
                                 f"wire_dtype(comm={ctx.policy.comm}, "
                                 f"n={ctx.n_clients}): the summed codes "
                                 "overflow"),
                        key=key, where=where, cell=cell))
                elif have > required.itemsize:
                    findings.append(Finding(
                        rule="wire.wide_allreduce", severity="warn",
                        message=(f"{rec.dtype} all-reduce is wider than "
                                 f"{required.name} implies — "
                                 f"{have / required.itemsize:.0f}x the "
                                 "necessary wire bytes"),
                        key=key, where=where, cell=cell))

        elif rec.kind == "reduce-scatter":
            # FSDP gradients reduce-scatter in f32 by design (the comm role
            # compresses only the DP all-reduce), so floats pass; an
            # INTEGER reduce-scatter carries summed wire codes and must
            # obey the same accumulator contract as the all-reduce.
            if required is not None and rec.dtype in _INT_BYTES:
                have = _INT_BYTES[rec.dtype]
                if have < required.itemsize:
                    findings.append(Finding(
                        rule="wire.narrow_reduce_scatter", severity="error",
                        message=(f"{rec.dtype} reduce-scatter accumulator "
                                 f"is narrower than {required.name} = "
                                 f"wire_dtype(comm={ctx.policy.comm}, "
                                 f"n={ctx.n_clients}): the scattered code "
                                 "sums overflow"),
                        key=key, where=where, cell=cell))
                elif have > required.itemsize:
                    findings.append(Finding(
                        rule="wire.wide_reduce_scatter", severity="warn",
                        message=(f"{rec.dtype} reduce-scatter is wider than "
                                 f"{required.name} implies — "
                                 f"{have / required.itemsize:.0f}x the "
                                 "necessary wire bytes"),
                        key=key, where=where, cell=cell))

        elif rec.kind.startswith("unknown:"):
            findings.append(Finding(
                rule="wire.unknown_collective", severity="warn",
                message=(f"{rec.kind.split(':', 1)[1]} moves "
                         f"{rec.dtype}[{rec.elems}] over group "
                         f"{rec.group_size} but no wire rule models it: "
                         "byte accounting treats the full result as wire "
                         "bytes (upper bound) — teach count.record_collective/wire_lint "
                         "this opcode"),
                key=key, where=where, cell=cell))

        elif rec.kind == "all-gather":
            if rec.dtype not in ctx.expected_gather_dtypes:
                expect = (sorted(ctx.expected_gather_dtypes)
                          if ctx.expected_gather_dtypes else "none at all")
                findings.append(Finding(
                    rule="wire.unexpected_allgather", severity="warn",
                    message=(f"{rec.dtype}[{rec.elems}] all-gather (group "
                             f"{rec.group_size}) — the sharding rule table "
                             f"predicts {expect} on this mesh "
                             f"(fsdp={ctx.fsdp}, tp={ctx.tp}): unintended "
                             "resharding?"),
                    key=key, where=where, cell=cell))
    return findings


def check_comm_report(mc, report: dict, cell: str = "",
                      rel_tol: float = 1e-6) -> list[Finding]:
    """Cross-check the records' integer all-reduce bytes vs
    ``grad_wire_report``.

    The report says the replicated gradient leaves move
    ``replicated_elems * itemsize(wire_dtype)`` bytes of codes per round;
    the step's integer all-reduce results must sum to exactly that (each
    record counts ``mult`` times a step).  Only meaningful when compression
    is on (``wire_dtype != 'none'/'float32'``).
    """
    wd = str(report.get("wire_dtype", "none"))
    if wd in ("none", "float32"):
        return []
    itemsize = _INT_BYTES.get({"int8": "s8", "int16": "s16",
                               "int32": "s32"}.get(wd, wd), None)
    if itemsize is None:
        return []
    expect = int(report["replicated_elems"]) * itemsize
    have = 0.0
    for rec in mc.collectives:
        # integer codes may cross as an all-reduce OR a reduce-scatter:
        # both count toward the same wire budget
        if rec.kind not in ("all-reduce", "reduce-scatter"):
            continue
        for dt, elems in (rec.parts or ((rec.dtype, rec.elems),)):
            if dt in _INT_BYTES:
                have += elems * _INT_BYTES[dt] * rec.mult
    if abs(have - expect) > rel_tol * max(expect, 1):
        return [Finding(
            rule="wire.comm_report_mismatch", severity="error",
            message=(f"the traced step moves {have:.0f} integer all-reduce "
                     f"bytes but comm_report() accounts "
                     f"{expect} ({report['replicated_elems']} replicated "
                     f"elems x {wd}): the wire accountings drifted"),
            key="module:comm_report", cell=cell)]
    return []
