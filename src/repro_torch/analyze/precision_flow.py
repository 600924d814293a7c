"""Precision-flow lint: a taint walk over a traced step's operation graph.

The reference (``repro/analyze/precision_flow.py``) walks a jaxpr; the port
walks the graph :func:`repro_torch.roofline.count.recording` keeps with
``graph=True`` (:class:`~repro_torch.roofline.count.Graph`), in the order
the step dispatched its operations.

TAINT SOURCES are quantized-code tensors the step did not make: integer
inputs of itemsize <= 2 (int8/int16 QTensor codes) with rank >= 2 — token
ids, page tables and lengths are int32/rank-1 and never taint.  Taint
PROPAGATES through the dequantization idiom (``_to_copy``, ``mul`` by a
scale, views, slices, ``cat``, ``clone``/``copy_``, ``detach``; a partial
in-place write taints its storage) and STOPS with a finding at any matmul
(the ops of ``count._DOTS`` and ``convolution``) consuming a tainted
operand: that matmul read a weight that was eagerly dequantized to floats
instead of streaming codes through K3 (``kernels/ops.quant_matmul``) — the
silent fallback that erases the paper's storage/bandwidth win (arXiv
2012.11070).  A K3 call (``quant_matmul``, and each launch of
``expert_dispatch``) is the fast path itself: codes are consumed inside
the kernel, and no kernel node propagates taint.

Taint deliberately does NOT propagate through ``embedding``,
``index_select``, ``gather`` or ``index`` (the embedding-row read is a
lookup, not a matmul weight) nor through ``add`` (residual streams would
smear taint over the whole graph).

The walk also checks integer all-reduce accumulators: summing ``n``
clients' ``bits``-wide codes needs the dtype of ``n * (2^bits - 1)``
(:func:`repro_torch.dist.collectives.wire_dtype`); a collective node whose
recorded dtype is narrower overflows on the wire.

An eager trace has already unrolled every loop, so the reference's scan,
while and cond fixpoints have no counterpart; an unrolled layer's
operations share their call site, and findings are kept once per
``(rule, key, where)``, so a dequant inside a repeated layer is reported
exactly once.
"""

from __future__ import annotations

from repro_torch.analyze.findings import Finding, source_key
from repro_torch.roofline import count

#: ops the dequant dataflow passes through without changing what the
#: values ARE (codes, possibly scaled); in-place forms match without "_"
_PROPAGATE = frozenset({
    "_to_copy", "to", "mul", "div", "expand", "expand_as", "broadcast_to", "permute",
    "transpose", "t", "view", "_unsafe_view", "reshape", "_reshape_alias", "view_as",
    "squeeze", "unsqueeze", "flatten", "unflatten", "slice", "select", "narrow", "split",
    "split_with_sizes", "unbind", "chunk", "cat", "stack", "constant_pad_nd", "clone",
    "copy", "contiguous", "detach", "alias", "lift_fresh", "lift_fresh_copy",
    "as_strided", "repeat", "movedim",
})

#: the matmul ops: count._DOTS (the roofline's list; a new matmul op belongs
#: there) and the convolutions the CNNs run
DOT_OPS = frozenset({f._overloadpacket.__name__ for f in count._DOTS}
                    | {"convolution", "_convolution"})

#: lookups: the row read is not a matmul weight
_GATHERS = frozenset({"embedding", "index_select", "gather", "index", "take"})

#: the integer dtypes, by name
INT_DTYPES = frozenset({"int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
                        "uint64"})

#: the fast path's kernel entries (K3)
FASTPATH_KERNELS = frozenset({"quant_matmul"})


def base_name(op: str) -> str:
    """``"mul_"`` -> ``"mul"`` (an in-place op's out-of-place name)."""
    return op[:-1] if op.endswith("_") and not op.endswith("__") else op


def graph_of(record):
    """The :class:`~repro_torch.roofline.count.Graph` of a record (or the
    graph itself)."""
    g = getattr(record, "graph", record)
    if g is None or not hasattr(g, "ops"):
        raise ValueError("no operation graph: trace with recording(graph=True)")
    return g


def is_code_like(meta) -> bool:
    """Integer dtype of itemsize <= 2 and rank >= 2 (a QTensor's codes)."""
    dtype, shape = meta
    return dtype in ("int8", "int16", "uint8", "uint16") and len(shape) >= 2


def _dot_operands(op) -> tuple:
    """Indices into ``op.ins`` of a matmul's (lhs, rhs)."""
    i, j = {"addmm": (1, 2), "baddbmm": (1, 2), "addmv": (1, 2)}.get(op.op, (0, 1))
    refs = [a for a in op.args if isinstance(a, count.Ref)]
    if len(refs) > max(i, j):
        return refs[i].i, refs[j].i
    return 0, min(1, len(op.ins) - 1)


class _Walker:
    def __init__(self, *, policy, cell):
        self.policy = policy
        self.cell = cell
        self.findings: dict[tuple, Finding] = {}
        self.n_dots = 0
        self.n_fastpath = 0

    def _emit(self, rule, severity, message, key, where):
        ident = (rule, key, where)
        if ident not in self.findings:
            self.findings[ident] = Finding(rule=rule, severity=severity, message=message,
                                           key=key, where=where, cell=self.cell)

    def run(self, graph) -> set:
        tainted: set = set()
        for op in graph.ops:
            self._op(graph, op, tainted)
        return tainted

    def _op(self, graph, op, tainted) -> None:
        in_taint = [v in tainted for v in op.ins]
        if op.kind == "input":
            if is_code_like(graph.meta[op.outs[0]]):
                tainted.add(op.outs[0])
            return
        if op.kind == "kernel":
            # the fast path itself: codes are consumed INSIDE the kernel
            if op.op in FASTPATH_KERNELS:
                self.n_fastpath += 1
            return
        if op.kind == "collective":
            self._check_allreduce(op)
            return
        if op.kind == "join":
            if any(in_taint):
                tainted.update(op.outs)
            return
        name = base_name(op.op)
        if name in DOT_OPS:
            self.n_dots += 1
            if any(in_taint):
                li, ri = _dot_operands(op)
                operand = "lhs" if li < len(in_taint) and in_taint[li] else "rhs"
                shapes = [graph.meta[v][1] for v in op.ins]
                sev = "error" if self.policy.lazy else "info"
                self._emit("precision.eager_dequant", sev,
                           f"{op.op} {operand} consumes eagerly-dequantized QTensor codes "
                           f"(shapes {shapes}); the quant_matmul fast path streams codes "
                           "instead", *source_key(op))
            return                              # a matmul's output is activations
        if name in _GATHERS:
            return                              # embedding-row reads
        if name in _PROPAGATE and any(in_taint):
            tainted.update(op.outs)

    def _check_allreduce(self, op) -> None:
        import numpy as np

        from repro_torch.dist.collectives import wire_dtype

        bits = getattr(self.policy, "comm", 32)
        n = int(op.params.get("group", 1))
        dtype = op.params.get("dtype", "float32")
        if op.op != "all-reduce" or bits >= 32 or n <= 1:
            return
        if op.params.get("reduction", "sum") != "sum":
            return                              # a max or min accumulates nothing
        if dtype not in INT_DTYPES:
            return
        try:
            required = np.dtype(wire_dtype(bits, n))
        except ValueError:
            return
        if np.dtype(dtype).itemsize < required.itemsize:
            self._emit("precision.narrow_accumulator", "error",
                       f"all-reduce {op.params.get('name', '')!r} (n={n}) accumulates "
                       f"{dtype} codes but n*(2^{bits}-1) needs {required.name}: the "
                       "reduction overflows on the wire", *source_key(op))


def lint_jaxpr(record, *, policy, axis_sizes=None, cell="",
               expect_fastpath=None) -> list[Finding]:
    """Precision-flow lint over one traced step (a
    :class:`~repro_torch.roofline.count.Record` kept with ``graph=True``,
    or its graph; the reference's name, which took a jaxpr).

    ``axis_sizes`` is accepted for the reference's signature: each
    collective node carries its own group size.  ``expect_fastpath``: when
    True (default: ``policy.lazy``), a step that runs matmuls but not one
    K3 call gets a ``precision.no_fastpath`` warning — the
    wholesale-dispatch-loss guard.
    """
    del axis_sizes
    w = _Walker(policy=policy, cell=cell)
    w.run(graph_of(record))
    findings = list(w.findings.values())
    expect = policy.lazy if expect_fastpath is None else expect_fastpath
    if expect and w.n_dots > 0 and w.n_fastpath == 0:
        findings.append(Finding(
            rule="precision.no_fastpath", severity="warn",
            message=f"policy is lazy but none of the {w.n_dots} matmuls went through the "
                    "quant_matmul kernel — dispatch lost wholesale?",
            key="module:no_fastpath", cell=cell))
    return findings
