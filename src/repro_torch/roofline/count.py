"""Step costs from a record of the operations the step runs.

Counterpart of ``repro/roofline/hlo_parse.py``.  The reference parses the
compiled HLO text of a step; the port runs the step eagerly under
``FakeTensorMode`` (nothing is allocated) inside :func:`recording`, and
counts from what it dispatched:

* dot FLOPs = 2 * prod(result dims) * contracted size, for every matmul the
  step dispatches (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``dot``, ``vdot``,
  ``mv``, ``addmv``: what ``@``, ``einsum`` and ``linear`` become);
* dot bytes = lhs + rhs + result bytes, raw and bf16-equivalent (f32 counted
  at 2 bytes, the rewrite of the reference's ``analysis.py``);
* kernel nodes: each of K1-K5 counted by a cost function of its own
  (:func:`quant_matmul_cost` and the rest), the work of the *function*
  whatever implements it.  K3-K5 are products and join the dot stream, as
  the reference's Pallas kernels contribute their dots to its count; K1 and
  K2 are elementwise, which the reference's dot stream excludes, and are
  kept apart (:attr:`Node.stream`);
* collectives: one :class:`CollectiveOp` for every collective the
  reference's device issues on the mesh, recorded by the port's code where
  the reference issues it (:func:`record_collective`), priced by the same
  ring model (group size n):
    all-gather: (n-1)/n * result;  reduce-scatter: (n-1) * result;
    all-reduce: 2(n-1)/n * result; all-to-all: (n-1)/n * result.

An eager trace unrolls every loop, so there are no trip counts (``n_while``
is 0).  **Per device** means one device of the reference's mesh: work done
under :func:`share` ``(f)`` counts ``f`` of itself, so a ``Dx1`` step that
loops over its D clients at ``share(1 / D)`` counts one client, the share of
one device.  The record also keeps the high-water mark of live tensor bytes
(the port's own card) and every host read the step makes, with its call
site (:func:`host_read`).

With ``graph=True`` the record also keeps the step's operation graph
(:class:`Graph`): one :class:`GraphOp` for every dispatched aten op, kernel
call and collective, with its value ids, scalar arguments and call site.
The static analyzer (``repro_torch.analyze``) walks it; recording it
changes no cost, peak or collective of the record.

Nothing here runs on a real tensor's path: the kernels' trace route
(``kernels/ops.py``) is taken only for fake tensors, and the other hooks do
nothing unless a recording is active.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import sys
import traceback
import weakref
from collections import defaultdict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.roofline.hw import H100_SXM, ChipSpec

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                    "collective-permute")

#: torch dtype -> the HLO element-type name the reference's records carry
HLO_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
              torch.float64: "f64", torch.int8: "s8", torch.int16: "s16",
              torch.int32: "s32", torch.int64: "s64", torch.uint8: "u8",
              torch.bool: "pred"}


def _elem_bytes(dtype: torch.dtype, bf16: bool = False) -> int:
    """Bytes an element; ``bf16`` counts f32 at 2 (the bf16-equivalent)."""
    if bf16 and dtype == torch.float32:
        return 2
    return dtype.itemsize


def _tensor_bytes(t: torch.Tensor, bf16: bool = False) -> int:
    """Bytes of the distinct elements ``t`` reads: a broadcast dim (stride 0,
    what ``matmul`` makes of a weight it batches) counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * _elem_bytes(t.dtype, bf16)


def ring_wire_bytes(kind: str, result_bytes: float, n: int) -> float:
    """Wire bytes a device moves for one collective (the reference's ring
    model); a group of one moves nothing."""
    if n <= 1:
        return 0.0
    if kind in ("all-gather", "all-to-all"):
        return (n - 1) / n * result_bytes
    if kind == "reduce-scatter":
        return (n - 1) * result_bytes
    if kind == "all-reduce":
        return 2 * (n - 1) / n * result_bytes
    return float(result_bytes)


@dataclasses.dataclass
class CollectiveOp:
    """One collective the reference's device issues, as the port recorded it.

    ``dtype`` is the HLO element name, ``elems`` the result's elements,
    ``bytes`` and ``wire_bytes`` one execution's; ``mult`` is the share of
    the record that one device executes (:func:`share`), so the per-step
    totals multiply by it.  ``name`` is the port's call site, and
    ``computation`` the step kind.
    """

    kind: str
    dtype: str
    elems: int
    bytes: float
    wire_bytes: float
    group_size: int
    mult: float
    name: str
    computation: str
    parts: tuple = ()

    def to_dict(self):
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ModuleCosts:
    flops: float
    dot_bytes: float
    collective_bytes: float           # wire-model bytes, per device
    collective_by_kind: dict
    collective_counts: dict
    n_while: int
    collectives: list = dataclasses.field(default_factory=list)

    def to_dict(self):
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# Kernel cost functions (K1-K5): the work of each function
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """What one call of a kernel's function must do.

    ``flops`` floating-point and ``int_ops`` integer operations, run at
    ``peak`` (``"bf16"``, ``"f32"`` or ``"int32"``); ``bytes`` each input read
    once and each output written once, ``bytes_bf16`` the same with f32 at 2
    bytes; ``stream`` is ``"dot"`` for the products (K3-K5) and
    ``"elementwise"`` for K1 and K2.
    """

    kernel: str | None          # "K1".."K5"; None for a dot
    flops: float
    int_ops: float
    bytes: float
    bytes_bf16: float
    peak: str
    stream: str

    def bound_s(self, chip: ChipSpec = H100_SXM) -> tuple[float, str]:
        """The least time on ``chip``: the larger of the bytes over the
        memory rate and the operations over their peak.  Returns
        ``(seconds, "bytes" or "operations")``."""
        t_bytes = self.bytes / chip.hbm_bw
        ops = self.int_ops if self.peak == "int32" else self.flops
        t_ops = ops / chip.peak(self.peak) if ops else 0.0
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _peak_of(dtype: torch.dtype) -> str:
    return "bf16" if dtype in (torch.bfloat16, torch.float16) else "f32"


def sr_quant_segments_cost(P: int, C: int, L: int) -> KernelCost:
    """K1's u-taking segment entry: ``w`` (P,), ``offsets`` (L+1,) and the
    scales (L,) read once, each client's uniforms read and output written
    once, ``delta`` (C,)."""
    raw = 4 * P + 8 * C * P + 4 * (2 * L + 1) + 4 * C
    b16 = 2 * P + 4 * C * P + 4 * (L + 1) + 2 * L + 2 * C
    return KernelCost("K1", 0.0, 0.0, raw, b16, "f32", "elementwise")


def sr_quant_keyed_cost(P: int, C: int) -> KernelCost:
    """K1's keyed segment entry: ``w`` read once, the output written once a
    client, ``delta``; 20 integer operations an output element (Philox)."""
    return KernelCost("K1", 0.0, 20.0 * C * P, 4 * P + 4 * C * P + 4 * C,
                      2 * P + 2 * C * P + 2 * C, "int32", "elementwise")


def sr_quant_inline_cost(n: int, out_dtype: torch.dtype) -> KernelCost:
    """K1's inline entry (one weight use): f32 ``w`` read, ``out_dtype``
    written, ``delta``; 20 integer operations an element."""
    es = _elem_bytes(out_dtype)
    return KernelCost("K1", 0.0, 20.0 * n, 4 * n + es * n + 4,
                      2 * n + _elem_bytes(out_dtype, True) * n + 2, "int32", "elementwise")


def sr_pack_segments_cost(P: int, C: int, L: int, code_dtype: torch.dtype) -> KernelCost:
    """K2's u-taking entry: gradients and uniforms read once, the codes
    written once, offsets and pitches once."""
    es = _elem_bytes(code_dtype)
    raw = 8 * C * P + C * P * es + 4 * (2 * L + 1)
    b16 = 4 * C * P + C * P * es + 4 * (L + 1) + 2 * L
    return KernelCost("K2", 0.0, 0.0, raw, b16, "f32", "elementwise")


def sr_pack_keyed_cost(P: int, C: int, L: int, code_dtype: torch.dtype) -> KernelCost:
    """K2's keyed entry: the gradients read once, the codes written once,
    the pitches (L,) and the non-finite count; 20 integer operations an
    element."""
    es = _elem_bytes(code_dtype)
    return KernelCost("K2", 0.0, 20.0 * C * P, 4 * C * P + C * P * es + 4 * L + 8,
                      2 * C * P + C * P * es + 2 * L + 8, "int32", "elementwise")


def sr_pack_keyed_scales_cost(P: int, C: int, L: int) -> KernelCost:
    """K2's pass 1 alone: the gradients read once, each row's largest finite
    |g| a leaf (C, L) and the non-finite count written; 3 integer operations
    an element (the mask, the compare, the count)."""
    return KernelCost("K2", 0.0, 3.0 * C * P, 4 * C * P + 4 * C * L + 8,
                      2 * C * P + 2 * C * L + 8, "int32", "elementwise")


def sr_pack_keyed_scaled_cost(P: int, C: int, L: int, code_dtype: torch.dtype) -> KernelCost:
    """K2's pass 2 given the scales: the gradients read once, the scales
    (L,) and (C, L) read, the codes and the pitches written; the keyed
    entry's 20 integer operations an element."""
    es = _elem_bytes(code_dtype)
    return KernelCost("K2", 0.0, 20.0 * C * P, 4 * C * P + 4 * L + 4 * C * L + C * P * es + 4 * L,
                      2 * C * P + 2 * L + 2 * C * L + C * P * es + 2 * L, "int32",
                      "elementwise")


def quant_matmul_cost(M: int, K: int, N: int, x_dtype: torch.dtype,
                      code_dtype: torch.dtype) -> KernelCost:
    """K3: ``x`` (M, K), the codes (K, N), the scale and the f32 output;
    2 M K N operations at ``x``'s dtype peak."""
    ec = _elem_bytes(code_dtype)
    raw = _elem_bytes(x_dtype) * M * K + ec * K * N + 4 + 4 * M * N
    b16 = _elem_bytes(x_dtype, True) * M * K + ec * K * N + 2 + 2 * M * N
    return KernelCost("K3", 2.0 * M * K * N, 0.0, raw, b16, _peak_of(x_dtype), "dot")


def flash_attention_cost(BH: int, S: int, D: int, dtype: torch.dtype,
                         causal: bool) -> KernelCost:
    """K4: q, k, v read and the output written once; the two products,
    4 BH D operations a query-key pair (S(S+1)/2 pairs causal, S^2 not), at
    the bf16 peak for f32 inputs too (the split path runs on the bf16
    tensor cores)."""
    pairs = S * (S + 1) / 2 if causal else S * S
    n = BH * S * D
    return KernelCost("K4", 4.0 * BH * D * pairs, 0.0, 4 * n * _elem_bytes(dtype),
                      4 * n * _elem_bytes(dtype, True), "bf16", "dot")


def flash_decode_cost(B: int, KV: int, G: int, hd: int, q_dtype: torch.dtype,
                      pool_dtype: torch.dtype, n_pmax: int, tokens: int) -> KernelCost:
    """K5: q, the ``tokens`` keys and values the slots' lengths reach, the
    page table, the lengths and the f32 outputs ``(acc, m, l)``;
    4 KV G hd operations a token at the f32 peak."""
    qn = B * KV * G * hd

    def nbytes(bf16: bool) -> float:
        return (qn * _elem_bytes(q_dtype, bf16)
                + 2 * tokens * KV * hd * _elem_bytes(pool_dtype, bf16)
                + 4 * B * n_pmax + 4 * B
                + _elem_bytes(torch.float32, bf16) * (qn + 2 * qn // hd))

    return KernelCost("K5", 4.0 * KV * G * hd * tokens, 0.0, nbytes(False), nbytes(True),
                      "f32", "dot")


def decode_tokens(page_table, lengths, page: int) -> int:
    """The keys K5 reads at these lengths: each slot's tokens in the pages
    it owns (``page_table`` rows of page ids, -1 a hole; host lists)."""
    return sum(min(page, n - j * page) for row, n in zip(page_table, lengths)
               for j, pid in enumerate(row) if pid >= 0 and j * page < n)


# ---------------------------------------------------------------------------
# The record
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Node(KernelCost):
    """One counted operation, a dot the step dispatched or a kernel call:
    its cost, and where and how much of it one device runs."""

    op: str = ""             # aten op, or the kernel's entry name
    share: float = 1.0       # the share of it one device of the mesh does
    copies: int = 1          # times the port's one-card step runs it (a
                             # traced device's client in a Dx1 loop: D)
    shape: str = ""
    site: str = ""           # the port function that ran it (a backward
                             # dot: the function of its forward op)


@dataclasses.dataclass
class HostRead:
    """A device value the step reads on the host (a sync on the card)."""

    site: str                # file:line and function of the read
    what: str


@dataclasses.dataclass
class Record:
    """What one traced step dispatched (see the module docstring)."""

    computation: str = "step"
    decode_len: int | list | None = None   # tokens K5 reads a slot (or per slot)
    nodes: list = dataclasses.field(default_factory=list)
    collectives: list = dataclasses.field(default_factory=list)
    host_reads: list = dataclasses.field(default_factory=list)
    argument_bytes: int = 0
    output_bytes: int = 0
    peak_bytes: int = 0
    live_bytes: int = 0
    graph: "Graph | None" = None           # with recording(graph=True)
    _share: list = dataclasses.field(default_factory=lambda: [(1.0, 1)])
    _untracked: int = 0

    @property
    def share(self) -> float:
        return self._share[-1][0]

    @property
    def copies(self) -> int:
        return self._share[-1][1]

    def by_site(self) -> dict:
        """``{site: [flops, bf16-equivalent bytes]}`` of the dot stream per
        device, by the port function each dot ran in."""
        out: dict = defaultdict(lambda: [0.0, 0.0])
        for n in self.nodes:
            if n.stream == "dot":
                out[n.site][0] += n.flops * n.share
                out[n.site][1] += n.bytes_bf16 * n.share
        return dict(out)


# ---------------------------------------------------------------------------
# The operation graph (recording(graph=True))
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Ref:
    """A tensor argument of a :class:`GraphOp`: ``ins[i]``."""

    i: int


@dataclasses.dataclass
class GraphOp:
    """One entry of the operation graph.

    ``kind``: ``"aten"`` (a dispatched op, ``op`` its packet name such as
    ``"add_"`` and ``overload`` such as ``"Tensor"``), ``"kernel"`` (a kernel
    call on the trace route, ``op`` its entry name, ``params`` its scalar
    arguments), ``"collective"`` (``op`` its kind, ``params`` the record's
    dtype, elements, group and name), ``"input"`` (a value the step did not
    make: an argument, a tensor made outside the recording), ``"join"``
    (a partial in-place write: the storage's value before and what was
    written).  ``ins``/``outs`` are value ids; ``args``/``kwargs`` the
    scalar arguments with tensors as :class:`Ref`.  ``site`` is the port
    function's qualified name (a backward op: its forward op's), ``key``
    ``file.py:function`` and ``where`` ``path:line``.
    """

    kind: str
    op: str
    ins: tuple = ()
    outs: tuple = ()
    args: tuple = ()
    kwargs: dict = dataclasses.field(default_factory=dict)
    overload: str = ""
    params: dict = dataclasses.field(default_factory=dict)
    site: str = "?"
    key: str = "?"
    where: str = "?"


@dataclasses.dataclass
class Graph:
    """The dataflow of one traced step.

    Values are numbered by a counter: a tensor's value is keyed by its
    storage, its view (offset, shape, stride, dtype) and its version, so
    the graph holds no reference to a tensor and an in-place write through
    a view gives the written view a new value and its storage the join of
    the old value and the written one.  ``meta[vid]`` is ``(dtype name,
    shape)``; ``const[vid]`` is ``(lo, hi, integral)`` of a value the fake
    tensor knows (``FakeTensor.constant``); ``inputs`` the value ids of the
    recording's arguments, in the order of their tensors; ``outputs`` what a
    caller marks (:meth:`mark_outputs`).
    """

    ops: list = dataclasses.field(default_factory=list)
    meta: list = dataclasses.field(default_factory=list)
    const: dict = dataclasses.field(default_factory=dict)
    inputs: list = dataclasses.field(default_factory=list)
    outputs: list = dataclasses.field(default_factory=list)
    producer: dict = dataclasses.field(default_factory=dict)
    _views: dict = dataclasses.field(default_factory=dict, repr=False)
    _whole: dict = dataclasses.field(default_factory=dict, repr=False)

    def new_value(self, t: torch.Tensor | None, dtype=None, shape=None) -> int:
        vid = len(self.meta)
        if t is not None:
            dtype, shape = t.dtype, tuple(t.shape)
        self.meta.append((dtype_name(dtype), tuple(shape or ())))
        return vid

    def add(self, op: GraphOp) -> GraphOp:
        i = len(self.ops)
        self.ops.append(op)
        for v in op.outs:
            self.producer[v] = i
        return op

    # -- tensor -> value ------------------------------------------------------
    @staticmethod
    def _view_key(t: torch.Tensor):
        return (t.storage_offset(), tuple(t.shape), tuple(t.stride()), t.dtype)

    def lookup(self, t: torch.Tensor) -> int | None:
        """The value ``t`` holds now, or None if the graph never saw it."""
        sid = id(t.untyped_storage())
        ver = t._version
        ent = self._views.get(sid, {}).get(self._view_key(t))
        if ent is not None and ent[0] == ver:
            return ent[1]
        whole = self._whole.get(sid)
        if whole is not None and whole[0] == ver:
            return whole[1]              # a view of a value: within its bounds
        return None

    def read(self, t, site=("?", "?", "?")) -> int:
        """The value of a tensor argument; one never seen is an ``input``."""
        vid = self.lookup(t)
        if vid is None:
            vid = self.new_value(t)
            self.add(GraphOp("input", "input", outs=(vid,), site=site[0], key=site[1],
                             where=site[2]))
            self._const(t, vid)
            self.bind(t, vid)
        return vid

    def bind(self, t: torch.Tensor, vid: int, version: int | None = None) -> None:
        """``t`` holds ``vid`` at ``version`` (default: its version now)."""
        st = t.untyped_storage()
        sid, ver = id(st), t._version if version is None else version
        self._views.setdefault(sid, {})[self._view_key(t)] = (ver, vid)
        if (t.storage_offset() == 0 and t.is_contiguous()
                and t.numel() * t.element_size() == st.nbytes()):
            self._whole[sid] = (ver, vid)

    def write(self, t: torch.Tensor, vid: int, before: int | None, site) -> None:
        """``t`` was written in place with ``vid``; ``before`` the value of
        its storage before the write (None: unknown).  A dispatch mode runs
        below autograd's version bump, so the write holds from the next
        version on."""
        st = t.untyped_storage()
        whole = (t.storage_offset() == 0 and t.is_contiguous()
                 and t.numel() * t.element_size() == st.nbytes())
        ver = t._version + 1
        self.bind(t, vid, ver)
        if whole:
            return
        if before is None:
            before = self.new_value(None, t.dtype, (st.nbytes() // max(t.element_size(), 1),))
            self.add(GraphOp("input", "input", outs=(before,), site=site[0], key=site[1],
                             where=site[2]))
        joined = self.new_value(None, t.dtype, (st.nbytes() // max(t.element_size(), 1),))
        self.add(GraphOp("join", "join", ins=(before, vid), outs=(joined,), site=site[0],
                         key=site[1], where=site[2]))
        self._whole[id(st)] = (ver, joined)

    def storage_value(self, t: torch.Tensor) -> int | None:
        """The value of ``t``'s whole storage at ``t``'s version, if known."""
        whole = self._whole.get(id(t.untyped_storage()))
        return whole[1] if whole is not None and whole[0] == t._version else None

    def forget(self, sid: int) -> None:
        self._views.pop(sid, None)
        self._whole.pop(sid, None)

    def _const(self, t, vid: int) -> None:
        c = getattr(t, "constant", None)
        if c is None and isinstance(t, torch.Tensor) and not is_traced(t):
            c = t                         # a real tensor among fake ones
        if c is None or c.numel() == 0 or c.numel() > 1 << 16:
            return
        from torch._subclasses.fake_tensor import unset_fake_temporarily

        with unset_fake_temporarily():
            a = c.detach().to("cpu", torch.float64)
            lo, hi = float(a.min()), float(a.max())
            integral = bool(torch.all(a == torch.round(a)))
        self.const[vid] = (lo, hi, integral)

    def mark_outputs(self, *tensors) -> list:
        """Mark ``tensors`` as the graph's outputs; returns their value ids."""
        self.outputs = [self.lookup(t) for t in tensors]
        return self.outputs

    def by_kind(self, kind: str) -> list:
        return [op for op in self.ops if op.kind == kind]


def dtype_name(dtype) -> str:
    """``torch.float32`` -> ``"float32"`` (the numpy-style name)."""
    return str(dtype).replace("torch.", "") if dtype is not None else "float32"


def _sanitize(x, ins: list):
    """A scalar argument as the graph keeps it; tensors become :class:`Ref`."""
    if isinstance(x, torch.Tensor):
        ins.append(x)
        return Ref(len(ins) - 1)
    if isinstance(x, (list, tuple)):
        return tuple(_sanitize(v, ins) for v in x)
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, torch.dtype):
        return dtype_name(x)
    return str(x)


@functools.lru_cache(maxsize=None)
def _written(func) -> tuple:
    """``((position, name), ...)`` of the arguments ``func`` writes."""
    return tuple((i, a.name) for i, a in enumerate(func._schema.arguments)
                 if a.alias_info is not None and a.alias_info.is_write)


_STDLIB = os.path.dirname(os.__file__)


def _user_frame(name: str) -> bool:
    """A frame of the caller's code: not torch, not the standard library or
    an installed package, not this module or the kernels' trace route."""
    return ("/torch/" not in name and not name.startswith(_STDLIB)
            and "-packages/" not in name and not name.startswith("<")
            and not name.endswith(("roofline/count.py", "kernels/ops.py")))


def _frame_site(frame) -> tuple:
    """``(qualified name of the innermost port function, "file.py:function",
    "path:line")``: the first as :func:`_port_function` gives it (the record's
    cost site), the others of the innermost frame of the caller's code (a
    port function, or whatever code outside torch ran the operation)."""
    key = where = None
    while frame is not None:
        name = frame.f_code.co_filename
        if key is None and _user_frame(name):
            base = name.rsplit("/", 1)[-1]
            key = f"{base}:{frame.f_code.co_name}"
            where = f"{name.split('/src/')[-1]}:{frame.f_lineno}"
        if ("repro_torch" in name and not name.endswith(("roofline/count.py",
                                                         "kernels/ops.py"))):
            return (frame.f_code.co_qualname, key, where)
        frame = frame.f_back
    return ("?", key or "?", where or "?")

_ACTIVE: Record | None = None


def active() -> Record | None:
    """The record being written, or None outside :func:`recording`."""
    return _ACTIVE


@contextlib.contextmanager
def share(fraction: float, copies: int = 1):
    """Count what runs inside at ``fraction`` of itself per device, and
    ``copies`` times in the step as the port runs it on its one card (the
    card bound, :func:`repro_torch.roofline.analysis.analyze_trace`); a
    no-op outside a recording."""
    rec = _ACTIVE
    if rec is None:
        yield
        return
    rec._share.append((rec.share * float(fraction), rec.copies * int(copies)))
    try:
        yield
    finally:
        rec._share.pop()


def record_kernel(op: str, cost: KernelCost, shape: str = "", *, ins=(), outs=(),
                  params: dict | None = None) -> None:
    """A kernel call on the trace route (``kernels/ops.py``).  With a graph,
    the call is a ``kernel`` node reading ``ins`` and writing ``outs`` (the
    tensors the route returns; each holds the kernel's value from here),
    with the scalar arguments ``params``."""
    rec = _ACTIVE
    if rec is not None:
        rec.nodes.append(Node(**dataclasses.asdict(cost), op=op, share=rec.share,
                              copies=rec.copies,
                              shape=shape, site=_port_function(sys._getframe(1))))
        if rec.graph is not None:
            site = _frame_site(sys._getframe(1))
            g = rec.graph
            ivs = tuple(g.read(t, site) for t in ins)
            ovs = tuple(g.new_value(t) for t in outs)
            g.add(GraphOp("kernel", op, ins=ivs, outs=ovs, params=dict(params or {},
                                                                       kernel=cost.kernel),
                          site=site[0], key=site[1], where=site[2]))
            for t, v in zip(outs, ovs):
                g.bind(t, v)


def record_collective(kind: str, dtype: torch.dtype, elems: int, group: int,
                      name: str, operand: torch.Tensor | None = None,
                      reduction: str = "sum") -> None:
    """A collective the reference's device issues here: ``kind`` over a
    group of ``group`` devices, a result of ``elems`` elements of ``dtype``
    (a no-op outside a recording).  ``operand``: the values one device
    contributes (whose sum an all-reduce carries); with a graph the
    collective is a node reading it (none given: the dtype's whole range).
    ``reduction``: what an all-reduce computes, ``"sum"``, ``"max"`` or
    ``"min"`` (the graph keeps it: only a sum accumulates)."""
    rec = _ACTIVE
    if rec is None:
        return
    if kind not in COLLECTIVE_KINDS:
        raise ValueError(f"unknown collective {kind!r}")
    nbytes = float(elems * _elem_bytes(dtype))
    rec.collectives.append(CollectiveOp(
        kind=kind, dtype=HLO_DTYPES[dtype], elems=int(elems), bytes=nbytes,
        wire_bytes=ring_wire_bytes(kind, nbytes, int(group)), group_size=int(group),
        mult=rec.share, name=name, computation=rec.computation,
        parts=((HLO_DTYPES[dtype], int(elems)),)))
    if rec.graph is not None:
        site = _frame_site(sys._getframe(1))
        ins = () if operand is None else (rec.graph.read(operand, site),)
        rec.graph.add(GraphOp("collective", kind, ins=ins, params=dict(
            dtype=dtype_name(dtype), elems=int(elems), group=int(group), name=name,
            index=len(rec.collectives) - 1, reduction=reduction), site=site[0], key=site[1],
            where=site[2]))


def graph_active() -> bool:
    """Whether the active recording keeps an operation graph."""
    return _ACTIVE is not None and _ACTIVE.graph is not None


@contextlib.contextmanager
def untracked():
    """Operations inside enter the graph but not the live-byte count (the
    values a graph-only computation makes, such as a collective's operand
    that the port's step does not compute itself)."""
    rec = _ACTIVE
    if rec is None:
        yield
        return
    rec._untracked += 1
    try:
        yield
    finally:
        rec._untracked -= 1


def _call_site() -> str:
    for fr in reversed(traceback.extract_stack()[:-2]):
        if "/torch/" not in fr.filename and not fr.filename.endswith("roofline/count.py"):
            return f"{fr.filename.split('/src/')[-1]}:{fr.lineno} {fr.name}"
    return "?"


def is_traced(t) -> bool:
    """Whether ``t`` is a fake tensor (the trace route's tensors; a meta
    tensor is no traced step's and has no route)."""
    return isinstance(t, FakeTensor)


def host_read(t: torch.Tensor, what: str):
    """Read ``t`` on the host, as ``int(t)`` does, where the real step reads
    it.  On a traced tensor there is no value: the read is recorded with its
    call site and None returned, and the caller skips what the value would
    only have checked (never a branch of the computation)."""
    if is_traced(t):
        if _ACTIVE is not None:
            _ACTIVE.host_reads.append(HostRead(_call_site(), what))
        return None
    return int(t)


# ---- the dispatch mode ------------------------------------------------------


def _port_function(frame) -> str:
    """Qualified name of the innermost port function on the stack (the
    kernels' trace route and this module excluded)."""
    while frame is not None:
        name = frame.f_code.co_filename
        if ("repro_torch" in name and not name.endswith(("roofline/count.py",
                                                         "kernels/ops.py"))):
            return frame.f_code.co_qualname
        frame = frame.f_back
    return "?"


def _recomputing(frame) -> bool:
    """Whether an op dispatched in backward is an activation checkpoint's
    recompute of its forward (a port function runs inside
    ``torch.utils.checkpoint``'s recompute): its site is that function, not
    the backward node that asked for the recompute."""
    port = False
    while frame is not None:
        name = frame.f_code.co_filename
        if name.endswith("utils/checkpoint.py"):
            return port
        if name.endswith(("autograd/graph.py", "autograd/__init__.py")):
            return False                        # the engine's caller: a plain backward
        if ("repro_torch" in name and not name.endswith(("roofline/count.py",
                                                         "kernels/ops.py"))):
            port = True
        frame = frame.f_back
    return False


_aten = torch.ops.aten
#: matmul ops -> (index of lhs, index of rhs) among the positional args
_DOTS = {_aten.mm.default: (0, 1), _aten.addmm.default: (1, 2),
         _aten.bmm.default: (0, 1), _aten.baddbmm.default: (1, 2),
         _aten.dot.default: (0, 1), _aten.vdot.default: (0, 1),
         _aten.mv.default: (0, 1), _aten.addmv.default: (1, 2)}


class _Recorder(TorchDispatchMode):
    def __init__(self, rec: Record):
        super().__init__()
        self.rec = rec
        self.live: dict = {}
        self.graph_only: set = set()  # storages made under untracked()
        self.sites: dict = {}        # autograd sequence number -> forward site

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self.live or key in self.graph_only:
            return
        g = self.rec.graph
        if g is not None:
            g.forget(key)                       # a new storage: an id reused
        if self.rec._untracked:
            self.graph_only.add(key)
            weakref.finalize(st, self._free, key)
            return
        n = st.nbytes()
        self.live[key] = n
        self.rec.live_bytes += n
        self.rec.peak_bytes = max(self.rec.peak_bytes, self.rec.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.graph_only.discard(key)
        n = self.live.pop(key, 0)
        self.rec.live_bytes -= n
        if self.rec.graph is not None:
            self.rec.graph.forget(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is _aten._local_scalar_dense.default:
            raise RuntimeError(
                f"a host read of a traced value at {_call_site()}: read it through "
                "repro_torch.roofline.count.host_read")
        g = self.rec.graph
        if g is not None:
            return self._dispatch_graph(func, args, kwargs)
        out = func(*args, **kwargs)
        node = torch._C._current_autograd_node()
        if node is not None and not _recomputing(sys._getframe(1)):
            site = self.sites.get(node._sequence_nr(), "?")    # backward: the forward op's
        else:
            site = _port_function(sys._getframe(1))
        # the node this op made (if any) has the number before the counter
        self.sites.setdefault(torch._C._autograd._get_sequence_nr() - 1, site)
        self._count(func, args, out, site)
        return out

    def _count(self, func, args, out, site) -> None:
        if func in _DOTS:
            i, j = _DOTS[func]
            self._dot(str(func.overloadpacket), args[i], args[j], out, site)
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.track(t)

    def _dispatch_graph(self, func, args, kwargs):
        """:meth:`__torch_dispatch__` with the graph: the same count, and the
        op's entry (values read before it runs, written after)."""
        g = self.rec.graph
        node = torch._C._current_autograd_node()
        if node is not None and not _recomputing(sys._getframe(2)):
            fsite = self.sites.get(node._sequence_nr(), ("?", "?", "?"))
        else:
            fsite = _frame_site(sys._getframe(2))
        ins: list = []
        sargs = _sanitize(tuple(args), ins)
        skw = {k: _sanitize(v, ins) for k, v in kwargs.items()}
        in_vids = tuple(g.read(t, fsite) for t in ins)
        written = []
        for i, name in _written(func):
            t = args[i] if i < len(args) else kwargs.get(name)
            if isinstance(t, torch.Tensor):
                written.append((t, g.storage_value(t)))
        out = func(*args, **kwargs)
        self.sites.setdefault(torch._C._autograd._get_sequence_nr() - 1, fsite)
        self._count(func, args, out, fsite[0])
        outs = [t for t in (out if isinstance(out, (tuple, list)) else (out,))
                if isinstance(t, torch.Tensor)]
        outs += [t for t, _ in written if not any(t is o for o in outs)]
        if not outs:
            return out
        out_vids = tuple(g.new_value(t) for t in outs)
        g.add(GraphOp("aten", func._overloadpacket.__name__, ins=in_vids, outs=out_vids,
                      args=sargs, kwargs=skw, overload=func._overloadname, site=fsite[0],
                      key=fsite[1], where=fsite[2]))
        for t, v in zip(outs, out_vids):
            before = next((b for w, b in written if w is t), False)
            if before is False:
                g.bind(t, v)
                g._const(t, v)
            else:
                g.write(t, v, before, fsite)
        return out

    def _dot(self, op, a, b, out, site) -> None:
        k = a.shape[-1] if a.ndim else 1
        flops = 2.0 * out.numel() * k
        raw = _tensor_bytes(a) + _tensor_bytes(b) + _tensor_bytes(out)
        b16 = _tensor_bytes(a, True) + _tensor_bytes(b, True) + _tensor_bytes(out, True)
        peak = "bf16" if a.dtype == torch.bfloat16 else "f32"
        dims = [",".join(map(str, t.shape)) for t in (a, b, out)]
        shape = f"{dims[0]}@{dims[1]}->{dims[2]} k={k}"
        self.rec.nodes.append(Node(None, flops, 0.0, raw, b16, peak, "dot", op=op,
                                   share=self.rec.share, copies=self.rec.copies,
                                   shape=shape, site=site))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


@contextlib.contextmanager
def recording(arguments=(), *, computation: str = "step", decode_len=None,
              graph: bool = False):
    """Record every operation run inside (under a ``FakeTensorMode`` the
    caller entered).  ``arguments``: the step's inputs, live from the start
    (the high-water mark counts them).  ``graph``: also keep the operation
    graph (:attr:`Record.graph`; its ``inputs`` are the arguments' tensors).
    Yields the :class:`Record`."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a recording is already active")
    rec = Record(computation=computation, decode_len=decode_len,
                 graph=Graph() if graph else None)
    mode = _Recorder(rec)
    for t in _tensors(arguments):
        mode.track(t)
        if rec.graph is not None:
            rec.graph.inputs.append(rec.graph.read(t, ("<argument>", "<argument>", "?")))
    _ACTIVE = rec
    try:
        with mode:
            yield rec
    finally:
        _ACTIVE = None


def tree_bytes(tree) -> int:
    """Bytes of the distinct storages a tree of tensors holds."""
    seen, n = set(), 0
    for t in _tensors(tree):
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            n += st.nbytes()
    return n


def costs(rec: Record, *, bf16: bool = False) -> ModuleCosts:
    """The dot stream's and the collectives' totals per device, as
    ``parse_module`` gives them for the reference (``bf16``: the
    bf16-equivalent rewrite)."""
    flops = sum(n.flops * n.share for n in rec.nodes if n.stream == "dot")
    dbytes = sum((n.bytes_bf16 if bf16 else n.bytes) * n.share
                 for n in rec.nodes if n.stream == "dot")
    by_kind: dict = defaultdict(float)
    counts: dict = defaultdict(float)
    ops = []
    for op in rec.collectives:
        if bf16 and op.dtype == "f32":
            op = dataclasses.replace(op, dtype="bf16", bytes=op.bytes / 2,
                                     wire_bytes=op.wire_bytes / 2,
                                     parts=(("bf16", op.elems),))
        by_kind[op.kind] += op.wire_bytes * op.mult
        counts[op.kind] += op.mult
        ops.append(op)
    return ModuleCosts(flops=flops, dot_bytes=dbytes,
                       collective_bytes=sum(by_kind.values()),
                       collective_by_kind=dict(by_kind),
                       collective_counts={k: int(round(v)) for k, v in counts.items()},
                       n_while=0, collectives=ops)
