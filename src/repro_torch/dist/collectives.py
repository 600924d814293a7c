"""Axis context, the batch and FSDP collectives, and the SR-quantized
gradient all-reduce of the port.

:class:`AxisCtx` names the axes of a launch as the reference's mesh context
does (``batch_axes``, ``model_axis``, ``fsdp_axes``) and carries their sizes.
A ``Dx1`` mesh runs one of two ways:

* **one process**: the D data-parallel groups (the FL clients) run one after
  another in a loop on one device, so where the reference asks
  ``lax.axis_index`` which client it is, the context says which client the
  loop is at (:meth:`AxisCtx.at_client`) and the batch collectives are
  identities, as the reference's are outside a mesh;
* **one process a client**: under a ``torch.distributed`` group of D ranks
  (:class:`Transport`), rank r is client r, and :meth:`AxisCtx.psum_batch`,
  :meth:`~AxisCtx.pmean_batch`, :meth:`~AxisCtx.pmax_batch` and
  :meth:`~AxisCtx.gather_fsdp` (a tiled all-gather whose transpose is a
  reduce-scatter) are the reference's collectives over real ranks.

A model axis of size T > 1 (tensor parallelism) runs one process a model
shard: under a group of D·T ranks, rank r is data index ``r // T`` and model
index ``r % T`` (``jax.make_mesh((D, T))``'s device order, data-major), and
the context carries a second :class:`Transport` over the rank's model group.
:meth:`AxisCtx.tp_index`, :meth:`~AxisCtx.psum_model`,
:meth:`~AxisCtx.pmax_model`, :meth:`~AxisCtx.pmin_model`,
:meth:`~AxisCtx.all_gather_model` and :meth:`~AxisCtx.psum_scatter_model`
are the reference's model-axis collectives over it; the batch collectives
go over the batch group (the ranks of the rank's model column).  Without a
model group the model axis is 1 and the model collectives are identities.
A traced step (the dry run, :mod:`repro_torch.roofline.count`) runs one
device of the mesh with a :class:`TraceTransport` of T ranks as its model
group: no process group, each collective recorded where the ranks run it.

The model collectives carry gradients as Megatron's pairs do, not as the
reference's transposes (its ``psum`` transposes to a ``psum``, which
multiplies every cotangent upstream of a row-parallel sum by T: ROADMAP §3,
D16).  Each model rank differentiates the same loss, and the cotangent of
an activation inside the rank-local region (between a block's input
gather and its output sum) is that rank's part of the whole: the sum
(:meth:`~AxisCtx.psum_model`) goes back as the identity, the all-gather of
a sequence-parallel input as the reduce-scatter of the parts, the
reduce-scatter of a block output as the all-gather of its slices, and a
replicated activation entering rank-local work (:meth:`~AxisCtx.copy_model`)
as the all-reduce of its parts; a replicated activation cut to the rank's
sequence slice (:meth:`~AxisCtx.split_model`) goes back as the all-gather of
the slices.  ``pmax`` and ``pmin`` carry none (the max the cross-entropy
takes is a constant to it).  Every backward collective goes through the
same :class:`Transport`, so its counts hold them.

:func:`quantized_psum_batch` is the paper's Eq. 1 stochastic-rounding
quantizer applied to model updates on the wire: the clients agree on a shared
grid through the max of their scales, round onto integer codes (K2), sum the
codes exactly and dequantize to the mean.  It takes any number of leaves, so
one K2 call packs a whole train step's wire: the keyed entry
(:func:`repro_torch.kernels.ops.sr_pack_keyed`, uniforms drawn in the kernel
from the wire's key, the clients' gradients read where they lie) or, given
uniforms, the u-taking one (:func:`repro_torch.kernels.ops.sr_pack_segments`).
Across ranks the keyed entry runs split at its pass boundary, the
reference's protocol: pass 1, the non-finite count's sum, the scales' max,
pass 2 drawing the rank's own Philox stream, the codes' sum.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any

import numpy as np
import torch

from repro_torch.core.quantization import FULL_PRECISION_BITS
from repro_torch.kernels import ops
from repro_torch.kernels.ref import f32_reciprocal, saturate_nonfinite
from repro_torch.roofline import count

log = logging.getLogger("repro_torch.dist")


class Transport:
    """The collectives of one ``torch.distributed`` process group.

    Every collective the port issues across ranks goes through here, so the
    counts by kind and dtype (``issued``: ``(kind, dtype) -> [calls,
    bytes]``, the bytes of the collective's full operand) are what the ranks
    really moved.  Under ``gloo`` a collective that the backend does not take
    on CUDA tensors is staged through a host copy: the first refusal is
    logged with its reason and the kind is listed in ``staged`` (``kind ->
    reason``).  Nothing is staged under ``nccl``; there a refusal raises.
    """

    def __init__(self, group=None):
        import torch.distributed as dist

        self.dist = dist
        self.group = group
        self.backend = str(dist.get_backend(group))
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.issued: dict = {}
        self.staged: dict = {}

    def _count(self, kind: str, t: torch.Tensor) -> None:
        acc = self.issued.setdefault((kind, str(t.dtype).replace("torch.", "")), [0, 0])
        acc[0] += 1
        acc[1] += t.numel() * t.element_size()

    def _run(self, kind: str, native, *tensors):
        """``native(*tensors)`` (the collective on the tensors where they
        lie), or on host copies of them, copied back, where gloo refuses the
        kind on CUDA tensors."""
        on_card = any(t.is_cuda for t in tensors)
        if kind not in self.staged or not on_card:
            try:
                native(*tensors)
                return
            except RuntimeError as e:
                if self.backend != "gloo" or not on_card:
                    raise
                self.staged[kind] = str(e).splitlines()[0][:200]
                log.warning("gloo does not take %s on CUDA tensors (%s): staged through "
                            "a host copy from now on", kind, self.staged[kind])
        host = [t.cpu() for t in tensors]
        native(*host)
        for t, h in zip(tensors, host):
            t.copy_(h)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """A new tensor: the sum (``op="sum"``), max (``"max"``) or min
        (``"min"``) of ``x`` over the ranks."""
        out = x.detach().clone().contiguous()
        rop = {"sum": self.dist.ReduceOp.SUM, "max": self.dist.ReduceOp.MAX,
               "min": self.dist.ReduceOp.MIN}[op]
        self._count(f"all-reduce {op}", out)
        self._run(f"all-reduce {op}", lambda t: self.dist.all_reduce(t, op=rop,
                                                                      group=self.group), out)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' ``x`` concatenated along dim 0, in rank order."""
        x = x.detach().contiguous()
        out = torch.empty((self.size * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        self._count("all-gather", out)
        self._run("all-gather", lambda o, i: self.dist.all_gather_into_tensor(
            o, i, group=self.group), out, x)
        return out

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """Rank r's dim-0 block of the sum of the ranks' ``x``."""
        x = x.detach().contiguous()
        if x.shape[0] % self.size:
            raise ValueError(f"reduce_scatter: dim 0 of {tuple(x.shape)} does not divide "
                             f"by {self.size} ranks")
        out = torch.empty((x.shape[0] // self.size, *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        self._count("reduce-scatter", x)
        self._run("reduce-scatter", lambda o, i: self.dist.reduce_scatter_tensor(
            o, i, op=self.dist.ReduceOp.SUM, group=self.group), out, x)
        return out

    def broadcast_object(self, obj, src: int = 0):
        """The ``obj`` of the group's rank ``src`` on every rank (pickled;
        host memory)."""
        box = [obj]
        self.dist.broadcast_object_list(box, group=self.group, group_src=src)
        self.issued.setdefault(("broadcast", "object"), [0, 0])[0] += 1
        return box[0]

    def barrier(self) -> None:
        self.dist.barrier(group=self.group)

    def report(self) -> dict:
        """``{"issued": {"kind dtype": {"calls", "bytes"}}, "staged": {kind:
        reason}}`` since the transport was made."""
        return {"issued": {f"{k} {dt}": {"calls": n, "bytes": b}
                           for (k, dt), (n, b) in sorted(self.issued.items())},
                "staged": dict(self.staged)}


class TraceTransport:
    """A stand-in for a group of ``size`` ranks, run as rank 0, in a traced
    step (:mod:`repro_torch.roofline.count`): no process group, nothing
    moved.

    ``all_reduce``, ``all_gather`` and ``reduce_scatter`` take traced
    (fake) tensors only and raise on any other: they move nothing, so a
    real step through them would compute wrong sums.  They return tensors
    of the shapes :class:`Transport` returns, record each call through
    :func:`~repro_torch.roofline.count.record_collective` under the
    reference's kind over a group of ``size``, and keep ``issued`` as
    :class:`Transport` does, so a traced rank's counts compare with a real
    rank's :meth:`Transport.report` (the model group is the one a trace
    runs through it).
    """

    def __init__(self, size: int):
        self.size, self.rank = int(size), 0
        self.issued: dict = {}
        self.staged: dict = {}

    _count = Transport._count
    report = Transport.report

    def _traced(self, kind: str, x: torch.Tensor) -> torch.Tensor:
        if not count.is_traced(x):
            raise RuntimeError(f"TraceTransport {kind}: a stand-in group moves nothing and "
                               "takes traced (fake) tensors only; a real step needs a "
                               "process group (launch/mesh.axis_ctx_for)")
        return x.detach().contiguous()

    def _record(self, kind: str, t: torch.Tensor, elems: int, operand,
                reduction: str = "sum") -> None:
        count.record_collective(kind, t.dtype, elems, self.size, f"model group {kind}",
                                operand=operand, reduction=reduction)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        out = self._traced("all-reduce", x).clone()
        self._count(f"all-reduce {op}", out)
        self._record("all-reduce", out, out.numel(), out, op)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        x = self._traced("all-gather", x)
        out = x.repeat(self.size, *([1] * (x.ndim - 1)))
        self._count("all-gather", out)
        self._record("all-gather", out, out.numel(), x)
        return out

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        x = self._traced("reduce-scatter", x)
        if x.shape[0] % self.size:
            raise ValueError(f"reduce_scatter: dim 0 of {tuple(x.shape)} does not divide "
                             f"by {self.size} ranks")
        out = x[:x.shape[0] // self.size].clone()
        self._count("reduce-scatter", x)
        self._record("reduce-scatter", out, out.numel(), x)
        return out


class _FSDPGather(torch.autograd.Function):
    """The tiled all-gather of an FSDP shard along ``axis``; its backward is
    the reduce-scatter (summed over the ranks) that is the gather's
    transpose, which makes FSDP gradients come back summed and sharded."""

    @staticmethod
    def forward(ctx, x, axis: int, transport: Transport):
        ctx.axis, ctx.transport = axis, transport
        full = transport.all_gather(x.movedim(axis, 0))
        return full.movedim(0, axis).contiguous()

    @staticmethod
    def backward(ctx, g):
        shard = ctx.transport.reduce_scatter(g.movedim(ctx.axis, 0))
        return shard.movedim(0, ctx.axis).contiguous(), None, None


class _ModelSum(torch.autograd.Function):
    """The all-reduce of a row-parallel output over the model group; its
    backward is the identity (every rank holds the same cotangent)."""

    @staticmethod
    def forward(ctx, x, transport: Transport):
        return transport.all_reduce(x, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ModelCopy(torch.autograd.Function):
    """The identity where a replicated activation enters rank-local work; its
    backward is the all-reduce of the ranks' parts of the cotangent."""

    @staticmethod
    def forward(ctx, x, transport: Transport):
        ctx.transport = transport
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.transport.all_reduce(g, "sum"), None


class _ModelGather(torch.autograd.Function):
    """The tiled all-gather of the ranks' slices along ``axis`` (model-index
    order); its backward reduce-scatters the ranks' parts of the cotangent
    (Megatron sequence parallelism's block input)."""

    @staticmethod
    def forward(ctx, x, axis: int, transport: Transport):
        ctx.axis, ctx.transport = axis, transport
        return transport.all_gather(x.movedim(axis, 0)).movedim(0, axis)

    @staticmethod
    def backward(ctx, g):
        part = ctx.transport.reduce_scatter(g.movedim(ctx.axis, 0))
        return part.movedim(0, ctx.axis), None, None


class _ModelScatterSum(torch.autograd.Function):
    """The reduce-scatter of the ranks' partial sums along ``axis``: rank t
    keeps block t of the sum; its backward all-gathers the blocks'
    cotangents (Megatron sequence parallelism's block output)."""

    @staticmethod
    def forward(ctx, x, axis: int, transport: Transport):
        ctx.axis, ctx.transport = axis, transport
        return transport.reduce_scatter(x.movedim(axis, 0)).movedim(0, axis)

    @staticmethod
    def backward(ctx, g):
        full = ctx.transport.all_gather(g.movedim(ctx.axis, 0))
        return full.movedim(0, ctx.axis), None, None


class _ModelSplit(torch.autograd.Function):
    """Rank t's block t of a replicated activation along ``axis``; its
    backward all-gathers the blocks' cotangents."""

    @staticmethod
    def forward(ctx, x, axis: int, transport: Transport):
        ctx.axis, ctx.transport = axis, transport
        n = x.shape[axis] // transport.size
        return x.narrow(axis, transport.rank * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        full = ctx.transport.all_gather(g.movedim(ctx.axis, 0))
        return full.movedim(0, ctx.axis), None, None


@dataclasses.dataclass(frozen=True)
class AxisCtx:
    """Named axes of one launch and their sizes (all 1 when unnamed).

    ``batch_axes``: data-parallel axes — one FL client per group.
    ``model_axis``: tensor-parallel axis (None = no TP).
    ``fsdp_axes``:  axes the reference fully shards parameters over (the
    batch axes).  ``sizes``: ``((axis name, size), ...)``.  ``client``: the
    data-parallel rank the code runs as.  ``transport``: the batch group's
    :class:`Transport` when each client is a process (then ``client`` is its
    rank in that group), None when the clients run in a loop or there is one
    client.  ``model_rank``: the model index the process runs as;
    ``model_transport``: the model group's :class:`Transport`, which a model
    axis larger than 1 requires (one process a model shard; its rank is
    ``model_rank``).
    """

    batch_axes: tuple[str, ...] = ()
    model_axis: str | None = None
    fsdp_axes: tuple[str, ...] = ()
    sizes: tuple[tuple[str, int], ...] = ()
    client: int = 0
    transport: Any = dataclasses.field(default=None, compare=False, repr=False)
    model_rank: int = 0
    model_transport: Any = dataclasses.field(default=None, compare=False, repr=False)

    def __post_init__(self):
        m = self.model_transport
        if self.tp > 1 and m is None:
            raise ValueError(one_process_tp_message(self.tp))
        if m is not None and (m.size != self.tp or m.rank != self.model_rank):
            raise ValueError(f"a model group of {m.size} ranks (this one {m.rank}) runs a "
                             f"model axis of {self.tp} as index {self.model_rank}")
        t = self.transport
        if t is not None and (t.size != self.dp or t.rank != self.client):
            raise ValueError(f"a group of {t.size} ranks (this one {t.rank}) runs "
                             f"{self.dp} clients as client {self.client}: want one rank a "
                             "client, rank r as client r")

    def _size(self, names) -> int:
        d = dict(self.sizes)
        n = 1
        for a in names:
            n *= int(d.get(a, 1))
        return n

    # --- static sizes ----------------------------------------------------
    @property
    def dp(self) -> int:
        """Number of data-parallel groups (= FL clients)."""
        return self._size(self.batch_axes)

    @property
    def tp(self) -> int:
        return self._size((self.model_axis,) if self.model_axis else ())

    @property
    def fsdp(self) -> int:
        return self._size(self.fsdp_axes)

    # --- indices ---------------------------------------------------------
    def dp_index(self) -> int:
        """Flattened data-parallel rank (client id): the process's rank
        under a group, the loop's client without one."""
        return self.client

    def tp_index(self) -> int:
        """The model index (tensor-parallel rank); 0 without a model group."""
        return self.model_rank

    @property
    def rank(self) -> int:
        """The process's rank in the mesh's group: ``dp_index * tp +
        tp_index`` (0 when the process runs the whole mesh)."""
        if self.transport is None and self.model_transport is None:
            return 0
        return self.client * self.tp + self.model_rank

    def at_client(self, c: int) -> "AxisCtx":
        """The same axes, running as client ``c`` (under a group, only the
        rank's own)."""
        if not 0 <= c < self.dp:
            raise ValueError(f"client {c} out of range for {self.dp} clients")
        if self.transport is not None and c != self.client:
            raise ValueError(f"rank {self.client} cannot run as client {c}")
        return dataclasses.replace(self, client=int(c))

    # --- model-axis collectives (identities without a model group) -------
    def psum_model(self, x):
        """Sum over the model axis's ranks (backward: the identity)."""
        return x if self.model_transport is None else _ModelSum.apply(x, self.model_transport)

    def copy_model(self, x):
        """The identity where a replicated ``x`` enters rank-local work
        (backward: the sum of the ranks' parts of the cotangent)."""
        return x if self.model_transport is None else _ModelCopy.apply(x, self.model_transport)

    def pmax_model(self, x):
        """Max over the model axis's ranks."""
        return x if self.model_transport is None else self.model_transport.all_reduce(x, "max")

    def pmin_model(self, x):
        """Min over the model axis's ranks."""
        return x if self.model_transport is None else self.model_transport.all_reduce(x, "min")

    def all_gather_model(self, x, *, axis: int):
        """Tiled all-gather over the model axis along ``axis``: the ranks'
        ``x`` concatenated there in model-index order (backward: the
        reduce-scatter of the ranks' cotangents)."""
        if self.model_transport is None:
            return x
        return _ModelGather.apply(x, axis, self.model_transport)

    def psum_scatter_model(self, x, *, axis: int):
        """Reduce-scatter over the model axis along ``axis``: rank t's block
        t of the ranks' sum (backward: the all-gather of the blocks'
        cotangents)."""
        if self.model_transport is None:
            return x
        if x.shape[axis] % self.tp:
            raise ValueError(f"psum_scatter_model: dim {axis} of {tuple(x.shape)} does not "
                             f"divide over {self.tp} model ranks")
        return _ModelScatterSum.apply(x, axis, self.model_transport)

    def split_model(self, x, *, axis: int):
        """Rank t's block t of a replicated ``x`` along ``axis`` (backward:
        the all-gather of the blocks' cotangents)."""
        if self.model_transport is None:
            return x
        if x.shape[axis] % self.tp:
            raise ValueError(f"split_model: dim {axis} of {tuple(x.shape)} does not divide "
                             f"over {self.tp} model ranks")
        return _ModelSplit.apply(x, axis, self.model_transport)

    # --- batch/FSDP collectives (identities without a group) -------------
    def psum_batch(self, x):
        """Sum over the batch axes' ranks."""
        return x if self.transport is None else self.transport.all_reduce(x, "sum")

    def pmean_batch(self, x):
        """Mean over the ranks: the sum times ``fl32(1 / dp)``, as XLA runs
        the reference's ``pmean``."""
        if self.transport is None:
            return x
        return self.transport.all_reduce(x, "sum") * f32_reciprocal(self.dp)

    def pmax_batch(self, x):
        """Max over the batch axes' ranks."""
        return x if self.transport is None else self.transport.all_reduce(x, "max")

    def gather_fsdp(self, x, *, axis: int):
        """Tiled all-gather of FSDP-sharded storage along ``axis`` (rank
        order); under autograd its transpose is the reduce-scatter."""
        if self.transport is None or self.fsdp == 1:
            return x
        return _FSDPGather.apply(x, axis, self.transport)


def one_process_tp_message(tp: int, spec: str | None = None) -> str:
    """The error of a model axis larger than 1 without a model group."""
    what = f"mesh {spec!r}" if spec else f"a model axis of size {tp}"
    return (f"{what}: a model axis larger than 1 runs one process a model shard; launch "
            f"D*{tp} ranks under torchrun (python -m torch.distributed.run) with --mesh "
            f"Dx{tp}, and the mesh's axis context joins their process group")


def code_bound(bits: int) -> int:
    """Largest |code| a ``bits``-wide SR quantizer can emit: ``2^bits - 1``.

    The exactness contract of the SR-quantized gradient all-reduce: codes are
    clipped to ``±code_bound(bits)``, and ``n_clients * code_bound(bits)``
    must fit the accumulator (:func:`wire_dtype`).
    """
    return 2 ** int(bits) - 1


def wire_dtype(bits: int, n_clients: int):
    """Narrowest signed integer dtype whose sum of ``n_clients`` codes is exact.

    Per-client codes lie in ``[-code_bound(bits), code_bound(bits)]``; the
    all-reduce accumulator must hold ``n * code_bound(bits)``.  Returns a
    numpy dtype class (``np.int8`` / ``np.int16`` / ``np.int32``).
    """
    need = n_clients * code_bound(bits)
    for dt in (np.int8, np.int16, np.int32):
        if need <= np.iinfo(dt).max:
            return dt
    raise ValueError(
        f"comm bits={bits} with {n_clients} clients needs an accumulator "
        f"holding {need} > int32 max; lower the bit-width (<= 16 is always "
        "safe below 32768 clients) or use 32 (uncompressed)")


def envelope_wire_dtype(bits_options, n_clients: int):
    """Widest accumulator any bit-width in an adaptive program's comm
    envelope needs, or ``None`` when the whole envelope is uncompressed.

    Calls :func:`wire_dtype` on every compressed member, so it raises if any
    round the program can emit would overflow the int32 accumulator.
    """
    compressed = [b for b in sorted({int(b) for b in bits_options})
                  if b < FULL_PRECISION_BITS]
    if not compressed:
        return None
    dts = [wire_dtype(b, n_clients) for b in compressed]
    return max(dts, key=lambda d: np.dtype(d).itemsize)


_TORCH_INT = {np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
              np.dtype(np.int32): torch.int32}


def _check_nonfinite_mode(on_nonfinite: str) -> None:
    if on_nonfinite not in ("raise", "saturate"):
        raise ValueError(f"on_nonfinite must be 'raise' or 'saturate', "
                         f"got {on_nonfinite!r}")


def _raise_nonfinite(bad: int | None) -> None:
    if bad:
        raise FloatingPointError(
            f"quantized_psum_batch: {bad} non-finite gradient "
            "values reached the wire quantizer (pass "
            "on_nonfinite='saturate' to clamp instead)")


def _nonfinite_guard(gfs: list, on_nonfinite: str) -> list:
    """Keep NaN/Inf gradients out of the wire quantizer.

    ``gfs`` are f32 leaves stacked over the clients.  A non-finite value
    would poison the shared scale and every client's codes.  ``"raise"``
    counts them over all leaves and raises ``FloatingPointError``;
    ``"saturate"`` maps NaN to 0 and clamps ±Inf to each client's largest
    finite magnitude in that leaf.
    """
    _check_nonfinite_mode(on_nonfinite)
    if on_nonfinite == "raise":
        reads = [count.host_read((~torch.isfinite(g)).sum(), "the wire's non-finite count")
                 for g in gfs]
        _raise_nonfinite(sum(r or 0 for r in reads))
        return gfs
    return [saturate_nonfinite(g) for g in gfs]


def quantized_psum_batch(axes: AxisCtx, grad, u, bits, *,
                         on_nonfinite: str = "raise", key: int | None = None):
    """SR-quantized all-reduce **mean** over the ``axes.dp`` clients.

    ``grad`` is one leaf stacked over the clients, ``(D, *shape)``, or a
    list of such leaves.  The SR draws are either ``u``, uniforms of the
    same shapes (client ``c``'s draws for each leaf), or, with ``u=None``,
    drawn inside K2 from the 64-bit ``key`` (:func:`ops.sr_pack_keyed
    <repro_torch.kernels.ops.sr_pack_keyed>`); with the key a leaf may also
    be a sequence of the D clients' gradients, read where they lie (nothing
    is stacked or concatenated).  Returns the mean of each leaf,
    ``shape``-sized, in the same structure:

    1. shared grid per leaf: ``s = max_c max|g_c|`` (1 where 0), pitch
       ``step = s / (2^bits - 1)``;
    2. every (client, leaf) segment rounded onto integer codes in ONE K2
       call, in :func:`wire_dtype` (int8/int16/int32);
    3. the codes summed exactly over the clients;
    4. ``(total * step) / D``.

    ``bits >= 32`` is the exact mean; one client is the identity.
    Under a process group (``axes.transport``) each rank passes its own
    client's gradients (one row a leaf, one uniform row) and gets the mean
    over the ranks: the one-process result, the codes bit for bit.
    ``on_nonfinite`` guards against NaN/Inf (see :func:`_nonfinite_guard`);
    the keyed path applies the guard inside K2 and, in ``"raise"`` mode,
    reads the device's non-finite count once.  A traced step records the
    collectives the reference's device issues for each leaf (the count's
    ``psum`` in ``"raise"`` mode, the scale's ``pmax``, and after K2 the
    codes' ``psum`` with the codes as its operand; a ``pmean`` at full
    precision), and counts the one K2 call at ``1 / D`` per device: each
    device of the reference packs its own client.
    """
    single = isinstance(grad, torch.Tensor)
    grads = [grad] if single else list(grad)
    n = axes.dp
    rows = 1 if axes.transport is not None else n      # a rank holds its own client's
    if (u is None) == (key is None):
        raise ValueError("quantized_psum_batch: pass exactly one of the uniforms u and a key")
    if u is None:
        grads = [list(g) for g in grads]       # a stacked leaf's rows are views
        for g in grads:
            if len(g) != rows or any(x.shape != g[0].shape for x in g):
                raise ValueError(f"quantized_psum_batch: leaves of {rows} client gradients "
                                 f"of one shape; got {[tuple(x.shape) for x in g]}")
    else:
        us = [u] if single else list(u)
        if len(us) != len(grads):
            raise ValueError("quantized_psum_batch: one uniform tensor per leaf")
        for g, uu in zip(grads, us):
            if g.shape[0] != rows or uu.shape != g.shape:
                raise ValueError(f"quantized_psum_batch: leaves ({rows}, ...) with uniforms "
                                 f"of their shape; got {tuple(g.shape)} and {tuple(uu.shape)}")
    if axes.transport is not None and n > 1:
        if int(bits) >= FULL_PRECISION_BITS:
            out = [axes.pmean_batch(g[0]) for g in grads]   # full precision: exact mean
        elif u is None:
            out = _quantized_mean_ranks(axes, grads, int(bits), on_nonfinite, int(key))
        else:
            out = _quantized_mean_ranks_given(axes, grads, us, int(bits), on_nonfinite)
        return out[0] if single else out
    if count.active() is not None and n > 1:
        _record_wire([g[0] for g in grads], int(bits), n, on_nonfinite)
    if n == 1:
        out = [g[0] for g in grads]             # single client: nothing to reduce
    elif int(bits) >= FULL_PRECISION_BITS:
        out = []
        for g in grads:                         # full precision: exact mean
            total = g[0]
            for c in range(1, n):
                total = total + g[c]
            out.append(total * f32_reciprocal(n))
    elif u is None:
        out = _quantized_mean_keyed(grads, int(bits), n, on_nonfinite, int(key))
    else:
        out = _quantized_mean(grads, us, int(bits), n, on_nonfinite)
    return out[0] if single else out


def _record_wire(leaves, bits: int, n: int, on_nonfinite: str) -> None:
    """The collectives the reference's device issues for each wire leaf
    (``leaves``: client 0's gradient of each) before its codes exist: the
    ``pmean`` at full precision, else the non-finite count's ``psum`` (in
    ``"raise"`` mode) and the scale's ``pmax``.  The codes' ``psum`` is
    recorded after K2 has made them (:func:`_record_codes`)."""
    name = "quantized_psum_batch"
    for g in leaves:
        if bits >= FULL_PRECISION_BITS:
            count.record_collective("all-reduce", g.dtype, g.numel(), n, f"{name} pmean",
                                    operand=g)
            continue
        if on_nonfinite == "raise":
            count.record_collective("all-reduce", torch.int32, 1, n,
                                    f"{name} non-finite count", operand=_device_count(g))
        count.record_collective("all-reduce", torch.float32, 1, n, f"{name} scale pmax")


def _device_count(g: torch.Tensor):
    """One device's non-finite count of its leaf, the operand of the
    reference's count ``psum``.  The port's keyed K2 counts inside the
    kernel, so this is computed only for a traced step's graph, outside its
    live bytes (None otherwise)."""
    if not count.graph_active():
        return None
    with count.untracked():
        return (~torch.isfinite(g)).sum(dtype=torch.int32)


def _record_codes(codes: torch.Tensor, sizes, n: int) -> None:
    """The codes' ``psum`` of each wire leaf (``sizes`` its elements), in
    the wire dtype K2 wrote, with K2's codes as its operand."""
    if count.active() is None:
        return
    for elems in sizes:
        count.record_collective("all-reduce", codes.dtype, elems, n,
                                "quantized_psum_batch codes", operand=codes)


def _dequantized_means(codes, step, sizes, shapes, dtypes, n: int) -> list:
    # the integer sum is exact: wire_dtype holds n * lim
    total = codes.sum(dim=0, dtype=torch.int64).to(torch.float32)
    inv_n = f32_reciprocal(n)
    return [((chunk * step[i]) * inv_n).reshape(shape).to(dtype)
            for i, (chunk, shape, dtype) in enumerate(zip(total.split(sizes), shapes, dtypes))]


def _quantized_mean(grads, us, bits: int, n: int, on_nonfinite: str) -> list:
    if not grads:
        return []
    dev = grads[0].device
    gfs = _nonfinite_guard([g.to(torch.float32) for g in grads], on_nonfinite)
    s = torch.stack([g.abs().amax() for g in gfs])
    s = torch.where(s > 0, s, torch.ones_like(s))
    lim = code_bound(bits)
    step = s * f32_reciprocal(lim)
    sizes = [g[0].numel() for g in gfs]
    offsets = torch.tensor([0, *np.cumsum(sizes)], dtype=torch.int32, device=dev)
    flat = torch.cat([g.reshape(n, -1) for g in gfs], dim=1)
    uflat = torch.cat([uu.to(torch.float32).reshape(n, -1) for uu in us], dim=1)
    with count.share(1 / n):
        codes = ops.sr_pack_segments(flat, offsets, step, uflat, lim,
                                     _TORCH_INT[np.dtype(wire_dtype(bits, n))])
    _record_codes(codes, sizes, n)
    return _dequantized_means(codes, step, sizes, [g.shape[1:] for g in grads],
                              [g.dtype for g in grads], n)


def _quantized_mean_keyed(grads, bits: int, n: int, on_nonfinite: str, key: int) -> list:
    """The keyed wire: ``grads`` per leaf the D clients' gradients; one K2
    call guards, scales, draws and packs; in ``"raise"`` mode the one host
    read of a step is the non-finite count, after everything is queued."""
    _check_nonfinite_mode(on_nonfinite)
    if not grads:
        return []
    lim = code_bound(bits)
    with count.share(1 / n):
        codes, step, bad = ops.sr_pack_keyed(grads, key, lim,
                                             _TORCH_INT[np.dtype(wire_dtype(bits, n))])
    _record_codes(codes, [g[0].numel() for g in grads], n)
    out = _dequantized_means(codes, step, [g[0].numel() for g in grads],
                             [g[0].shape for g in grads], [g[0].dtype for g in grads], n)
    if on_nonfinite == "raise":
        _raise_nonfinite(count.host_read(bad, "the wire's non-finite count"))
    return out


# ---------------------------------------------------------------------------
# The wire across ranks: one client a process
# ---------------------------------------------------------------------------

_WIDENED_LOGGED = [False]


def _psum_codes(axes: AxisCtx, codes: torch.Tensor) -> torch.Tensor:
    """The codes' exact sum over the ranks.  int16 codes are widened to
    int32 for the all-reduce: neither gloo nor NCCL sums int16 (ROADMAP §3,
    D12), so the wire moves twice the reference's s16 bytes."""
    if codes.dtype == torch.int16:
        if not _WIDENED_LOGGED[0]:
            _WIDENED_LOGGED[0] = True
            log.info("quantized_psum_batch: int16 codes widened to int32 for the all-reduce: "
                     "%d bytes a call where the reference's s16 wire moves %d",
                     codes.numel() * 4, codes.numel() * 2)
        codes = codes.to(torch.int32)
    return axes.psum_batch(codes)


def _quantized_mean_ranks(axes: AxisCtx, grads, bits: int, on_nonfinite: str,
                          key: int) -> list:
    """The keyed wire across ranks, in the reference's order: K2's pass 1 on
    the rank's row, the non-finite count's sum ("raise"), the scales' max,
    pass 2 drawing stream ``rank`` (the loop's row ``rank``), the codes'
    sum.  Every rank issues the same collectives whatever its data, and in
    "raise" mode every rank reads the same summed count once, after the
    codes' sum, and raises together."""
    _check_nonfinite_mode(on_nonfinite)
    if not grads:
        return []
    n = axes.dp
    lim = code_bound(bits)
    fmax, bad = ops.sr_pack_keyed_scales(grads)
    if on_nonfinite == "raise":
        bad = axes.psum_batch(bad)
    smax = axes.pmax_batch(fmax[0])
    codes, step = ops.sr_pack_keyed_scaled(grads, smax, fmax, key, lim,
                                           _TORCH_INT[np.dtype(wire_dtype(bits, n))],
                                           c0=axes.dp_index())
    total = _psum_codes(axes, codes)
    out = _dequantized_means(total, step, [g[0].numel() for g in grads],
                             [g[0].shape for g in grads], [g[0].dtype for g in grads], n)
    if on_nonfinite == "raise":
        _raise_nonfinite(count.host_read(bad, "the wire's non-finite count"))
    return out


def _quantized_mean_ranks_given(axes: AxisCtx, grads, us, bits: int,
                                on_nonfinite: str) -> list:
    """The u-taking wire across ranks (``grads``/``us`` the rank's row of
    each leaf): the guard (the count summed over the ranks and read before
    any scale is made, so every rank raises together), the scales' max, K2's
    u-taking entry on the rank's row, the codes' sum."""
    _check_nonfinite_mode(on_nonfinite)
    if not grads:
        return []
    n = axes.dp
    dev = grads[0].device
    gfs = [g.to(torch.float32) for g in grads]
    if on_nonfinite == "raise":
        bad = sum(((~torch.isfinite(g)).sum() for g in gfs),
                  torch.zeros((), dtype=torch.int64, device=dev))
        _raise_nonfinite(count.host_read(axes.psum_batch(bad), "the wire's non-finite count"))
    else:
        gfs = [saturate_nonfinite(g) for g in gfs]
    s = axes.pmax_batch(torch.stack([g.abs().amax() for g in gfs]))
    s = torch.where(s > 0, s, torch.ones_like(s))
    lim = code_bound(bits)
    step = s * f32_reciprocal(lim)
    sizes = [g[0].numel() for g in gfs]
    offsets = torch.tensor([0, *np.cumsum(sizes)], dtype=torch.int32, device=dev)
    flat = torch.cat([g.reshape(1, -1) for g in gfs], dim=1)
    uflat = torch.cat([uu.to(torch.float32).reshape(1, -1) for uu in us], dim=1)
    codes = ops.sr_pack_segments(flat, offsets, step, uflat, lim,
                                 _TORCH_INT[np.dtype(wire_dtype(bits, n))])
    return _dequantized_means(_psum_codes(axes, codes), step, sizes,
                              [g.shape[1:] for g in grads], [g.dtype for g in grads], n)
