"""Shared machinery for the model code: packed weights and the parameter funnel.

* :class:`QTensor` — packed int8/int16 codes + scale, the quantized storage
  the serving path reads (1/4 the bytes of f32).
* :class:`ParamCtx` — every weight is *used* through ``pc.use(path, w)``,
  which applies the active weight transform (identity, or dequantization of
  packed codes) and casts to the compute dtype.  Under a lazy policy a packed
  weight passes through as its :class:`QTensor`, and the projection call
  sites dispatch on the leaf type (:func:`repro_torch.kernels.ops.dense_dispatch`).

Parameters are a flat dict keyed by the reference's path strings
(``"embed/table"``, ``"blocks/attn/wq"``, ...); leaves under ``blocks/`` keep
their leading ``(L, ...)`` layer dim, as the reference's scanned stacks do.
In one process the port holds every leaf whole (a traced device its model
slice of each), so the FSDP gathers of the reference are identities (a
traced step records each one the reference issues, at the slice's size over
the batch axes, :mod:`repro_torch.roofline.count`).  Under a process group
(one client a rank) each rank holds its FSDP shard of every FSDP leaf
(:func:`apply_fsdp_sharding`) and the whole of every replicated leaf, and
:meth:`ParamCtx.use` all-gathers a shard at each use; the gather's backward
is the reduce-scatter that returns the FSDP gradients summed and sharded.
On a model axis of T > 1 ranks each holds its tensor-parallel slice of the
whole model (:func:`sharded_init` with a model cut), then its FSDP slice of
that.  Which leaves the reference shards decides how a train step reduces their
gradients (:func:`fsdp_plan`): the sharded ones are mean-reduced in f32, the
replicated ones cross the SR wire.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.quantization import _flatten_with_paths
from repro_torch.dist.collectives import AxisCtx, f32_reciprocal
from repro_torch.roofline import count

Transform = Callable[[str, torch.Tensor], torch.Tensor]


@dataclasses.dataclass
class QTensor:
    """Quantized parameter storage: ``w ~= codes * scale`` (scale folds delta)."""

    codes: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.codes.shape

    @property
    def ndim(self):
        return self.codes.ndim

    @property
    def dtype(self):
        return self.codes.dtype

    def __getitem__(self, i):
        """Layer ``i`` of a stacked leaf (per-layer scales slice with it)."""
        return QTensor(self.codes[i], self.scale[i] if self.scale.ndim else self.scale)

    def nbytes(self) -> int:
        return (self.codes.numel() * self.codes.element_size()
                + self.scale.numel() * self.scale.element_size())


def dequant(q: QTensor, dtype) -> torch.Tensor:
    return q.codes.to(torch.float32).to(dtype) * q.scale.to(dtype)


#: Stack prefixes: leaves under these carry a leading layer dim.
STACK_PREFIXES = ("blocks/", "periods/", "encoder/", "decoder/")


def is_stacked(path: str) -> bool:
    return any(p in path for p in STACK_PREFIXES)


def leaf_bytes(w) -> int:
    return w.nbytes() if isinstance(w, QTensor) else w.numel() * w.element_size()


def _put(node: dict, path: str, w) -> None:
    *parents, leaf = path.split("/")
    for p in parents:
        node = node.setdefault(p, {})
    node[leaf] = w


def layer_params(params: dict, layer: int, prefix: str = "blocks/") -> dict:
    """Layer ``layer``'s slice of the leaves under ``prefix`` as the
    reference's nested per-layer tree (``{"attn": {"wq": ...}, "ln1": ...}``;
    a hybrid's ``periods/`` give ``{"sub0": {"mixer": ...}, ...}``)."""
    out: dict = {}
    for path, w in params.items():
        if path.startswith(prefix):
            _put(out, path[len(prefix):], w[layer])
    return out


def layer_cache(caches, layer: int):
    """Layer ``layer``'s slice of a layer-stacked cache (any NamedTuple of
    tensors with a leading ``(L,)``): views, so a write lands in the stack."""
    return type(caches)(*(t[layer] for t in caches))


def layer_views(params: dict, n_layers: int, prefix: str = "blocks/") -> list[dict]:
    """Every layer's nested tree of the leaves under ``prefix``, as views
    from ONE ``unbind`` per leaf (its backward stacks the layers' gradients
    once): the training forward's counterpart of :func:`layer_params`.  A
    packed :class:`QTensor` stack (an encoder run at serving) is sliced."""
    out = [{} for _ in range(n_layers)]
    for path, w in params.items():
        if path.startswith(prefix):
            per = [w[i] for i in range(n_layers)] if isinstance(w, QTensor) else w.unbind(0)
            for node, wi in zip(out, per):
                _put(node, path[len(prefix):], wi)
    return out


#: Minimum product of the NON-sharded dims for FSDP participation.
FSDP_MIN_OTHER = 256

#: Path fragments never FSDP-sharded.
FSDP_EXCLUDE = ("router", "conv_", "a_log", "dt_bias", "d_skip", "/ln", "norm",
                "gate_scalar")


def fsdp_shard_dim(path: str, ndim: int) -> int:
    """The reference's FSDP shard dim of a parameter (per-layer view, stack
    dim stripped): the second-to-last dim, but the last for embedding tables
    and the row-parallel ``w_down``."""
    if path.endswith("/table") or "w_down" in path:
        return ndim - 1
    return ndim - 2


def fsdp_participates(path: str, per_layer_shape: tuple, fsdp: int) -> bool:
    """Whether the reference FSDP-shards this leaf: ``fsdp > 1``, at least
    2-D per layer, not excluded, and its non-shard dims multiply to at least
    :data:`FSDP_MIN_OTHER`."""
    if fsdp <= 1 or len(per_layer_shape) < 2:
        return False
    if any(x in path for x in FSDP_EXCLUDE):
        return False
    dim = fsdp_shard_dim(path, len(per_layer_shape))
    other = 1
    for i, s in enumerate(per_layer_shape):
        if i != dim:
            other *= s
    return other >= FSDP_MIN_OTHER


#: ``(paths, leaves)`` of a parameter dict in the reference's flatten order
#: (dict keys sorted level by level, as JAX flattens a nested dict).
tree_paths_leaves = _flatten_with_paths


def fsdp_plan(params: dict, fsdp: int, *, check_divisibility: bool = True):
    """``(paths, leaves, plan)``: per leaf (in flatten order) its FSDP dim in
    stored coordinates, or None for a replicated leaf.

    ``check_divisibility`` holds only for unsharded shapes: it raises, as
    the reference does, where the shard dim does not divide by ``fsdp``."""
    paths, leaves = tree_paths_leaves(params)
    plan = []
    for path, leaf in zip(paths, leaves):
        arr = leaf.codes if isinstance(leaf, QTensor) else leaf
        stacked = is_stacked(path)
        eff_ndim = arr.ndim - 1 if stacked else arr.ndim
        shape = tuple(arr.shape[1:] if stacked else arr.shape)
        if not fsdp_participates(path, shape, fsdp):
            plan.append(None)
            continue
        dim = fsdp_shard_dim(path, eff_ndim) + (1 if stacked else 0)
        if check_divisibility and arr.shape[dim] % fsdp != 0:
            raise ValueError(
                f"FSDP-eligible param {path} shape {tuple(arr.shape)} not divisible by "
                f"fsdp={fsdp} on dim {dim}; adjust fsdp_shard_dim rule")
        plan.append(dim)
    return paths, leaves, plan


def sharded_init(init, ctx: AxisCtx, pack=None, cut=None) -> dict:
    """Rank ``ctx``'s storage of a model's init, each leaf cut to the rank's
    piece as soon as it is drawn.

    ``init(meta)`` runs the model's init: on the meta device when ``meta``
    (which draw is which leaf, at no cost), then for real from the
    caller's generator, whose draws are exactly the one-process init's.  A
    draw of :func:`init_dense` / :func:`init_embed` is cut to the rank's
    piece before the next draw, so a rank holds one whole leaf at a time; a
    leaf drawn another way is cut once the init returns.

    The piece of a whole leaf: ``pack(leaves) -> leaves`` (serving's
    :func:`pack_params_for_policy`) turns it into its storage first (the
    scale is the whole leaf's), then ``cut(path, w)`` keeps the rank's
    model-axis slice (:func:`repro_torch.dist.sharding.cut_model`; None:
    the model axis is 1), then the rank's FSDP slice of that, on
    :func:`fsdp_plan`'s dim of the cut shapes."""
    def tp(path, w):
        return w if cut is None else cut(path, w)

    def keep(path, w, dim):
        w = w if pack is None else pack({path: w})[path]
        return shard_leaf(tp(path, w), dim, ctx)
    drawn: list = []
    _INIT_HOOK[0] = lambda w: drawn.append(w) or w
    try:
        meta = init(True)
    finally:
        _INIT_HOOK[0] = None
    path_of = {id(w): p for p, w in meta.items()}
    paths, _leaves, plan = fsdp_plan({p: tp(p, w) for p, w in meta.items()}, ctx.fsdp)
    dims = dict(zip(paths, plan))
    order = [path_of.get(id(w)) for w in drawn]
    del drawn, meta
    done: set = set()
    at = iter(order)

    def hook(w):
        path = next(at)
        if path is not None and (cut is not None or dims[path] is not None):
            done.add(path)
            return keep(path, w, dims[path])
        return w

    _INIT_HOOK[0] = hook
    try:
        params = init(False)
    finally:
        _INIT_HOOK[0] = None
    out = {}
    for p in list(params):          # popped: a leaf is freed once kept
        w = params.pop(p)
        out[p] = w if p in done else keep(p, w, dims[p])
    return out


def apply_fsdp_sharding(params: dict, ctx: AxisCtx) -> dict:
    """Each FSDP leaf sliced to rank ``ctx.dp_index()``'s piece on
    :func:`fsdp_plan`'s dim (a copy, so the whole leaf can be freed); the
    replicated leaves as they are.  The reference's
    ``models/common.apply_fsdp_sharding``."""
    paths, _leaves, plan = fsdp_plan(params, ctx.fsdp)
    dims = dict(zip(paths, plan))
    return {path: shard_leaf(w, dims[path], ctx) for path, w in params.items()}


def shard_leaf(w, dim, ctx: AxisCtx):
    """Rank ``ctx.dp_index()``'s piece of a whole leaf ``w`` on ``dim`` (None:
    the leaf itself)."""
    if dim is None or ctx.fsdp == 1:
        return w
    if isinstance(w, QTensor):
        return QTensor(shard_leaf(w.codes, dim, ctx), w.scale)
    n = w.shape[dim] // ctx.fsdp
    return w.narrow(dim, ctx.dp_index() * n, n).clone()


def gather_leaf(w: torch.Tensor, dim, ctx: AxisCtx) -> torch.Tensor:
    """The whole leaf from the ranks' pieces ``w`` on ``dim`` (None: ``w``);
    every rank must call it (a collective)."""
    if dim is None or ctx.transport is None:
        return w
    return ctx.transport.all_gather(w.movedim(dim, 0)).movedim(0, dim).contiguous()


def _gather_bytes(codes: torch.Tensor, dim: int, ctx: AxisCtx) -> torch.Tensor:
    """An integer tensor gathered as a ``uint8`` view: a gather moves bytes,
    so it is exact for any element width (each element's bytes stay
    together along the last dim)."""
    moved = codes.movedim(dim, 0).contiguous()
    full = ctx.transport.all_gather(moved.view(torch.uint8))
    return full.view(codes.dtype).movedim(0, dim).contiguous()


def reduce_gradients(grad_sums: dict, ctx: AxisCtx) -> dict:
    """Server-side gradient mean (Algorithm 1 line 10) from the per-leaf sums
    over the ``ctx.dp`` clients.

    In the reference the FSDP leaves arrive reduce-scattered (summed) and are
    divided by ``dp``, and the replicated leaves are ``pmean``-ed; both are
    the f32 sum over the clients times ``fl32(1 / dp)`` as XLA runs them.  In
    one process ``grad_sums`` holds the sums over the clients' loop; under a
    group the FSDP leaves' gradients arrive summed (their gather's backward)
    and the replicated leaves hold the rank's own gradient, which is
    ``pmean_batch``-ed.  A traced step records each replicated leaf's
    ``pmean`` (an all-reduce over the batch axes; the FSDP leaves'
    reduce-scatter is their gather's transpose, recorded by
    :meth:`ParamCtx.use`).
    """
    tracing = count.active() is not None and ctx.batch_axes
    if tracing or ctx.transport is not None:
        paths, leaves, plan = fsdp_plan(grad_sums, ctx.fsdp, check_divisibility=False)
        replicated = {p for p, dim in zip(paths, plan) if dim is None}
        if tracing:
            for path, g in zip(paths, leaves):
                if path in replicated:
                    count.record_collective("all-reduce", g.dtype, g.numel(), ctx.dp,
                                            f"reduce_gradients pmean {path}")
        if ctx.transport is not None:
            return {p: (ctx.pmean_batch(g) if p in replicated else g * f32_reciprocal(ctx.dp))
                    for p, g in grad_sums.items()}
    return {p: g * f32_reciprocal(ctx.dp) for p, g in grad_sums.items()}


class _GatherRecord(torch.autograd.Function):
    """Identity whose backward records the reduce-scatter that is the FSDP
    all-gather's transpose in the reference (once a backward pass, so a
    rematerialized forward does not count it twice)."""

    @staticmethod
    def forward(ctx, w, group: int, name: str):
        ctx.group, ctx.name = group, name
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        count.record_collective("reduce-scatter", g.dtype, g.numel() // ctx.group, ctx.group,
                                ctx.name, operand=g)
        return g, None, None


@dataclasses.dataclass
class ParamCtx:
    """Threads the axis context + weight transform through model code.

    ``policy``: a :class:`repro_torch.api.precision.PrecisionPolicy`.  Its
    ``lazy`` flag selects the serving fast path: ``use()`` on a
    :class:`QTensor` returns the packed handle itself (NOT dequantized), so
    the ``quant_matmul`` kernel reads the int8 codes.
    """

    ctx: AxisCtx
    transform: Transform | None = None
    compute_dtype: Any = torch.bfloat16
    sp: bool = False
    policy: Any = None
    gather_dtype: Any = None

    @property
    def lazy(self) -> bool:
        return bool(getattr(self.policy, "lazy", False))

    @classmethod
    def from_policy(cls, ctx: AxisCtx, policy, *, transform=None,
                    compute_dtype=torch.bfloat16, sp: bool = False) -> "ParamCtx":
        """The policy-driven constructor every launcher goes through."""
        return cls(ctx=ctx, transform=transform, compute_dtype=compute_dtype,
                   sp=sp, policy=policy)

    def _gathered(self, path: str, w) -> bool:
        """Whether the reference all-gathers this leaf over FSDP at a use."""
        leaf = w.codes if isinstance(w, QTensor) else w
        return fsdp_participates(path, tuple(leaf.shape), self.ctx.fsdp)

    def use(self, path: str, w):
        """Transform + cast: the single funnel every weight goes through.

        Returns a dense tensor, or the packed :class:`QTensor` when
        ``policy.lazy`` is on — consumers dispatch on the leaf type.  As in
        the reference, ``gather_dtype`` casts an FSDP leaf before its gather:
        an all-gather of the rank's shard under a process group (packed
        codes as bytes; the backward of a dense leaf's gather is the
        reduce-scatter, in the gather's dtype), else an identity that a
        traced step records.
        """
        tracing = count.active() is not None
        ranks = self.ctx.transport is not None
        gather = (tracing or ranks or self.gather_dtype is not None) and self._gathered(path, w)
        if isinstance(w, QTensor):
            if gather and tracing:
                count.record_collective("all-gather", w.codes.dtype, w.codes.numel(),
                                        self.ctx.fsdp, f"ParamCtx.use {path}", operand=w.codes)
            elif gather and ranks:
                w = QTensor(_gather_bytes(w.codes, fsdp_shard_dim(path, w.codes.ndim),
                                          self.ctx), w.scale)
            if self.lazy and self.transform is None:
                return w
            full = w.codes.to(torch.float32) * w.scale.to(torch.float32)
        else:
            full = w
            if gather and self.gather_dtype is not None:
                full = full.to(self.gather_dtype)
            if gather and ranks and not tracing:
                full = self.ctx.gather_fsdp(full, axis=fsdp_shard_dim(path, full.ndim))
            if gather and tracing:
                count.record_collective("all-gather", full.dtype, full.numel(),
                                        self.ctx.fsdp, f"ParamCtx.use {path}", operand=full)
                if full.requires_grad:
                    full = _GatherRecord.apply(full, self.ctx.fsdp,
                                               f"ParamCtx.use {path} (transpose)")
        if self.transform is not None:
            full = self.transform(path, full)
        return full.to(self.compute_dtype)

    def use_small(self, path: str, w) -> torch.Tensor:
        """Replicated small parameters (norm scales, biases)."""
        if self.transform is not None:
            w = self.transform(path, w)
        return w.to(self.compute_dtype)


# ---------------------------------------------------------------------------
# Initialization (explicit device and generator for every draw)
# ---------------------------------------------------------------------------


#: What :func:`sharded_init` applies to each draw of :func:`init_dense` and
#: :func:`init_embed` (None: the draw as it is).
_INIT_HOOK: list = [None]


def _drawn(w: torch.Tensor) -> torch.Tensor:
    hook = _INIT_HOOK[0]
    return w if hook is None else hook(w)


def init_dense(gen: torch.Generator, d_in: int, d_out: int, *, lead=(),
               device=None, dtype=torch.float32, scale: float | None = None):
    """Truncated-normal fan-in init (LeCun); ``lead`` prepends stack dims."""
    std = scale if scale is not None else (1.0 / d_in) ** 0.5
    w = torch.empty(tuple(lead) + (d_in, d_out), device=device, dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=gen)
    return _drawn(w.mul_(std).to(dtype))


def init_embed(gen: torch.Generator, vocab: int, d: int, *, device=None,
               dtype=torch.float32):
    w = torch.empty((vocab, d), device=device, dtype=torch.float32)
    return _drawn(w.normal_(0.0, 1.0, generator=gen).mul_(0.02).to(dtype))


# ---------------------------------------------------------------------------
# Serving-path packing
# ---------------------------------------------------------------------------


def pack_params_for_policy(params: dict, policy, *, exempt=None) -> dict:
    """Pack a param dict per a :class:`~repro_torch.api.precision.PrecisionPolicy`.

    Identity at 32-bit weights; otherwise int8/int16 :class:`QTensor` codes at
    ``policy.serve_bits``, packed one leaf at a time and popped from
    ``params`` as it goes: each f32 leaf is dropped once its codes exist, so
    the card never holds a second copy of the f32 tree beside the codes
    (full olmoe-1b-7b draws 27.6 GB of f32, 8.6 GB in each expert stack).
    """
    if not policy.packed:
        return params
    if exempt is None:
        from repro_torch.core.quantization import default_exempt as exempt
    out = {}
    for path in list(params):
        out.update(pack_params_for_serving({path: params.pop(path)}, policy.serve_bits,
                                           exempt=exempt))
    return out


def pack_params_for_serving(params: dict, bits: int, *, exempt) -> dict:
    """Convert matmul weights to :class:`QTensor` int8/int16 storage.

    Deterministic nearest rounding (half to even, as ``jnp.round``), the
    reference's arithmetic step for step: f32 division by the broadcast scale,
    a per-layer ``(L,)`` scale for stacked leaves and a scalar otherwise.
    Stacked leaves are packed one layer at a time, so the temporaries stay one
    layer large; the rounding and the clamp run in place on the quotient, so
    a leaf's packing holds one f32 temporary beside it (a rank drawing a
    4.2 GB embedding whole needs 4.2 GB more, not 8.4).
    """
    from repro_torch.core.quantization import storage_dtype

    delta = 1.0 / (2.0**bits - 1.0)
    lim = 2**bits - 1
    out = {}
    for path, leaf in params.items():
        if exempt is not None and exempt(path, leaf):
            out[path] = leaf
            continue
        if is_stacked(path) and leaf.ndim >= 2:
            # per-layer scales so stacks slice cleanly (and tighter)
            codes = torch.empty(leaf.shape, dtype=storage_dtype(bits), device=leaf.device)
            scales = []
            for i in range(leaf.shape[0]):
                wf = leaf[i].to(torch.float32)
                s = torch.clamp(wf.abs().max(), min=1e-12)
                scale = (s * delta).to(torch.float32)
                codes[i] = (wf / scale).round_().clamp_(-lim, lim).to(codes.dtype)
                scales.append(scale)
            out[path] = QTensor(codes=codes, scale=torch.stack(scales))   # (L,)
        else:
            wf = leaf.to(torch.float32)
            s = torch.clamp(wf.abs().max(), min=1e-12)
            scale = (s * delta).to(torch.float32)                         # ()
            codes = (wf / scale).round_().clamp_(-lim, lim).to(storage_dtype(bits))
            out[path] = QTensor(codes=codes, scale=scale)
    return out
