"""Sharding-rule table: the parameter, batch and cache layouts of a launch.

Counterpart of ``repro/dist/sharding.py``.  The port has no
``PartitionSpec``: a spec is a plain tuple with one entry a dim, each entry
``None`` (replicated), an axis name, or a tuple of axis names (major to
minor) — the reference's ``P(...)`` as ``tuple(spec)``.  The model zoo's
``model.init(gen, tp)`` gives **local-TP** shapes; a rank's storage is the
whole ``tp = 1`` init cut to its model shard (:func:`cut_model` on
:func:`tree_param_specs` with the launch's ``kv``), then FSDP-sliced
(:func:`repro_torch.models.common.sharded_init`).  This module turns a
parameter's path into the global layout those steps imply, the layout the
checkpoint gathers from and that sharded serving reads, and cuts a tree
into the shards of its batch (:func:`cut_batch`) or its model axis
(:func:`cut_model`) and joins them back.

Rules are keyed on the leaf name (the path's last segment), the Megatron
conventions the layers implement:

=============  ====================================  =================
leaf           storage (per layer)                   TP-sharded dim
=============  ====================================  =================
``wq``         (d_model, heads_local*hd)             1 (column)
``wk``/``wv``  (d_model, kv_local*hd)                1 iff KV sharded
``wo``         (heads_local*hd | d_inner_l, d)       0 (row)
``w_up/gate``  mlp (d, d_ff/tp) / moe (e/tp, d, f)   1 / 0 (experts)
``w_down``     mlp (d_ff/tp, d) / moe (e/tp, f, d)   0 / 0 (experts)
``embed/table``(vocab/tp, d)                         0 (vocab rows)
``unembed/w``  (d, vocab/tp)                         1 (vocab cols)
``wx/wz/w_dt`` (d, d_inner_l | heads_l)              1 (column)
``conv_x``     (W, d_inner_l)                        1
``norm``       SSD gated norm (d_inner_l,)           0
``a_log`` ...  per-head scalars (heads_l,)           0
``ln*``, router, adapter, gates                      replicated
=============  ====================================  =================

FSDP placement reuses :func:`repro_torch.models.common.fsdp_participates`
and ``fsdp_shard_dim``, the predicate the storage's slicing uses, so spec
and storage cannot disagree.  A dim carrying both TP and FSDP gets the tuple
``(model, *fsdp_axes)``.  As in the reference, a named model axis appears in
a spec even at size 1.
"""

from __future__ import annotations

import torch

from repro_torch.dist.collectives import AxisCtx

#: leaf-name -> per-layer TP dim for 2-D projections (None = replicated).
_TP_2D = {
    "wq": 1, "wo": 0,
    "w_up": 1, "w_gate": 1, "w_down": 0,
    "wx": 1, "wz": 1, "w_dt": 1,
    "conv_x": 1,
    "table": 0, "w": 1,
}

#: leaf names sharded over the expert dim when 3-D (MoE expert stacks).
_TP_EXPERT = ("w_up", "w_gate", "w_down")

#: 1-D per-head/per-channel leaves that are TP-local.
_TP_1D = ("norm", "a_log", "dt_bias", "d_skip")


def _basename(path: str) -> str:
    return path.rsplit("/", 1)[-1]


def tp_dim(path: str, ndim: int, kv: bool = True) -> int | None:
    """Tensor-parallel sharded dim of a parameter, in per-layer coordinates
    (any stack dim stripped), or None if replicated.  ``kv``: whether KV
    heads are sharded on this launch; when False ``wk``/``wv`` replicate."""
    base = _basename(path)
    if base in ("wk", "wv"):
        return 1 if kv else None
    if ndim == 3 and base in _TP_EXPERT:
        return 0                       # MoE expert stacks: shard experts
    if ndim == 1:
        return 0 if base in _TP_1D else None
    return _TP_2D.get(base)


#: leaves replicated over the model axis that a block uses inside its
#: rank-local region (between its input gather and its output sum): the
#: MoE router (its gates weight the rank's own experts), the SSM's B/C
#: projection and conv, replicated KV projections (the rank's q heads read
#: their KV heads)
_RANK_LOCAL_REPLICATED = ("router", "w_bc", "conv_bc", "wk", "wv")


def grad_summed_over_model(path: str, cfg, sp: bool) -> bool:
    """Whether each model rank's gradient of ``path``, a leaf replicated
    over the model axis, is only its part of the whole, to be summed over
    the model group after the backward pass.

    True for a leaf used inside the rank-local region
    (:data:`_RANK_LOCAL_REPLICATED`, and the VLM's adapter, whose image
    memory enters every cross layer's rank-local K/V), and under sequence
    parallelism for every other one (norm scales, the VLM's tanh gates: the
    rank applies them to its own positions); False for those without it (a
    replicated activation, a whole cotangent) and for the enc-dec's adapter,
    applied to the whole source before the encoder's input is cut
    (:func:`repro_torch.models.layers.sp_split`: its cotangent comes back
    whole).  Summing a whole gradient would give T times it."""
    base = _basename(path)
    if base in _RANK_LOCAL_REPLICATED:
        return True
    if path == "adapter":
        return cfg.family == "vlm"
    return bool(sp)


def model_summed_leaves(params: dict, cfg, axes: AxisCtx, sp: bool) -> list:
    """The paths of ``params`` (a rank's storage) whose gradients are summed
    over the model group (:func:`grad_summed_over_model`), in flatten
    order; none at ``tp = 1``."""
    if axes.tp == 1:
        return []
    from repro_torch.models.common import is_stacked, tree_paths_leaves
    from repro_torch.models.transformer import attn_dims

    kv = attn_dims(cfg, axes.tp).kv_sharded if cfg.n_kv_heads else True
    paths, _leaves = tree_paths_leaves(params)
    out = []
    for path in paths:
        nd = params[path].ndim - (1 if is_stacked(path) and params[path].ndim else 0)
        if tp_dim(path, nd, kv) is None and grad_summed_over_model(path, cfg, sp):
            out.append(path)
    return out


def _kv_sharded(path: str, per_layer_shape: tuple, cfg) -> bool:
    """Whether KV heads were sharded at init, from the storage: a
    replicated KV projection stores the full ``n_kv * head_dim`` outputs."""
    if _basename(path) not in ("wk", "wv") or not cfg.n_kv_heads:
        return True
    return per_layer_shape[-1] != cfg.n_kv_heads * cfg.resolved_head_dim


def _entry(names):
    if not names:
        return None
    return tuple(names) if len(names) > 1 else names[0]


def _leaf_spec(path: str, shape: tuple, cfg, axes: AxisCtx, fsdp: int,
               kv: bool | None = None) -> tuple:
    from repro_torch.models.common import fsdp_participates, fsdp_shard_dim, is_stacked

    ndim = len(shape)
    off = 1 if (is_stacked(path) and ndim >= 1) else 0
    nd = ndim - off
    per_shape = tuple(shape[off:])
    entries: list = [None] * ndim
    td = tp_dim(path, nd, _kv_sharded(path, per_shape, cfg) if kv is None else kv)
    if td is not None and axes.model_axis is not None:
        entries[td + off] = (axes.model_axis,)
    if fsdp > 1 and axes.fsdp_axes and fsdp_participates(path, per_shape, fsdp):
        fd = fsdp_shard_dim(path, nd) + off
        entries[fd] = (entries[fd] or ()) + tuple(axes.fsdp_axes)
    return tuple(_entry(e) for e in entries)


def tree_param_specs(params: dict, cfg, axes: AxisCtx, fsdp: int,
                     kv: bool | None = None) -> dict:
    """The spec of every leaf of a parameter dict, keyed by path.  Leaves
    may be tensors (meta tensors too) or
    :class:`~repro_torch.models.common.QTensor`, whose codes take the
    leaf's spec and whose scale is replicated.  The rules read only
    sharding-invariant dims, so the shapes may be sliced for FSDP or not.
    ``fsdp``: the launch's FSDP way-count.  ``kv``: whether the launch
    splits the KV heads (``attn_dims(cfg, axes.tp).kv_sharded``); None reads
    it from local storage, where a replicated KV projection keeps all its
    outputs.  A WHOLE dict (the ``tp = 1`` init's shapes, or the
    reference's global arrays) cannot say, so its callers pass it."""
    from repro_torch.models.common import QTensor

    out = {}
    for path, leaf in params.items():
        if isinstance(leaf, QTensor):
            out[path] = QTensor(codes=_leaf_spec(path, tuple(leaf.codes.shape), cfg, axes, fsdp,
                                                 kv),
                                scale=(None,) * leaf.scale.ndim)
        else:
            out[path] = _leaf_spec(path, tuple(leaf.shape), cfg, axes, fsdp, kv)
    return out


# ---------------------------------------------------------------------------
# Batch / cache layouts
# ---------------------------------------------------------------------------


def _batch_entry(axes: AxisCtx):
    ba = tuple(axes.batch_axes)
    if not ba:
        return None
    return ba if len(ba) > 1 else ba[0]


def batch_specs(batch: dict, axes: AxisCtx) -> dict:
    """Every batch leaf's leading (global-batch) dim over the batch axes;
    all other dims replicated."""
    lead = _batch_entry(axes)
    return {k: (lead,) + (None,) * (v.ndim - 1) for k, v in batch.items()}


def cache_specs(caches, axes: AxisCtx, cfg):
    """The specs of a decode cache tree (layer-stacked, batch-local
    storage), in the tree's own structure: ``KVCache`` / ``PagedKVCache`` /
    ``SSMCache`` of specs, dicts keyed as the tree (a hybrid's ``sub{j}``,
    the VLM's ``self{j}``, enc-dec's ``self``), and a tuple for a bare
    tensor (the cross K/V).

    Self-attention KV caches split the KV-head dim over the model axis on
    KV-sharded launches and the sequence dim otherwise (each TP shard owns a
    slice of the context); a paged pool and table then shard over the model
    axis with it.  SSM caches split heads / channels.  The cross K/V split
    their KV-head dim only when KV is sharded.
    """
    from repro_torch.models.attention import KVCache, PagedKVCache
    from repro_torch.models.ssm import SSMCache

    model = axes.model_axis
    lead = _batch_entry(axes)

    def kv_sharded(n_kv_local: int) -> bool:
        return bool(cfg.n_kv_heads) and n_kv_local != cfg.n_kv_heads

    def self_kv(t):                          # (L, B, S_local, KV_local, hd)
        if kv_sharded(t.shape[3]):
            return (None, lead, None, model, None)
        return (None, lead, model, None, None)   # sequence-parallel cache

    def one(c):
        if isinstance(c, dict):
            return {k: one(v) for k, v in c.items()}
        if isinstance(c, PagedKVCache):
            # pools (L, N_pool, page, KV_local, hd); tables (L, B, n_pmax)
            if kv_sharded(c.k_pages.shape[3]):
                pool, table = (None, None, None, model, None), (None, lead, None)
            else:
                pool, table = (None, model, None, None, None), (None, lead, model)
            return PagedKVCache(k_pages=pool, v_pages=pool, page_table=table,
                                length=(None, lead))
        if isinstance(c, KVCache):
            return KVCache(k=self_kv(c.k), v=self_kv(c.v), length=(None, lead))
        if isinstance(c, SSMCache):
            return SSMCache(state=(None, lead, model, None, None),   # (L, B, H_l, N, P)
                            conv_x=(None, lead, None, model),        # (L, B, W-1, d_in_l)
                            conv_bc=(None, lead, None, None))        # (L, B, W-1, 2N)
        if c.ndim == 5:                      # cross K/V: (L, B, S_mem, KV_l, hd)
            if kv_sharded(c.shape[3]):
                return (None, lead, None, model, None)
            return (None, lead, None, None, None)
        return (None,) if c.ndim == 1 else (None, lead) + (None,) * (c.ndim - 2)

    return one(caches)


# ---------------------------------------------------------------------------
# A tree cut into the shards of its batch, and joined back
# ---------------------------------------------------------------------------


def _batch_dims(spec: tuple, lead) -> list[int]:
    return [i for i, e in enumerate(spec) if lead is not None and e == lead]


def _walk(tree, specs, leaf_fn):
    """``leaf_fn(tensor_or_list, spec)`` over a tree (dict, NamedTuple, bare
    tensor) and its specs in the same structure; ``tree`` may also be a list
    of such trees (one a shard), walked in step."""
    many = isinstance(tree, list)
    first = tree[0] if many else tree
    if isinstance(first, dict):
        return {k: _walk([t[k] for t in tree] if many else tree[k], specs[k], leaf_fn)
                for k in first}
    if isinstance(first, tuple):
        fields = zip(*tree) if many else tree
        return type(first)(*(_walk(list(f) if many else f, s, leaf_fn)
                             for f, s in zip(fields, specs)))
    return leaf_fn(tree, specs)


def cut_batch(tree, specs, axes: AxisCtx, shard: int):
    """Shard ``shard``'s piece of a cache tree or batch dict laid out by
    ``specs`` (:func:`cache_specs`, :func:`batch_specs`): each dim whose
    entry is the batch axes' is narrowed to the shard's ``n / axes.dp``
    rows; a leaf without one (a paged pool) is the shard's whole."""
    lead = _batch_entry(axes)

    def one(t, spec):
        for d in _batch_dims(spec, lead):
            n = t.shape[d] // axes.dp
            t = t.narrow(d, shard * n, n)
        return t

    return _walk(tree, specs, one)


def join_batch(trees: list, specs, axes: AxisCtx):
    """The global tree of the shards' pieces ``trees`` (shard order): each
    batch dim concatenated; a leaf without one taken from shard 0, as the
    reference's global array of a replicated leaf reads its first shard."""
    lead = _batch_entry(axes)

    def one(ts, spec):
        dims = _batch_dims(spec, lead)
        if not dims:
            return ts[0]
        if len(dims) > 1:
            raise ValueError(f"spec {spec} splits more than one dim over the batch axes")
        return torch.cat(ts, dim=dims[0])

    return _walk(trees, specs, one)


# ---------------------------------------------------------------------------
# A tree cut into the shards of the model axis, and joined back
# ---------------------------------------------------------------------------


def _model_dims(spec: tuple, model) -> list[int]:
    """The dims a spec splits over the model axis first (major): its entry
    is the axis, or a tuple of axes that starts with it."""
    if model is None:
        return []
    return [i for i, e in enumerate(spec)
            if e == model or (isinstance(e, tuple) and e and e[0] == model)]


def cut_model(tree, specs, axes: AxisCtx, t: int):
    """Model shard ``t``'s piece of a whole tree laid out by ``specs``
    (:func:`tree_param_specs`, :func:`cache_specs`): each dim split over
    the model axis narrowed to block ``t`` of ``ceil(n / axes.tp)`` (a
    copy, so the whole leaf can be freed); the rest whole.  A dim that does
    not divide (a vocabulary) pads the last shard's block with zeros, the
    reference's global layout of ``padded_vocab_local`` rows or columns a
    shard.  A packed leaf's codes are cut and its scale kept whole."""
    from repro_torch.models.common import QTensor

    T = axes.tp

    def cut(w, spec):
        for d in _model_dims(spec, axes.model_axis):
            n = w.shape[d]
            blk = -(-n // T)
            lo = min(t * blk, n)
            piece = w.narrow(d, lo, min(blk, n - lo))
            if piece.shape[d] < blk:
                pad = list(piece.shape)
                pad[d] = blk - piece.shape[d]
                piece = torch.cat([piece, piece.new_zeros(pad)], dim=d)
            w = piece.clone()
        return w

    def one(w, spec):
        if isinstance(w, QTensor):
            return QTensor(cut(w.codes, spec.codes), w.scale)
        return cut(w, spec)

    return _walk(tree, specs, one)


def join_model(trees: list, specs, axes: AxisCtx):
    """The global tree of the model shards' pieces ``trees`` (model-index
    order): each model dim concatenated; a leaf without one taken from
    shard 0, as the reference's global array of a replicated leaf reads
    device 0's copy."""
    from repro_torch.models.common import QTensor

    model = axes.model_axis

    def cat(ts, spec):
        dims = _model_dims(spec, model)
        if not dims:
            return ts[0]
        if len(dims) > 1:
            raise ValueError(f"spec {spec} splits more than one dim over the model axis")
        return torch.cat(ts, dim=dims[0])

    def one(ts, spec):
        if isinstance(ts[0], QTensor):
            return QTensor(cat([w.codes for w in ts], spec.codes), ts[0].scale)
        return cat(ts, spec)

    return _walk(list(trees), specs, one)
