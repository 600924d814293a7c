"""Step builders: the FWQ train step, its init, and the serving steps.

Counterparts of ``build_init_fn`` / ``build_train_step`` /
``local_param_shapes`` / ``build_decode_step`` / ``build_cached_prefill`` /
``init_global_caches`` / ``build_prefill_step`` in ``repro/launch/steps.py``
as plain callables: no ``shard_map``, no jit — PyTorch runs eagerly.

In one process the train step runs a ``Dx1`` mesh's D clients one after
another (the reference runs them as the data-parallel shards of one program)
and then does the server's part: the reference's FSDP leaves mean-reduced in
f32, its replicated leaves through the SR-quantized all-reduce (one K2 call),
one optimizer step.  Under a process group (``axes.transport``) each rank
runs its own client on its FSDP shards, and the reductions are the
reference's collectives over the ranks.  On a model axis above 1 (``1xT`` /
``DxT``, one rank a mesh device) each rank runs its client's step on its
model shard, the model group's collectives inside the layers, and the
gradients of the replicated leaves that are each rank's part of the whole
are summed over the model group before the batch reductions.  The dry
run traces one device of the mesh (``build_train_step(one_device=True)``):
its own client at share 1, its model group a stand-in, its batch group's
collectives recorded.  Its SR noise comes from :class:`SRDraws`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.fwq import _stable_hash, make_inline_quantizer, site_key
from repro_torch.dist.collectives import AxisCtx, f32_reciprocal, quantized_psum_batch
from repro_torch.kernels.ref import philox_uniforms_plain
from repro_torch.models import common
from repro_torch.models.common import ParamCtx, fsdp_plan, reduce_gradients
from repro_torch.models.model import Model
from repro_torch.optim import Optimizer
from repro_torch.roofline import count


def _compute_dtype(cfg: ModelConfig):
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


class SRDraws:
    """The stochastic-rounding randomness of one train step: round
    ``round_idx`` of a run seeded with ``seed``.

    Every draw is keyed by ``(seed, round_idx, site)`` (:func:`site_key`),
    so a step is deterministic and a resumed run repeats it.  The sites are
    the reference's: a weight use is ``(client, _stable_hash(path))`` (no
    layer index: every layer of a stacked weight gets the same draws), the
    wire is ``17``.  A weight use draws its uniforms inside K1 from
    :meth:`weight_key`; :meth:`weights` returns those same uniforms as a
    tensor.  The wire draws inside K2 from :meth:`wire_key`, client ``c``'s
    row over the wire leaves concatenated in flatten order as stream ``c``
    (:func:`~repro_torch.kernels.ref.philox_streams_plain`).  PyTorch cannot reproduce the reference's
    threefry bits, so this class is the one seam a test replaces to feed the
    reference's own draws: a subclass that overrides :meth:`weights` has its
    uniforms used as given (K1's segment entry), and one whose :meth:`wire`
    returns uniforms has them used as given (K2's u-taking entry).
    """

    def __init__(self, seed: int, round_idx: int):
        self.seed, self.round_idx = int(seed), int(round_idx)
        self._keys: dict = {}

    def weight_key(self, client: int, path: str) -> int:
        """The 64-bit key of client ``client``'s inline quantization of
        ``path`` (cached: remat asks again in backward)."""
        site = (int(client), path)
        if site not in self._keys:
            self._keys[site] = site_key(self.seed, self.round_idx, int(client),
                                        _stable_hash(path))
        return self._keys[site]

    def weights(self, client: int, path: str, shape, device) -> torch.Tensor:
        """Uniforms for client ``client``'s inline quantization of ``path``:
        the ones K1 draws from :meth:`weight_key`."""
        n = int(np.prod(tuple(shape), dtype=np.int64))
        return philox_uniforms_plain(self.weight_key(client, path), n).reshape(
            tuple(shape)).to(device)

    def wire_key(self) -> int:
        """The 64-bit key of the step's SR wire (site ``17``)."""
        return site_key(self.seed, self.round_idx, 17)

    def wire(self, leaf: int, n_clients: int, shape, device):
        """The wire's seam: ``(n_clients, *shape)`` uniforms for wire leaf
        ``leaf``, or None (here) for K2's own draws from :meth:`wire_key`."""
        return None


@dataclasses.dataclass(frozen=True)
class TrainStep:
    fn: Any                     # (params, opt_state, batch, delta, draws) -> ...
    batch_spec_fn: Any          # (global_batch, seq) -> meta-tensor batch
    n_clients: int


def build_train_step(model: Model, axes: AxisCtx, opt: Optimizer,
                     train_cfg: TrainConfig, *, attn_impl: str = "auto",
                     one_device: bool = False) -> TrainStep:
    """The FWQ train step of Algorithm 1 on a ``Dx1``, ``1xT`` or ``DxT`` mesh.

    ``fn(params, opt_state, batch, delta, draws) -> (params, opt_state,
    {"loss", "grad_sq_shard_sum"})``.  ``batch`` leaves have the global batch
    ``D * b`` as leading dim (client ``c`` takes rows ``c*b : (c+1)*b``),
    ``delta`` is ``(D,)`` per-client resolutions, ``draws`` an
    :class:`SRDraws`.  Each client quantizes the weights at its ``delta[c]``
    as it uses them (one call of K1's inline entry a weight use, keyed by
    ``draws.weight_key``; K1's segment entry from ``draws.weights`` where a
    subclass overrides that) and takes its loss and gradient there; the server
    means the reference's FSDP leaves in f32 and, when
    ``train_cfg.grad_compression_bits`` is set, sends the replicated leaves
    through :func:`quantized_psum_batch` (one call of K2's keyed entry
    under ``draws.wire_key()``; the u-taking entry where ``draws.wire``
    gives uniforms), then steps the optimizer.  ``loss`` is the clients' mean; ``grad_sq_shard_sum`` is the
    reference's sum over shards of the reduced gradients' squared norms
    (FSDP leaves once, replicated leaves ``D`` times).

    Under a process group (``axes.transport``) the step runs on each rank
    as the reference's shard does: ``params`` are the rank's storage (its
    FSDP shards, :func:`build_init_fn`), ``batch`` its own client's ``b``
    rows, and client ``r = axes.dp_index()`` takes its gradient at
    ``delta[r]``; the FSDP gradients come back reduce-scattered (summed) and
    divided by D, the replicated ones are ``pmean``-ed or cross the wire
    (K2 split across the ranks), and ``loss`` is ``pmean_batch``-ed,
    ``grad_sq_shard_sum`` ``psum_batch``-ed from each rank's part.

    With ``one_device`` (the dry run's traced device, no group) the step is
    one device of the mesh, as a rank is: ``batch`` is its client's ``b``
    rows, client ``axes.dp_index()`` runs at share 1, the wire's K2 call
    takes that client's row as every client's (priced at ``1 / D`` a row,
    the loop's record), and the batch group's collectives are recorded.
    At ``Dx1``, where the port's one card runs the D clients in a loop,
    the client's operations count D times in the card bound
    (:func:`repro_torch.roofline.count.share`'s ``copies``).

    On a model axis of T > 1 (``axes.model_transport``) the rank's storage
    is its model shard's slice of every leaf (then its FSDP shard over the
    batch group), its batch its client's rows, the same on the T ranks of a
    model group; under ``cfg.seq_parallel`` the residual stream is cut over
    the sequence (S must divide by T).  Each rank quantizes its own slices
    (the scale a slice's own ``max|w|``, the site key the client's: the
    reference's semantics inside ``shard_map``).  The replicated leaves
    whose rank gradients are parts
    (:func:`~repro_torch.dist.sharding.model_summed_leaves`) are summed in
    one all-reduce over the model group; then the batch reductions run
    over the batch group on the rank's slices, as at ``Dx1``.  At 32-bit
    weights the step is the ``1x1`` (``Dx1``) step of the same model cut,
    and every replicated leaf comes out the same on every rank of a model
    group; ``grad_sq_shard_sum`` is also summed over the model group (a
    replicated leaf counted T times, as the reference's definition).
    """
    from repro_torch.dist.sharding import model_summed_leaves

    cfg = model.cfg
    D = axes.dp
    bits = int(train_cfg.grad_compression_bits)
    if one_device and axes.transport is not None:
        raise ValueError("one_device is one traced device of the mesh, without a group; "
                         "under a group each rank runs its own client already")
    # what the port's one card runs in one process: at Dx1 the loop's D
    # clients and each FSDP leaf whole; on a model axis above 1, one rank a
    # device, the device's own
    card_clients = D if one_device and axes.tp == 1 else 1
    card_shards = axes.fsdp if axes.tp == 1 else 1

    gather_dtype = torch.bfloat16 if cfg.fsdp_gather_dtype == "bfloat16" else None

    def _client_grads(c, params, cb, delta, draws, paths, wire, sums, stacked, given, cd):
        """Client ``c``'s loss and gradient on its batch ``cb`` at its
        quantized weights; the gradients go to ``sums`` (FSDP-reduced
        leaves) or ``stacked`` (wire)."""
        if given:
            transform = make_inline_quantizer(
                delta[c], out_dtype=cd,
                uniforms=lambda path, w: draws.weights(c, path, w.shape, w.device))
        else:                                   # one keyed K1 call a weight use
            transform = make_inline_quantizer(
                delta[c], out_dtype=cd, keys=lambda path: draws.weight_key(c, path))
        pc = ParamCtx(ctx=axes.at_client(c), compute_dtype=cd, sp=cfg.seq_parallel,
                      transform=transform, gather_dtype=gather_dtype)
        leaves = {p: params[p].detach().requires_grad_() for p in paths}
        loss, _aux = model.train_loss(pc, leaves, cb, attn_impl=attn_impl)
        grads = torch.autograd.grad(loss, [leaves[p] for p in paths])
        for p, g in zip(paths, grads):
            if p in wire:
                stacked[p].append(g)
            elif p not in sums:
                sums[p] = g
            else:
                sums[p].add_(g)
        return loss.detach()

    def fn(params, opt_state, batch, delta, draws: SRDraws):
        ranks = axes.transport is not None      # one client a process: this rank's
        clients = [axes.dp_index()] if ranks or one_device else range(D)
        paths, _, plan = fsdp_plan(params, axes.fsdp, check_divisibility=False)
        replicated = {p for p, dim in zip(paths, plan) if dim is None}
        wire = replicated if bits else set()
        b = batch["tokens"].shape[0] // len(clients)
        dev = params[paths[0]].device
        delta = delta.to(dev)
        sums, stacked, loss_sum = {}, {p: [] for p in wire}, None
        cd = _compute_dtype(cfg)
        given = type(draws).weights is not SRDraws.weights   # a subclass's own uniforms
        for i, c in enumerate(clients):
            with count.share(1 / len(clients), card_clients):     # a client a device
                cb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
                loss_c = _client_grads(c, params, cb, delta, draws, paths, wire, sums,
                                       stacked, given, cd)
            loss_sum = loss_c if i == 0 else loss_sum + loss_c
        if one_device:                          # the device's row stands for each client's:
            stacked = {p: g * D for p, g in stacked.items()}    # K2 priced at 1 / D a row
        if axes.tp > 1:                         # the ranks' parts of replicated leaves
            _sum_over_model(axes, model_summed_leaves(params, cfg, axes, cfg.seq_parallel),
                            sums, stacked)
        # ---- server aggregation (Algorithm 1 line 10) ----------------------
        G = reduce_gradients(sums, axes)        # across ranks: FSDP sums from the gathers
        if wire:
            idx = [(i, p) for i, p in enumerate(paths) if p in wire]
            leaves = [stacked.pop(p) for _i, p in idx]      # per leaf, the clients' here
            us = [draws.wire(i, D, params[p].shape, dev) for i, p in idx]
            if all(uu is None for uu in us):    # K2 draws; the gradients stay put
                means = quantized_psum_batch(axes, leaves, None, bits, key=draws.wire_key(),
                                             on_nonfinite=train_cfg.nonfinite_grads)
            else:
                if ranks:                       # the rank's own row of each leaf's draws
                    us = [uu[clients[0]:clients[0] + 1] for uu in us]
                means = quantized_psum_batch(axes, [torch.stack(g) for g in leaves], us, bits,
                                             on_nonfinite=train_cfg.nonfinite_grads)
            G.update(zip((p for _i, p in idx), means))
        # ---- server update (line 11) --------------------------------------
        updates, opt_state = opt.update(G, opt_state, params)
        params = {k: (p.to(torch.float32) + updates[k]).to(p.dtype)
                  for k, p in params.items()}
        gnorm = 0.0
        for p in paths:                         # the reference's vdot(g, g) a leaf
            g = G[p].to(torch.float32).reshape(-1)
            copies = 1
            if p not in replicated and count.is_traced(g):
                g = g[:g.numel() // axes.fsdp]  # a traced device's shard of the leaf,
                copies = card_shards            # the card's whole leaf
            # a replicated leaf counts once a shard: D times here, once a rank
            with count.share(1, copies):
                gnorm = gnorm + torch.dot(g, g) * (D if p in replicated and not ranks else 1)
        if not ranks:                           # the batch group's, which a trace records
            count.record_collective("all-reduce", torch.float32, 1, D, "train_step loss pmean")
            count.record_collective("all-reduce", torch.float32, 1, D,
                                    "train_step grad_sq_shard_sum psum")
        if ranks or axes.tp > 1:
            gnorm = axes.psum_model(axes.psum_batch(gnorm))
            return params, opt_state, {"loss": axes.pmean_batch(loss_sum),
                                       "grad_sq_shard_sum": gnorm}
        metrics = {"loss": loss_sum * f32_reciprocal(D), "grad_sq_shard_sum": gnorm}
        return params, opt_state, metrics

    return TrainStep(fn=fn, batch_spec_fn=model.train_batch_spec, n_clients=D)


def _sum_over_model(axes: AxisCtx, paths: list, sums: dict, stacked: dict) -> None:
    """Each of ``paths``' gradients (in ``sums``, or the rank's one client's
    in ``stacked``) replaced, in place, by its sum over the model group: one
    f32 all-reduce of them concatenated."""
    if not paths:
        return
    gs = [stacked[p][0] if p in stacked else sums[p] for p in paths]
    total = axes.model_transport.all_reduce(
        torch.cat([g.reshape(-1).to(torch.float32) for g in gs]))
    for g, part in zip(gs, total.split([g.numel() for g in gs])):
        g.copy_(part.view_as(g))


def build_init_fn(model: Model, axes: AxisCtx, *, device=None, pack=None):
    """``init(generator) -> params``: this rank's storage of the one-process
    init from ``generator`` — its tensor-parallel slice of every leaf on a
    model axis above 1, then its FSDP shard of every FSDP leaf of that,
    every replicated leaf whole (the one-process init itself without a
    group).

    Every rank draws the whole ``tp = 1`` model from the same generator,
    so the shards are slices of exactly the one-process leaves, and a leaf
    replicated over the model axis is the same on every rank (the
    reference inits each model shard from its own key instead: ROADMAP §3,
    D14); each leaf is cut as soon as it is drawn
    (:func:`repro_torch.models.common.sharded_init`, the model cut by
    :func:`repro_torch.dist.sharding.cut_model` on the reference's global
    layout), so a rank holds one whole leaf at a time, never the whole
    model.  ``pack(leaves) -> leaves`` (serving's
    :func:`~repro_torch.models.common.pack_params_for_policy`) turns each
    whole leaf into its storage before it is cut: leaf by leaf, so a rank's
    codes are the one-process packing's, cut, and its scales the whole
    leaves' (the reference packs its global arrays).
    """
    cut = None
    if axes.tp > 1:
        from repro_torch.dist.sharding import cut_model, tree_param_specs
        from repro_torch.models.transformer import attn_dims

        kv = attn_dims(model.cfg, axes.tp).kv_sharded

        def cut(path, w):
            leaf = {path: w}
            return cut_model(leaf, tree_param_specs(leaf, model.cfg, axes, 1, kv), axes,
                             axes.tp_index())[path]

    def init(generator: torch.Generator) -> dict:
        if cut is None and (axes.transport is None or axes.fsdp == 1):
            params = model.init(generator, 1, device=device)
            return params if pack is None else pack(params)
        return common.sharded_init(
            lambda meta: model.init(torch.Generator().manual_seed(0) if meta else generator,
                                    1, device="meta" if meta else device), axes, pack, cut)

    return init


def local_param_shapes(model: Model, axes: AxisCtx) -> dict:
    """Per-shard parameter shapes (the reference's post-FSDP storage layout)
    as meta tensors; raises as the reference does where an FSDP leaf does
    not divide by the FSDP size."""
    fsdp = axes.fsdp
    params = model.init(torch.Generator().manual_seed(0), axes.tp, device="meta")
    paths, leaves, plan = fsdp_plan(params, fsdp)
    out = {}
    for path, leaf, dim in zip(paths, leaves, plan):
        shape = list(leaf.shape)
        if dim is not None:
            shape[dim] //= fsdp
        out[path] = torch.empty(shape, dtype=leaf.dtype, device="meta")
    return out


@dataclasses.dataclass(frozen=True)
class ServeStep:
    fn: Any


def _greedy_pick(axes: AxisCtx, tp: int, vl: int, logits):
    """Greedy token over vocab-parallel local logits (B, 1, V/tp) -> (B, 1)
    int32; the first index wins a tie, as ``jnp.argmax`` does.  Under tp the
    shards agree on the max (``pmax``), and among the shards that hold it
    the smallest global id wins (``pmin``; ``2**30`` for a shard that lost),
    so every model rank picks the same token."""
    lg = logits[:, -1, :].to(torch.float32)
    mloc = lg.amax(dim=-1)
    iloc = torch.argmax(lg, dim=-1).to(torch.int32) + axes.tp_index() * vl
    if tp > 1:
        mglob = axes.pmax_model(mloc)
        cand = torch.where(mloc >= mglob, iloc, torch.full_like(iloc, 2**30))
        iloc = axes.pmin_model(cand)
    return iloc[:, None]


def _cache_kwargs(page_size, pool_pages) -> dict:
    """init_caches kwargs for the requested KV layout (paged iff page_size)."""
    if page_size is None:
        return {}
    return {"page_size": int(page_size),
            "pool_pages": None if pool_pages is None else int(pool_pages)}


def init_global_caches(model: Model, axes: AxisCtx, *, s_max: int, batch_global: int,
                       dtype=torch.float32, device=None, page_size: int | None = None,
                       pool_pages: int | None = None):
    """Allocate one mesh device's decode caches: ``batch_global // axes.dp``
    slots (the reference's ``b_local``), and on the paged layout a whole pool
    of ``pool_pages`` pages (the pool has no batch entry in
    :func:`~repro_torch.dist.sharding.cache_specs`: each shard keeps its own);
    at ``axes.tp`` the model shard's local shapes (its KV heads, or on the
    sequence-parallel layout its ``s_max / tp`` positions).  On a ``1x1``
    mesh this is the launch's whole cache.

    ``page_size``/``pool_pages`` select the paged KV layout; its page tables
    start all-unallocated (-1), everything else zeroed.  ``device="meta"``
    gives the shapes without allocating.
    """
    return model.init_caches(batch_global // max(axes.dp, 1), s_max, axes.tp, dtype=dtype,
                             device=device, **_cache_kwargs(page_size, pool_pages))


def build_decode_step(model: Model, axes: AxisCtx, *, policy=None,
                      attn_impl: str = "ref") -> ServeStep:
    """One-token decode step with greedy sampling, run by one data shard.

    ``fn(params, {"token": (B, 1)}, caches) -> (next (B, 1) int32, caches)``
    over the shard's ``B`` slots and caches (:func:`init_global_caches`).
    ``axes`` is the shard's: on a ``Dx1`` mesh in one process
    ``axes.at_client(c)`` (no transport), under a group the rank's own,
    whose FSDP-stored weights :meth:`ParamCtx.use` gathers at each use.
    With ``policy.lazy``, packed ``QTensor`` weights stay int8 through the
    projections (``quant_matmul``); ``attn_impl="flash"`` routes paged
    decode attention through the flash-decode kernel.
    """
    cfg = model.cfg
    from repro_torch.models.transformer import padded_vocab_local
    vl = padded_vocab_local(cfg, axes.tp)
    pc = ParamCtx.from_policy(axes, policy, compute_dtype=_compute_dtype(cfg))

    @torch.no_grad()
    def fn(params, batch, caches):
        logits, new_caches = model.decode_step(pc, params, batch, caches,
                                               attn_impl=attn_impl)
        return _greedy_pick(axes, axes.tp, vl, logits), new_caches

    return ServeStep(fn=fn)


def build_cached_prefill(model: Model, axes: AxisCtx, *, attn_impl: str = "auto",
                         policy=None, bos_id: int = 1) -> ServeStep:
    """Prefill-into-slots step for continuous batching, run by one data shard
    (its ``B`` slots and caches; ``axes`` as in :func:`build_decode_step`).

    ``fn(params, batch, caches, slot_mask, prompt_lens=None) ->
    (first_token (B, 1), merged_caches)``: runs the model's prefill over a
    fresh zeroed copy of the caches, then merges ONLY the slots selected by
    ``slot_mask`` into the live caches (in place), so new requests join a
    mid-flight batch without disturbing the sequences still decoding in the
    other slots.  Paged caches merge at page granularity through the live
    page tables, which the driver must have set for the admitted slots
    BEFORE this call.  ``prompt_lens`` (B,) keeps each right-padded prompt's
    true length (cache stamps, last-position logits).  A prefill that
    returns ``None`` logits (enc-dec: the prompt is the source modality)
    seeds every slot with ``bos_id``.
    """
    cfg = model.cfg
    from repro_torch.models.attention import fresh_slot_caches, merge_slot_caches
    from repro_torch.models.transformer import padded_vocab_local
    vl = padded_vocab_local(cfg, axes.tp)
    pc = ParamCtx.from_policy(axes, policy, compute_dtype=_compute_dtype(cfg))

    @torch.no_grad()
    def fn(params, batch, caches, slot_mask, prompt_lens=None):
        kw = {"prompt_lens": prompt_lens} if prompt_lens is not None else {}
        logits, filled = model.prefill(pc, params, batch, fresh_slot_caches(caches),
                                       attn_impl=attn_impl, **kw)
        if logits is None:      # enc-dec: decode starts from BOS
            tok = torch.full((slot_mask.shape[0], 1), bos_id, dtype=torch.int32,
                             device=slot_mask.device)
        else:
            tok = _greedy_pick(axes, axes.tp, vl, logits)
        return tok, merge_slot_caches(caches, filled, slot_mask)

    return ServeStep(fn=fn)



def build_prefill_step(model: Model, axes: AxisCtx, *, attn_impl: str = "auto",
                       policy=None) -> ServeStep:
    """Forward-only prefill: ``fn(params, batch) -> (B, 1, V)`` last-position
    logits (the dry run's prefill cell; ``batch`` without labels).  A lazy
    ``policy`` keeps packed weights packed through ``quant_matmul``; the
    reference's cell takes no policy (the port's default)."""
    cfg = model.cfg
    pc = ParamCtx.from_policy(axes, policy, compute_dtype=_compute_dtype(cfg),
                              sp=cfg.seq_parallel)

    @torch.no_grad()
    def fn(params, batch):
        loss_free = {k: v for k, v in batch.items() if k != "labels"}
        logits = model.forward(pc, params, loss_free, attn_impl=attn_impl)
        return logits[:, -1:, :]

    return ServeStep(fn=fn)
