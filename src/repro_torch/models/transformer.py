"""Decoder-only transformer LM (dense and MoE families): init, training
forward and loss, prefill, decode.

Counterpart of ``repro/models/transformer.py``.  A Python loop over the
layer-stacked parameters takes the place of ``lax.scan``; with ``cfg.remat``
each training block runs under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint``), so its weight transform runs again in backward.  Caches
are layer-stacked ``(L, ...)``; each layer reads and writes its slice in
place, so a step returns the same pools with new lengths.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.attention import (
    AttnDims,
    decode_self_attention,
    init_attention,
    init_kv_cache,
    init_paged_kv_cache,
    prefill_kv_cache,
    self_attention,
)
from repro_torch.models.common import (ParamCtx, init_dense, init_embed, layer_cache,
                                       layer_params, layer_views)
from repro_torch.models.moe import MoEDims, init_moe, moe_block


def padded_vocab_local(cfg: ModelConfig, tp: int) -> int:
    return -(-cfg.vocab_size // tp)  # ceil


def attn_dims(cfg: ModelConfig, tp: int, causal: bool = True) -> AttnDims:
    return AttnDims(
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
        d_model=cfg.d_model, tp=tp, causal=causal, rope_theta=cfg.rope_theta,
    )


def moe_dims(cfg: ModelConfig, tp: int) -> MoEDims:
    return MoEDims(
        n_experts=cfg.n_experts, k=cfg.experts_per_token, d_model=cfg.d_model,
        d_ff=cfg.moe_d_ff or cfg.d_ff, tp=tp,
        capacity_factor=cfg.capacity_factor, act=cfg.mlp_act,
    )


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe"):
        raise ValueError(
            f"family {cfg.family!r} is not a decoder-only transformer LM: the SSM, "
            "hybrid, VLM and enc-dec families have their own modules "
            "(models/model.build_model picks them)")


def _ffn(cfg: ModelConfig, pc: ParamCtx, lp, h, md: MoEDims | None):
    """The block's feed-forward: the MoE block (its aux dropped, as the
    reference drops it) or the MLP."""
    if md is not None:
        return moe_block(pc, "blocks/moe", lp["moe"], h, md)[0]
    return L.mlp(pc, "blocks/mlp", lp["mlp"], h, cfg.mlp_act)


def _moe_dims_of(cfg: ModelConfig, tp: int) -> MoEDims | None:
    return moe_dims(cfg, tp) if cfg.family == "moe" else None


def init_lm(cfg: ModelConfig, gen: torch.Generator, tp: int = 1, *, device=None,
            dtype=torch.float32) -> dict:
    """Random f32 parameters drawn on ``device`` from ``gen``, keyed by path."""
    _require_ported(cfg)
    vl = padded_vocab_local(cfg, tp)
    d, nl = cfg.d_model, (cfg.n_layers,)
    kw = {"device": device, "dtype": dtype}
    p = {"embed/table": init_embed(gen, vl, d, **kw),
         "blocks/ln1": torch.zeros(nl + (d,), **kw)}
    for name, w in init_attention(gen, attn_dims(cfg, tp), lead=nl, **kw).items():
        p[f"blocks/attn/{name}"] = w
    p["blocks/ln2"] = torch.zeros(nl + (d,), **kw)
    if cfg.family == "moe":
        for name, w in init_moe(gen, moe_dims(cfg, tp), lead=nl, **kw).items():
            p[f"blocks/moe/{name}"] = w
    else:
        for name, w in L.init_mlp(gen, d, cfg.d_ff // tp, cfg.mlp_act, lead=nl,
                                  **kw).items():
            p[f"blocks/mlp/{name}"] = w
    p["final_norm"] = torch.zeros((d,), **kw)
    p["unembed/w"] = init_dense(gen, d, vl, **kw)
    return p


def _block_fn(cfg: ModelConfig, pc: ParamCtx, tp: int, attn_impl: str):
    ad, md = attn_dims(cfg, tp), _moe_dims_of(cfg, tp)

    def block(x, lp):
        h = L.sp_gather(pc, L.rmsnorm(pc, "blocks/ln1", lp["ln1"], x, cfg.norm_eps))
        a, _ = self_attention(pc, "blocks/attn", lp["attn"], h, ad, impl=attn_impl)
        x = x + a
        h = L.sp_gather(pc, L.rmsnorm(pc, "blocks/ln2", lp["ln2"], x, cfg.norm_eps))
        return x + _ffn(cfg, pc, lp, h, md)

    return block


def forward(cfg: ModelConfig, pc: ParamCtx, params, tokens, *, attn_impl="auto",
            return_hidden=False):
    """tokens: (B, S) -> logits (B, S, V), or the final hidden (B, S, D)."""
    _require_ported(cfg)
    tp = pc.ctx.tp
    vl = padded_vocab_local(cfg, tp)
    x = L.vocab_embed(pc, "embed", params["embed/table"], tokens, vl)
    x = x.to(pc.compute_dtype)
    block = _block_fn(cfg, pc, tp, attn_impl)
    for lp in layer_views(params, cfg.n_layers):
        if cfg.remat:
            x = checkpoint(block, x, lp, use_reentrant=False)
        else:
            x = block(x, lp)
    x = L.sp_gather(pc, L.rmsnorm(pc, "final_norm", params["final_norm"], x,
                                  cfg.norm_eps))
    if return_hidden:
        return x
    return L.vocab_logits(pc, "unembed", params["unembed/w"], x)


def train_loss(cfg: ModelConfig, pc: ParamCtx, params, batch, *, attn_impl="auto"):
    """Mean next-token cross-entropy of ``batch`` (``tokens``, ``labels``
    (B, S)); returns ``(loss, {})`` as the reference does."""
    x = forward(cfg, pc, params, batch["tokens"], attn_impl=attn_impl,
                return_hidden=True)
    vl = padded_vocab_local(cfg, pc.ctx.tp)
    loss = L.fused_vocab_xent(pc, "unembed/w", params["unembed/w"], x,
                              batch["labels"], vl, vocab=cfg.vocab_size)
    return loss, {}


def init_caches(cfg: ModelConfig, batch: int, s_max: int, tp: int = 1,
                dtype=torch.bfloat16, *, device=None, page_size=None, pool_pages=None):
    """Layer-stacked decode caches; ``page_size`` selects the paged layout
    (shared page pool + per-slot page tables) over the contiguous slab."""
    ad = attn_dims(cfg, tp)
    lead = (cfg.n_layers,)
    if page_size:
        return init_paged_kv_cache(batch, s_max, ad, dtype, page_size=page_size,
                                   pool_pages=pool_pages, device=device, lead=lead)
    return init_kv_cache(batch, s_max, ad, dtype, device=device, lead=lead)


def _restack(caches, per_layer):
    """The stacked caches after a pass: the pools were written in place, the
    per-layer lengths are new."""
    return caches._replace(length=torch.stack([c.length for c in per_layer]))


def last_position_logits(pc: ParamCtx, params, x, prompt_lens=None):
    """Logits at each slot's true last prompt position (``prompt_lens - 1``:
    bucketed prefill right-pads prompts)."""
    if prompt_lens is None:
        x_last = x[:, -1:, :]
    else:
        idx = torch.clamp(prompt_lens.to(torch.long) - 1, 0, x.shape[1] - 1)
        x_last = x[torch.arange(x.shape[0], device=x.device), idx][:, None, :]
    return L.vocab_logits(pc, "unembed", params["unembed/w"], x_last)


def prefill(cfg: ModelConfig, pc: ParamCtx, params, tokens, caches,
            *, attn_impl="auto", prompt_lens=None):
    """Parallel prefill: one forward pass over the prompt that also writes
    every layer's K/V into ``caches`` (in place) and stamps per-sequence
    lengths.

    tokens: (B, S_p) with S_p <= s_max.  Returns (last-position logits
    (B, 1, V), caches).  ``attn_impl="flash"`` runs the prompt through the
    flash-attention kernel.  ``prompt_lens`` (B,) gives per-slot true
    lengths when prompts are right-padded to a bucket size.
    """
    _require_ported(cfg)
    tp = pc.ctx.tp
    ad, md = attn_dims(cfg, tp), _moe_dims_of(cfg, tp)
    vl = padded_vocab_local(cfg, tp)
    x = L.vocab_embed(pc, "embed", params["embed/table"], tokens, vl)
    x = x.to(pc.compute_dtype)
    per_layer = []
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h = L.rmsnorm(pc, "blocks/ln1", lp["ln1"], x, cfg.norm_eps)
        a, (k, v) = self_attention(pc, "blocks/attn", lp["attn"], h, ad, impl=attn_impl)
        x = x + a
        h = L.rmsnorm(pc, "blocks/ln2", lp["ln2"], x, cfg.norm_eps)
        x = x + _ffn(cfg, pc, lp, h, md)
        per_layer.append(prefill_kv_cache(pc, layer_cache(caches, i), k, v, ad,
                                          prompt_lens))
    x = L.rmsnorm(pc, "final_norm", params["final_norm"], x, cfg.norm_eps)
    return last_position_logits(pc, params, x, prompt_lens), _restack(caches, per_layer)


def decode_step(cfg: ModelConfig, pc: ParamCtx, params, token, caches,
                *, attn_impl="auto"):
    """token: (B, 1) int -> (logits (B,1,V), caches with lengths + 1).

    ``attn_impl="flash"`` routes paged caches through the flash-decode
    kernel; any other value takes the gather reference path.
    """
    _require_ported(cfg)
    tp = pc.ctx.tp
    ad, md = attn_dims(cfg, tp), _moe_dims_of(cfg, tp)
    vl = padded_vocab_local(cfg, tp)
    x = L.vocab_embed(pc, "embed", params["embed/table"], token, vl)
    x = x.to(pc.compute_dtype)
    decode_impl = "flash" if attn_impl == "flash" else "ref"
    per_layer = []
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h = L.rmsnorm(pc, "blocks/ln1", lp["ln1"], x, cfg.norm_eps)
        a, new_cache = decode_self_attention(pc, "blocks/attn", lp["attn"], h,
                                             layer_cache(caches, i), ad,
                                             impl=decode_impl)
        x = x + a
        h = L.rmsnorm(pc, "blocks/ln2", lp["ln2"], x, cfg.norm_eps)
        x = x + _ffn(cfg, pc, lp, h, md)
        per_layer.append(new_cache)
    x = L.rmsnorm(pc, "final_norm", params["final_norm"], x, cfg.norm_eps)
    logits = L.vocab_logits(pc, "unembed", params["unembed/w"], x)
    return logits, _restack(caches, per_layer)
