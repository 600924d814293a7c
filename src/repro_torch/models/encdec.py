"""Encoder-decoder backbone (seamless-m4t class).

Counterpart of ``repro/models/encdec.py``.  The modality frontend is a stub:
precomputed audio-frame embeddings ``(B, S_src, d_frontend)`` go through a
linear adapter into the encoder width.  The encoder is non-causal
self-attention + MLP; the text decoder is causal self-attention, then
cross-attention into the encoder memory, then MLP.

Parameters are the flat path dict of the other families: ``adapter``,
``encoder/...`` and ``decoder/...`` (each with a leading ``(L,)``),
``enc_norm``, ``embed/table``, ``final_norm``, ``unembed/w``.  Caches are
``{"self": cache, "cross_k": tensor, "cross_v": tensor}``: the decoder's
layer-stacked self-attention cache (paged or contiguous, written in place)
and the cross K/V over the memory, ``(L, B, S_src, KVl, hd)`` bare tensors
filled at prefill.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.attention import (cross_attention, cross_attention_cached,
                                          decode_self_attention, init_attention,
                                          init_kv_cache, init_paged_kv_cache,
                                          project_cross_kv, self_attention)
from repro_torch.models.common import (ParamCtx, init_dense, init_embed, layer_cache,
                                       layer_params, layer_views)
from repro_torch.models.transformer import _restack, attn_dims, padded_vocab_local


def init_encdec(cfg: ModelConfig, gen: torch.Generator, tp: int = 1, *, device=None,
                dtype=torch.float32) -> dict:
    """Random f32 parameters drawn on ``device`` from ``gen``, keyed by path."""
    ad = attn_dims(cfg, tp)
    vl = padded_vocab_local(cfg, tp)
    d = cfg.d_model
    kw = {"device": device, "dtype": dtype}
    p = {"adapter": init_dense(gen, cfg.d_frontend or d, d, **kw)}
    for stack, n, subs in (("encoder", cfg.n_encoder_layers, ("attn",)),
                           ("decoder", cfg.n_layers, ("self", "cross"))):
        lead = (n,)
        p[f"{stack}/ln1"] = torch.zeros(lead + (d,), **kw)
        for sub in subs:
            if sub == "cross":
                p[f"{stack}/ln_x"] = torch.zeros(lead + (d,), **kw)
            for name, w in init_attention(gen, ad, lead=lead, **kw).items():
                p[f"{stack}/{sub}/{name}"] = w
        p[f"{stack}/ln2"] = torch.zeros(lead + (d,), **kw)
        for name, w in L.init_mlp(gen, d, cfg.d_ff // tp, cfg.mlp_act, lead=lead,
                                  **kw).items():
            p[f"{stack}/mlp/{name}"] = w
    p["enc_norm"] = torch.zeros((d,), **kw)
    p["embed/table"] = init_embed(gen, vl, d, **kw)
    p["final_norm"] = torch.zeros((d,), **kw)
    p["unembed/w"] = init_dense(gen, d, vl, **kw)
    return p


def encode(cfg: ModelConfig, pc: ParamCtx, params, frames, *, attn_impl="auto"):
    """frames: (B, S_src, d_frontend) stub embeddings -> memory (B, S_src, D).
    ``attn_impl="flash"`` runs the encoder's self-attention through the
    flash-attention kernel, non-causal."""
    ad = attn_dims(cfg, tp=pc.ctx.tp, causal=False)
    x = L.sp_split(pc, L.dense(pc, "adapter", params["adapter"], frames.to(pc.compute_dtype)))

    def layer(x, lp):
        h = L.sp_gather(pc, L.rmsnorm(pc, "enc/ln1", lp["ln1"], x, cfg.norm_eps))
        a, _ = self_attention(pc, "enc/attn", lp["attn"], h, ad, impl=attn_impl)
        x = x + a
        h = L.sp_gather(pc, L.rmsnorm(pc, "enc/ln2", lp["ln2"], x, cfg.norm_eps))
        return x + L.mlp(pc, "enc/mlp", lp["mlp"], h, cfg.mlp_act)

    for lp in layer_views(params, cfg.n_encoder_layers, prefix="encoder/"):
        x = checkpoint(layer, x, lp, use_reentrant=False) if cfg.remat else layer(x, lp)
    return L.sp_gather(pc, L.rmsnorm(pc, "enc_norm", params["enc_norm"], x, cfg.norm_eps))


def decode_train(cfg: ModelConfig, pc: ParamCtx, params, memory, tokens, *,
                 attn_impl="auto", return_hidden=False):
    """The decoder over whole sequences: tokens (B, S) against ``memory``
    -> logits (B, S, V), or the final hidden (B, S, D)."""
    tp = pc.ctx.tp
    ad = attn_dims(cfg, tp)
    x = L.vocab_embed(pc, "embed", params["embed/table"], tokens, padded_vocab_local(cfg, tp))
    x = x.to(pc.compute_dtype)

    def layer(x, lp, memory):
        h = L.sp_gather(pc, L.rmsnorm(pc, "dec/ln1", lp["ln1"], x, cfg.norm_eps))
        a, _ = self_attention(pc, "dec/self", lp["self"], h, ad, impl=attn_impl)
        x = x + a
        h = L.sp_gather(pc, L.rmsnorm(pc, "dec/ln_x", lp["ln_x"], x, cfg.norm_eps))
        x = x + cross_attention(pc, "dec/cross", lp["cross"], h, memory, ad)
        h = L.sp_gather(pc, L.rmsnorm(pc, "dec/ln2", lp["ln2"], x, cfg.norm_eps))
        return x + L.mlp(pc, "dec/mlp", lp["mlp"], h, cfg.mlp_act)

    for lp in layer_views(params, cfg.n_layers, prefix="decoder/"):
        x = (checkpoint(layer, x, lp, memory, use_reentrant=False) if cfg.remat
             else layer(x, lp, memory))
    x = L.sp_gather(pc, L.rmsnorm(pc, "final_norm", params["final_norm"], x, cfg.norm_eps))
    if return_hidden:
        return x
    return L.vocab_logits(pc, "unembed", params["unembed/w"], x)


def train_loss(cfg: ModelConfig, pc: ParamCtx, params, batch, *, attn_impl="auto"):
    """Mean next-token cross-entropy of ``batch`` (``frames``, ``tokens``,
    ``labels``); returns ``(loss, {})`` as the reference does."""
    memory = encode(cfg, pc, params, batch["frames"], attn_impl=attn_impl)
    x = decode_train(cfg, pc, params, memory, batch["tokens"], attn_impl=attn_impl,
                     return_hidden=True)
    vl = padded_vocab_local(cfg, pc.ctx.tp)
    loss = L.fused_vocab_xent(pc, "unembed/w", params["unembed/w"], x, batch["labels"], vl,
                              vocab=cfg.vocab_size)
    return loss, {}


def init_decoder_caches(cfg: ModelConfig, batch: int, s_max: int, tp: int = 1,
                        dtype=torch.bfloat16, *, device=None, page_size=None,
                        pool_pages=None) -> dict:
    """The decoder's self caches (paged when ``page_size`` is given) and the
    cross K/V, ``(L, batch, s_max, KVl, hd)`` zeros until a prefill fills
    them: the memory is a fixed-size slab, never paged."""
    ad = attn_dims(cfg, tp)
    lead = (cfg.n_layers,)
    if page_size:
        self_caches = init_paged_kv_cache(batch, s_max, ad, dtype, page_size=page_size,
                                          pool_pages=pool_pages, device=device, lead=lead)
    else:
        self_caches = init_kv_cache(batch, s_max, ad, dtype, device=device, lead=lead)
    kv_shape = lead + (batch, s_max, ad.kv_local, ad.head_dim)
    return {"self": self_caches,
            "cross_k": torch.zeros(kv_shape, dtype=dtype, device=device),
            "cross_v": torch.zeros(kv_shape, dtype=dtype, device=device)}


def fill_cross_caches(cfg: ModelConfig, pc: ParamCtx, params, memory, caches) -> dict:
    """Every decoder layer's cross K/V over ``memory``, written into
    ``caches["cross_k"]``/``["cross_v"]`` in place."""
    ad = attn_dims(cfg, pc.ctx.tp)
    for i in range(cfg.n_layers):
        k, v = project_cross_kv(pc, "dec/cross", layer_params(params, i, "decoder/")["cross"],
                                memory, ad)
        caches["cross_k"][i].copy_(k)
        caches["cross_v"][i].copy_(v)
    return caches


def prefill(cfg: ModelConfig, pc: ParamCtx, params, frames, caches, *, attn_impl="auto",
            prompt_lens=None):
    """Run the encoder over the source frames and fill the cross K/V.  The
    decoder's self caches stay empty (decode starts from BOS), so the logits
    are ``None``: the driver seeds every slot with BOS.  ``frames`` must
    span the caches' memory length (``s_max``); ``prompt_lens`` is accepted
    for a uniform interface and ignored (the text side has no prompt)."""
    del prompt_lens
    memory = encode(cfg, pc, params, frames, attn_impl=attn_impl)
    return None, fill_cross_caches(cfg, pc, params, memory, caches)


def decode_step(cfg: ModelConfig, pc: ParamCtx, params, token, caches, *, attn_impl="auto"):
    """token: (B, 1) int -> (logits (B,1,V), caches with the self lengths
    + 1).  ``attn_impl="flash"`` sends paged self-attention through the
    flash-decode kernel; cross-attention reads the cached K/V."""
    tp = pc.ctx.tp
    ad = attn_dims(cfg, tp)
    x = L.vocab_embed(pc, "embed", params["embed/table"], token, padded_vocab_local(cfg, tp))
    x = x.to(pc.compute_dtype)
    decode_impl = "flash" if attn_impl == "flash" else "ref"
    per_layer = []
    for i in range(cfg.n_layers):
        lp = layer_params(params, i, "decoder/")
        h = L.rmsnorm(pc, "dec/ln1", lp["ln1"], x, cfg.norm_eps)
        a, nc = decode_self_attention(pc, "dec/self", lp["self"], h,
                                      layer_cache(caches["self"], i), ad, impl=decode_impl)
        per_layer.append(nc)
        x = x + a
        h = L.rmsnorm(pc, "dec/ln_x", lp["ln_x"], x, cfg.norm_eps)
        x = x + cross_attention_cached(pc, "dec/cross", lp["cross"], h, caches["cross_k"][i],
                                       caches["cross_v"][i], ad)
        h = L.rmsnorm(pc, "dec/ln2", lp["ln2"], x, cfg.norm_eps)
        x = x + L.mlp(pc, "dec/mlp", lp["mlp"], h, cfg.mlp_act)
    x = L.rmsnorm(pc, "final_norm", params["final_norm"], x, cfg.norm_eps)
    logits = L.vocab_logits(pc, "unembed", params["unembed/w"], x)
    return logits, {**caches, "self": _restack(caches["self"], per_layer)}
