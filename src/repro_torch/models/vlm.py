"""Vision-language backbone (llama-3.2-vision class).

Counterpart of ``repro/models/vlm.py``.  The layers come in periods of one
gated cross-attention layer and ``cross_attn_period - 1`` self-attention
layers (llama-3.2-vision-90b: 20 periods of 1 + 4).  The vision frontend is
a stub: precomputed patch embeddings ``(B, n_image_tokens, d_frontend)`` go
through a linear adapter to the backbone width and serve as the
cross-attention memory.

Parameters are ``adapter``, ``embed/table``, ``periods/cross/...`` and
``periods/self{j}/...`` (each with a leading ``(n_periods,)``; the gates
``periods/cross/gate`` and ``periods/cross/mlp_gate`` are ``(n_periods,)``
zeros, so a fresh model ignores its images), ``final_norm``, ``unembed/w``.
Caches are ``{"self{j}": cache, "cross_k": tensor, "cross_v": tensor}``:
each self-attention sublayer's cache stacked over the periods (paged or
contiguous, written in place) and the cross K/V over the image memory,
``(n_periods, B, n_img, KVl, hd)`` bare tensors filled at prefill.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.attention import (cross_attention, cross_attention_cached,
                                          decode_self_attention, init_attention,
                                          init_kv_cache, init_paged_kv_cache,
                                          prefill_kv_cache, project_cross_kv,
                                          self_attention)
from repro_torch.models.common import (ParamCtx, init_dense, init_embed, layer_cache,
                                       layer_params, layer_views)
from repro_torch.models.transformer import (_restack, attn_dims, last_position_logits,
                                            padded_vocab_local)


def n_periods(cfg: ModelConfig) -> int:
    if cfg.n_layers % cfg.cross_attn_period:
        raise ValueError(f"{cfg.n_layers} layers are not whole periods of "
                         f"{cfg.cross_attn_period}")
    return cfg.n_layers // cfg.cross_attn_period


def init_vlm(cfg: ModelConfig, gen: torch.Generator, tp: int = 1, *, device=None,
             dtype=torch.float32) -> dict:
    """Random f32 parameters drawn on ``device`` from ``gen``, keyed by path."""
    lead = (n_periods(cfg),)
    ad = attn_dims(cfg, tp)
    vl = padded_vocab_local(cfg, tp)
    d = cfg.d_model
    kw = {"device": device, "dtype": dtype}
    p = {"adapter": init_dense(gen, cfg.d_frontend or d, d, **kw),
         "embed/table": init_embed(gen, vl, d, **kw)}
    for j in range(-1, cfg.cross_attn_period - 1):
        pre, ln = ("periods/cross", "ln") if j < 0 else (f"periods/self{j}", "ln1")
        p[f"{pre}/{ln}"] = torch.zeros(lead + (d,), **kw)
        p.update({f"{pre}/attn/{k}": w
                  for k, w in init_attention(gen, ad, lead=lead, **kw).items()})
        p[f"{pre}/ln2"] = torch.zeros(lead + (d,), **kw)
        p.update({f"{pre}/mlp/{k}": w for k, w in L.init_mlp(
            gen, d, cfg.d_ff // tp, cfg.mlp_act, lead=lead, **kw).items()})
        if j < 0:   # zero-initialised tanh gates (llama 3.2), f32 as in the reference
            p["periods/cross/gate"] = torch.zeros(lead, dtype=torch.float32, device=device)
            p["periods/cross/mlp_gate"] = torch.zeros(lead, dtype=torch.float32,
                                                      device=device)
    p["final_norm"] = torch.zeros((d,), **kw)
    p["unembed/w"] = init_dense(gen, d, vl, **kw)
    return p


def _gated(x, gate, y):
    return x + torch.tanh(gate).to(x.dtype) * y


def _cross_mlp(cfg: ModelConfig, pc: ParamCtx, cp, x, a):
    """The cross layer after its attention output ``a``: the gated residual,
    then the gated MLP."""
    x = _gated(x, cp["gate"], a)
    h = L.sp_gather(pc, L.rmsnorm(pc, "cross/ln2", cp["ln2"], x, cfg.norm_eps))
    return _gated(x, cp["mlp_gate"], L.mlp(pc, "cross/mlp", cp["mlp"], h, cfg.mlp_act))


def _self_mlp(cfg: ModelConfig, pc: ParamCtx, j: int, sp, x):
    h = L.sp_gather(pc, L.rmsnorm(pc, f"self{j}/ln2", sp["ln2"], x, cfg.norm_eps))
    return x + L.mlp(pc, f"self{j}/mlp", sp["mlp"], h, cfg.mlp_act)


def _period_fn(cfg: ModelConfig, pc: ParamCtx, tp: int, attn_impl: str):
    ad = attn_dims(cfg, tp)

    def period(x, pp, memory):
        cp = pp["cross"]
        h = L.sp_gather(pc, L.rmsnorm(pc, "cross/ln", cp["ln"], x, cfg.norm_eps))
        x = _cross_mlp(cfg, pc, cp, x, cross_attention(pc, "cross/attn", cp["attn"], h,
                                                       memory, ad))
        for j in range(cfg.cross_attn_period - 1):
            sp = pp[f"self{j}"]
            h = L.sp_gather(pc, L.rmsnorm(pc, f"self{j}/ln1", sp["ln1"], x, cfg.norm_eps))
            a, _ = self_attention(pc, f"self{j}/attn", sp["attn"], h, ad, impl=attn_impl)
            x = _self_mlp(cfg, pc, j, sp, x + a)
        return x

    return period


def _memory(pc: ParamCtx, params, images):
    return L.dense(pc, "adapter", params["adapter"], images.to(pc.compute_dtype))


def forward(cfg: ModelConfig, pc: ParamCtx, params, tokens, images, *, attn_impl="auto",
            return_hidden=False):
    """tokens: (B, S); images: (B, n_img, d_frontend) stub patch embeddings
    -> logits (B, S, V), or the final hidden (B, S, D)."""
    tp = pc.ctx.tp
    memory = _memory(pc, params, images)
    x = L.vocab_embed(pc, "embed", params["embed/table"], tokens, padded_vocab_local(cfg, tp))
    x = x.to(pc.compute_dtype)
    period = _period_fn(cfg, pc, tp, attn_impl)
    for pp in layer_views(params, n_periods(cfg), prefix="periods/"):
        x = (checkpoint(period, x, pp, memory, use_reentrant=False) if cfg.remat
             else period(x, pp, memory))
    x = L.sp_gather(pc, L.rmsnorm(pc, "final_norm", params["final_norm"], x, cfg.norm_eps))
    if return_hidden:
        return x
    return L.vocab_logits(pc, "unembed", params["unembed/w"], x)


def train_loss(cfg: ModelConfig, pc: ParamCtx, params, batch, *, attn_impl="auto"):
    """Mean next-token cross-entropy of ``batch`` (``tokens``, ``images``,
    ``labels``); returns ``(loss, {})`` as the reference does."""
    x = forward(cfg, pc, params, batch["tokens"], batch["images"], attn_impl=attn_impl,
                return_hidden=True)
    vl = padded_vocab_local(cfg, pc.ctx.tp)
    loss = L.fused_vocab_xent(pc, "unembed/w", params["unembed/w"], x, batch["labels"], vl,
                              vocab=cfg.vocab_size)
    return loss, {}


def init_vlm_caches(cfg: ModelConfig, batch: int, s_max: int, tp: int = 1,
                    dtype=torch.bfloat16, *, device=None, page_size=None,
                    pool_pages=None) -> dict:
    """Each self-attention sublayer's cache stacked over the periods (paged
    when ``page_size`` is given) and the cross K/V, ``(n_periods, batch,
    n_img, KVl, hd)`` zeros until a prefill fills them."""
    lead = (n_periods(cfg),)
    ad = attn_dims(cfg, tp)
    caches = {}
    for j in range(cfg.cross_attn_period - 1):
        caches[f"self{j}"] = (
            init_paged_kv_cache(batch, s_max, ad, dtype, page_size=page_size,
                                pool_pages=pool_pages, device=device, lead=lead)
            if page_size else init_kv_cache(batch, s_max, ad, dtype, device=device, lead=lead))
    kv_shape = lead + (batch, cfg.n_image_tokens or 1601, ad.kv_local, ad.head_dim)
    caches["cross_k"] = torch.zeros(kv_shape, dtype=dtype, device=device)
    caches["cross_v"] = torch.zeros(kv_shape, dtype=dtype, device=device)
    return caches


def fill_cross_caches(cfg: ModelConfig, pc: ParamCtx, params, images, caches) -> dict:
    """Project the image memory and write every period's cross K/V into
    ``caches["cross_k"]``/``["cross_v"]`` in place."""
    ad = attn_dims(cfg, pc.ctx.tp)
    memory = _memory(pc, params, images)
    for i in range(n_periods(cfg)):
        cp = layer_params(params, i, prefix="periods/")["cross"]
        k, v = project_cross_kv(pc, "cross/attn", cp["attn"], memory, ad)
        caches["cross_k"][i].copy_(k)
        caches["cross_v"][i].copy_(v)
    return caches


def prefill(cfg: ModelConfig, pc: ParamCtx, params, tokens, images, caches, *,
            attn_impl="auto", prompt_lens=None):
    """Project the image memory, fill every period's cross K/V, and run the
    prompt through the self-attention layers, writing their K/V and
    per-slot lengths (``prompt_lens`` under bucketed, right-padded prompts)
    in place.  Returns (last-position logits (B, 1, V), caches).

    The period body is :func:`decode_step`'s over a whole prompt; a change
    to the period's math in :func:`_period_fn` belongs in both."""
    tp = pc.ctx.tp
    ad = attn_dims(cfg, tp)
    memory = _memory(pc, params, images)
    x = L.vocab_embed(pc, "embed", params["embed/table"], tokens, padded_vocab_local(cfg, tp))
    x = x.to(pc.compute_dtype)
    per = {f"self{j}": [] for j in range(cfg.cross_attn_period - 1)}
    for i in range(n_periods(cfg)):
        pp = layer_params(params, i, prefix="periods/")
        cp = pp["cross"]
        ck, cv = project_cross_kv(pc, "cross/attn", cp["attn"], memory, ad)
        h = L.rmsnorm(pc, "cross/ln", cp["ln"], x, cfg.norm_eps)
        x = _cross_mlp(cfg, pc, cp, x, cross_attention_cached(pc, "cross/attn", cp["attn"],
                                                              h, ck, cv, ad))
        caches["cross_k"][i].copy_(ck)
        caches["cross_v"][i].copy_(cv)
        for j in range(cfg.cross_attn_period - 1):
            sp = pp[f"self{j}"]
            h = L.rmsnorm(pc, f"self{j}/ln1", sp["ln1"], x, cfg.norm_eps)
            a, (k, v) = self_attention(pc, f"self{j}/attn", sp["attn"], h, ad,
                                       impl=attn_impl)
            per[f"self{j}"].append(prefill_kv_cache(pc, layer_cache(caches[f"self{j}"], i),
                                                    k, v, ad, prompt_lens))
            x = _self_mlp(cfg, pc, j, sp, x + a)
    x = L.rmsnorm(pc, "final_norm", params["final_norm"], x, cfg.norm_eps)
    out = {**caches, **{name: _restack(caches[name], c) for name, c in per.items()}}
    return last_position_logits(pc, params, x, prompt_lens), out


def decode_step(cfg: ModelConfig, pc: ParamCtx, params, token, caches, *, attn_impl="auto"):
    """token: (B, 1) int -> (logits (B,1,V), caches with the self lengths
    + 1).  Cross-attention reads the cached K/V; ``attn_impl="flash"`` sends
    paged self-attention through the flash-decode kernel."""
    tp = pc.ctx.tp
    ad = attn_dims(cfg, tp)
    x = L.vocab_embed(pc, "embed", params["embed/table"], token, padded_vocab_local(cfg, tp))
    x = x.to(pc.compute_dtype)
    decode_impl = "flash" if attn_impl == "flash" else "ref"
    per = {f"self{j}": [] for j in range(cfg.cross_attn_period - 1)}
    for i in range(n_periods(cfg)):
        pp = layer_params(params, i, prefix="periods/")
        cp = pp["cross"]
        h = L.rmsnorm(pc, "cross/ln", cp["ln"], x, cfg.norm_eps)
        x = _cross_mlp(cfg, pc, cp, x, cross_attention_cached(
            pc, "cross/attn", cp["attn"], h, caches["cross_k"][i], caches["cross_v"][i], ad))
        for j in range(cfg.cross_attn_period - 1):
            sp = pp[f"self{j}"]
            h = L.rmsnorm(pc, f"self{j}/ln1", sp["ln1"], x, cfg.norm_eps)
            a, nc = decode_self_attention(pc, f"self{j}/attn", sp["attn"], h,
                                          layer_cache(caches[f"self{j}"], i), ad,
                                          impl=decode_impl)
            per[f"self{j}"].append(nc)
            x = _self_mlp(cfg, pc, j, sp, x + a)
    x = L.rmsnorm(pc, "final_norm", params["final_norm"], x, cfg.norm_eps)
    logits = L.vocab_logits(pc, "unembed", params["unembed/w"], x)
    return logits, {**caches, **{name: _restack(caches[name], c) for name, c in per.items()}}
