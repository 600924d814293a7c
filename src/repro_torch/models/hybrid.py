"""Jamba-style hybrid: Mamba2 + attention (1:``attn_period``) with periodic MoE.

Counterpart of ``repro/models/hybrid.py``.  Layer pattern (period =
``attn_period``, default 8):

* sublayer 0: attention mixer;
* sublayers 1..p-1: mamba2 (SSD) mixers;
* the ffn of sublayer j: MoE when ``j % moe_period == 0`` (jamba: every 2nd
  layer), dense MLP otherwise.

Parameters are ``periods/sub{j}/{ln1,ln2,mixer/...,ffn/...}``, each with a
leading ``(n_periods,)``; a Python loop over the periods takes the place of
the reference's ``lax.scan`` and the sublayers inside a period are unrolled.
Caches are ``{"sub{j}": cache}``: a layer-stacked :class:`KVCache` or
:class:`PagedKVCache` for the attention sublayer (written in place), an
:class:`~repro_torch.models.ssm.SSMCache` for each mamba sublayer (new
tensors every step).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models.attention import (decode_self_attention, init_attention,
                                          init_kv_cache, init_paged_kv_cache,
                                          self_attention)
from repro_torch.models.common import (ParamCtx, init_dense, init_embed, layer_cache,
                                       layer_params, layer_views)
from repro_torch.models.moe import init_moe, moe_block
from repro_torch.models.transformer import attn_dims, moe_dims, padded_vocab_local


def ssm_dims(cfg: ModelConfig, tp: int) -> ssm.SSMDims:
    return ssm.SSMDims(
        d_model=cfg.d_model, d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
        expand=cfg.ssm_expand, conv_width=cfg.ssm_conv_width,
        chunk=cfg.ssm_chunk, tp=tp,
    )


def _layer_kinds(cfg: ModelConfig):
    """Per-sublayer (mixer, ffn) kinds within one period."""
    kinds = []
    for j in range(cfg.attn_period):
        mixer = "attn" if j == 0 else "ssm"
        ffn = "moe" if (j % max(cfg.moe_period, 1)) == 0 and cfg.n_experts else "mlp"
        kinds.append((mixer, ffn))
    return kinds


def init_hybrid(cfg: ModelConfig, gen: torch.Generator, tp: int = 1, *, device=None,
                dtype=torch.float32) -> dict:
    """Random f32 parameters drawn on ``device`` from ``gen``, keyed by path."""
    if cfg.n_layers % cfg.attn_period:
        raise ValueError(f"{cfg.n_layers} layers are not whole periods of "
                         f"{cfg.attn_period}")
    lead = (cfg.n_layers // cfg.attn_period,)
    d = cfg.d_model
    kw = {"device": device, "dtype": dtype}
    vl = padded_vocab_local(cfg, tp)
    p = {"embed/table": init_embed(gen, vl, d, **kw)}
    for j, (mixer, ffn) in enumerate(_layer_kinds(cfg)):
        pre = f"periods/sub{j}"
        p[f"{pre}/ln1"] = torch.zeros(lead + (d,), **kw)
        p[f"{pre}/ln2"] = torch.zeros(lead + (d,), **kw)
        mix = (init_attention(gen, attn_dims(cfg, tp), lead=lead, **kw) if mixer == "attn"
               else ssm.init_ssm(gen, ssm_dims(cfg, tp), lead=lead, **kw))
        p.update({f"{pre}/mixer/{k}": w for k, w in mix.items()})
        ff = (init_moe(gen, moe_dims(cfg, tp), lead=lead, **kw) if ffn == "moe"
              else L.init_mlp(gen, d, cfg.d_ff // tp, cfg.mlp_act, lead=lead, **kw))
        p.update({f"{pre}/ffn/{k}": w for k, w in ff.items()})
    p["final_norm"] = torch.zeros((d,), **kw)
    p["unembed/w"] = init_dense(gen, d, vl, **kw)
    return p


def _ffn(cfg: ModelConfig, pc: ParamCtx, j: int, kind: str, sp, h, md):
    if kind == "moe":
        return moe_block(pc, f"sub{j}/moe", sp["ffn"], h, md)[0]
    return L.mlp(pc, f"sub{j}/mlp", sp["ffn"], h, cfg.mlp_act)


def _period_fn(cfg: ModelConfig, pc: ParamCtx, tp: int, attn_impl: str):
    ad, sd, md = attn_dims(cfg, tp), ssm_dims(cfg, tp), moe_dims(cfg, tp)
    kinds = _layer_kinds(cfg)

    def period(x, pp):
        for j, (mixer, ffn) in enumerate(kinds):
            sp = pp[f"sub{j}"]
            h = L.sp_gather(pc, L.rmsnorm(pc, f"sub{j}/ln1", sp["ln1"], x, cfg.norm_eps))
            if mixer == "attn":
                a, _ = self_attention(pc, f"sub{j}/attn", sp["mixer"], h, ad, impl=attn_impl)
            else:
                a = ssm.ssm_block(pc, f"sub{j}/ssm", sp["mixer"], h, sd)
            x = x + a
            h = L.sp_gather(pc, L.rmsnorm(pc, f"sub{j}/ln2", sp["ln2"], x, cfg.norm_eps))
            x = x + _ffn(cfg, pc, j, ffn, sp, h, md)
        return x

    return period


def forward(cfg: ModelConfig, pc: ParamCtx, params, tokens, *, attn_impl="auto",
            return_hidden=False):
    """tokens: (B, S) -> logits (B, S, V), or the final hidden (B, S, D)."""
    tp = pc.ctx.tp
    x = L.vocab_embed(pc, "embed", params["embed/table"], tokens, padded_vocab_local(cfg, tp))
    x = x.to(pc.compute_dtype)
    period = _period_fn(cfg, pc, tp, attn_impl)
    for pp in layer_views(params, cfg.n_layers // cfg.attn_period, prefix="periods/"):
        x = checkpoint(period, x, pp, use_reentrant=False) if cfg.remat else period(x, pp)
    x = L.sp_gather(pc, L.rmsnorm(pc, "final_norm", params["final_norm"], x, cfg.norm_eps))
    if return_hidden:
        return x
    return L.vocab_logits(pc, "unembed", params["unembed/w"], x)


def train_loss(cfg: ModelConfig, pc: ParamCtx, params, batch, *, attn_impl="auto"):
    x = forward(cfg, pc, params, batch["tokens"], attn_impl=attn_impl, return_hidden=True)
    vl = padded_vocab_local(cfg, pc.ctx.tp)
    loss = L.fused_vocab_xent(pc, "unembed/w", params["unembed/w"], x, batch["labels"], vl,
                              vocab=cfg.vocab_size)
    return loss, {}


# ---------------------------------------------------------------------------
# Decode: attention sublayers carry a KV cache, mamba sublayers an SSM state.
# ---------------------------------------------------------------------------


def init_hybrid_caches(cfg: ModelConfig, batch: int, s_max: int, tp: int = 1,
                       dtype=torch.bfloat16, *, device=None, page_size=None,
                       pool_pages=None) -> dict:
    """``{"sub{j}": cache}`` stacked over the periods; ``page_size`` selects
    the paged layout for the attention sublayers."""
    lead = (cfg.n_layers // cfg.attn_period,)
    caches = {}
    for j, (mixer, _kind) in enumerate(_layer_kinds(cfg)):
        if mixer == "ssm":
            caches[f"sub{j}"] = ssm.init_ssm_cache(batch, ssm_dims(cfg, tp), dtype,
                                                   device=device, lead=lead)
        elif page_size:
            caches[f"sub{j}"] = init_paged_kv_cache(
                batch, s_max, attn_dims(cfg, tp), dtype, page_size=page_size,
                pool_pages=pool_pages, device=device, lead=lead)
        else:
            caches[f"sub{j}"] = init_kv_cache(batch, s_max, attn_dims(cfg, tp), dtype,
                                              device=device, lead=lead)
    return caches


def prefill(cfg: ModelConfig, pc: ParamCtx, params, tokens, caches,
            *, attn_impl="auto", prompt_lens=None):
    """Hybrid prefill: a loop of decode steps over the prompt.  The SSM
    sublayers advance their state and the attention sublayers fill their KV
    caches through the gather path (``attn_impl`` is not passed on, as in
    the reference: the flash-decode kernel runs in the serving decode steps
    only).  tokens: (B, S_p).  Returns (last-position logits, caches)."""
    del attn_impl
    from repro_torch.models.ssm_lm import prefill_by_decode

    return prefill_by_decode(lambda t, c: decode_step(cfg, pc, params, t, c),
                             tokens, caches, prompt_lens)


def decode_step(cfg: ModelConfig, pc: ParamCtx, params, token, caches, *, attn_impl="auto"):
    """token: (B, 1) int -> (logits (B,1,V), caches).  ``attn_impl="flash"``
    sends paged attention through the flash-decode kernel."""
    tp = pc.ctx.tp
    ad, sd, md = attn_dims(cfg, tp), ssm_dims(cfg, tp), moe_dims(cfg, tp)
    kinds = _layer_kinds(cfg)
    x = L.vocab_embed(pc, "embed", params["embed/table"], token, padded_vocab_local(cfg, tp))
    x = x.to(pc.compute_dtype)
    decode_impl = "flash" if attn_impl == "flash" else "ref"
    new = {f"sub{j}": [] for j in range(len(kinds))}
    for i in range(cfg.n_layers // cfg.attn_period):
        pp = layer_params(params, i, prefix="periods/")
        for j, (mixer, ffn) in enumerate(kinds):
            sp, cache = pp[f"sub{j}"], caches[f"sub{j}"]
            h = L.rmsnorm(pc, f"sub{j}/ln1", sp["ln1"], x, cfg.norm_eps)
            if mixer == "attn":
                a, nc = decode_self_attention(pc, f"sub{j}/attn", sp["mixer"], h,
                                              layer_cache(cache, i), ad, impl=decode_impl)
            else:
                a, nc = ssm.ssm_decode_step(pc, f"sub{j}/ssm", sp["mixer"], h,
                                            layer_cache(cache, i), sd)
            new[f"sub{j}"].append(nc)
            x = x + a
            h = L.rmsnorm(pc, f"sub{j}/ln2", sp["ln2"], x, cfg.norm_eps)
            x = x + _ffn(cfg, pc, j, ffn, sp, h, md)
    x = L.rmsnorm(pc, "final_norm", params["final_norm"], x, cfg.norm_eps)
    logits = L.vocab_logits(pc, "unembed", params["unembed/w"], x)
    out = {}
    for j, (mixer, _kind) in enumerate(kinds):
        per, cache = new[f"sub{j}"], caches[f"sub{j}"]
        # attention: the pools were written in place, the lengths are new
        out[f"sub{j}"] = (ssm.stack_caches(per) if mixer == "ssm" else
                          cache._replace(length=torch.stack([c.length for c in per])))
    return logits, out
