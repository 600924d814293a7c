"""Pure-SSM language model (mamba2 class): norm -> SSD mixer -> residual.

Counterpart of ``repro/models/ssm_lm.py``.  No attention, no per-token KV
growth: the decode state is O(1) in context length.  Parameters are the
flat path dict of the other families (``blocks/ln``, ``blocks/ssm/wx``, ...,
each ``blocks/`` leaf with its leading ``(L,)``); caches are one
layer-stacked :class:`~repro_torch.models.ssm.SSMCache`.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models.attention import merge_slot_caches
from repro_torch.models.common import (ParamCtx, init_dense, init_embed, layer_cache,
                                       layer_params, layer_views)
from repro_torch.models.hybrid import ssm_dims
from repro_torch.models.transformer import padded_vocab_local


def init_ssm_lm(cfg: ModelConfig, gen: torch.Generator, tp: int = 1, *, device=None,
                dtype=torch.float32) -> dict:
    """Random f32 parameters drawn on ``device`` from ``gen``, keyed by path."""
    vl = padded_vocab_local(cfg, tp)
    d, nl = cfg.d_model, (cfg.n_layers,)
    kw = {"device": device, "dtype": dtype}
    p = {"embed/table": init_embed(gen, vl, d, **kw),
         "blocks/ln": torch.zeros(nl + (d,), **kw)}
    for name, w in ssm.init_ssm(gen, ssm_dims(cfg, tp), lead=nl, **kw).items():
        p[f"blocks/ssm/{name}"] = w
    p["final_norm"] = torch.zeros((d,), **kw)
    p["unembed/w"] = init_dense(gen, d, vl, **kw)
    return p


def forward(cfg: ModelConfig, pc: ParamCtx, params, tokens, *, attn_impl="auto",
            return_hidden=False):
    """tokens: (B, S) -> logits (B, S, V), or the final hidden (B, S, D)."""
    del attn_impl  # no attention in this family
    tp = pc.ctx.tp
    sd = ssm_dims(cfg, tp)
    x = L.vocab_embed(pc, "embed", params["embed/table"], tokens, padded_vocab_local(cfg, tp))
    x = x.to(pc.compute_dtype)

    def block(x, lp):
        h = L.sp_gather(pc, L.rmsnorm(pc, "blocks/ln", lp["ln"], x, cfg.norm_eps))
        return x + ssm.ssm_block(pc, "blocks/ssm", lp["ssm"], h, sd)

    for lp in layer_views(params, cfg.n_layers):
        x = checkpoint(block, x, lp, use_reentrant=False) if cfg.remat else block(x, lp)
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


def init_ssm_lm_caches(cfg: ModelConfig, batch: int, tp: int = 1, dtype=torch.bfloat16,
                       *, device=None) -> ssm.SSMCache:
    return ssm.init_ssm_cache(batch, ssm_dims(cfg, tp), dtype, device=device,
                              lead=(cfg.n_layers,))


def prefill(cfg: ModelConfig, pc: ParamCtx, params, tokens, caches,
            *, attn_impl="auto", prompt_lens=None):
    """SSM prefill: the recurrence run over the prompt as a loop of decode
    steps (the state update IS the prefill for a constant-state mixer).
    tokens: (B, S_p).  Returns (last-position logits, caches).

    ``prompt_lens`` (B,): per-slot true lengths under bucketed
    (right-padded) prompts; each slot's state stops advancing at its own
    length, so padding never enters the recurrence."""
    del attn_impl  # no attention in this family
    return prefill_by_decode(lambda t, c: decode_step(cfg, pc, params, t, c),
                             tokens, caches, prompt_lens)


def prefill_by_decode(step_fn, tokens, caches, prompt_lens=None):
    """Prefill of a recurrent family as a loop of decode steps.

    ``step_fn(token (B,1), caches) -> (logits (B,1,V), caches)``.  With
    ``prompt_lens`` every cache leaf advances per slot only while the step
    index is inside that slot's prompt (:func:`merge_slot_caches`), and the
    logits returned are each slot's own last-position logits.  A step's SSM
    state is new tensors, so a padded step cannot reach the state a slot
    keeps.  Attention sublayers write their token's K/V in place at
    ``length[b]``: a padded step writes at the slot's frozen length, which
    the next real token (the first decode step) overwrites before it
    attends there.
    """
    if prompt_lens is None:
        for i in range(tokens.shape[1]):
            logits, caches = step_fn(tokens[:, i:i + 1], caches)
        return logits, caches
    plens = prompt_lens.to(torch.int32)
    last = None
    for i in range(tokens.shape[1]):
        logits, new = step_fn(tokens[:, i:i + 1], caches)
        caches = merge_slot_caches(caches, new, i < plens)
        if last is None:
            last = torch.zeros_like(logits)
        last = torch.where((plens - 1 == i)[:, None, None], logits, last)
    return last, caches


def decode_step(cfg: ModelConfig, pc: ParamCtx, params, token, caches):
    """token: (B, 1) int -> (logits (B,1,V), new caches)."""
    tp = pc.ctx.tp
    sd = ssm_dims(cfg, tp)
    x = L.vocab_embed(pc, "embed", params["embed/table"], token, padded_vocab_local(cfg, tp))
    x = x.to(pc.compute_dtype)
    per_layer = []
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h = L.rmsnorm(pc, "blocks/ln", lp["ln"], x, cfg.norm_eps)
        a, nc = ssm.ssm_decode_step(pc, "blocks/ssm", lp["ssm"], h,
                                    layer_cache(caches, i), sd)
        x = x + a
        per_layer.append(nc)
    x = L.rmsnorm(pc, "final_norm", params["final_norm"], x, cfg.norm_eps)
    return L.vocab_logits(pc, "unembed", params["unembed/w"], x), ssm.stack_caches(per_layer)
