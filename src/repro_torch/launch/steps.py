"""Serving step builders: greedy decode step and prefill-into-slots.

Counterparts of ``build_decode_step`` / ``build_cached_prefill`` /
``init_global_caches`` in ``repro/launch/steps.py`` as plain callables on
one device: no ``shard_map``, no jit — PyTorch runs eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.collectives import AxisCtx
from repro_torch.models.common import ParamCtx
from repro_torch.models.model import Model


def _compute_dtype(cfg: ModelConfig):
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


@dataclasses.dataclass(frozen=True)
class ServeStep:
    fn: Any


def _greedy_pick(axes: AxisCtx, tp: int, vl: int, logits):
    """Greedy token over logits (B, 1, V) -> (B, 1) int32; the first index
    wins a tie, as ``jnp.argmax`` does."""
    lg = logits[:, -1, :].to(torch.float32)
    iloc = torch.argmax(lg, dim=-1).to(torch.int32) + axes.tp_index() * vl
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
    """Allocate the decode caches of a launch (one device: global == local).

    ``page_size``/``pool_pages`` select the paged KV layout; its page tables
    start all-unallocated (-1), everything else zeroed.  ``device="meta"``
    gives the shapes without allocating.
    """
    return model.init_caches(batch_global, s_max, axes.tp, dtype=dtype, device=device,
                             **_cache_kwargs(page_size, pool_pages))


def build_decode_step(model: Model, axes: AxisCtx, *, policy=None,
                      attn_impl: str = "ref") -> ServeStep:
    """One-token decode step with greedy sampling.

    ``fn(params, {"token": (B, 1)}, caches) -> (next (B, 1) int32, caches)``.
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
                         policy=None) -> ServeStep:
    """Prefill-into-slots step for continuous batching.

    ``fn(params, batch, caches, slot_mask, prompt_lens=None) ->
    (first_token (B, 1), merged_caches)``: runs the model's prefill over a
    fresh zeroed copy of the caches, then merges ONLY the slots selected by
    ``slot_mask`` into the live caches (in place), so new requests join a
    mid-flight batch without disturbing the sequences still decoding in the
    other slots.  Paged caches merge at page granularity through the live
    page tables, which the driver must have set for the admitted slots
    BEFORE this call.  ``prompt_lens`` (B,) keeps each right-padded prompt's
    true length (cache stamps, last-position logits).
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
        tok = _greedy_pick(axes, axes.tp, vl, logits)
        return tok, merge_slot_caches(caches, filled, slot_mask)

    return ServeStep(fn=fn)

