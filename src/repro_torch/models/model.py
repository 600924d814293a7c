"""Family dispatch facade: one uniform surface over the model zoo.

``build_model(cfg)`` returns a :class:`Model` with

* ``init(gen, tp, device)``                     -> f32 params on ``device``
* ``train_loss(pc, params, batch, **kw)``       -> (scalar, aux)
* ``forward(pc, params, batch, **kw)``          -> logits
* ``prefill(pc, params, batch, caches, **kw)``  -> (last-position logits, caches)
* ``decode_step(pc, params, batch, caches, **kw)`` -> (logits, caches)
* ``init_caches(batch, s_max, tp, dtype, device=, page_size=, pool_pages=)``
* ``train_batch_spec(b, s)``                    -> the batch as meta tensors

The dense and MoE families (one transformer), the SSM family (mamba2) and
the hybrid (jamba) are ported; VLM and enc-dec raise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import hybrid, ssm_lm, transformer


def _tokens_spec(b: int, s: int) -> dict:
    return {"tokens": torch.empty((b, s), dtype=torch.int32, device="meta"),
            "labels": torch.empty((b, s), dtype=torch.int32, device="meta")}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable
    train_loss: Callable
    forward: Callable            # (pc, params, batch, **kw) -> logits
    train_batch_spec: Callable   # (b, s) -> {"tokens", "labels"} meta tensors
    decode_step: Callable
    init_caches: Callable
    prefill: Callable
    # whether init_caches understands page_size/pool_pages (families whose
    # decode state grows per token; SSM state is O(1): nothing to page)
    supports_paged_kv: bool = False


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family in ("dense", "moe"):
        return Model(
            cfg=cfg,
            init=lambda gen, tp, device=None: transformer.init_lm(
                cfg, gen, tp, device=device),
            train_loss=lambda pc, p, b, **kw: transformer.train_loss(cfg, pc, p, b, **kw),
            forward=lambda pc, p, b, **kw: transformer.forward(cfg, pc, p, b["tokens"],
                                                               **kw),
            train_batch_spec=_tokens_spec,
            decode_step=lambda pc, p, b, caches, **kw: transformer.decode_step(
                cfg, pc, p, b["token"], caches, **kw),
            init_caches=lambda batch, s_max, tp, dtype=torch.bfloat16, **kw:
                transformer.init_caches(cfg, batch, s_max, tp, dtype, **kw),
            prefill=lambda pc, p, b, caches, **kw: transformer.prefill(
                cfg, pc, p, b["tokens"], caches, **kw),
            supports_paged_kv=True,
        )
    if cfg.family == "ssm":
        return Model(
            cfg=cfg,
            init=lambda gen, tp, device=None: ssm_lm.init_ssm_lm(cfg, gen, tp, device=device),
            train_loss=lambda pc, p, b, **kw: ssm_lm.train_loss(cfg, pc, p, b, **kw),
            forward=lambda pc, p, b, **kw: ssm_lm.forward(cfg, pc, p, b["tokens"], **kw),
            train_batch_spec=_tokens_spec,
            decode_step=lambda pc, p, b, caches, **kw: ssm_lm.decode_step(
                cfg, pc, p, b["token"], caches),
            # constant-state mixer: nothing grows per token, nothing to page
            init_caches=lambda batch, s_max, tp, dtype=torch.bfloat16, device=None, **kw:
                ssm_lm.init_ssm_lm_caches(cfg, batch, tp, dtype, device=device),
            prefill=lambda pc, p, b, caches, **kw: ssm_lm.prefill(
                cfg, pc, p, b["tokens"], caches, **kw),
        )
    if cfg.family == "hybrid":
        return Model(
            cfg=cfg,
            init=lambda gen, tp, device=None: hybrid.init_hybrid(cfg, gen, tp, device=device),
            train_loss=lambda pc, p, b, **kw: hybrid.train_loss(cfg, pc, p, b, **kw),
            forward=lambda pc, p, b, **kw: hybrid.forward(cfg, pc, p, b["tokens"], **kw),
            train_batch_spec=_tokens_spec,
            decode_step=lambda pc, p, b, caches, **kw: hybrid.decode_step(
                cfg, pc, p, b["token"], caches, **kw),
            init_caches=lambda batch, s_max, tp, dtype=torch.bfloat16, **kw:
                hybrid.init_hybrid_caches(cfg, batch, s_max, tp, dtype, **kw),
            prefill=lambda pc, p, b, caches, **kw: hybrid.prefill(
                cfg, pc, p, b["tokens"], caches, **kw),
            supports_paged_kv=True,
        )
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet: VLM and enc-dec follow in "
        "ROADMAP queue 1, item 2")
