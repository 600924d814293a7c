"""Family dispatch facade: one uniform surface over the model zoo.

``build_model(cfg)`` returns a :class:`Model` with

* ``init(gen, tp, device)``                     -> f32 params on ``device``
* ``train_loss(pc, params, batch, **kw)``       -> (scalar, aux)
* ``forward(pc, params, batch, **kw)``          -> logits
* ``prefill(pc, params, batch, caches, **kw)``  -> (last-position logits, caches)
* ``decode_step(pc, params, batch, caches, **kw)`` -> (logits, caches)
* ``init_caches(batch, s_max, tp, dtype, device=, page_size=, pool_pages=)``
* ``train_batch_spec(b, s)``                    -> the batch as meta tensors

The dense and MoE families (one transformer) are ported so far; the other
families raise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


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
    # whether init_caches understands page_size/pool_pages
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
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet: SSM, hybrid, VLM and enc-dec "
        "follow in ROADMAP queue 1, item 2")
