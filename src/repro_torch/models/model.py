"""Family dispatch facade: one uniform surface over the model zoo.

``build_model(cfg)`` returns a :class:`Model` with

* ``init(gen, tp, device)``                     -> f32 params on ``device``
* ``train_loss(pc, params, batch, **kw)``       -> (scalar, aux)
* ``forward(pc, params, batch, **kw)``          -> logits
* ``prefill(pc, params, batch, caches, **kw)``  -> (last-position logits, caches)
* ``decode_step(pc, params, batch, caches, **kw)`` -> (logits, caches)
* ``init_caches(batch, s_max, tp, dtype, device=, page_size=, pool_pages=)``
* ``train_batch_spec(b, s)``                    -> the batch as meta tensors
* ``prefill_batch_spec(b, s_prompt, s_max)``    -> the prefill's batch as meta
  tensors: tokens, plus ``images`` (VLM); ``frames`` spanning ``s_max`` and
  no tokens (enc-dec)

Every family of the reference is ported: dense and MoE (one transformer),
SSM (mamba2), the hybrid (jamba), VLM (llama-3.2-vision) and enc-dec
(seamless-m4t).  An enc-dec prefill returns ``None`` logits: the driver
seeds decoding with BOS.  Every family serves and trains under tensor
parallelism (a model axis above 1, one rank a model shard).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, hybrid, ssm_lm, transformer, vlm


def _meta(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _tokens_spec(b: int, s: int) -> dict:
    return {"tokens": _meta((b, s)), "labels": _meta((b, s))}


def _token_prefill_spec(b: int, s_prompt: int, s_max: int) -> dict:
    return {"tokens": _meta((b, s_prompt))}


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
    # (b, s_prompt, s_max) -> the prefill batch as meta tensors
    prefill_batch_spec: Callable = _token_prefill_spec
    # whether init_caches understands page_size/pool_pages (families whose
    # decode state grows per token; SSM state is O(1): nothing to page)
    supports_paged_kv: bool = False


def count_passes(model: Model, passes: dict, ticks: list | None = None) -> Model:
    """``model`` with each call of its ``prefill`` and ``decode_step`` added
    to ``passes["prefill"]`` / ``passes["decode"]`` (a data shard's call is
    one) and, where ``ticks`` is given, each decode call's start on the host
    clock (``time.perf_counter``) appended to it."""
    def counted(fn, kind):
        def call(*a, **kw):
            passes[kind] += 1
            if ticks is not None and kind == "decode":
                ticks.append(time.perf_counter())
            return fn(*a, **kw)
        return call

    return dataclasses.replace(model, prefill=counted(model.prefill, "prefill"),
                               decode_step=counted(model.decode_step, "decode"))


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
    d_front = cfg.d_frontend or cfg.d_model
    if cfg.family == "encdec":
        return Model(
            cfg=cfg,
            init=lambda gen, tp, device=None: encdec.init_encdec(cfg, gen, tp, device=device),
            train_loss=lambda pc, p, b, **kw: encdec.train_loss(cfg, pc, p, b, **kw),
            forward=lambda pc, p, b, **kw: encdec.decode_train(
                cfg, pc, p, encdec.encode(cfg, pc, p, b["frames"], **kw), b["tokens"], **kw),
            train_batch_spec=lambda b, s: {"frames": _meta((b, s, d_front), torch.float32),
                                           **_tokens_spec(b, s)},
            decode_step=lambda pc, p, b, caches, **kw: encdec.decode_step(
                cfg, pc, p, b["token"], caches, **kw),
            init_caches=lambda batch, s_max, tp, dtype=torch.bfloat16, **kw:
                encdec.init_decoder_caches(cfg, batch, s_max, tp, dtype, **kw),
            prefill=lambda pc, p, b, caches, **kw: encdec.prefill(
                cfg, pc, p, b["frames"], caches, **kw),
            # the cross caches are sized by s_max, so the source spans it
            prefill_batch_spec=lambda b, s_prompt, s_max: {
                "frames": _meta((b, s_max, d_front), torch.float32)},
            supports_paged_kv=True,
        )
    if cfg.family == "vlm":
        n_img = cfg.n_image_tokens or 1601
        return Model(
            cfg=cfg,
            init=lambda gen, tp, device=None: vlm.init_vlm(cfg, gen, tp, device=device),
            train_loss=lambda pc, p, b, **kw: vlm.train_loss(cfg, pc, p, b, **kw),
            forward=lambda pc, p, b, **kw: vlm.forward(cfg, pc, p, b["tokens"], b["images"],
                                                       **kw),
            train_batch_spec=lambda b, s: {"images": _meta((b, n_img, d_front), torch.float32),
                                           **_tokens_spec(b, s)},
            decode_step=lambda pc, p, b, caches, **kw: vlm.decode_step(
                cfg, pc, p, b["token"], caches, **kw),
            init_caches=lambda batch, s_max, tp, dtype=torch.bfloat16, **kw:
                vlm.init_vlm_caches(cfg, batch, s_max, tp, dtype, **kw),
            prefill=lambda pc, p, b, caches, **kw: vlm.prefill(
                cfg, pc, p, b["tokens"], b["images"], caches, **kw),
            prefill_batch_spec=lambda b, s_prompt, s_max: {
                "tokens": _meta((b, s_prompt)),
                "images": _meta((b, n_img, d_front), torch.float32)},
            supports_paged_kv=True,
        )
    raise ValueError(f"unknown family {cfg.family!r}")
