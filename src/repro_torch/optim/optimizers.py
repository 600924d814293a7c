"""Optimizers over flat parameter dicts (no external deps).

The paper's server update is plain SGD in full precision (Algorithm 1
line 11); momentum/AdamW are provided for the beyond-paper experiments.
The API and the state keys are the reference's: ``init(params) -> state``;
``update(grads, state, params) -> (updates, state)`` where ``updates`` are
*added* to params.  ``state["step"]`` is an int32 tensor on the params'
device, so an update never waits for the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]


def _lr_fn(lr):
    return lr if callable(lr) else (lambda step: torch.tensor(lr, dtype=torch.float32,
                                                              device=step.device))


def _device(params: dict):
    return next(iter(params.values())).device


def sgd(lr: Callable | float, momentum: float = 0.0, weight_decay: float = 0.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        state = {"step": torch.zeros((), dtype=torch.int32, device=_device(params))}
        if momentum:
            state["mu"] = {k: torch.zeros_like(p, dtype=torch.float32)
                           for k, p in params.items()}
        return state

    def update(grads, state, params):
        step = state["step"]
        lr_t = lr_fn(step)
        g = {k: gg.to(torch.float32) for k, gg in grads.items()}
        if weight_decay:
            g = {k: gg + weight_decay * params[k].to(torch.float32) for k, gg in g.items()}
        if momentum:
            mu = {k: momentum * state["mu"][k] + gg for k, gg in g.items()}
            return {k: -lr_t * m for k, m in mu.items()}, {"step": step + 1, "mu": mu}
        return {k: -lr_t * gg for k, gg in g.items()}, {"step": step + 1}

    return Optimizer(init, update)


def adamw(lr: Callable | float, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"step": torch.zeros((), dtype=torch.int32, device=_device(params)),
                "m": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
                "v": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        stepf = step.to(torch.float32)
        g = {k: gg.to(torch.float32) for k, gg in grads.items()}
        m = {k: b1 * state["m"][k] + (1 - b1) * gg for k, gg in g.items()}
        v = {k: b2 * state["v"][k] + (1 - b2) * gg * gg for k, gg in g.items()}
        upd = {}
        for k in g:
            mh = m[k] / (1 - b1 ** stepf)
            vh = v[k] / (1 - b2 ** stepf)
            upd[k] = -lr_t * (mh / (torch.sqrt(vh) + eps)
                              + weight_decay * params[k].to(torch.float32))
        return upd, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def build_optimizer(name: str, lr, **kw) -> Optimizer:
    if name == "sgd":
        return sgd(lr, **kw)
    if name == "adamw":
        return adamw(lr, **kw)
    raise ValueError(f"unknown optimizer {name}")
