"""Learning-rate schedules (pure functions of the int32 step tensor)."""

from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32, device=step.device)


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        t = torch.clamp(step / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return (lr * (final_frac + (1 - final_frac) * cos)).to(torch.float32)
    return f


def warmup_cosine(lr: float, warmup: int, total_steps: int, final_frac: float = 0.1):
    decay = cosine_decay(lr, max(total_steps - warmup, 1), final_frac)

    def f(step):
        w = torch.clamp(step / max(warmup, 1), 0.0, 1.0)
        return torch.where(step < warmup, lr * w, decay(step - warmup)).to(torch.float32)
    return f
