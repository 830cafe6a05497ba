"""Learning-rate schedules as step -> lr callables, in f32 as the
reference computes them. ``step`` is an int or an integer tensor; the lr
is a 0-d f32 tensor on the step's device (the CPU for an int)."""
from __future__ import annotations

import math

import torch


def _f32_step(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32)


def constant(lr: float):
    return lambda step: torch.full_like(_f32_step(step), lr)


def cosine_decay(lr: float, decay_steps: int, alpha: float = 0.0):
    def f(step):
        t = torch.clamp(_f32_step(step) / decay_steps, 0.0, 1.0)
        return lr * (alpha + (1 - alpha) * 0.5 * (1 + torch.cos(math.pi * t)))
    return f


def warmup_cosine(lr: float, warmup_steps: int, decay_steps: int,
                  alpha: float = 0.0):
    cos = cosine_decay(lr, max(decay_steps - warmup_steps, 1), alpha)

    def f(step):
        s = _f32_step(step)
        warm = lr * s / max(warmup_steps, 1)
        return torch.where(s < warmup_steps, warm, cos(s - warmup_steps))
    return f
