"""Learning-rate schedules, as `tpu_dist.train.schedule`: ``f(step) -> lr``,
computed in float32 as there (a 0-d float32 tensor on the CPU)."""

from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def constant(lr: float):
    return lambda step: _f32(lr)


def cosine(base_lr: float, total_steps: int, *, warmup_steps: int = 0):
    """Linear warmup to ``base_lr`` then cosine decay to zero."""
    if total_steps <= warmup_steps:
        raise ValueError(
            f"total_steps {total_steps} must exceed warmup_steps {warmup_steps}"
        )

    def f(step):
        step = _f32(step)
        warm = base_lr * step / max(warmup_steps, 1)
        progress = ((step - warmup_steps) / (total_steps - warmup_steps)).clamp(0.0, 1.0)
        decayed = base_lr * 0.5 * (1.0 + torch.cos(math.pi * progress))
        return torch.where(step < warmup_steps, warm, decayed)

    return f


def step_decay(base_lr: float, *, gamma: float = 0.1, every: int = 30):
    """Multiply by ``gamma`` every ``every`` steps (epoch-style decay)."""

    def f(step):
        k = torch.floor(_f32(step) / every)
        return base_lr * _f32(gamma) ** k

    return f
