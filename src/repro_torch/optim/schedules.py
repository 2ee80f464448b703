"""LR schedules as pure functions of the step count (a tensor in, an f32
tensor out), as in the JAX package."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    def f(count: torch.Tensor) -> torch.Tensor:
        return torch.tensor(lr, dtype=torch.float32, device=count.device)

    return f


def linear_warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                         final_fraction: float = 0.1):
    def f(count: torch.Tensor) -> torch.Tensor:
        c = count.to(torch.float32)
        warm = c / max(warmup_steps, 1)
        progress = torch.clamp(
            (c - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_fraction + (1 - final_fraction) * 0.5 * (
            1 + torch.cos(math.pi * progress))
        return peak_lr * torch.where(c < warmup_steps, warm, cos)

    return f


def inverse_sqrt(peak_lr: float, warmup_steps: int):
    def f(count: torch.Tensor) -> torch.Tensor:
        c = torch.clamp(count.to(torch.float32), min=1.0)
        warm = c / max(warmup_steps, 1)
        # a true division, as jnp divides (``int / tensor`` in torch
        # multiplies by the reciprocal, one rounding more)
        decay = torch.sqrt(torch.full_like(c, warmup_steps) / c) \
            if warmup_steps else 1.0 / torch.sqrt(c)
        return peak_lr * torch.minimum(warm, decay)

    return f
