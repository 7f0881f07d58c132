"""Learning-rate schedules (step -> lr), evaluated in float32.

The reference's ``repro.optim.schedules``: each schedule maps an integer
step to a 0-d float32 tensor with the reference's arithmetic (``jnp.cos``
of a float32 argument, ``jnp.where(step <= warmup, …)``), so an optimizer
driven by it sees the reference's learning rates to float32 rounding.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32)


def constant(lr: float):
    return lambda step: _f32(lr)


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = torch.clamp_max(_f32(step), total_steps) / total_steps
        cos = 0.5 * (1.0 + torch.cos(_f32(math.pi) * t))
        return _f32(lr) * (final_frac + (1 - final_frac) * cos)
    return fn


def linear_warmup_cosine(lr: float, warmup: int, total_steps: int,
                         final_frac: float = 0.1):
    cd = cosine_decay(lr, max(total_steps - warmup, 1), final_frac)

    def fn(step):
        s = _f32(step)
        warm = _f32(lr) * s / max(warmup, 1)
        return torch.where(torch.as_tensor(step) <= warmup, warm,
                           cd(torch.as_tensor(step) - warmup))
    return fn
