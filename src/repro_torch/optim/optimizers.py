"""Functional optimizers as ``(init, update)`` pairs over lists of tensors.

The reference's ``repro.optim.optimizers`` with its state and arithmetic,
so a parameter trajectory matches the reference's step for step (to
float32 rounding): ``sgd`` keeps ``mu`` (``mu ← momentum·mu + g``, no
dampening) and updates by ``−lr·mu``; ``adamw`` keeps ``m``, ``v`` (in
``state_dtype``, e.g. bf16, when given) and computes in float32 with the
bias corrections ``1 − b**step`` and ``u = −lr·(m̂/(√v̂ + eps) + wd·p)``.
``lr`` is a float or a schedule ``step -> lr`` (``optim.schedules``),
evaluated at the step being taken (1 for the first update).
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple

import torch

F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable
    update: Callable   # (grads, state, params) -> (updates, state)


def apply_updates(params: List[torch.Tensor],
                  updates: List[torch.Tensor]) -> None:
    """Add ``updates`` to ``params`` in place (the reference returns
    ``params + updates``; in place saves a copy of every parameter)."""
    with torch.no_grad():
        for p, u in zip(params, updates):
            p.add_(u)


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float):
    """``grads`` scaled so their global float32 norm is at most
    ``max_norm``; returns (clipped grads, the norm before clipping)."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g.to(F32)))
                          for g in grads))
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return [(g * scale).to(g.dtype) for g in grads], norm


def _lr_fn(lr):
    return lr if callable(lr) else (lambda _: lr)


def sgd(lr, momentum: float = 0.9) -> Optimizer:
    """Heavy-ball SGD; ``lr`` a float or a schedule (the reference's
    ``nesterov`` variant has no caller here)."""
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"mu": [torch.zeros_like(p) for p in params], "step": 0}

    def update(grads, state, params=None):
        step = state["step"] + 1
        lrv = lr_fn(step)
        mu = [momentum * m + g for m, g in zip(state["mu"], grads)]
        upd = [-(lrv) * m for m in mu]
        return upd, {"mu": mu, "step": step}

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, state_dtype=None) -> Optimizer:
    """AdamW. ``state_dtype`` (e.g. ``torch.bfloat16``) keeps the moments
    in that dtype (half the optimizer memory at bf16); the arithmetic is
    float32 either way. ``update`` replaces the state's moment lists leaf
    by leaf (the lists of the state it was given, which it returns), so one
    leaf's old and new moments coexist at a time, not two copies of all."""
    lr_fn = _lr_fn(lr)

    def _cast(x):
        return x.to(state_dtype) if state_dtype is not None else x

    def init(params):
        return {"m": [_cast(torch.zeros_like(p, dtype=F32)) for p in params],
                "v": [_cast(torch.zeros_like(p, dtype=F32)) for p in params],
                "step": 0}

    def update(grads, state, params):
        step = state["step"] + 1
        lrv = lr_fn(step)
        s = torch.tensor(step, dtype=F32)
        bc1 = 1.0 - torch.tensor(b1, dtype=F32) ** s
        bc2 = 1.0 - torch.tensor(b2, dtype=F32) ** s
        upd = []
        with torch.no_grad():
            for i, (g, p) in enumerate(zip(grads, params)):
                gf = g.to(F32)
                m32 = state["m"][i].to(F32) * b1 + (1 - b1) * gf
                v32 = state["v"][i].to(F32) * b2 + (1 - b2) * torch.square(gf)
                mh = m32 / bc1
                vh = v32 / bc2
                u = -(lrv) * (mh / (torch.sqrt(vh) + eps)
                              + weight_decay * p.to(F32))
                upd.append(u.to(p.dtype))
                state["m"][i], state["v"][i] = _cast(m32), _cast(v32)
        state["step"] = step
        return upd, state

    return Optimizer(init, update)
