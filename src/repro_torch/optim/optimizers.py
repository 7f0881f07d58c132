"""Functional optimizers as ``(init, update)`` pairs over lists of tensors.

``sgd`` keeps the reference's state and arithmetic
(``repro.optim.optimizers.sgd``): ``mu`` mirrors the parameters, ``step``
counts updates, ``mu ← momentum·mu + g`` (no dampening) and the update is
``−lr·mu``, so a parameter trajectory matches the reference step for step.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple

import torch


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


def sgd(lr: float, momentum: float = 0.9) -> Optimizer:
    """Heavy-ball SGD at a constant learning rate (the reference's
    ``nesterov`` and scheduled-``lr`` variants have no caller here)."""

    def init(params):
        return {"mu": [torch.zeros_like(p) for p in params], "step": 0}

    def update(grads, state, params=None):
        mu = [momentum * m + g for m, g in zip(state["mu"], grads)]
        upd = [-(lr) * m for m in mu]
        return upd, {"mu": mu, "step": state["step"] + 1}

    return Optimizer(init, update)
