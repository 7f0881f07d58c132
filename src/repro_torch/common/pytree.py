"""Parameter-init helpers, and the stacked-parameter helpers of the cohort
engine.

Dense weights keep the reference's ``w (d_in, d_out)`` layout and are
applied as ``x @ w + b``, so parameters exported from the JAX package load
without transposes; conv weights take PyTorch's OIHW layout, and the
reference's HWIO ones are transposed at load (``models.cnn``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch


def init_dense(d_in: int, d_out: int, *,
               generator: Optional[torch.Generator] = None,
               bias: bool = False, device=None) -> Dict[str, torch.Tensor]:
    """Lecun-normal float32 dense init; returns {'w': (d_in, d_out)
    [, 'b': (d_out,)]}.

    Draws on the CPU from ``generator`` and then moves to ``device``, so a
    seed gives the same weights on every device."""
    w = torch.randn((d_in, d_out), generator=generator) / math.sqrt(d_in)
    p = {"w": w.to(device)}
    if bias:
        p["b"] = torch.zeros((d_out,), device=device)
    return p


def init_conv(c_in: int, c_out: int, k: int, *,
              generator: Optional[torch.Generator] = None,
              device=None) -> Dict[str, torch.Tensor]:
    """He-normal float32 conv init; returns {'w': (c_out, c_in, k, k),
    'b': (c_out,)}, std sqrt(2 / (c_in·k·k)) and a zero bias.

    The weight is in PyTorch's OIHW layout (the reference's is HWIO). It
    draws on the CPU from ``generator``, as ``init_dense`` does."""
    std = math.sqrt(2.0 / (c_in * k * k))
    w = torch.randn((c_out, c_in, k, k), generator=generator) * std
    return {"w": w.to(device), "b": torch.zeros((c_out,), device=device)}


# ---- stacked clients (the reference's cohort.py _stack_trees,
# _unstack_tree, _where_tree), over lists of tensors

def stack_trees(trees: Sequence[Sequence[torch.Tensor]]) -> List[torch.Tensor]:
    """C lists of tensors -> one list of (C, ...) tensors."""
    return [torch.stack(leaves) for leaves in zip(*trees)]


def unstack_tree(tree: Sequence[torch.Tensor], i: int) -> List[torch.Tensor]:
    """Row ``i`` of every stacked tensor (views)."""
    return [leaf[i] for leaf in tree]


def where_tree(flag: torch.Tensor, new: Sequence[torch.Tensor],
               old: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Per client: ``new`` where ``flag`` (C,) is set, else ``old``."""
    return [torch.where(flag.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)
            for a, b in zip(new, old)]
