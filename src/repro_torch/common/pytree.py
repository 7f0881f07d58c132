"""Parameter-init helpers, the stacked-parameter helper of the cohort
engine, and the parameter-aligned helpers of the models' reference-layout
export and import (``jax_params`` / ``load_jax_params``).

Dense weights keep the reference's ``w (d_in, d_out)`` layout and are
applied as ``x @ w + b``, so parameters exported from the JAX package load
without transposes; conv weights take PyTorch's OIHW layout, and the
reference's HWIO ones are transposed at load (``models.cnn``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn


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


# ---- stacked clients (the reference's cohort.py _unstack_tree; the cohort
# engine stacks and gates leaf by leaf, in place: ``fed.cohort``)

def unstack_tree(tree: Sequence[torch.Tensor], i: int) -> List[torch.Tensor]:
    """Row ``i`` of every stacked tensor (views)."""
    return [leaf[i] for leaf in tree]


# ---- reference-layout export and import

def host_values(module: nn.Module, values=None) -> Dict[int, np.ndarray]:
    """Host copies of ``values`` (tensors aligned with
    ``module.parameters()``, e.g. the SGD momentum), or of the parameters
    themselves, keyed by ``id`` of the parameter they belong to."""
    params = list(module.parameters())
    vals = params if values is None else list(values)
    if len(vals) != len(params):
        raise ValueError(f"{len(vals)} tensors given for {len(params)} "
                         "parameters")
    return {id(p): v.detach().to("cpu", copy=True).numpy()
            for p, v in zip(params, vals)}


def targets(module: nn.Module, into=None):
    """Where ``load_jax_params`` writes a parameter: the parameter itself,
    or its entry of ``into`` (tensors aligned with ``module.parameters()``)."""
    if into is None:
        return lambda p: p
    params = list(module.parameters())
    if len(into) != len(params):
        raise ValueError(f"{len(into)} tensors given for {len(params)} "
                         "parameters")
    by_id = {id(p): t for p, t in zip(params, into)}
    return lambda p: by_id[id(p)]
