"""Parameter-init helpers.

Dense weights keep the reference's ``w (d_in, d_out)`` layout and are
applied as ``x @ w + b``, so parameters exported from the JAX package load
without transposes.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

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
