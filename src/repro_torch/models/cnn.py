"""Client models. Ported so far: the feature-mode ``MLPClassifier``.

The Tables I/II CNN zoo of ``repro.models.cnn`` is not ported yet (ROADMAP
queue A item 4).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.common.pytree import init_dense


class MLPClassifier(nn.Module):
    """Small MLP for pre-extracted-feature experiments (CIFAR10* mode).

    Layer i holds ``weights[i]`` (d_in, d_out) and ``biases[i]`` (d_out,)
    and computes ``x @ w + b`` (ReLU between layers), the reference's
    layout, so JAX parameters load as they are (``load_jax_params``)."""

    def __init__(self, d_in: int, hidden: Sequence[int] = (256, 128),
                 num_classes: int = 10, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.dims = [d_in, *hidden, num_classes]
        self.weights = nn.ParameterList()
        self.biases = nn.ParameterList()
        for i in range(len(self.dims) - 1):
            p = init_dense(self.dims[i], self.dims[i + 1], generator=generator,
                           bias=True, device=device)
            self.weights.append(nn.Parameter(p["w"]))
            self.biases.append(nn.Parameter(p["b"]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        last = len(self.weights) - 1
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            x = x @ w + b
            if i < last:
                x = torch.relu(x)
        return x

    def load_jax_params(self, params: List[Dict[str, np.ndarray]]
                        ) -> "MLPClassifier":
        """Copy the reference's ``[{'w': (d_in, d_out), 'b': (d_out,)}, …]``
        parameter list into this module (no transposes)."""
        if len(params) != len(self.weights):
            raise ValueError(f"{len(params)} layers given, model has "
                             f"{len(self.weights)}")
        with torch.no_grad():
            for w, b, p in zip(self.weights, self.biases, params):
                w.copy_(torch.from_numpy(np.array(p["w"], np.float32)))
                b.copy_(torch.from_numpy(np.array(p["b"], np.float32)))
        return self
