"""Plain PyTorch version of the RBF Gram-matrix kernel.

Op for op the reference's canonical jnp route
(``repro.kernels.dispatch._rbf_matrix_jnp``: the matmul-form
``pairwise_sq_dists``, then the exponential): the CPU path, the tests and
``chip_smoke.py`` call it; a CUDA tensor goes to the kernel (``ops.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.kmeans_dist.ref import pairwise_sq_dists


def rbf_matrix(a: torch.Tensor, b: torch.Tensor, sigma: float) -> torch.Tensor:
    """K[i, j] = exp(−‖a_i − b_j‖² / (2σ²)); a (n, d), b (m, d) -> (n, m)
    f32; over a client axis, one shared a (n, d) against C clients' b
    (C, m, d) -> (C, n, m), client c's the matrix of (a, b[c])."""
    d2 = pairwise_sq_dists(a.to(torch.float32), b.to(torch.float32))
    return torch.exp(-d2 / (2.0 * sigma * sigma))
