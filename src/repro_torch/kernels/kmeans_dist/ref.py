"""Plain PyTorch versions of the fused-Lloyd kernel's function.

Op for op the reference's canonical jnp code
(``repro.kernels.dispatch.pairwise_sq_dists`` / ``_lloyd_step_jnp``): the
CPU path, the tests and ``chip_smoke.py`` call these; a CUDA tensor goes
to the kernel (``ops.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def pairwise_sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """‖x−c‖² via the matmul form: x (…, n, d), c (…, k, d) -> (…, n, k),
    clamped at 0 (cancellation can leave tiny negatives)."""
    x2 = torch.sum(torch.square(x), dim=-1, keepdim=True)      # (…, n, 1)
    c2 = torch.sum(torch.square(c), dim=-1)                     # (…, k)
    cross = x @ c.transpose(-1, -2)                             # (…, n, k)
    return torch.clamp_min(x2 - 2.0 * cross + c2[..., None, :], 0.0)


def lloyd_step(x: torch.Tensor, centroids: torch.Tensor):
    """One Lloyd iteration: x (n, d) or (C, n, d), centroids (k, d) or
    (C, k, d) -> (assign i32, min_d2 f32, sums (…, k, d) f32,
    counts (…, k) f32), accumulating in f32 for any input dtype."""
    x = x.to(torch.float32)
    centroids = centroids.to(torch.float32)
    k = centroids.shape[-2]
    d2 = pairwise_sq_dists(x, centroids)
    assign = torch.argmin(d2, dim=-1)
    one_hot = F.one_hot(assign, k).to(torch.float32)           # (…, n, k)
    counts = torch.sum(one_hot, dim=-2)                         # (…, k)
    sums = one_hot.transpose(-1, -2) @ x                        # (…, k, d)
    return (assign.to(torch.int32), torch.amin(d2, dim=-1), sums, counts)
