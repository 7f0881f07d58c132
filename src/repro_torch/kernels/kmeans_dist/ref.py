"""Plain PyTorch versions of the KMeans-DRE kernels' functions.

Op for op the reference's canonical jnp code
(``repro.kernels.dispatch.pairwise_sq_dists`` / ``_lloyd_step_jnp``, and
``repro.core.kmeans.min_dist_to_centroids`` with the threshold test of
``KMeansDRE.is_id``): the CPU path, the tests and ``chip_smoke.py`` call
these; a CUDA tensor goes to the kernels (``ops.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b, leading axes broadcast. On the CPU one 2-D product per slice
    of the leading axes, so that a client's slice of a batched call is bit
    for bit its own 2-D call (a batched BLAS call may take another
    kernel)."""
    if a.device.type != "cpu" or (a.ndim == 2 and b.ndim == 2):
        return a @ b
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a3 = a.expand(*lead, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
    b3 = b.expand(*lead, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
    out = torch.stack([u @ v for u, v in zip(a3, b3)])
    return out.reshape(*lead, a.shape[-2], b.shape[-1])


def pairwise_sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """‖x−c‖² via the matmul form: x (…, n, d), c (…, k, d) -> (…, n, k),
    clamped at 0 (cancellation can leave tiny negatives)."""
    x2 = torch.sum(torch.square(x), dim=-1, keepdim=True)      # (…, n, 1)
    c2 = torch.sum(torch.square(c), dim=-1)                     # (…, k)
    cross = _matmul(x, c.transpose(-1, -2))                     # (…, n, k)
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
    sums = _matmul(one_hot.transpose(-1, -2), x)                # (…, k, d)
    return (assign.to(torch.int32), torch.amin(d2, dim=-1), sums, counts)


def min_dist_and_mask(x: torch.Tensor, centroids: torch.Tensor, threshold):
    """The filter's estimation step: x (t, d), centroids (k, d), threshold
    a float or a one-element tensor -> (distance of each row to its nearest
    centroid (t,) f32, ID mask distance <= threshold (t,) bool).

    Over a client axis: centroids (C, k, d), thresholds a float or a (C,)
    tensor, and x shared (t, d) (a cohort's report) or each client's own
    (C, t, d) (its calibration) -> (C, t) distances and masks, client c's
    those of the call on its own operands."""
    d2 = pairwise_sq_dists(x.to(torch.float32), centroids.to(torch.float32))
    dist = torch.sqrt(torch.amin(d2, dim=-1))
    if centroids.ndim == 3 and isinstance(threshold, torch.Tensor):
        threshold = threshold.reshape(-1, 1)
    return dist, dist <= threshold
