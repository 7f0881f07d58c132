"""KMeans: k-means++ seeding + Lloyd iterations through the Lloyd-step op.

The paper's KMeans-DRE learns centroid positions from a client's private
data (Algorithm 1 line 3). Every Lloyd iteration is one
``dispatch.lloyd_step`` (the fused CUDA kernel for a CUDA tensor), as in
the reference's ``_kmeans_fit_pallas``; the update, convergence flag and
iteration count follow ``repro.core.kmeans`` exactly.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.dispatch import pairwise_sq_dists


class KMeansResult(NamedTuple):
    centroids: torch.Tensor     # (c, d)
    assignments: torch.Tensor   # (n,) int32
    inertia: torch.Tensor       # scalar — sum of squared distances
    n_iter: int                 # iterations executed


def kmeans_plus_plus(x: torch.Tensor, k: int, *,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """k-means++ seeding (sklearn's default, which the paper uses).

    ``x`` (n, d) may live on any device; the random draws come from the
    CPU ``generator``, so a seed picks the same rows on every device (up
    to float differences in the sampling weights)."""
    n = x.shape[0]
    picks = [int(torch.randint(n, (1,), generator=generator))]
    if k > 1:
        min_d2 = torch.full((n,), float("inf"), dtype=x.dtype,
                            device=x.device)
        for _ in range(1, k):
            d2 = torch.sum(torch.square(x - x[picks[-1]]), dim=-1)
            min_d2 = torch.minimum(min_d2, d2)
            probs = min_d2 / torch.clamp_min(torch.sum(min_d2), 1e-12)
            w = probs.to("cpu", torch.float64)
            if not float(w.sum()) > 0.0:   # every row on a centroid already
                w = torch.ones_like(w)
            picks.append(int(torch.multinomial(w, 1, generator=generator)))
    return x[torch.as_tensor(picks, device=x.device)]


def kmeans_fit(x: torch.Tensor, k: int, max_iter: int = 50,
               tol: float = 1e-6, *,
               generator: Optional[torch.Generator] = None,
               init: Optional[torch.Tensor] = None,
               backend: Optional[str] = None) -> KMeansResult:
    """Lloyd's algorithm. x: (n, d) -> KMeansResult.

    ``init`` (k, d) replaces the k-means++ seeding (a parity harness hands
    in the reference's seeds); otherwise ``generator`` drives it. The loop
    keeps the reference's fixed-length semantics — an iteration whose shift
    falls below ``tol`` still applies its update and counts, later ones are
    no-ops — and simply stops launching once converged (one host read of
    the shift per iteration). One more Lloyd step gives the assignment,
    per-row distances and inertia."""
    x = x.to(torch.float32)
    cents = (kmeans_plus_plus(x, k, generator=generator) if init is None
             else torch.as_tensor(init, dtype=torch.float32, device=x.device))
    iters = 0
    for _ in range(max_iter):
        _, _, sums, counts = dispatch.lloyd_step(x, cents, backend=backend)
        new = torch.where(counts[:, None] > 0,
                          sums / torch.clamp_min(counts[:, None], 1.0), cents)
        shift = torch.sum(torch.square(new - cents))
        cents = new
        iters += 1
        if bool(shift < tol):
            break
    assign, min_d2, _, _ = dispatch.lloyd_step(x, cents, backend=backend)
    return KMeansResult(cents, assign, torch.sum(min_d2), iters)


def min_dist_to_centroids(x: torch.Tensor,
                          centroids: torch.Tensor) -> torch.Tensor:
    """Euclidean distance of each row of x to its nearest centroid."""
    d2 = pairwise_sq_dists(x.to(torch.float32), centroids.to(torch.float32))
    return torch.sqrt(torch.amin(d2, dim=-1))
