"""KMeans: k-means++ seeding + Lloyd iterations through the Lloyd-step op.

The paper's KMeans-DRE learns centroid positions from a client's private
data (Algorithm 1 line 3). Every Lloyd iteration is one
``dispatch.lloyd_step`` (the fused CUDA kernel for a CUDA tensor) for one
client or, in ``kmeans_fit_batched``, for a cohort's C clients at once, as
in the reference's ``_kmeans_fit_pallas``; the update, convergence flags
and iteration counts follow ``repro.core.kmeans`` exactly.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.dispatch import pairwise_sq_dists


class KMeansResult(NamedTuple):
    centroids: torch.Tensor     # (c, d)
    assignments: torch.Tensor   # (n,) int32
    inertia: torch.Tensor       # scalar — sum of squared distances
    n_iter: int                 # iterations executed (a list of C ints
                                # from kmeans_fit_batched)


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


def kmeans_fit_batched(xs: torch.Tensor, k: int, max_iter: int = 50,
                       tol: float = 1e-6, *,
                       generators: Optional[Sequence[torch.Generator]] = None,
                       inits=None,
                       backend: Optional[str] = None) -> KMeansResult:
    """Lloyd's algorithm for C clients at once: xs (C, n, d) -> a
    ``KMeansResult`` whose fields carry a leading client axis (``n_iter`` a
    list of C ints).

    ``inits[c]`` (k, d) replaces client c's k-means++ seeding (a parity
    harness hands in the reference's seeds); where it is None (or without
    ``inits``), ``generators[c]`` seeds client c. Every
    Lloyd iteration is one ``dispatch.lloyd_step`` for all C clients (the
    kernel's client axis), as the reference's ``_kmeans_fit_pallas``; each
    client keeps a ``done`` flag and an iteration count, a converged
    client's centroids stay frozen (``torch.where``), and the loop stops
    launching once every client has converged: one host read of
    ``done.all()`` an iteration, not C. One more Lloyd step gives the
    assignments, per-row distances and inertias."""
    xs = xs.to(torch.float32)
    c = xs.shape[0]
    gens = [None] * c if generators is None else list(generators)
    inits = [None] * c if inits is None else list(inits)
    cents = torch.stack([
        kmeans_plus_plus(xs[i], k, generator=gens[i]) if inits[i] is None
        else torch.as_tensor(inits[i], dtype=torch.float32, device=xs.device)
        for i in range(c)])
    done = torch.zeros((c,), dtype=torch.bool, device=xs.device)
    iters = torch.zeros((c,), dtype=torch.int64, device=xs.device)
    for _ in range(max_iter):
        _, _, sums, counts = dispatch.lloyd_step(xs, cents, backend=backend)
        new = torch.where(counts[..., None] > 0,
                          sums / torch.clamp_min(counts[..., None], 1.0),
                          cents)
        shift = torch.sum(torch.square(new - cents).reshape(c, -1), dim=1)
        cents = torch.where(done[:, None, None], cents, new)
        iters += (~done).to(torch.int64)
        done = done | (shift < tol)
        if bool(done.all()):
            break
    assign, min_d2, _, _ = dispatch.lloyd_step(xs, cents, backend=backend)
    return KMeansResult(cents, assign, torch.sum(min_d2, dim=-1),
                        iters.tolist())


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
    the convergence flag per iteration). It is ``kmeans_fit_batched`` for
    one client, so a cohort's fit and a client's own take the same steps."""
    res = kmeans_fit_batched(x[None], k, max_iter, tol,
                             generators=[generator],
                             inits=None if init is None else [init],
                             backend=backend)
    return KMeansResult(res.centroids[0], res.assignments[0],
                        res.inertia[0], res.n_iter[0])


def min_dist_to_centroids(x: torch.Tensor,
                          centroids: torch.Tensor) -> torch.Tensor:
    """Euclidean distance of each row of x to its nearest centroid."""
    d2 = pairwise_sq_dists(x.to(torch.float32), centroids.to(torch.float32))
    return torch.sqrt(torch.amin(d2, dim=-1))
