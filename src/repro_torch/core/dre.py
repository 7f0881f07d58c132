"""Density-ratio estimators: the paper's KMeans-DRE and the KuLSIF-DRE
baseline it replaces (Kanamori et al. 2012, as Selective-FD uses it).

KMeans-DRE (paper §III): a sample is in-distribution (ID) iff its
distance to the nearest private-data centroid is ≤ T^ID. Learn
O(k·n·c·d), estimate O(t·c·d) — Table IV. The estimation step (distances
and the threshold test in one call) is ``dispatch.min_dist_and_mask``.

KuLSIF-DRE (paper §V-B): the ratio r(x) = Σ_j α_j K(x, a_j) +
Σ_i K(x, x_i)/(λn) over auxiliary samples a_j and the private samples
x_i, with α from the m×m system (K11/m + λI) α = −K12·1/(λnm). Learn
O(m³ + m²d + nmd), estimate O(t(n+m)d). Its Gram matrices are
``dispatch.rbf_matrix``; the solve, ``k_ta @ alpha`` and the row sums stay
library calls, as the reference leaves them outside its kernels.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch

from repro_torch.core.kmeans import kmeans_fit, kmeans_fit_batched
from repro_torch.kernels import dispatch


# ---------------------------------------------------------------------------
# KMeans-DRE (the paper's contribution)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KMeansDRE:
    """One centroid for strong non-IID; one per label for weak non-IID /
    IID (paper §IV-A)."""
    num_centroids: int = 1
    threshold: Optional[Union[float, torch.Tensor]] = None  # None: learn()
    calibration_q: float = 0.95         # quantile of private distances
    max_iter: int = 50
    # kernel dispatch for the Lloyd fit and the estimation step
    # (repro_torch.kernels.dispatch); None/"auto" = ambient policy
    kernel_backend: Optional[str] = None

    centroids: Optional[torch.Tensor] = None

    def learn(self, x: torch.Tensor, *,
              generator: Optional[torch.Generator] = None,
              init: Optional[torch.Tensor] = None) -> "KMeansDRE":
        """Fit centroids; if threshold is None, set T^ID to the
        ``calibration_q`` quantile (linear interpolation, as
        ``jnp.quantile``) of the private data's own distances, taken by
        the estimation step with an infinite threshold. The threshold
        stays a device scalar (no host sync)."""
        flat = x.reshape(x.shape[0], -1)
        res = kmeans_fit(flat, self.num_centroids, self.max_iter,
                         generator=generator, init=init,
                         backend=self.kernel_backend)
        thr = self.threshold
        if thr is None:
            d, _ = dispatch.min_dist_and_mask(flat, res.centroids, math.inf,
                                              backend=self.kernel_backend)
            thr = torch.quantile(d, self.calibration_q)
        return dataclasses.replace(self, centroids=res.centroids,
                                   threshold=thr)

    def distances_and_id(self, t: torch.Tensor):
        """(distance to the nearest centroid (t,), ID mask distance ≤ T^ID
        (t,) bool), from one estimation step."""
        if self.centroids is None:
            raise RuntimeError("call learn() first")
        thr = math.inf if self.threshold is None else self.threshold
        return dispatch.min_dist_and_mask(t.reshape(t.shape[0], -1),
                                          self.centroids, thr,
                                          backend=self.kernel_backend)

    def distances(self, t: torch.Tensor) -> torch.Tensor:
        return self.distances_and_id(t)[0]

    def estimate(self, t: torch.Tensor) -> torch.Tensor:
        """Density-ratio proxy: −distance, so higher = more ID."""
        return -self.distances(t)

    def is_id(self, t: torch.Tensor) -> torch.Tensor:
        return self.distances_and_id(t)[1]


def learn_kmeans_batched(dre: KMeansDRE, xs: torch.Tensor, *,
                         generators=None, inits=None):
    """``KMeansDRE.learn`` for C clients of one configuration at once
    (``dre``'s centroid count, threshold, quantile, iterations, backend):
    xs (C, n, d) -> (centroids (C, k, d), thresholds (C,)). One
    ``kmeans_fit_batched`` (one Lloyd launch an iteration for all C) and,
    without a fixed threshold, one estimation launch over every client's
    own rows, then ``torch.quantile`` row by row — the reference cohort's
    fast path (``repro.fed.cohort._Cohort.learn_dres``)."""
    flat = xs.reshape(xs.shape[0], xs.shape[1], -1)
    res = kmeans_fit_batched(flat, dre.num_centroids, dre.max_iter,
                             generators=generators, inits=inits,
                             backend=dre.kernel_backend)
    if dre.threshold is None:
        d, _ = dispatch.min_dist_and_mask(flat, res.centroids, math.inf,
                                          backend=dre.kernel_backend)
        thr = torch.quantile(d, dre.calibration_q, dim=1)
    else:
        thr = torch.full((xs.shape[0],), float(dre.threshold),
                         dtype=torch.float32, device=xs.device)
    return res.centroids, thr


def kmeans_id_masks(centroids: torch.Tensor, thresholds: torch.Tensor,
                    cids: torch.Tensor, proxy_x: torch.Tensor,
                    proxy_owner: torch.Tensor,
                    backend: Optional[str] = None) -> torch.Tensor:
    """The two-stage filter of C KMeans-DRE clients on one proxy batch, one
    estimation launch: centroids (C, k, d), thresholds (C,), client ids
    (C,), proxy_x (t, d) flat, proxy_owner (t,) -> masks (C, t),
    ``(owner == cid) | (distance <= threshold)`` (the reference cohort's
    ``kmeans_mask_chunk``)."""
    _, stage2 = dispatch.min_dist_and_mask(proxy_x, centroids, thresholds,
                                           backend=backend)
    return (proxy_owner[None, :] == cids[:, None]) | stage2


def kulsif_id_masks(alpha: torch.Tensor, aux: torch.Tensor,
                    private: torch.Tensor, n: torch.Tensor,
                    thresholds: torch.Tensor, cids: torch.Tensor,
                    sigma: float, lam: float, proxy_x: torch.Tensor,
                    proxy_owner: torch.Tensor,
                    backend: Optional[str] = None) -> torch.Tensor:
    """The two-stage filter of C KuLSIF-DRE clients on one proxy batch:
    alpha (C, m), aux (C, m, d), private sets (C, n_max, d) padded with
    far-away sentinel rows (their kernel mass is exactly 0), private sizes
    n (C,) f32, thresholds (C,), client ids (C,) -> masks (C, t), ``(owner
    == cid) | (r >= threshold)`` with r the estimated ratio — the
    reference cohort's ``kulsif_mask_chunk``; each Gram matrix is one
    launch for all C clients."""
    k_ta = dispatch.rbf_matrix(proxy_x, aux, sigma, backend=backend)
    k_tp = dispatch.rbf_matrix(proxy_x, private, sigma, backend=backend)
    # λ·n in f32, as the reference's vmap computes it
    lam_n = torch.tensor(lam, dtype=torch.float32) * n
    r = (torch.bmm(k_ta, alpha[..., None])[..., 0]
         + torch.sum(k_tp, dim=2) / lam_n[:, None])
    return (proxy_owner[None, :] == cids[:, None]) | (r >= thresholds[:, None])


# ---------------------------------------------------------------------------
# KuLSIF-DRE (Selective-FD's estimator — the baseline)
# ---------------------------------------------------------------------------

def rbf_kernel(a: torch.Tensor, b: torch.Tensor, sigma: float) -> torch.Tensor:
    """K(a,b) = exp(−‖a−b‖²/(2σ²)); a (n,d), b (m,d) -> (n,m), through the
    plain route (the kernel route is ``dispatch.rbf_matrix(...,
    backend="cuda")``)."""
    return dispatch.rbf_matrix(a, b, sigma, backend="torch")


def _kulsif_learn(aux: torch.Tensor, private: torch.Tensor, sigma: float,
                  lam: float, backend: Optional[str] = None) -> torch.Tensor:
    m = aux.shape[0]
    n = private.shape[0]
    k11 = dispatch.rbf_matrix(aux, aux, sigma, backend=backend)      # O(m² d)
    k12 = dispatch.rbf_matrix(aux, private, sigma, backend=backend)  # O(n m d)
    a = k11 / m + lam * torch.eye(m, dtype=k11.dtype, device=k11.device)
    # λ·n·m in f32, as the reference's jit computes it from an f32 λ
    scale = torch.tensor(lam, dtype=torch.float32) * n * m
    b = -torch.sum(k12, dim=1) / scale
    return torch.linalg.solve(a, b)                                  # O(m³)


@dataclasses.dataclass
class KuLSIFDRE:
    """Kernel unconstrained least-squares importance fitting.

    Needs locally generated auxiliary (denominator) samples — the paper
    counts them as an extra burden of statistical DREs; they are drawn
    uniformly over the private data's bounding box."""
    sigma: float = 1.0
    lam: float = 0.1
    num_aux: int = 256
    threshold: float = 1.0     # on the estimated ratio
    # kernel dispatch for the Gram matrices (repro_torch.kernels.dispatch);
    # None/"auto" = ambient policy
    kernel_backend: Optional[str] = None

    alpha: Optional[torch.Tensor] = None
    aux: Optional[torch.Tensor] = None
    private: Optional[torch.Tensor] = None

    def learn(self, x: torch.Tensor, *,
              generator: Optional[torch.Generator] = None,
              aux: Optional[torch.Tensor] = None) -> "KuLSIFDRE":
        """Solve for α on the private data ``x``. ``aux`` (num_aux, d)
        replaces the uniform draw from ``generator`` (a parity harness
        hands in the reference's)."""
        x = x.reshape(x.shape[0], -1).to(torch.float32)
        if aux is None:
            lo = torch.amin(x, dim=0)
            hi = torch.amax(x, dim=0)
            u = torch.rand((self.num_aux, x.shape[1]), generator=generator)
            aux = lo + (hi - lo) * u.to(x.device)
        else:
            aux = torch.as_tensor(aux, dtype=torch.float32, device=x.device)
        alpha = _kulsif_learn(aux, x, self.sigma, self.lam,
                              backend=self.kernel_backend)
        return dataclasses.replace(self, alpha=alpha, aux=aux, private=x)

    def estimate(self, t: torch.Tensor) -> torch.Tensor:
        """r̂(t) — density ratio p_private/p_aux (higher = more ID)."""
        if self.alpha is None:
            raise RuntimeError("call learn() first")
        t = t.reshape(t.shape[0], -1).to(torch.float32)
        k_ta = dispatch.rbf_matrix(t, self.aux, self.sigma,
                                   backend=self.kernel_backend)   # O(t·m·d)
        k_tp = dispatch.rbf_matrix(t, self.private, self.sigma,
                                   backend=self.kernel_backend)   # O(t·n·d)
        n = self.private.shape[0]
        return k_ta @ self.alpha + torch.sum(k_tp, dim=1) / (self.lam * n)

    def is_id(self, t: torch.Tensor) -> torch.Tensor:
        return self.estimate(t) >= self.threshold


def make_dre(kind: str, **kw):
    if kind == "kmeans":
        return KMeansDRE(**kw)
    if kind == "kulsif":
        return KuLSIFDRE(**kw)
    raise ValueError(f"unknown DRE kind {kind!r}")
