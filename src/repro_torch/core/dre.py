"""The paper's KMeans density-ratio estimator (KMeans-DRE, §III).

A sample is in-distribution (ID) iff its distance to the nearest
private-data centroid is ≤ T^ID (the two-stage filter reads
``distances`` and ``threshold``). Learn O(k·n·c·d),
estimate O(t·c·d) — Table IV. The KuLSIF-DRE baseline of
``repro.core.dre`` is not ported yet (ROADMAP queue A item 4).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core.kmeans import kmeans_fit, min_dist_to_centroids


@dataclasses.dataclass
class KMeansDRE:
    """One centroid for strong non-IID; one per label for weak non-IID /
    IID (paper §IV-A)."""
    num_centroids: int = 1
    threshold: Optional[Union[float, torch.Tensor]] = None  # None: learn()
    calibration_q: float = 0.95         # quantile of private distances
    max_iter: int = 50
    # kernel dispatch for the Lloyd fit (repro_torch.kernels.dispatch);
    # None/"auto" = ambient policy
    kernel_backend: Optional[str] = None

    centroids: Optional[torch.Tensor] = None

    def learn(self, x: torch.Tensor, *,
              generator: Optional[torch.Generator] = None,
              init: Optional[torch.Tensor] = None) -> "KMeansDRE":
        """Fit centroids; if threshold is None, set T^ID to the
        ``calibration_q`` quantile (linear interpolation, as
        ``jnp.quantile``) of the private data's own distances. The
        threshold stays a device scalar (no host sync)."""
        flat = x.reshape(x.shape[0], -1)
        res = kmeans_fit(flat, self.num_centroids, self.max_iter,
                         generator=generator, init=init,
                         backend=self.kernel_backend)
        thr = self.threshold
        if thr is None:
            d = min_dist_to_centroids(flat, res.centroids)
            thr = torch.quantile(d, self.calibration_q)
        return dataclasses.replace(self, centroids=res.centroids,
                                   threshold=thr)

    def distances(self, t: torch.Tensor) -> torch.Tensor:
        if self.centroids is None:
            raise RuntimeError("call learn() first")
        return min_dist_to_centroids(t.reshape(t.shape[0], -1),
                                     self.centroids)
