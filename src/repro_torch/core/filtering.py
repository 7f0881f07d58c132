"""Two-stage client-side filtering (Algorithm 1, CLIENTFILTER, lines 28–37).

A proxy sample's logits are in-distribution (ID) for client c iff
  stage 1: the sample originated from c's own private data (provenance
           recorded at proxy construction), OR
  stage 2: KMeans-DRE distance to c's private centroids ≤ T^ID.

The filter returns a fixed-shape boolean mask over the round's proxy
batch, which the server's masked aggregation consumes directly.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch


class FilterStats(NamedTuple):
    mask: torch.Tensor        # (t,) bool — ID decisions
    stage1: torch.Tensor      # (t,) bool — membership hits
    stage2: torch.Tensor      # (t,) bool — distance-test hits
    distances: torch.Tensor   # (t,) f32 — DRE distances (diagnostics)


def membership_mask(proxy_owner: torch.Tensor,
                    client_id: Union[int, torch.Tensor]) -> torch.Tensor:
    """Stage 1 via provenance: owner ids recorded at proxy construction."""
    return proxy_owner == client_id


def two_stage_filter(dre, proxy_x: torch.Tensor, proxy_owner: torch.Tensor,
                     client_id: int) -> FilterStats:
    """Full CLIENTFILTER for a distance-based DRE (``KMeansDRE``).
    proxy_x: (t, ...) samples; proxy_owner: (t,) int."""
    stage1 = membership_mask(proxy_owner, client_id)
    d = dre.distances(proxy_x)
    stage2 = d <= dre.threshold
    # the vectorised OR is the fixed-shape form of the two-stage
    # short-circuit (stage 2 only matters where stage 1 missed)
    return FilterStats(mask=stage1 | stage2, stage1=stage1, stage2=stage2,
                       distances=d)
