"""Two-stage client-side filtering (Algorithm 1, CLIENTFILTER, lines 28–37).

A proxy sample's logits are in-distribution (ID) for client c iff
  stage 1: the sample originated from c's own private data (provenance
           recorded at proxy construction), OR
  stage 2: KMeans-DRE distance to c's private centroids ≤ T^ID (or, for
           the Selective-FD baseline's KuLSIF-DRE, the estimated density
           ratio ≥ its threshold).

The filter returns a fixed-shape boolean mask over the round's proxy
batch, which the server's masked aggregation consumes directly.
``server_entropy_filter`` is Selective-FD's extra server-side stage, the
one EdgeFD removes.
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
    """Full CLIENTFILTER. proxy_x: (t, ...) samples; proxy_owner: (t,) int.

    A distance DRE (``KMeansDRE``) gives distances and the stage-2 test in
    one estimation step. A ratio DRE (``KuLSIFDRE``) is estimated once and
    its ratio r gives both the test (r ≥ threshold) and the diagnostic
    distance −r; the reference estimates it twice on the same input, with
    the same result, so the Gram-matrix kernel launches half as often
    here."""
    stage1 = membership_mask(proxy_owner, client_id)
    if hasattr(dre, "distances"):
        d, stage2 = dre.distances_and_id(proxy_x)
    else:  # ratio-based DRE (KuLSIF): higher ratio = more ID
        r = dre.estimate(proxy_x)
        stage2 = r >= dre.threshold
        d = -r
    # the vectorised OR is the fixed-shape form of the two-stage
    # short-circuit (stage 2 only matters where stage 1 missed)
    return FilterStats(mask=stage1 | stage2, stage1=stage1, stage2=stage2,
                       distances=d)


def server_entropy_filter(logits: torch.Tensor, mask: torch.Tensor,
                          max_entropy_frac: float = 0.75) -> torch.Tensor:
    """Selective-FD's server-side ambiguity filter (baseline only).

    Drops client logits whose predictive entropy exceeds a fraction of
    log(num_classes). logits: (C, t, K); mask: (C, t) bool. Returns the
    tightened mask. The limit is taken in f32, as the reference takes it."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    ent = -torch.sum(probs * torch.log(torch.clamp_min(probs, 1e-12)),
                     dim=-1)
    k = torch.tensor(float(logits.shape[-1]), dtype=torch.float32)
    max_ent = torch.log(k) * max_entropy_frac
    return mask & (ent <= max_ent)
