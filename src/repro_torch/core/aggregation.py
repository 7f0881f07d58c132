"""Server-side aggregation (Algorithm 1 line 15) — masked mean of ID logits.

EdgeFD's server averages the ID predictions each client uploaded: no
filtering, no teacher model. The plain mean guards against non-finite
client rows (an exact no-op on finite inputs). DS-FL sharpens the mean
(``temperature_sharpen``); FKD and PLS exchange class-wise mean logits
(``classwise_mean_logits``); a round with stale reports weights each
client by its staleness (``weighted_masked_mean_logits``).

Two-tier servers reduce each edge's client shard to a ``(num, den)``
partial (``partial_masked_sums``) and fuse the partials at the root
(``fuse_partial_sums``). The robust reducers (``ROBUST_AGGREGATIONS``:
coordinate-wise trimmed mean and median, per-position Krum) replace the
mean over the client axis; ``client_outlier_distance`` scores each client
against the fused center for trust and quarantine. All of it runs on the
tensors' device; only the outlier distances come back to the host.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# reducers over the client axis of the stacked (C, t, K) reports; "mean" is
# the masked mean
ROBUST_AGGREGATIONS = ("mean", "trimmed_mean", "median", "krum_row")


def _finite_rows(logits: torch.Tensor, mask: torch.Tensor):
    """Drop non-finite client rows: a (c, t) row with any inf/NaN entry is
    removed from the mask and zeroed in the values (``0 * nan`` is nan, so
    masking alone is not enough). Exact identity on finite inputs."""
    lo = torch.as_tensor(logits).to(torch.float32)
    fin = torch.isfinite(lo).all(dim=-1)                      # (C, t)
    return torch.where(fin[..., None], lo, 0.0), fin


def _sharpen(teacher: torch.Tensor,
             temperature_sharpen: Optional[float]) -> torch.Tensor:
    """DS-FL's entropy reduction: log of the softmax at a low temperature
    (a no-op for None or 0)."""
    if temperature_sharpen:
        probs = torch.softmax(teacher / temperature_sharpen, dim=-1)
        teacher = torch.log(torch.clamp_min(probs, 1e-12))
    return teacher


def masked_mean_logits(logits: torch.Tensor, mask: torch.Tensor, *,
                       temperature_sharpen: Optional[float] = None,
                       guard_finite: bool = True):
    """logits: (C, t, K) per-client proxy logits; mask: (C, t) ID decisions.

    Returns (teacher (t, K), valid (t,) bool). Samples where no client is
    ID get a zero teacher and valid=False — the distillation loss masks
    them. DS-FL-style temperature sharpening is optional.
    ``guard_finite=False`` re-exposes the poison-the-teacher behavior of an
    unsanitized server."""
    if guard_finite:
        lo, fin = _finite_rows(logits, mask)
        mb = torch.logical_and(mask, fin)
    else:
        lo, mb = torch.as_tensor(logits).to(torch.float32), mask
    m = mb.to(torch.float32)[..., None]                      # (C, t, 1)
    s = torch.sum(lo * m, dim=0)                              # (t, K)
    cnt = torch.sum(m, dim=0)                                 # (t, 1)
    teacher = s / torch.clamp_min(cnt, 1.0)
    valid = cnt[..., 0] > 0.0
    return _sharpen(teacher, temperature_sharpen), valid


def weighted_masked_mean_logits(logits: torch.Tensor, mask: torch.Tensor,
                                client_weights: torch.Tensor, *,
                                temperature_sharpen: Optional[float] = None,
                                guard_finite: bool = True):
    """``masked_mean_logits`` with a per-client weight (C,): the staleness
    model's ``decay ** age`` (``repro_torch.fed.participation``).

    The sum is divided by the weight sum itself, not by a floor, so a
    position whose only contributor is heavily decayed recovers that
    contributor's logits; where every weight is 0 the sum is exactly 0 and
    the teacher is 0, with valid=False."""
    if guard_finite:
        lo, fin = _finite_rows(logits, mask)
        mb = torch.logical_and(mask, fin)
    else:
        lo, mb = torch.as_tensor(logits).to(torch.float32), mask
    w = mb.to(torch.float32) * client_weights[:, None]      # (C, t)
    wl = w[..., None]                                         # (C, t, 1)
    s = torch.sum(lo * wl, dim=0)                             # (t, K)
    den = torch.sum(wl, dim=0)                                # (t, 1)
    teacher = s / torch.where(den > 0.0, den, 1.0)
    valid = den[..., 0] > 0.0
    return _sharpen(teacher, temperature_sharpen), valid


def partial_masked_sums(logits: torch.Tensor, mask: torch.Tensor,
                        client_weights: Optional[torch.Tensor] = None, *,
                        guard_finite: bool = True):
    """One edge aggregator's share of the masked (weighted) mean.

    logits: (C_e, t, K), this edge's client shard; mask: (C_e, t);
    ``client_weights``: optional (C_e,) staleness weights (None: all
    fresh). Returns ``(num (t, K), den (t,))``, the weighted logit sums and
    weight sums of the shard; ``fuse_partial_sums`` over every shard's
    pair gives the flat mean up to the order of the float sums."""
    if guard_finite:
        lo, fin = _finite_rows(logits, mask)
        mb = torch.logical_and(mask, fin)
    else:
        lo, mb = torch.as_tensor(logits).to(torch.float32), mask
    w = mb.to(torch.float32)
    if client_weights is not None:
        w = w * client_weights[:, None]
    num = torch.sum(lo * w[..., None], dim=0)
    return num, torch.sum(w, dim=0)


def fuse_partial_sums(nums: torch.Tensor, dens: torch.Tensor, *,
                      temperature_sharpen: Optional[float] = None):
    """Root fusion of E edge partials: (E, t, K) nums and (E, t) dens into
    (teacher (t, K), valid (t,)). The divisor is the summed weight, a dummy
    1 only where it is exactly 0."""
    s = torch.sum(nums.to(torch.float32), dim=0)              # (t, K)
    den = torch.sum(dens.to(torch.float32), dim=0)            # (t,)
    teacher = s / torch.where(den > 0.0, den, 1.0)[..., None]
    return _sharpen(teacher, temperature_sharpen), den > 0.0


def classwise_mean_logits(logits: torch.Tensor, labels: torch.Tensor,
                          num_classes: int):
    """FKD/PLS-style data-free aggregation: per-label mean logits.

    logits: (n, K) local logits on private data; labels: (n,). Returns the
    (num_classes, K) mean logits per class (zero rows for absent classes)
    and the per-class counts (num_classes,) f32."""
    one_hot = F.one_hot(labels.to(torch.int64), num_classes).to(
        torch.float32)                                        # (n, C)
    sums = one_hot.T @ logits.to(torch.float32)               # (C, K)
    cnt = torch.sum(one_hot, dim=0)[:, None]
    return sums / torch.clamp_min(cnt, 1.0), cnt[:, 0]


def scrub_nonfinite(logits: torch.Tensor, masks: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Server-side sanitize pass over raw ``(C, t, K)`` reports, on the
    reports' device.

    Rows with any non-finite entry are zeroed and removed from the mask.
    Returns ``(logits, masks, scrubbed_per_client)`` where the (C,) int64
    count is the number of claimed-ID rows each client lost. Clean inputs
    come back as the same objects (no copy)."""
    lo = logits.to(torch.float32)
    mk = masks.to(torch.bool)
    fin = torch.isfinite(lo).all(dim=-1)                     # (C, t)
    scrubbed = torch.sum(mk & ~fin, dim=1, dtype=torch.int64)  # (C,)
    if bool(fin.all()):
        return lo, mk, scrubbed
    return torch.where(fin[..., None], lo, 0.0), mk & fin, scrubbed


# ---------------------------------------------------------------------------
# Robust reducers over the client axis
# ---------------------------------------------------------------------------

def _sorted_valid(logits: torch.Tensor, mask: torch.Tensor):
    """Sort each (t, K) coordinate over the client axis with invalid
    (masked-out or non-finite) rows pushed to ``+inf``, so the first
    ``n[t]`` entries of a coordinate are its valid values ascending."""
    lo = torch.as_tensor(logits).to(torch.float32)
    fin = torch.isfinite(lo).all(dim=-1)
    m = torch.logical_and(mask, fin)                          # (C, t)
    xs = torch.sort(torch.where(m[..., None], lo, torch.inf), dim=0).values
    n = torch.sum(m, dim=0, dtype=torch.int32)                # (t,)
    return xs, n, m


def trimmed_mean_logits(logits: torch.Tensor, mask: torch.Tensor, *,
                        trim_frac: float = 0.2,
                        temperature_sharpen: Optional[float] = None):
    """Coordinate-wise trimmed mean over the client axis.

    Per (t, k) coordinate, drops the ``floor(trim_frac * n_t)`` smallest
    and largest of the ``n_t`` valid client values and averages the rest
    (``trim_frac < 0.5`` leaves at least one). The product is taken in
    float32, as the reference's weakly typed product of an int32 count is,
    so a product that is an integer in float64 floors the same way."""
    if not 0.0 <= trim_frac < 0.5:
        raise ValueError(f"trim_frac must be in [0, 0.5), got {trim_frac!r}")
    xs, n, _ = _sorted_valid(logits, mask)
    frac = torch.tensor(trim_frac, dtype=torch.float32, device=xs.device)
    k = torch.floor(frac * n.to(torch.float32)).to(n.dtype)   # (t,)
    ranks = torch.arange(xs.shape[0], device=xs.device)[:, None, None]
    keep = ((ranks >= k[None, :, None])
            & (ranks < (n - k)[None, :, None]))               # (C, t, 1)
    num = torch.sum(torch.where(keep, xs, 0.0), dim=0)        # (t, K)
    den = torch.sum(keep, dim=0).to(torch.float32)            # (t, 1)
    teacher = num / torch.clamp_min(den, 1.0)
    return _sharpen(teacher, temperature_sharpen), n > 0


def median_logits(logits: torch.Tensor, mask: torch.Tensor, *,
                  temperature_sharpen: Optional[float] = None):
    """Coordinate-wise median over the client axis (an even count averages
    the two middle values)."""
    xs, n, _ = _sorted_valid(logits, mask)
    top = xs.shape[0] - 1

    def pick(idx):
        idx = torch.clamp(idx, 0, top).to(torch.int64)        # (t,)
        return torch.gather(
            xs, 0, idx[None, :, None].expand((1,) + xs.shape[1:]))[0]

    med = 0.5 * (pick(torch.div(n - 1, 2, rounding_mode="floor"))
                 + pick(torch.div(n, 2, rounding_mode="floor")))
    teacher = torch.where((n > 0)[:, None], med, 0.0)
    return _sharpen(teacher, temperature_sharpen), n > 0


def krum_row_logits(logits: torch.Tensor, mask: torch.Tensor, *,
                    temperature_sharpen: Optional[float] = None):
    """Per-proxy-position Krum: each position selects the one client whose
    logits sit closest to its ``n_t - 2`` nearest neighbours (sum of
    squared distances). Ties resolve to the lowest client id
    (``torch.argmin`` returns the first minimum). O(C² t K): for modest
    cohorts."""
    lo = torch.as_tensor(logits).to(torch.float32)
    fin = torch.isfinite(lo).all(dim=-1)
    m = torch.logical_and(mask, fin)                          # (C, t)
    safe = torch.where(m[..., None], lo, 0.0)
    num_clients = lo.shape[0]
    diff = safe[:, None] - safe[None, :]                      # (C, C, t, K)
    d2 = torch.sum(diff * diff, dim=-1)                       # (C, C, t)
    pair = m[:, None, :] & m[None, :, :]
    eye = torch.eye(num_clients, dtype=torch.bool,
                    device=lo.device)[:, :, None]
    d2 = torch.where(pair & ~eye, d2, torch.inf)
    ds = torch.sort(d2, dim=1).values                         # neighbours asc
    n = torch.sum(m, dim=0, dtype=torch.int32)                # (t,)
    q = torch.clamp_min(n - 2, 1)
    take = (torch.arange(num_clients, device=lo.device)[None, :, None]
            < q[None, None, :])
    score = torch.sum(torch.where(take & torch.isfinite(ds), ds, 0.0),
                      dim=1)
    score = torch.where(m, score, torch.inf)                  # (C, t)
    best = torch.argmin(score, dim=0)                         # (t,)
    teacher = torch.gather(
        safe, 0, best[None, :, None].expand((1,) + safe.shape[1:]))[0]
    teacher = torch.where((n > 0)[:, None], teacher, 0.0)
    return _sharpen(teacher, temperature_sharpen), n > 0


def robust_reduce(logits: torch.Tensor, mask: torch.Tensor, mode: str, *,
                  trim_frac: float = 0.2,
                  temperature_sharpen: Optional[float] = None):
    """One of ``ROBUST_AGGREGATIONS`` over the client axis. ``mean`` is
    ``masked_mean_logits``; the robust modes are unweighted (staleness
    weights act only as a contribute/exclude mask upstream)."""
    if mode == "mean":
        return masked_mean_logits(logits, mask,
                                  temperature_sharpen=temperature_sharpen)
    if mode == "trimmed_mean":
        return trimmed_mean_logits(logits, mask, trim_frac=trim_frac,
                                   temperature_sharpen=temperature_sharpen)
    if mode == "median":
        return median_logits(logits, mask,
                             temperature_sharpen=temperature_sharpen)
    if mode == "krum_row":
        return krum_row_logits(logits, mask,
                               temperature_sharpen=temperature_sharpen)
    raise ValueError(
        f"robust_aggregation must be one of {ROBUST_AGGREGATIONS}, "
        f"got {mode!r}")


def client_outlier_distance(logits: torch.Tensor, masks: torch.Tensor,
                            teacher: torch.Tensor
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-client mean squared distance from the fused center, the
    trust/quarantine signal.

    For each client, the mean over its claimed-ID rows of ``mean_k (logit
    - teacher)^2``, where both rows are finite; a client whose claimed
    rows hold a non-finite value scores ``inf``. The row means and their
    per-client sums are float32 on the device; the (C,) sums and counts
    come to the host, where the division is float64, as the reference's
    float32 sum over an int64 count is. Returns ``(dist (C,) float64,
    contributing (C,) bool)`` as numpy: a non-contributing client scores 0
    and must not have its trust updated."""
    lo = torch.as_tensor(logits).to(torch.float32)
    mk = torch.as_tensor(masks, device=lo.device).to(torch.bool)
    th = torch.as_tensor(teacher, device=lo.device).to(torch.float32)
    own_fin = torch.isfinite(lo).all(dim=-1)                  # (C, t)
    th_fin = torch.isfinite(th).all(dim=-1)                   # (t,)
    use = mk & own_fin & th_fin[None, :]
    lo_c = torch.where(own_fin[..., None], lo, 0.0)
    th_c = torch.where(th_fin[:, None], th, 0.0)
    diff = lo_c - th_c[None]
    d2 = torch.where(use, torch.mean(diff * diff, dim=-1), 0.0)  # (C, t)
    sums = torch.sum(d2, dim=1)                               # (C,) f32
    cnt = torch.sum(use, dim=1)
    poisoned = (mk & ~own_fin).any(dim=1)
    contributing = mk.any(dim=1)
    sums, cnt, poisoned, contributing = (
        t.cpu().numpy() for t in (sums, cnt, poisoned, contributing))
    dist = sums / np.maximum(cnt.astype(np.int64), 1)         # float64
    dist = np.where(poisoned, np.inf, dist)
    return dist.astype(np.float64), contributing
