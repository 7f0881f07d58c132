"""Server-side aggregation (Algorithm 1 line 15) — masked mean of ID logits.

EdgeFD's server averages the ID predictions each client uploaded: no
filtering, no teacher model. The plain mean guards against non-finite
client rows (an exact no-op on finite inputs). DS-FL sharpens the mean
(``temperature_sharpen``); FKD and PLS exchange class-wise mean logits
(``classwise_mean_logits``); a round with stale reports weights each
client by its staleness (``weighted_masked_mean_logits``). The robust
reducers and the two-tier partial sums of ``repro.core.aggregation`` are
not ported yet (ROADMAP queue A item 7).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


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
