"""Server-side aggregation (Algorithm 1 line 15) — masked mean of ID logits.

EdgeFD's server averages the ID predictions each client uploaded: no
filtering, no teacher model. The plain mean guards against non-finite
client rows (an exact no-op on finite inputs). The robust reducers and
the two-tier partial sums of ``repro.core.aggregation`` are not ported
yet (ROADMAP queue A item 7).
"""
from __future__ import annotations

from typing import Tuple

import torch


def _finite_rows(logits: torch.Tensor, mask: torch.Tensor):
    """Drop non-finite client rows: a (c, t) row with any inf/NaN entry is
    removed from the mask and zeroed in the values (``0 * nan`` is nan, so
    masking alone is not enough). Exact identity on finite inputs."""
    lo = torch.as_tensor(logits).to(torch.float32)
    fin = torch.isfinite(lo).all(dim=-1)                      # (C, t)
    return torch.where(fin[..., None], lo, 0.0), fin



def masked_mean_logits(logits: torch.Tensor, mask: torch.Tensor, *,
                       guard_finite: bool = True):
    """logits: (C, t, K) per-client proxy logits; mask: (C, t) ID decisions.

    Returns (teacher (t, K), valid (t,) bool). Samples where no client is
    ID get a zero teacher and valid=False — the distillation loss masks
    them. ``guard_finite=False`` re-exposes the poison-the-teacher
    behavior of an unsanitized server. (The reference's DS-FL
    ``temperature_sharpen`` comes with ROADMAP queue A item 4.)"""
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
    return teacher, valid


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
