"""Plain PyTorch versions of the temperature-KL kernels.

``kd_kl_per_sample`` is op for op
``repro.kernels.distill_kl.ref.kd_kl_per_sample``; ``kd_kl_loss``, the
fused loss of one distill step, is it followed by the weighted mean of
``repro.core.distill.kd_kl_loss``. Gradients are PyTorch autograd through
these ops. The CPU path, the tests and ``chip_smoke.py`` call them; a
CUDA tensor goes to the kernels (``ops.py``).
"""
from __future__ import annotations

import torch


def kd_kl_per_sample(student_logits: torch.Tensor,
                     teacher_logits: torch.Tensor,
                     temperature: float) -> torch.Tensor:
    """Per-sample KL(teacher_T ∥ student_T) · T². (n, K) -> (n,)."""
    t = temperature
    sp = torch.log_softmax(student_logits.to(torch.float32) / t, dim=-1)
    tlogp = torch.log_softmax(teacher_logits.to(torch.float32) / t, dim=-1)
    tp = torch.exp(tlogp)
    return torch.sum(tp * (tlogp - sp), dim=-1) * (t * t)


def weighted_mean(v: torch.Tensor, sample_weight=None) -> torch.Tensor:
    """sum(v·w) / max(sum(w), 1), or the plain mean without a weight: over
    all of v (n,), or over each row of v (C, n) -> (C,)."""
    if v.ndim > 1:
        if sample_weight is None:
            return torch.mean(v, dim=-1)
        w = sample_weight.to(torch.float32)
        return (torch.sum(v * w, dim=-1)
                / torch.clamp_min(torch.sum(w, dim=-1), 1.0))
    if sample_weight is None:
        return torch.mean(v)
    w = sample_weight.to(torch.float32)
    return torch.sum(v * w) / torch.clamp_min(torch.sum(w), 1.0)


def kd_kl_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
               temperature: float, sample_weight=None) -> torch.Tensor:
    """Weighted mean of the per-sample T²·KL: (n, K), weight (n,) -> 0-d;
    or each client's over its own rows: (C, n, K), weight (C, n) -> (C,),
    the reference's loss vmapped over a cohort's clients."""
    return weighted_mean(kd_kl_per_sample(student_logits, teacher_logits,
                                          temperature), sample_weight)
