"""Knowledge-distillation losses (Hinton et al.; Algorithm 1 line 41).

Clients distill from the server's aggregated ensemble logits over proxy
samples. ``kd_kl_loss`` takes its per-sample KL from
``dispatch.kd_kl_per_sample``: the fused CUDA kernels (forward and
backward) for CUDA tensors, the plain PyTorch version for CPU tensors. A
per-sample weight masks out proxy samples with no valid teacher.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import dispatch


def _weighted_mean(v: torch.Tensor, sample_weight) -> torch.Tensor:
    if sample_weight is None:
        return torch.mean(v)
    w = sample_weight.to(torch.float32)
    return torch.sum(v * w) / torch.clamp_min(torch.sum(w), 1.0)


def kd_kl_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
               temperature: float = 3.0, sample_weight=None, *,
               backend: Optional[str] = None) -> torch.Tensor:
    """KL(teacher_T ∥ student_T) · T², mean over weighted samples.

    student_logits/teacher_logits: (..., K). Scaled by T² so gradient
    magnitudes match the CE loss."""
    lead = student_logits.shape[:-1]
    k = student_logits.shape[-1]
    kl = dispatch.kd_kl_per_sample(
        student_logits.reshape(-1, k), teacher_logits.reshape(-1, k),
        temperature, backend=backend).reshape(lead)
    return _weighted_mean(kl, sample_weight)


def kd_mse_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                sample_weight=None) -> torch.Tensor:
    """Mean-squared error on raw logits (FedMD-style digest matching)."""
    se = torch.mean(torch.square(student_logits.to(torch.float32)
                                 - teacher_logits.to(torch.float32)), dim=-1)
    return _weighted_mean(se, sample_weight)


def ce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Plain classification CE (local training, Algorithm 1 line 40)."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.take_along_dim(logp, labels.to(torch.int64)[..., None],
                              dim=-1)[..., 0]
    return -torch.mean(ll)
