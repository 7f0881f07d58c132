"""Knowledge-distillation losses (Hinton et al.; Algorithm 1 line 41).

Clients distill from the server's aggregated ensemble logits over proxy
samples. ``kd_kl_loss`` is ``dispatch.kd_kl_loss``: for CUDA tensors one
launch of the fused kernel for the loss and the student's gradient, for
CPU tensors the plain PyTorch version. A per-sample weight masks out proxy
samples with no valid teacher.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.distill_kl.ref import weighted_mean as _weighted_mean


def kd_kl_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
               temperature: float = 3.0, sample_weight=None, *,
               backend: Optional[str] = None) -> torch.Tensor:
    """KL(teacher_T ∥ student_T) · T², mean over weighted samples.

    student_logits/teacher_logits: (..., K). Scaled by T² so gradient
    magnitudes match the CE loss."""
    if student_logits.ndim != 2:  # a distill step's (n, K) goes as it is
        k = student_logits.shape[-1]
        student_logits = student_logits.reshape(-1, k)
        teacher_logits = teacher_logits.reshape(-1, k)
        if sample_weight is not None:
            sample_weight = sample_weight.reshape(-1)
    return dispatch.kd_kl_loss(student_logits, teacher_logits, temperature,
                               sample_weight, backend=backend)


def kd_kl_loss_clients(student_logits: torch.Tensor,
                       teacher_logits: torch.Tensor,
                       temperature: float = 3.0, sample_weight=None, *,
                       backend: Optional[str] = None) -> torch.Tensor:
    """``kd_kl_loss`` for each client of a cohort: (C, B, K) logits and a
    (C, B) weight -> (C,), client c's loss over its own rows — the
    reference's loss vmapped over clients, one launch of the fused kernel
    on a CUDA tensor."""
    return dispatch.kd_kl_loss(student_logits, teacher_logits, temperature,
                               sample_weight, backend=backend)


def kd_mse_loss_clients(student_logits: torch.Tensor,
                        teacher_logits: torch.Tensor,
                        sample_weight=None) -> torch.Tensor:
    """``kd_mse_loss`` for each client: (C, B, K), weight (C, B) -> (C,)."""
    se = torch.mean(torch.square(student_logits.to(torch.float32)
                                 - teacher_logits.to(torch.float32)), dim=-1)
    return _weighted_mean(se, sample_weight)


def ce_loss_clients(logits: torch.Tensor, labels: torch.Tensor,
                    sample_weight: torch.Tensor) -> torch.Tensor:
    """Each client's weighted CE over its padded batch, as the reference's
    cohort computes it: (C, B, K) logits, (C, B) labels and weights (0 on
    pad slots) -> (C,), ``-Σ w·log p_y / max(Σ w, 1)``."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.take_along_dim(logp, labels.to(torch.int64)[..., None],
                              dim=-1)[..., 0]
    return -(torch.sum(ll * sample_weight, dim=-1)
             / torch.clamp_min(torch.sum(sample_weight, dim=-1), 1.0))


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
