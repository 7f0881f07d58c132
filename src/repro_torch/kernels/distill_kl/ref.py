"""Plain PyTorch version of the fused temperature-KL loss.

Op for op ``repro.kernels.distill_kl.ref.kd_kl_per_sample``; its gradient
is PyTorch autograd through these ops. The CPU path, the tests and
``chip_smoke.py`` call it; a CUDA tensor goes to the kernels (``ops.py``).
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
