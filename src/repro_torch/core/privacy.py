"""Pre-distillation privacy counter-measure: the reference's
``repro.core.privacy`` (paper §V-D, future work there; a feature beyond
the paper in both packages).

The Gaussian mechanism on shared proxy data: each client perturbs its
proxy contribution with N(0, σ²) noise calibrated to an (ε, δ) budget by
the analytic Gaussian mechanism bound σ ≥ Δ₂·sqrt(2 ln(1.25/δ))/ε, the
L2 sensitivity Δ₂ taken as the per-sample feature-space clipping norm.
``privatize_proxy`` draws its noise from an explicit ``torch.Generator``
(the reference's takes a JAX key, so the two noises cannot be the same
numbers); ``privatize_proxy_np`` is the numpy variant, the reference's
bit for bit.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class DPParams(NamedTuple):
    epsilon: float
    delta: float
    clip_norm: float
    sigma: float        # resulting noise std


def gaussian_sigma(epsilon: float, delta: float, clip_norm: float) -> float:
    """Analytic Gaussian mechanism noise scale (Dwork & Roth Thm A.1)."""
    if epsilon <= 0:
        raise ValueError("epsilon must be positive")
    return clip_norm * math.sqrt(2.0 * math.log(1.25 / delta)) / epsilon


def make_dp(epsilon: float, delta: float = 1e-5,
            clip_norm: float = 1.0) -> DPParams:
    return DPParams(epsilon, delta, clip_norm,
                    gaussian_sigma(epsilon, delta, clip_norm))


def clip_samples(x: torch.Tensor, clip_norm: float) -> torch.Tensor:
    """Per-sample L2 clipping in flattened feature space (rows of norm
    above ``clip_norm`` scaled down to it; norms floored at 1e-12)."""
    flat = x.reshape(x.shape[0], -1)
    norms = torch.linalg.vector_norm(flat, dim=1, keepdim=True)
    scale = torch.clamp_max(clip_norm / torch.clamp_min(norms, 1e-12), 1.0)
    return (flat * scale).reshape(x.shape)


def privatize_proxy(generator: torch.Generator, x: torch.Tensor,
                    dp: DPParams) -> torch.Tensor:
    """Clip + add Gaussian noise: the released proxy subset, f32 on
    ``x``'s device. ``generator`` must be a generator of that device."""
    clipped = clip_samples(torch.as_tensor(x, dtype=torch.float32),
                           dp.clip_norm)
    noise = torch.randn(clipped.shape, generator=generator,
                        device=clipped.device)
    return clipped + dp.sigma * noise


def privatize_proxy_np(rng: np.random.Generator, x: np.ndarray,
                       dp: DPParams) -> np.ndarray:
    """NumPy variant for the data-pipeline side (proxy.build_proxy hook)."""
    flat = x.reshape(len(x), -1).astype(np.float32)
    norms = np.linalg.norm(flat, axis=1, keepdims=True)
    flat = flat * np.minimum(1.0, dp.clip_norm / np.maximum(norms, 1e-12))
    flat = flat + dp.sigma * rng.standard_normal(flat.shape).astype(np.float32)
    return flat.reshape(x.shape)
