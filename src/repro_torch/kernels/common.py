"""Shared helpers for the kernel wrappers."""
from __future__ import annotations

from typing import Sequence

import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def check_operand(t: torch.Tensor, name: str, *, dtype: torch.dtype,
                  shape: Sequence[int], device: torch.device) -> None:
    """Raise unless ``t`` is what a kernel takes: a contiguous tensor of
    ``dtype`` and ``shape`` on ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def require_cuda(t: torch.Tensor, op: str) -> None:
    """A wrapper takes its plain version only for a CPU tensor; anything
    that is neither on the CPU nor on a CUDA device is refused."""
    if t.device.type != "cuda":
        raise ValueError(f"{op}: no kernel for a tensor on {t.device}")
