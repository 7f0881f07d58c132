"""Kernel backend dispatch: route hot-path ops to a CUDA kernel or plain
PyTorch.

Every compute hot spot of the federated round on the ported path (the
Lloyd step of the KMeans-DRE fit, the temperature-KL distillation loss and
its gradient) exists twice: a hand-written CUDA kernel for Hopper
(``repro_torch.kernels.*.ops``) and its plain PyTorch version
(``repro_torch.kernels.*.ref``). This module is the switch between them.

Backends
--------
``kernel_backend ∈ {"auto", "cuda", "torch"}`` (the reference's
``"pallas"`` and ``"jnp"`` are accepted as aliases of ``"cuda"`` and
``"torch"``, so one config value drives both packages):

* ``"auto"`` (the default) — resolves to ``"cuda"`` on a host with a CUDA
  device and to ``"torch"`` elsewhere.
* ``"cuda"`` — the kernel for every tensor on a CUDA device. A tensor on
  the CPU takes the plain version: that, and only that, is what a wrapper
  does with a CPU tensor (it never falls back from a failed build or
  launch).
* ``"torch"`` — an explicit request for the plain version, on any device.

Resolution order for an ``"auto"``/unset request, as in the reference
(``repro/kernels/dispatch.py``): the innermost :func:`kernel_backend`
context manager, then the ``REPRO_KERNEL_BACKEND`` environment variable,
then the platform rule above. An explicit ``"cuda"``/``"torch"`` always
wins. PyTorch runs eagerly, so resolution happens at every call.
"""
from __future__ import annotations

import contextlib
import os
from typing import List, Optional

import torch

from repro_torch.kernels.kmeans_dist.ref import lloyd_step as _lloyd_step_torch
from repro_torch.kernels.kmeans_dist.ref import pairwise_sq_dists

__all__ = ["BACKENDS", "ENV_VAR", "requested_backend", "resolve",
           "kernel_backend", "pairwise_sq_dists", "lloyd_step",
           "kd_kl_per_sample"]

BACKENDS = ("auto", "cuda", "torch")
ALIASES = {"pallas": "cuda", "jnp": "torch"}
ENV_VAR = "REPRO_KERNEL_BACKEND"

_context_stack: List[str] = []


def _validate(name: str, source: str) -> str:
    name = ALIASES.get(name, name)
    if name not in BACKENDS:
        raise ValueError(
            f"unknown kernel backend {name!r} (from {source}); known: "
            f"{', '.join(BACKENDS)} (aliases: {', '.join(ALIASES)})")
    return name


def requested_backend(backend: Optional[str] = None) -> str:
    """The raw request before platform resolution (may be ``"auto"``)."""
    if backend is not None:
        backend = _validate(backend, "argument")
        if backend != "auto":
            return backend
    if _context_stack and _context_stack[-1] != "auto":
        return _context_stack[-1]
    env = os.environ.get(ENV_VAR, "")
    if env:
        env = _validate(env, f"${ENV_VAR}")
        if env != "auto":
            return env
    return "auto"


def resolve(backend: Optional[str] = None) -> str:
    """Resolve a request down to the concrete backend: "cuda" or "torch".

    ``None`` and ``"auto"`` defer to the ambient request (context manager,
    then ``REPRO_KERNEL_BACKEND``), and finally to the platform rule:
    kernels iff a CUDA device is present."""
    b = requested_backend(backend)
    if b != "auto":
        return b
    return "cuda" if torch.cuda.is_available() else "torch"


@contextlib.contextmanager
def kernel_backend(name: str):
    """Scoped ambient-backend override (tests/benchmarks). Overrides
    ``"auto"``/unset requests inside the ``with`` block; an explicit
    per-call/per-config ``"cuda"``/``"torch"`` still wins."""
    _context_stack.append(_validate(name, "kernel_backend()"))
    try:
        yield
    finally:
        _context_stack.pop()


# ---------------------------------------------------------------------------
# Dispatched ops
# ---------------------------------------------------------------------------

def lloyd_step(x, centroids, *, backend: Optional[str] = None):
    """Fused Lloyd assignment + accumulation step of the KMeans-DRE fit.

    ``x``: (n, d) or (C, n, d); ``centroids``: (k, d) / (C, k, d). Returns
    ``(assign int32, min_d2 f32, sums f32, counts f32)`` with matching
    leading axes."""
    if resolve(backend) == "cuda":
        from repro_torch.kernels.kmeans_dist import ops as kd_ops
        return kd_ops.lloyd_step(x, centroids)
    return _lloyd_step_torch(x, centroids)


def kd_kl_per_sample(student_logits, teacher_logits, temperature: float,
                     *, backend: Optional[str] = None):
    """Per-sample temperature-KL (Hinton) distillation loss, (n, K) -> (n,).

    Differentiable on both backends: the kernel route is an
    ``autograd.Function`` whose backward is a second kernel."""
    if resolve(backend) == "cuda":
        from repro_torch.kernels.distill_kl import ops as kl_ops
        return kl_ops.kd_kl_per_sample(student_logits, teacher_logits,
                                       float(temperature))
    from repro_torch.kernels.distill_kl import ref as kl_ref
    return kl_ref.kd_kl_per_sample(student_logits, teacher_logits,
                                   temperature)
