"""Kernel backend dispatch: route hot-path ops to a CUDA kernel or plain
PyTorch.

Every compute hot spot of the federated round on the ported path (the
Lloyd step of the KMeans-DRE fit, the KMeans-DRE filter's min-distance
estimation, the KuLSIF-DRE's RBF Gram matrix, the temperature-KL
distillation loss and its gradient, and the transformer clients'
attention) exists twice: a hand-written CUDA
kernel for Hopper (``repro_torch.kernels.*.ops``) and its plain PyTorch
version (``repro_torch.kernels.*.ref``). This module is the switch between them.
The Lloyd step, the estimation step, the Gram matrix and the KL loss also
take a client axis (the cohort engine's stacked clients, one launch for
all of them), as the reference's cohort engine vmaps them.

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

from repro_torch.kernels.kmeans_dist import ref as _kd_ref
from repro_torch.kernels.kmeans_dist.ref import pairwise_sq_dists
from repro_torch.kernels.kulsif_rbf import ref as _rbf_ref

__all__ = ["BACKENDS", "ENV_VAR", "requested_backend", "resolve",
           "kernel_backend", "pairwise_sq_dists", "lloyd_step",
           "min_dist_and_mask", "rbf_matrix", "kd_kl_loss",
           "kd_kl_per_sample", "flash_attention"]

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
    return _kd_ref.lloyd_step(x, centroids)


def min_dist_and_mask(x, centroids, threshold, *,
                      backend: Optional[str] = None):
    """KMeans-DRE's estimation step: x (t, d), centroids (k, d) ->
    ``(dist (t,) f32, mask (t,) bool)``, the distance of each row to its
    nearest centroid and ``dist <= threshold``. ``threshold`` is a float or
    a one-element tensor; the kernel reads a tensor where it lies.

    Over a client axis: centroids (C, k, d), ``threshold`` a float or a
    (C,) tensor, x shared (t, d) or per client (C, t, d) -> (C, t) each."""
    if resolve(backend) == "cuda":
        from repro_torch.kernels.kmeans_dist import ops as kd_ops
        return kd_ops.min_dist_and_mask(x, centroids, threshold)
    return _kd_ref.min_dist_and_mask(x, centroids, threshold)


def rbf_matrix(a, b, sigma, *, backend: Optional[str] = None):
    """RBF Gram matrix K(a, b), (n, d) × (m, d) -> (n, m) f32: the
    KuLSIF-DRE learn/estimate hot spot. ``sigma`` is a Python float. Over
    a client axis: one shared a (n, d) against b (C, m, d) -> (C, n, m)."""
    if resolve(backend) == "cuda":
        from repro_torch.kernels.kulsif_rbf import ops as rbf_ops
        return rbf_ops.rbf_matrix(a, b, sigma)
    return _rbf_ref.rbf_matrix(a, b, sigma)


def kd_kl_loss(student_logits, teacher_logits, temperature: float,
               sample_weight=None, *, backend: Optional[str] = None):
    """One distill step's temperature-KL loss: the mean of the per-sample
    T²·KL over (n, K) logits, weighted by ``sample_weight`` (n,) when
    given -> 0-d; over a client axis, (C, n, K) logits and a (C, n) weight
    -> (C,), each client's loss over its own rows.

    Differentiable on both backends: the kernel route is an
    ``autograd.Function`` whose one forward launch also writes the
    student's gradient; the plain route is ``kd_kl_per_sample``'s plain
    version followed by the weighted mean."""
    if resolve(backend) == "cuda":
        from repro_torch.kernels.distill_kl import ops as kl_ops
        return kl_ops.kd_kl_loss(student_logits, teacher_logits,
                                 float(temperature), sample_weight)
    from repro_torch.kernels.distill_kl import ref as kl_ref
    return kl_ref.kd_kl_loss(student_logits, teacher_logits, temperature,
                             sample_weight)


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


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    backend: Optional[str] = None):
    """Full-sequence attention in the model layout: q (B, S, N, h), k and
    v (B, S, Nkv, h) with Nkv dividing N. Returns (B, S, N, h) in
    ``v.dtype``.

    The transformer clients' local-train, report, distill and eval hot
    path. The plain route expands k/v to N heads by repeat and runs
    ``models.layers``' mask + scores sequence, op for op the reference's
    jnp route; the kernel route reads the kv heads in place, with no
    transpose or repeat copy (the kernel takes strided (B, N, S, h) views).
    It covers causal and full attention only: a sliding ``window`` always
    takes the plain route. Differentiable on both routes (the kernel route
    is an ``autograd.Function`` whose backward recomputes through the
    plain version)."""
    if window == 0 and resolve(backend) == "cuda":
        from repro_torch.kernels.flash_attention import ops as fa_ops
        o = fa_ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=causal)
        return o.transpose(1, 2).to(v.dtype)
    from repro_torch.models import layers as L
    n_rep = q.shape[2] // k.shape[2]
    mask = L.make_mask(q.shape[1], k.shape[1], causal=causal, window=window,
                       device=q.device)
    return L.attention_scores(q, L._expand_kv(k, n_rep), L._expand_kv(v, n_rep),
                              mask)
