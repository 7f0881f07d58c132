"""Wrapper of the flash-attention CUDA kernel (``csrc/flash_attention.cu``).

``flash_attention`` is the public, differentiable op: for a CUDA tensor it
runs ``FlashAttentionFunction`` (kernel forward; under ``torch.func.vmap``
one launch for every vmapped slice, the vmapped axes folded into the
batch), for a CPU tensor the plain version (``ref.attention_gqa``) under
autograd, and it refuses anything else. ``flash_attention_cuda`` checks
its operands, allocates the output with ``torch.empty_like``, launches on
the current stream and counts its launches in
``flash_attention_cuda.launches``; a batch above ``MAX_GRID_YZ`` goes out
in chunks, each a launch.

The backward recomputes through the plain version, as the reference's
``custom_vjp`` does (``repro.kernels.flash_attention.ops._attn_bwd``): the
JAX package has no backward kernel for attention either.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import require_cuda
from repro_torch.kernels.flash_attention import ref

HEAD_DIMS = (16, 32, 64, 80, 128)   # the kernel's template instances
_STRIDES = ctypes.c_longlong * 12
MAX_GRID_YZ = 65535             # heads and batch are grid axes y and z
VEC = 4                         # floats in one 16-byte copy


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.repro_flash_attention.argtypes = (
        [ptr] * 4 + [i32] * 6 + [ctypes.POINTER(ctypes.c_longlong), i32, ptr])
    lib.repro_flash_attention.restype = ctypes.c_int
    lib.repro_flash_attention_short_occupancy.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.repro_flash_attention_short_occupancy.restype = ctypes.c_int
    return lib


def vector_aligned(t: torch.Tensor) -> bool:
    """Whether the kernel's 16-byte copies can read ``t`` (4-d): a 16-byte
    aligned pointer and batch, head and sequence strides that are
    multiples of 4 elements. (Runs on every launch: kept to a few
    attribute reads.)"""
    st = t.stride()
    return t.data_ptr() % (4 * VEC) == 0 and (st[0] | st[1] | st[2]) % VEC == 0


def short_route_occupancy(h: int) -> int:
    """Blocks of the short route's kernel (Sq <= 32) at head width ``h``
    that one SM of the current CUDA device holds at once."""
    blocks = ctypes.c_int(0)
    lib = _lib()
    build.check(lib, lib.repro_flash_attention_short_occupancy(
        h, ctypes.byref(blocks)), "flash_attention occupancy")
    return blocks.value


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    require_cuda(q, "flash_attention")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes q (B, N, Sq, h) and k, v "
                         "(B, Nkv, Sk, h)")
    b, n, sq, h = q.shape
    nkv, sk = k.shape[1], k.shape[2]
    for name, t, shape in (("q", q, (b, n, sq, h)), ("k", k, (b, nkv, sk, h)),
                           ("v", v, (b, nkv, sk, h))):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}, expected "
                            "torch.float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last axis must be contiguous")
        if not vector_aligned(t):
            raise ValueError(f"{name} must have a 16-byte aligned pointer "
                             f"and strides that are multiples of {VEC} "
                             f"(got strides {t.stride()})")
    if min(b, n, sq, sk) == 0:
        raise ValueError(f"flash_attention: empty operand q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if n % nkv:
        raise ValueError(f"flash_attention: {nkv} kv heads do not divide "
                         f"{n} query heads")
    if h not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head width {h} has no kernel "
                         f"instance (built: {HEAD_DIMS})")
    if b > MAX_GRID_YZ or n > MAX_GRID_YZ:
        raise ValueError(f"flash_attention: batch {b} or heads {n} exceed "
                         f"the grid's {MAX_GRID_YZ}")
    return b, n, nkv, sq, sk, h


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool) -> torch.Tensor:
    """Launch the kernel on q (B, N, Sq, h) and k, v (B, Nkv, Sk, h), f32
    on one CUDA device, each with a contiguous last axis, a 16-byte
    aligned pointer and strides that are multiples of 4 (any such strides,
    e.g. a transposed view of the model's (B, S, N, h), are read as they
    are). Returns o (B, N, Sq, h) f32 laid out as q."""
    b, n, nkv, sq, sk, h = _check(q, k, v)
    o = torch.empty_like(q)
    strides = _STRIDES(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                       *o.stride()[:3])
    lib = _lib()
    with torch.cuda.device(q.device):
        code = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, n, nkv,
            sq, sk, h, strides, int(bool(causal)),
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, code, "flash_attention")
    flash_attention_cuda.launches += 1
    return o


flash_attention_cuda.launches = 0


def _operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernel reads it: f32, with a contiguous last axis, a
    16-byte aligned pointer and strides that are multiples of 4 (as it is
    when it already is, else a fresh copy: ``contiguous()`` would keep a
    misaligned pointer). Reads the pointer, so it runs on real tensors,
    below any ``vmap`` level."""
    t = t.to(torch.float32)
    if t.stride(-1) == 1 and vector_aligned(t):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool) -> torch.Tensor:
    """``flash_attention_cuda`` on aligned operands, in chunks of at most
    ``MAX_GRID_YZ`` batch rows when the batch (grid axis z) is larger: a
    cohort folds its client axis into the batch. Batch rows are
    independent, so a chunk's rows are bitwise those of one launch."""
    q, k, v = _operand(q), _operand(k), _operand(v)
    b = q.shape[0]
    if b <= MAX_GRID_YZ:
        return flash_attention_cuda(q, k, v, causal)
    return torch.cat([flash_attention_cuda(q[lo:lo + MAX_GRID_YZ],
                                           k[lo:lo + MAX_GRID_YZ],
                                           v[lo:lo + MAX_GRID_YZ], causal)
                      for lo in range(0, b, MAX_GRID_YZ)])


class FlashAttentionFunction(torch.autograd.Function):
    """Attention with the kernel forward and a backward that recomputes
    through the plain version (no probabilities are kept).

    Under ``torch.func.vmap`` (the cohort engine's client axis) the
    ``vmap`` rule folds every batched dimension into the kernel's batch
    axis, (C, B, N, S, h) -> (C·B, N, S, h), and calls the function once:
    one launch for the whole cohort (chunked past ``MAX_GRID_YZ`` rows),
    each client's rows bitwise what its own launch gives."""

    @staticmethod
    def forward(q, k, v, causal: bool):
        return _launch(q, k, v, causal)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal = inputs
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = ref.attention_gqa(*inputs, causal=ctx.causal)
            dq, dk, dv = torch.autograd.grad(out, inputs, g)
        return dq, dk, dv, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal):
        def fold(t, dim):
            t = (t.unsqueeze(0).expand(info.batch_size, *t.shape)
                 if dim is None else t.movedim(dim, 0))
            return t.reshape(t.shape[0] * t.shape[1], *t.shape[2:])
        qd, kd, vd = in_dims[:3]
        o = FlashAttentionFunction.apply(fold(q, qd), fold(k, kd),
                                         fold(v, vd), causal)
        return o.reshape(info.batch_size, -1, *o.shape[1:]), 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Differentiable attention: q (B, N, Sq, h), k and v (B, Nkv, Sk, h)
    with Nkv dividing N (GQA: query head n reads kv head n // (N/Nkv)).
    Returns (B, N, Sq, h) f32. Runs under ``torch.func.vmap`` too, one
    launch for every vmapped slice (``FlashAttentionFunction.vmap``)."""
    if q.device.type == "cpu":
        return ref.attention_gqa(q, k, v, causal=causal)
    require_cuda(q, "flash_attention")
    return FlashAttentionFunction.apply(q, k, v, bool(causal))
