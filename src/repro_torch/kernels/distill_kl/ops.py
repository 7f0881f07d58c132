"""Wrappers of the temperature-KL CUDA kernels (``csrc/kd_kl.cu``).

``kd_kl_per_sample`` is the public, differentiable op: for a CUDA tensor
it runs ``KdKlFunction`` (forward kernel, backward kernels), for a CPU
tensor the plain version (``ref.kd_kl_per_sample``) under autograd, and it
refuses anything else. Each ``*_cuda`` wrapper checks its operands,
allocates its output with ``torch.empty``, launches on the current stream
and counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_operand, require_cuda
from repro_torch.kernels.distill_kl import ref


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("kd_kl")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.repro_kd_kl_fwd.argtypes = [ptr, ptr, i32, i32, f32, ptr, ptr]
    lib.repro_kd_kl_bwd_ds.argtypes = [ptr, ptr, ptr, i32, i32, f32, ptr, ptr]
    lib.repro_kd_kl_bwd_dt.argtypes = [ptr, ptr, ptr, i32, i32, f32, ptr, ptr]
    for fn in (lib.repro_kd_kl_fwd, lib.repro_kd_kl_bwd_ds,
               lib.repro_kd_kl_bwd_dt):
        fn.restype = ctypes.c_int
    return lib


def _check_logits(student: torch.Tensor, teacher: torch.Tensor, op: str):
    require_cuda(student, op)
    if student.ndim != 2:
        raise ValueError(f"{op} takes (n, K) logits, got "
                         f"{tuple(student.shape)}")
    n, k = student.shape
    if n == 0 or k == 0:
        raise ValueError(f"{op}: empty logits {tuple(student.shape)}")
    for name, t in (("student", student), ("teacher", teacher)):
        check_operand(t, name, dtype=torch.float32, shape=(n, k),
                      device=student.device)
    return n, k


def kd_kl_fwd_cuda(student: torch.Tensor, teacher: torch.Tensor,
                   temperature: float) -> torch.Tensor:
    """Forward kernel: (n, K) f32 logits -> per-sample T²·KL (n,) f32."""
    n, k = _check_logits(student, teacher, "kd_kl_fwd")
    out = torch.empty((n,), dtype=torch.float32, device=student.device)
    lib = _lib()
    with torch.cuda.device(student.device):
        code = lib.repro_kd_kl_fwd(
            student.data_ptr(), teacher.data_ptr(), n, k, float(temperature),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    build.check(lib, code, "kd_kl_fwd")
    kd_kl_fwd_cuda.launches += 1
    return out


def _bwd(launcher, name: str, student, teacher, g, temperature):
    n, k = _check_logits(student, teacher, name)
    check_operand(g, "g", dtype=torch.float32, shape=(n,),
                  device=student.device)
    out = torch.empty((n, k), dtype=torch.float32, device=student.device)
    lib = _lib()
    with torch.cuda.device(student.device):
        code = getattr(lib, launcher)(
            student.data_ptr(), teacher.data_ptr(), g.data_ptr(), n, k,
            float(temperature), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, code, name)
    return out


def kd_kl_bwd_ds_cuda(student, teacher, g, temperature) -> torch.Tensor:
    """d(T²·KL)/d student for per-sample cotangent g (n,): (n, K) f32."""
    ds = _bwd("repro_kd_kl_bwd_ds", "kd_kl_bwd_ds", student, teacher, g,
              temperature)
    kd_kl_bwd_ds_cuda.launches += 1
    return ds


def kd_kl_bwd_dt_cuda(student, teacher, g, temperature) -> torch.Tensor:
    """d(T²·KL)/d teacher for per-sample cotangent g (n,): (n, K) f32."""
    dt = _bwd("repro_kd_kl_bwd_dt", "kd_kl_bwd_dt", student, teacher, g,
              temperature)
    kd_kl_bwd_dt_cuda.launches += 1
    return dt


kd_kl_fwd_cuda.launches = 0
kd_kl_bwd_ds_cuda.launches = 0
kd_kl_bwd_dt_cuda.launches = 0


class KdKlFunction(torch.autograd.Function):
    """Per-sample T²·KL with kernel forward and kernel backward.

    The residuals are the raw logits; the backward kernels recompute both
    softmaxes. The teacher's gradient is launched only when autograd needs
    it (in federated distillation the teacher is a constant)."""

    @staticmethod
    def forward(ctx, student, teacher, temperature: float):
        ctx.save_for_backward(student, teacher)
        ctx.temperature = temperature
        return kd_kl_fwd_cuda(student, teacher, temperature)

    @staticmethod
    def backward(ctx, g):
        student, teacher = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        ds = dt = None
        if ctx.needs_input_grad[0]:
            ds = kd_kl_bwd_ds_cuda(student, teacher, g, ctx.temperature)
        if ctx.needs_input_grad[1]:
            dt = kd_kl_bwd_dt_cuda(student, teacher, g, ctx.temperature)
        return ds, dt, None


def kd_kl_per_sample(student: torch.Tensor, teacher: torch.Tensor,
                     temperature: float) -> torch.Tensor:
    """Differentiable per-sample T²·KL(teacher_T ∥ student_T), (n, K) ->
    (n,). ``temperature`` is a Python float (never differentiated)."""
    if student.device.type == "cpu":
        return ref.kd_kl_per_sample(student, teacher, temperature)
    require_cuda(student, "kd_kl_per_sample")
    return KdKlFunction.apply(student.to(torch.float32).contiguous(),
                              teacher.to(torch.float32).contiguous(),
                              float(temperature))
