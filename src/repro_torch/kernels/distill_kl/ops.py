"""Wrappers of the temperature-KL CUDA kernels (``csrc/kd_kl.cu``).

Two public, differentiable ops; each takes its plain version
(``ref.py``) under autograd for a CPU tensor and refuses anything that is
neither on the CPU nor on a CUDA device:

* ``kd_kl_loss``: one distill step's loss, the weighted mean of the
  per-sample T²·KL, for one learner (n, K) or for each client of a cohort
  (C, n, K). For a CUDA tensor it runs ``KdKlLossFunction``: one launch
  of the fused kernel writes the loss and the student's gradient (every
  client's, with the client on the grid's y axis), and the backward
  multiplies that gradient by the cotangent.
* ``kd_kl_per_sample``: the per-sample T²·KL, kernels B3 and B4 one for
  one (``KdKlFunction``: forward kernel, backward kernels).

Each ``*_cuda`` wrapper checks its operands, allocates its outputs with
``torch.empty``, launches on the current stream and counts its launches in
``<wrapper>.launches``.
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
    lib.repro_kd_kl_loss.argtypes = [ptr, ptr, ptr, i32, i32, f32, i32,
                                     ptr, ptr, ptr, ptr, ptr, ptr]
    lib.repro_kd_kl_loss_clients.argtypes = [ptr, ptr, ptr, i32, i32, i32,
                                             f32, i32, ptr, ptr, ptr, ptr,
                                             ptr, ptr]
    lib.repro_kd_kl_noop.argtypes = [ptr]
    for fn in (lib.repro_kd_kl_fwd, lib.repro_kd_kl_bwd_ds,
               lib.repro_kd_kl_bwd_dt, lib.repro_kd_kl_loss,
               lib.repro_kd_kl_loss_clients, lib.repro_kd_kl_noop):
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


# rows per block of the fused loss (LOSS_ROWS in csrc/kd_kl.cu): one
# partial sum per block
LOSS_ROWS = 16
# (device index, stream handle) -> the fused loss's tickets, one int32 a
# client, zero between launches; one set per stream, so launches on two
# streams of a card never share them
_tickets: dict = {}


def _ticket(device: torch.device, stream: int, clients: int = 1
            ) -> torch.Tensor:
    key = (device.index, stream)
    ticket = _tickets.get(key)
    if ticket is None or len(ticket) < clients:
        ticket = _tickets[key] = torch.zeros((max(clients, 1),),
                                             dtype=torch.int32, device=device)
    return ticket


def kd_kl_loss_cuda(student: torch.Tensor, teacher: torch.Tensor,
                    sample_weight, temperature: float, want_ds: bool = True):
    """The fused kernel, one launch: (n, K) f32 logits and an optional
    (n,) f32 weight -> ``(loss, kl, ds)``: the 0-d weighted mean of
    ``kl`` (the plain mean without a weight), the per-sample T²·KL (n,)
    and, when ``want_ds``, the loss's gradient for the student (n, K),
    else None. The operands must lie on the current device."""
    require_cuda(student, "kd_kl_loss")
    if student.ndim != 2 or student.numel() == 0:
        raise ValueError("kd_kl_loss takes non-empty (n, K) logits, got "
                         f"{tuple(student.shape)}")
    n, k = student.shape
    dev = student.device
    check_operand(teacher, "teacher", dtype=torch.float32, shape=(n, k),
                  device=dev)
    check_operand(student, "student", dtype=torch.float32, shape=(n, k),
                  device=dev)
    if sample_weight is not None:
        check_operand(sample_weight, "sample_weight", dtype=torch.float32,
                      shape=(n,), device=dev)
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"kd_kl_loss: operands on {dev}, but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    # one allocation: ds (n·K, first, so it is aligned), kl (n), the loss,
    # one partial sum per block
    n_ds = n * k if want_ds else 0
    blocks = -(-n // LOSS_ROWS)
    buf = torch.empty((n_ds + n + 1 + blocks,), dtype=torch.float32,
                      device=dev)
    base = buf.data_ptr()
    lib = _lib()
    code = lib.repro_kd_kl_loss(
        student.data_ptr(), teacher.data_ptr(),
        None if sample_weight is None else sample_weight.data_ptr(), n, k,
        float(temperature), int(want_ds), base + 4 * n_ds,
        base + 4 * (n_ds + n), base if want_ds else None,
        base + 4 * (n_ds + n + 1), _ticket(dev, stream).data_ptr(), stream)
    build.check(lib, code, "kd_kl_loss")
    kd_kl_loss_cuda.launches += 1
    ds = buf.as_strided((n, k), (k, 1)) if want_ds else None
    return (buf.as_strided((), (), n_ds + n),
            buf.as_strided((n,), (1,), n_ds), ds)


kd_kl_loss_cuda.launches = 0


def kd_kl_loss_clients_cuda(student: torch.Tensor, teacher: torch.Tensor,
                            sample_weight, temperature: float,
                            want_ds: bool = True):
    """The fused kernel over a client axis, one launch: (C, n, K) f32
    logits and an optional (C, n) f32 weight -> ``(loss (C,), kl (C, n),
    ds (C, n, K) or None)``, client c's loss the weighted mean over its own
    rows. Client c's outputs are bit for bit ``kd_kl_loss_cuda`` on its
    slices. The operands must lie on the current device."""
    require_cuda(student, "kd_kl_loss")
    if student.ndim != 3 or student.numel() == 0:
        raise ValueError("kd_kl_loss over clients takes non-empty (C, n, K) "
                         f"logits, got {tuple(student.shape)}")
    c, n, k = student.shape
    dev = student.device
    check_operand(teacher, "teacher", dtype=torch.float32, shape=(c, n, k),
                  device=dev)
    check_operand(student, "student", dtype=torch.float32, shape=(c, n, k),
                  device=dev)
    if sample_weight is not None:
        check_operand(sample_weight, "sample_weight", dtype=torch.float32,
                      shape=(c, n), device=dev)
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"kd_kl_loss: operands on {dev}, but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    # one allocation: ds (C·n·K), kl (C·n), the losses (C), each client's
    # partial sums (C·blocks)
    n_ds = c * n * k if want_ds else 0
    blocks = -(-n // LOSS_ROWS)
    buf = torch.empty((n_ds + c * n + c + c * blocks,), dtype=torch.float32,
                      device=dev)
    base = buf.data_ptr()
    lib = _lib()
    code = lib.repro_kd_kl_loss_clients(
        student.data_ptr(), teacher.data_ptr(),
        None if sample_weight is None else sample_weight.data_ptr(), c, n, k,
        float(temperature), int(want_ds), base + 4 * n_ds,
        base + 4 * (n_ds + c * n), base if want_ds else None,
        base + 4 * (n_ds + c * n + c), _ticket(dev, stream, c).data_ptr(),
        stream)
    build.check(lib, code, "kd_kl_loss")
    kd_kl_loss_clients_cuda.launches += 1
    ds = buf.as_strided((c, n, k), (n * k, k, 1)) if want_ds else None
    return (buf.as_strided((c,), (1,), n_ds + c * n),
            buf.as_strided((c, n), (n, 1), n_ds), ds)


kd_kl_loss_clients_cuda.launches = 0


def noop_cuda(device: torch.device) -> None:
    """An empty kernel through the same C interface: the launch floor
    that ``chip_smoke.py`` times beside the fused loss (not counted)."""
    lib = _lib()
    build.check(lib, lib.repro_kd_kl_noop(
        torch.cuda.current_stream(device).cuda_stream), "kd_kl_noop")


class KdKlLossFunction(torch.autograd.Function):
    """The weighted-mean T²·KL loss through the fused kernel: (n, K) logits
    -> 0-d, or over a client axis (C, n, K) -> (C,), each client's loss
    over its own rows (a cohort's distill step, one launch).

    The forward launches it once and keeps the student's gradient for a
    unit cotangent, so the backward is ``ds * g``, no launch of ours. Only
    when the teacher needs a gradient (never in federated distillation,
    where it is the server's constant; (n, K) logits only) does the
    backward launch the per-sample dt kernel with the mean's per-sample
    cotangent. The weight is not differentiated."""

    @staticmethod
    def forward(ctx, student, teacher, sample_weight, temperature: float):
        fused = kd_kl_loss_cuda if student.ndim == 2 else \
            kd_kl_loss_clients_cuda
        loss, _, ds = fused(student, teacher, sample_weight, temperature,
                            want_ds=ctx.needs_input_grad[0])
        ctx.temperature = temperature
        if ctx.needs_input_grad[1]:
            ctx.save_for_backward(ds, student, teacher, sample_weight)
        else:
            ctx.save_for_backward(ds)
        return loss

    @staticmethod
    def backward(ctx, g):
        ds, *operands = ctx.saved_tensors
        # over clients, a client's cotangent scales its own rows
        gs = g if g.ndim == 0 else g[:, None, None]
        d_student = ds * gs if ctx.needs_input_grad[0] else None
        d_teacher = None
        if ctx.needs_input_grad[1]:
            student, teacher, w = operands
            if w is None:
                per_sample = (g / student.shape[0]).expand(student.shape[0])
            else:
                per_sample = w * (g / torch.clamp_min(torch.sum(w), 1.0))
            d_teacher = kd_kl_bwd_dt_cuda(
                student, teacher,
                per_sample.to(torch.float32).contiguous(), ctx.temperature)
        return d_student, d_teacher, None, None


def _f32(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.float32 and t.is_contiguous():
        return t
    return t.to(torch.float32).contiguous()


def kd_kl_loss(student: torch.Tensor, teacher: torch.Tensor,
               temperature: float, sample_weight=None) -> torch.Tensor:
    """Differentiable loss of one distill step: the mean of the
    per-sample T²·KL(teacher_T ∥ student_T) weighted by ``sample_weight``
    (n,), or the plain mean without it. (n, K) logits -> 0-d; over a
    client axis, (C, n, K) logits and a (C, n) weight -> (C,), one launch
    for every client. ``temperature`` is a Python float (never
    differentiated)."""
    if student.device.type == "cpu":
        return ref.kd_kl_loss(student, teacher, temperature, sample_weight)
    require_cuda(student, "kd_kl_loss")
    if student.ndim == 3 and teacher.requires_grad:
        raise ValueError("kd_kl_loss: over clients the kernel route does "
                         "not differentiate the teacher")
    if sample_weight is not None:
        if sample_weight.requires_grad:
            raise ValueError("kd_kl_loss: the kernel route does not "
                             "differentiate the sample weight")
        sample_weight = _f32(sample_weight)
    return KdKlLossFunction.apply(_f32(student), _f32(teacher),
                                  sample_weight, float(temperature))


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
