"""Wrappers of the KMeans-DRE CUDA kernels: the fused Lloyd step of the fit
(``csrc/lloyd_step.cu``) and the filter's min-distance estimation step
(``csrc/kmeans_dist.cu``).

``lloyd_step`` and ``min_dist_and_mask`` are the public ops (each also
over a client axis, one launch for C clients): the kernel
for a CUDA tensor, the plain version (``ref``) for a CPU tensor, and an
error for anything else. Each ``*_cuda`` wrapper checks its operands,
allocates its outputs (and scratch) with ``torch.empty``, launches on the
current stream and counts its launches in ``<wrapper>.launches`` (the Lloyd
step's wide route launches two kernels a call: ``lloyd_launches``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_operand, require_cuda
from repro_torch.kernels.kmeans_dist import ref

# shared memory one block may use on Hopper (227 KB opt-in)
MAX_SHARED_BYTES = 232448


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("lloyd_step")
    lib.repro_lloyd_step.argtypes = ([ctypes.c_void_p] * 2
                                     + [ctypes.c_int] * 4
                                     + [ctypes.c_void_p] * 7)
    lib.repro_lloyd_step.restype = ctypes.c_int
    lib.repro_lloyd_scratch_floats.argtypes = [ctypes.c_int] * 4
    lib.repro_lloyd_scratch_floats.restype = ctypes.c_longlong
    lib.repro_lloyd_tickets.argtypes = [ctypes.c_int] * 2
    lib.repro_lloyd_tickets.restype = ctypes.c_int
    for limit in (lib.repro_lloyd_max_d, lib.repro_lloyd_max_k):
        limit.argtypes = []
        limit.restype = ctypes.c_int
    lib.repro_lloyd_launches.argtypes = [ctypes.c_int]
    lib.repro_lloyd_launches.restype = ctypes.c_int
    return lib


# (device index, stream handle) -> the Lloyd kernel's tickets, one int32
# per client (per feature slice and client on the wide route), zero between
# launches; one set per stream, so launches on two streams of a card never
# share them
_tickets: dict = {}


def _lloyd_tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    tickets = _tickets.get(key)
    if tickets is None or len(tickets) < n:
        tickets = _tickets[key] = torch.zeros((max(n, 4096),),
                                              dtype=torch.int32,
                                              device=device)
    return tickets


@functools.cache
def _dist_lib() -> ctypes.CDLL:
    lib = build.load("kmeans_dist")
    lib.repro_min_dist_mask.argtypes = ([ctypes.c_void_p] * 3
                                        + [ctypes.c_float]
                                        + [ctypes.c_int] * 3
                                        + [ctypes.c_void_p] * 3)
    lib.repro_min_dist_mask.restype = ctypes.c_int
    lib.repro_min_dist_mask_clients.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_float, ctypes.c_int]
        + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
        + [ctypes.c_void_p] * 3)
    lib.repro_min_dist_mask_clients.restype = ctypes.c_int
    lib.repro_min_dist_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.repro_min_dist_smem_bytes.restype = ctypes.c_longlong
    return lib


@functools.lru_cache(maxsize=None)
def _dist_smem(d: int, k: int) -> int:
    """Dynamic shared memory the estimation kernel needs for (d, k)."""
    return _dist_lib().repro_min_dist_smem_bytes(d, k)


def lloyd_launches(d: int) -> int:
    """Kernels one ``lloyd_step_cuda`` call launches for rows of width d."""
    return _lib().repro_lloyd_launches(d)


def lloyd_step_cuda(x: torch.Tensor, centroids: torch.Tensor):
    """Launch the kernel on x (C, n, d) and centroids (C, k, d), both f32,
    contiguous and on one CUDA device. Returns (assign (C, n) i32,
    min_d2 (C, n) f32, sums (C, k, d) f32, counts (C, k) f32)."""
    require_cuda(x, "lloyd_step")
    if x.ndim != 3 or centroids.ndim != 3:
        raise ValueError("lloyd_step_cuda takes x (C, n, d) and "
                         "centroids (C, k, d)")
    c, n, d = x.shape
    k = centroids.shape[1]
    dev = x.device
    check_operand(x, "x", dtype=torch.float32, shape=(c, n, d), device=dev)
    check_operand(centroids, "centroids", dtype=torch.float32,
                  shape=(c, k, d), device=dev)
    if min(c, n, d, k) == 0:
        raise ValueError(f"lloyd_step: empty operand x {tuple(x.shape)}, "
                         f"centroids {tuple(centroids.shape)}")
    lib = _lib()
    if d > lib.repro_lloyd_max_d() or k > lib.repro_lloyd_max_k():
        raise ValueError(
            f"lloyd_step: the kernel takes at most {lib.repro_lloyd_max_k()} "
            f"centroids of width at most {lib.repro_lloyd_max_d()}, got "
            f"{k} of width {d}")
    f32 = dict(dtype=torch.float32, device=dev)
    assign = torch.empty((c, n), dtype=torch.int32, device=dev)
    min_d2 = torch.empty((c, n), **f32)
    sums = torch.empty((c, k, d), **f32)
    counts = torch.empty((c, k), **f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        # each block's sums and counts, for the last block's sum
        partials = torch.empty((lib.repro_lloyd_scratch_floats(c, n, d, k),),
                               **f32)
        tickets = _lloyd_tickets(dev, stream, lib.repro_lloyd_tickets(c, d))
        code = lib.repro_lloyd_step(
            x.data_ptr(), centroids.data_ptr(), c, n, d, k,
            assign.data_ptr(), min_d2.data_ptr(), sums.data_ptr(),
            counts.data_ptr(), partials.data_ptr(), tickets.data_ptr(),
            stream)
    build.check(lib, code, "lloyd_step")
    lloyd_step_cuda.launches += lib.repro_lloyd_launches(d)
    return assign, min_d2, sums, counts


lloyd_step_cuda.launches = 0


def lloyd_step(x: torch.Tensor, centroids: torch.Tensor):
    """One fused Lloyd iteration of the KMeans-DRE fit.

    ``x``: (n, d) or (C, n, d); ``centroids``: (k, d) or (C, k, d). Returns
    ``(assign i32, min_d2 f32, sums f32, counts f32)`` with matching leading
    axes. The kernel computes the matmul-form distances, the argmin and the
    per-centroid sums/counts without materialising the (n, k) one-hot: in
    one launch for d <= 64, in two (assignments, then sums) for wider rows,
    up to 4096 (flattened images)."""
    if x.device.type == "cpu":
        return ref.lloyd_step(x, centroids)
    require_cuda(x, "lloyd_step")
    xb = x.to(torch.float32).contiguous()
    cb = centroids.to(torch.float32).contiguous()
    if x.ndim == 2:
        return tuple(o[0] for o in lloyd_step_cuda(xb[None], cb[None]))
    return lloyd_step_cuda(xb, cb)


def min_dist_and_mask_cuda(x: torch.Tensor, centroids: torch.Tensor,
                           threshold):
    """Launch the estimation kernel on x (t, d) and centroids (k, d), both
    f32, contiguous and on the current CUDA device. ``threshold`` is a
    Python float, passed with the launch, or a one-element f32 tensor on
    that device, which the kernel reads there (a calibrated threshold costs
    no host read). Returns (dist (t,) f32, mask (t,) bool)."""
    require_cuda(x, "min_dist_and_mask")
    if x.ndim != 2 or centroids.ndim != 2:
        raise ValueError("min_dist_and_mask_cuda takes x (t, d) and "
                         "centroids (k, d)")
    t, d = x.shape
    k = centroids.shape[0]
    dev = x.device
    f32 = torch.float32
    is_tensor = isinstance(threshold, torch.Tensor)
    # the common case in a few attribute reads (this wrapper's host work is
    # most of a call); anything else is checked operand by operand
    if not (x.dtype is f32 and centroids.dtype is f32 and x.is_contiguous()
            and centroids.is_contiguous() and centroids.device == dev
            and centroids.shape[1] == d
            and (not is_tensor or (threshold.dtype is f32
                                   and threshold.device == dev
                                   and threshold.shape == (1,)))):
        check_operand(x, "x", dtype=f32, shape=(t, d), device=dev)
        check_operand(centroids, "centroids", dtype=f32, shape=(k, d),
                      device=dev)
        if is_tensor:
            check_operand(threshold, "threshold", dtype=f32, shape=(1,),
                          device=dev)
    if is_tensor:
        thr_ptr, thr_value = threshold.data_ptr(), 0.0
    else:
        thr_ptr, thr_value = None, float(threshold)
    if min(t, d, k) == 0:
        raise ValueError(f"min_dist_and_mask: empty operand x "
                         f"{tuple(x.shape)}, centroids "
                         f"{tuple(centroids.shape)}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"min_dist_and_mask: operands on {dev}, but the "
                         f"current device is cuda:{torch.cuda.current_device()}")
    lib = _dist_lib()
    smem = _dist_smem(d, k)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"min_dist_and_mask: {k} centroids of width {d} need {smem} "
            f"bytes of shared memory, more than {MAX_SHARED_BYTES}")
    # one allocation: the distances (t f32), then the mask (t bytes)
    buf = torch.empty((t + (t + 3) // 4,), dtype=torch.float32, device=dev)
    dist = buf[:t]
    mask = buf.view(torch.bool)[4 * t:5 * t]
    # the raw handle of the current stream (torch.cuda.current_stream
    # builds a Stream object, several microseconds a call)
    code = lib.repro_min_dist_mask(
        x.data_ptr(), centroids.data_ptr(), thr_ptr, thr_value, t, d, k,
        dist.data_ptr(), mask.data_ptr(),
        torch._C._cuda_getCurrentRawStream(dev.index))
    build.check(lib, code, "min_dist_and_mask")
    min_dist_and_mask_cuda.launches += 1
    return dist, mask


min_dist_and_mask_cuda.launches = 0


def _client_rows(a: torch.Tensor, c: int):
    """``a`` (C, ...) f32 as a (C, s) buffer whose client rows start on 16
    bytes: itself when its own are (s a multiple of 4 floats, the base
    16-byte aligned), else a padded copy. Returns (buffer, s)."""
    per = a[0].numel()
    if per % 4 == 0 and a.data_ptr() % 16 == 0:
        return a, per
    s = -(-per // 4) * 4
    buf = torch.zeros((c, s), dtype=torch.float32, device=a.device)
    buf[:, :per] = a.reshape(c, per)
    return buf, s


def min_dist_and_mask_clients_cuda(x: torch.Tensor, centroids: torch.Tensor,
                                   threshold):
    """Launch the estimation kernel once for C clients: centroids (C, k, d)
    and x shared (t, d) or per client (C, t, d), all f32, contiguous and
    on the current CUDA device; ``threshold`` a Python float for every
    client, or a (C,) f32 tensor on that device, read there. Returns
    (dist (C, t) f32, mask (C, t) bool); client c's are bit for bit
    ``min_dist_and_mask_cuda`` on its own (16-byte aligned) operands:
    client rows that would not start on 16 bytes are copied to ones that
    do, so every client takes the route its own launch would."""
    require_cuda(x, "min_dist_and_mask")
    if centroids.ndim != 3 or x.ndim not in (2, 3):
        raise ValueError("min_dist_and_mask over clients takes centroids "
                         "(C, k, d) and x (t, d) or (C, t, d)")
    c, k, d = centroids.shape
    t = x.shape[-2]
    dev = x.device
    f32 = torch.float32
    check_operand(centroids, "centroids", dtype=f32, shape=(c, k, d),
                  device=dev)
    check_operand(x, "x", dtype=f32,
                  shape=(t, d) if x.ndim == 2 else (c, t, d), device=dev)
    if isinstance(threshold, torch.Tensor):
        check_operand(threshold, "threshold", dtype=f32, shape=(c,),
                      device=dev)
        thr_ptr, thr_value = threshold.data_ptr(), 0.0
    else:
        thr_ptr, thr_value = None, float(threshold)
    if min(c, t, d, k) == 0:
        raise ValueError(f"min_dist_and_mask: empty operand x "
                         f"{tuple(x.shape)}, centroids "
                         f"{tuple(centroids.shape)}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"min_dist_and_mask: operands on {dev}, but the "
                         f"current device is cuda:{torch.cuda.current_device()}")
    lib = _dist_lib()
    smem = _dist_smem(d, k)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"min_dist_and_mask: {k} centroids of width {d} need {smem} "
            f"bytes of shared memory, more than {MAX_SHARED_BYTES}")
    cb, c_cs = _client_rows(centroids, c)
    if x.ndim == 3:
        xb, x_cs = _client_rows(x, c)
    else:
        xb, x_cs = (x, 0) if x.data_ptr() % 16 == 0 else (x.clone(), 0)
    n = c * t
    buf = torch.empty((n + (n + 3) // 4,), dtype=f32, device=dev)
    dist = buf[:n].view(c, t)
    mask = buf.view(torch.bool)[4 * n:5 * n].view(c, t)
    code = lib.repro_min_dist_mask_clients(
        xb.data_ptr(), cb.data_ptr(), thr_ptr, thr_value, c, x_cs, c_cs, t,
        d, k, dist.data_ptr(), mask.data_ptr(),
        torch._C._cuda_getCurrentRawStream(dev.index))
    build.check(lib, code, "min_dist_and_mask")
    min_dist_and_mask_clients_cuda.launches += 1
    return dist, mask


min_dist_and_mask_clients_cuda.launches = 0


def min_dist_and_mask(x: torch.Tensor, centroids: torch.Tensor, threshold):
    """KMeans-DRE's estimation step: x (t, d), centroids (k, d), threshold
    a float or a one-element tensor -> (distance of each row to its nearest
    centroid (t,) f32, ID mask distance <= threshold (t,) bool).

    Over a client axis (one launch): centroids (C, k, d), thresholds a
    float or a (C,) tensor, and x shared (t, d) or per client (C, t, d)
    -> (C, t) distances and masks.

    On a CUDA tensor a threshold tensor on that device is read there by the
    kernel (no host read); a float, or a tensor on the CPU, goes with the
    launch as a value (no copy to the device)."""
    if x.device.type == "cpu":
        return ref.min_dist_and_mask(x, centroids, threshold)
    require_cuda(x, "min_dist_and_mask")
    if centroids.ndim == 3:
        if not (isinstance(threshold, torch.Tensor)
                and threshold.device == x.device):
            thr = float(threshold)
        else:
            thr = threshold.to(torch.float32).reshape(-1).contiguous()
        return min_dist_and_mask_clients_cuda(
            x.to(torch.float32).contiguous(),
            centroids.to(torch.float32).contiguous(), thr)
    if isinstance(threshold, torch.Tensor) and threshold.device == x.device:
        thr = threshold.to(torch.float32).reshape(1)
    else:
        thr = float(threshold)
    return min_dist_and_mask_cuda(x.to(torch.float32).contiguous(),
                                  centroids.to(torch.float32).contiguous(),
                                  thr)
