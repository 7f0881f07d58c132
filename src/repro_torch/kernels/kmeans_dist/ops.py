"""Wrapper of the fused Lloyd-step CUDA kernel (``csrc/lloyd_step.cu``).

``lloyd_step`` is the public op: the kernel for a CUDA tensor, the plain
version (``ref.lloyd_step``) for a CPU tensor, and an error for anything
else. ``lloyd_step_cuda`` checks its operands, allocates the outputs and
the per-tile scratch with ``torch.empty``, launches on the current stream
and counts its launches in ``lloyd_step_cuda.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import cdiv, check_operand, require_cuda
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
    lib.repro_lloyd_tile.argtypes = []
    lib.repro_lloyd_tile.restype = ctypes.c_int
    lib.repro_lloyd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.repro_lloyd_smem_bytes.restype = ctypes.c_longlong
    return lib


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
    smem = lib.repro_lloyd_smem_bytes(d, k)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"lloyd_step: {k} centroids of width {d} and a row tile need "
            f"{smem} bytes of shared memory, more than {MAX_SHARED_BYTES}")
    tiles = cdiv(n, lib.repro_lloyd_tile())
    f32 = dict(dtype=torch.float32, device=dev)
    assign = torch.empty((c, n), dtype=torch.int32, device=dev)
    min_d2 = torch.empty((c, n), **f32)
    sums = torch.empty((c, k, d), **f32)
    counts = torch.empty((c, k), **f32)
    part_sums = torch.empty((c, tiles, k, d), **f32)
    part_counts = torch.empty((c, tiles, k), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = lib.repro_lloyd_step(
            x.data_ptr(), centroids.data_ptr(), c, n, d, k,
            assign.data_ptr(), min_d2.data_ptr(), sums.data_ptr(),
            counts.data_ptr(), part_sums.data_ptr(), part_counts.data_ptr(),
            stream)
    build.check(lib, code, "lloyd_step")
    lloyd_step_cuda.launches += 1
    return assign, min_d2, sums, counts


lloyd_step_cuda.launches = 0


def lloyd_step(x: torch.Tensor, centroids: torch.Tensor):
    """One fused Lloyd iteration of the KMeans-DRE fit.

    ``x``: (n, d) or (C, n, d); ``centroids``: (k, d) or (C, k, d). Returns
    ``(assign i32, min_d2 f32, sums f32, counts f32)`` with matching leading
    axes. The kernel computes the matmul-form distances, the argmin and the
    per-centroid sums/counts in one launch pair, without materialising the
    (n, k) one-hot."""
    if x.device.type == "cpu":
        return ref.lloyd_step(x, centroids)
    require_cuda(x, "lloyd_step")
    xb = x.to(torch.float32).contiguous()
    cb = centroids.to(torch.float32).contiguous()
    if x.ndim == 2:
        return tuple(o[0] for o in lloyd_step_cuda(xb[None], cb[None]))
    return lloyd_step_cuda(xb, cb)
