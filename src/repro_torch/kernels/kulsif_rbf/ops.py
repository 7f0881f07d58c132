"""Wrapper of the RBF Gram-matrix CUDA kernel (``csrc/rbf_matrix.cu``).

``rbf_matrix`` is the public op: the kernel for a CUDA tensor, the plain
version (``ref.rbf_matrix``) for a CPU tensor, and an error for anything
else. ``rbf_matrix_cuda`` checks its operands, allocates the output with
``torch.empty``, launches on the current stream and counts its launches in
``rbf_matrix_cuda.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_operand, require_cuda
from repro_torch.kernels.kulsif_rbf import ref

# the kernel's smaller row tile; the grid's second axis holds the row tiles
ROW_TILE = 32
MAX_GRID_Y = 65535
# floats a row of the output is padded to: one 32-byte sector
ROW_ALIGN = 8


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("rbf_matrix")
    lib.repro_rbf_matrix.argtypes = ([ctypes.c_void_p] * 2
                                     + [ctypes.c_int] * 3
                                     + [ctypes.c_float]
                                     + [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_void_p])
    lib.repro_rbf_matrix.restype = ctypes.c_int
    return lib


def rbf_matrix_cuda(a: torch.Tensor, b: torch.Tensor,
                    sigma: float) -> torch.Tensor:
    """Launch the kernel on a (n, d) and b (m, d), both f32, contiguous and
    on one CUDA device; ``sigma`` a Python float. Returns (n, m) f32: a
    view whose rows are padded to a multiple of 8 floats (so that every
    row starts on a 32-byte sector, which the kernel's stores need to fill
    whole sectors), contiguous when m is such a multiple."""
    require_cuda(a, "rbf_matrix")
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError("rbf_matrix_cuda takes a (n, d) and b (m, d)")
    n, d = a.shape
    m = b.shape[0]
    check_operand(a, "a", dtype=torch.float32, shape=(n, d), device=a.device)
    check_operand(b, "b", dtype=torch.float32, shape=(m, d), device=a.device)
    if min(n, m, d) == 0:
        raise ValueError(f"rbf_matrix: empty operand a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}")
    if -(-n // ROW_TILE) > MAX_GRID_Y:
        raise ValueError(f"rbf_matrix: {n} rows of a exceed the grid's "
                         f"{MAX_GRID_Y * ROW_TILE}")
    ldo = -(-m // ROW_ALIGN) * ROW_ALIGN
    out = torch.empty((n, ldo), dtype=torch.float32, device=a.device)
    lib = _lib()
    with torch.cuda.device(a.device):
        # 2σ² in double, rounded to f32 by ctypes: the value PyTorch divides
        # by in the plain version
        code = lib.repro_rbf_matrix(
            a.data_ptr(), b.data_ptr(), n, m, d, 2.0 * sigma * sigma,
            out.data_ptr(), ldo, torch.cuda.current_stream().cuda_stream)
    build.check(lib, code, "rbf_matrix")
    rbf_matrix_cuda.launches += 1
    return out if ldo == m else out[:, :m]


rbf_matrix_cuda.launches = 0


def rbf_matrix(a: torch.Tensor, b: torch.Tensor, sigma) -> torch.Tensor:
    """RBF Gram matrix exp(−‖a_i − b_j‖² / (2σ²)): a (n, d), b (m, d) ->
    (n, m) f32. The kernel tiles the output by shape and keeps the cross
    term in IEEE fp32, with the plain version's matmul form."""
    if a.device.type == "cpu":
        return ref.rbf_matrix(a, b, sigma)
    require_cuda(a, "rbf_matrix")
    return rbf_matrix_cuda(a.to(torch.float32).contiguous(),
                           b.to(torch.float32).contiguous(), float(sigma))
