"""Wrapper of the RBF Gram-matrix CUDA kernel (``csrc/rbf_matrix.cu``).

``rbf_matrix`` is the public op, also over a client axis (one shared a
against C clients' b, one launch): the kernel for a CUDA tensor, the
plain version (``ref.rbf_matrix``) for a CPU tensor, and an error for
anything else. ``rbf_matrix_cuda`` checks its operands, allocates the output with
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


def _launch(a: torch.Tensor, b: torch.Tensor, sigma: float) -> torch.Tensor:
    """One launch on a (n, d) and b (m, d) (uncounted): the (n, m) view."""
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
    return out if ldo == m else out[:, :m]


def rbf_matrix_cuda(a: torch.Tensor, b: torch.Tensor,
                    sigma: float) -> torch.Tensor:
    """Launch the kernel on a (n, d) and b (m, d), both f32, contiguous and
    on one CUDA device; ``sigma`` a Python float. Returns (n, m) f32: a
    view whose rows are padded to a multiple of 8 floats (so that every
    row starts on a 32-byte sector, which the kernel's stores need to fill
    whole sectors), contiguous when m is such a multiple."""
    out = _launch(a, b, sigma)
    rbf_matrix_cuda.launches += 1
    return out


rbf_matrix_cuda.launches = 0


def rbf_matrix_clients_cuda(a: torch.Tensor, b: torch.Tensor,
                            sigma: float) -> torch.Tensor:
    """One launch for C clients: a (n, d) shared, b (C, m, d), both f32,
    contiguous and on one CUDA device -> (C, n, m) f32, a view of one
    (n, C·m) matrix (the kernel's launch on b's rows stacked) whose rows
    are padded as ``rbf_matrix_cuda``'s. Every entry is computed from its
    own row of a and of b, so client c's (n, m) slice is bit for bit
    ``rbf_matrix_cuda(a, b[c], sigma)``."""
    require_cuda(a, "rbf_matrix")
    if b.ndim != 3:
        raise ValueError("rbf_matrix over clients takes b (C, m, d)")
    c, m, d = b.shape
    out = _launch(a, b.reshape(c * m, d), sigma)
    rbf_matrix_clients_cuda.launches += 1
    return out.view(a.shape[0], c, m).transpose(0, 1)


rbf_matrix_clients_cuda.launches = 0


def rbf_matrix(a: torch.Tensor, b: torch.Tensor, sigma) -> torch.Tensor:
    """RBF Gram matrix exp(−‖a_i − b_j‖² / (2σ²)): a (n, d), b (m, d) ->
    (n, m) f32; or one shared a against C clients' b (C, m, d) -> (C, n,
    m), in one launch. The kernel tiles the output by shape and keeps the
    cross term in IEEE fp32, with the plain version's matmul form."""
    if a.device.type == "cpu":
        return ref.rbf_matrix(a, b, sigma)
    require_cuda(a, "rbf_matrix")
    launch = rbf_matrix_clients_cuda if b.ndim == 3 else rbf_matrix_cuda
    return launch(a.to(torch.float32).contiguous(),
                  b.to(torch.float32).contiguous(), float(sigma))
