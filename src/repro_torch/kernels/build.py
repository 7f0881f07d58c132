"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each source compiles on first use into a shared library of its own with a
plain C interface (``nvcc -shared``, no PyTorch headers, so a build takes
seconds). Libraries go to ``kernels/_build/`` beside this file, which
``.gitignore`` lists, or to ``$REPRO_TORCH_BUILD_DIR``. A library's file
name carries a hash of its source and the flags: an edited source is
rebuilt and a stale library is never loaded. ``build_all`` starts one nvcc
per source, all at once, and renames each finished library into place, so
two processes building at once never load a half-written file.

Every exported C function returns ``cudaGetLastError()`` after its
launches; ``check`` turns a non-zero code into an exception naming it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("lloyd_step", "kd_kl")
# sm_90a (not sm_90): Hopper's wgmma/setmaxnreg exist only for that target.
# -Xptxas -v reports each kernel's registers, shared memory and spills into
# the build log kept beside the library.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def build_dir() -> Path:
    override = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return (Path(override) if override
            else Path(__file__).resolve().parent / "_build")


def nvcc() -> str:
    candidates = []
    home = os.environ.get("CUDA_HOME")
    if home:
        candidates.append(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"lib{name}-{digest[:16]}.so"


def build_log(name: str) -> str:
    """nvcc's output (ptxas register/shared-memory report) of the last
    build of ``name``, or "" if it has not been built here."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(names: Iterable[str] = SOURCES) -> float:
    """Compile every library in ``names`` that is not built yet, one nvcc
    per source, all started together. Returns the wall seconds taken."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    errors = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"{name}.cu: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, lib)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """Load the library for ``csrc/<name>.cu``, building it first if
    needed (each ops module loads its library once)."""
    path = library_path(name)
    if not path.exists():
        build_all((name,))
    lib = ctypes.CDLL(str(path))
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, op: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if code != 0:
        msg = lib.repro_error_string(code).decode()
        raise RuntimeError(f"{op}: CUDA error {code} ({msg})")
