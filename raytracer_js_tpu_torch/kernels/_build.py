"""Build and load the package's CUDA kernels.

The sources under ``csrc/`` have a plain C interface. They are compiled by
``nvcc`` into a shared library under ``build/torch_kernels/`` at the root of
the checkout, at first use, and loaded with ``ctypes``. The library's file
name carries a hash of the sources and the flags, so a stale library is
never loaded. Without ``nvcc`` the build raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

_PKG = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "trace_fused.cu"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

#: sm_90a (Hopper); no fast math, and --fmad=false so the kernels round
#: operation for operation like their plain PyTorch versions
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")


@dataclasses.dataclass(frozen=True)
class Build:
    path: pathlib.Path
    seconds: float      # nvcc wall time; 0.0 when the library was cached
    log: str            # nvcc/ptxas output (registers, spills per kernel)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (searched PATH and CUDA_HOME): the "
                       "CUDA kernels cannot be built")


def build() -> Build:
    """Compile ``csrc/trace_fused.cu`` unless a library for these exact
    sources and flags exists already."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + "\0".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"libtrace_fused_{digest[:16]}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        return Build(lib, 0.0, log.read_text() if log.exists() else "")
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n{out}")
    log.write_text(out)
    os.replace(tmp, lib)
    return Build(lib, seconds, out)


_P, _I, _U, _F, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                       ctypes.c_float, ctypes.c_longlong)


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process."""
    lib = ctypes.CDLL(str(build().path))
    tables = [_P, _I, _P, _I, _P, _I, _P]   # sph, box, tri (with counts), sky
    lib.rt_trace_frame.argtypes = tables + [
        _P, _I, _I, _I, _F, _I, _I, _U, _I, _I, _P, _P, _P, _I, _P]
    lib.rt_trace_frame.restype = _I
    lib.rt_trace_rays.argtypes = tables + [
        _P, _P, _P, _P, _LL, _I, _F, _I, _I, _U, _P, _P, _P, _I, _P]
    lib.rt_trace_rays.restype = _I
    lib.rt_error_string.argtypes = [_I]
    lib.rt_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err:
        msg = lib.rt_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
