"""ctypes bindings for the port's native scene kit (``csrc/scenekit.cpp``).

Port of ``raytracer_js_tpu.native``: host C++ for the octree's CSR build,
its covering-level pass and OBJ loading. The library is compiled at first
use with ``g++ -O3 -fPIC -shared -std=c++17`` (no ``-march`` flag: it runs
on any x86-64 host) into ``build/scenekit/`` at the root of the checkout;
the file name carries a hash of the source and the flags, so a stale
library is never loaded. Every entry point has a NumPy fallback, which is
its specification: the tests and ``chip_smoke.py`` hold the two equal bit
for bit. :func:`available` says whether the library built; the reason it
did not is kept in :func:`build_error`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
import time
from typing import Optional, Tuple

import numpy as np

_PKG = pathlib.Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "scenekit.cpp"
BUILD_DIR = _PKG.parent / "build" / "scenekit"
CXX = "g++"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None
#: seconds the last compile took in this process (0.0: the library existed)
build_seconds = 0.0

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def library_path() -> pathlib.Path:
    """Where the library for this source and these flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update("\0".join((CXX, *CXX_FLAGS)).encode())
    return BUILD_DIR / f"libscenekit_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the scene kit unless its library exists. Concurrent builders
    (test workers) each write a temporary file and rename it into place."""
    global build_seconds
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        subprocess.run([CXX, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, text=True,
                       timeout=300)
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """Build (once) and load the library; None if it cannot be built."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", None)
            _error = f"{type(e).__name__}: {e}" + (f"\n{detail}" if detail
                                                   else "")
            return None
        lib.sk_count_pairs.restype = ctypes.c_int64
        lib.sk_count_pairs.argtypes = [_f32p, _f32p, _u8p, ctypes.c_int64,
                                       _f32p, ctypes.c_float, ctypes.c_int]
        lib.sk_fill_csr.restype = ctypes.c_int32
        lib.sk_fill_csr.argtypes = [_f32p, _f32p, _u8p, ctypes.c_int64,
                                    _f32p, ctypes.c_float, ctypes.c_int,
                                    _i32p, _i32p, ctypes.c_int64]
        lib.sk_covering_levels.restype = None
        lib.sk_covering_levels.argtypes = [_f32p, _f32p, ctypes.c_int64,
                                           _f32p, ctypes.c_float,
                                           ctypes.c_int, _i32p, _i32p]
        lib.sk_obj_counts.restype = ctypes.c_int
        lib.sk_obj_counts.argtypes = [ctypes.c_char_p, _i64p, _i64p]
        lib.sk_obj_load.restype = ctypes.c_int
        lib.sk_obj_load.argtypes = [ctypes.c_char_p, _f32p, _i32p,
                                    ctypes.c_int64, ctypes.c_int64]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library could not be built or loaded (None if it was)."""
    _load()
    return _error


# ---------------------------------------------------------------------------
# Octree CSR build
# ---------------------------------------------------------------------------

def grid_csr(lo: np.ndarray, hi: np.ndarray, fine_mask: np.ndarray,
             root_lo: np.ndarray, root_size: float,
             depth: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """(cell_offsets [R^3+1] i32, cell_ids [K] i32, max_per_cell).

    Native when built; NumPy otherwise. Both paths are bit-identical
    (same cell clipping and stable prim order).
    """
    lib = _load()
    R = 1 << depth
    lo32 = np.ascontiguousarray(lo, np.float32)
    hi32 = np.ascontiguousarray(hi, np.float32)
    fm = np.ascontiguousarray(fine_mask, np.uint8)
    rl = np.ascontiguousarray(root_lo, np.float32)
    n = lo32.shape[0]
    if lib is not None:
        total = lib.sk_count_pairs(lo32, hi32, fm, n, rl,
                                   ctypes.c_float(root_size), depth)
        offsets = np.zeros(R ** 3 + 1, np.int32)
        ids = np.zeros(int(total), np.int32)
        mpc = lib.sk_fill_csr(lo32, hi32, fm, n, rl,
                              ctypes.c_float(root_size), depth,
                              offsets, ids, total)
        if mpc < 0:
            raise ValueError("octree CSR overflow")
        return offsets, ids, int(mpc)
    return _grid_csr_numpy(lo32, hi32, fm.astype(bool), rl, root_size, depth)


def _grid_csr_numpy(lo, hi, fine_mask, root_lo, root_size, depth):
    R = 1 << depth
    cell_sz = root_size / R
    pairs_cell, pairs_id = [], []
    for p in np.where(fine_mask)[0]:
        c_lo = np.clip(np.floor((lo[p] - root_lo) / cell_sz), 0, R - 1).astype(int)
        c_hi = np.clip(np.floor((hi[p] - root_lo) / cell_sz - 1e-9), 0,
                       R - 1).astype(int)
        gx, gy, gz = np.meshgrid(np.arange(c_lo[0], c_hi[0] + 1),
                                 np.arange(c_lo[1], c_hi[1] + 1),
                                 np.arange(c_lo[2], c_hi[2] + 1),
                                 indexing="ij")
        lin = (gx.astype(np.int64) * R + gy) * R + gz
        pairs_cell.append(lin.ravel())
        pairs_id.append(np.full(lin.size, p, np.int64))
    if pairs_cell:
        pc = np.concatenate(pairs_cell)
        pi = np.concatenate(pairs_id)
        o = np.argsort(pc, kind="stable")
        pc, pi = pc[o], pi[o]
        counts = np.bincount(pc, minlength=R ** 3)
        offsets = np.zeros(R ** 3 + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        return (offsets.astype(np.int32), pi.astype(np.int32),
                int(counts.max()) if counts.size else 0)
    return np.zeros(R ** 3 + 1, np.int32), np.zeros(0, np.int32), 0


def covering_levels_native(lo, hi, root_lo, root_size, depth):
    """Native covering-level pass; None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    lo32 = np.ascontiguousarray(lo, np.float32)
    hi32 = np.ascontiguousarray(hi, np.float32)
    rl = np.ascontiguousarray(root_lo, np.float32)
    n = lo32.shape[0]
    level = np.zeros(n, np.int32)
    cell = np.zeros((n, 3), np.int32)
    lib.sk_covering_levels(lo32, hi32, n, rl, ctypes.c_float(root_size),
                           depth, level, np.ascontiguousarray(cell))
    return level.astype(np.int64), cell.astype(np.int64)


# ---------------------------------------------------------------------------
# OBJ loading
# ---------------------------------------------------------------------------

def load_obj(path) -> Tuple[np.ndarray, np.ndarray]:
    """OBJ file -> (vertices [V,3] f32, faces [T,3] i32), fan-triangulated."""
    lib = _load()
    path = str(path)
    if lib is not None:
        nv = np.zeros(1, np.int64)
        nt = np.zeros(1, np.int64)
        if lib.sk_obj_counts(path.encode(), nv, nt) != 0:
            raise IOError(f"cannot read {path}")
        verts = np.zeros((int(nv[0]), 3), np.float32)
        faces = np.zeros((int(nt[0]), 3), np.int32)
        rc = lib.sk_obj_load(path.encode(), np.ascontiguousarray(verts),
                             np.ascontiguousarray(faces), int(nv[0]),
                             int(nt[0]))
        if rc != 0:
            raise IOError(f"OBJ parse failure ({rc}) in {path}")
        return verts, faces
    return _load_obj_python(path)


def _load_obj_python(path):
    verts, faces = [], []
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v ") or line.startswith("v\t"):
                parts = line.split()
                verts.append([float(x) for x in parts[1:4]])
            elif line.startswith("f ") or line.startswith("f\t"):
                idx = []
                for tok in line.split()[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(len(verts) + i if i < 0 else i - 1)
                for k in range(2, len(idx)):
                    faces.append([idx[0], idx[k - 1], idx[k]])
    return (np.asarray(verts, np.float32).reshape(-1, 3),
            np.asarray(faces, np.int32).reshape(-1, 3))
