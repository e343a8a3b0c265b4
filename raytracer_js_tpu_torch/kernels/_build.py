"""Build and load the package's CUDA kernels.

The sources under ``csrc/`` have a plain C interface (``csrc/*.cuh`` are
headers they include). Each ``csrc/*.cu`` is compiled by its own ``nvcc``
process (all started together) into an object file, and the objects are
linked into one shared library under ``build/torch_kernels/`` at the root
of the checkout, at first use, and loaded with ``ctypes``. The library's
file name carries a hash of every source, header and flag, so a stale
library is never loaded. Without ``nvcc`` the build raises: there is no
fallback.
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
from typing import Optional

import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
#: headers the sources include (part of the hash, not compiled alone)
HEADERS = tuple(sorted((_PKG / "csrc").glob("*.cuh")))
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
#: sm_90a (Hopper); no fast math, and --fmad=false so the kernels round
#: operation for operation like their plain PyTorch versions
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xcompiler",
              "-fPIC", "-Xptxas=-v")
LINK_FLAGS = (*_ARCH, "-shared")


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


def _digest() -> str:
    h = hashlib.sha256()
    for src in SOURCES + HEADERS:
        h.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    h.update("\0".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Build:
    """Compile every ``csrc/*.cu`` and link them into one library, unless a
    library for these exact sources and flags exists already."""
    digest = _digest()
    lib = BUILD_DIR / f"librt_kernels_{digest}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        return Build(lib, 0.0, log.read_text() if log.exists() else "")
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{digest}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}_{tag}.o" for src in SOURCES]
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(SOURCES, objs)]
    outs = [(src.name, p.communicate()[0], p.returncode)
            for src, p in zip(SOURCES, procs)]
    out = "".join(f"== {name}\n{text}" for name, text, _ in outs)
    failed = [name for name, _, rc in outs if rc != 0]
    if not failed:
        link = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True, check=False)
        out += f"== link\n{link.stdout}{link.stderr}"
        if link.returncode != 0:
            failed = ["link"]
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{out}")
    log.write_text(out)
    os.replace(tmp, lib)
    return Build(lib, seconds, out)


_P, _I, _U, _F, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                       ctypes.c_float, ctypes.c_longlong)


# sph, box, tri (+ counts), sky, sph4, balls, refr0, refr_def
_FUSED_TABLES = [_P, _I, _P, _I, _P, _I, _P, _P, _P, _P, _P]
_HIT_TABLES = [_P, _I, _I] * 3                 # sph, box, tri (+ count, stride)
# sph, box (+ counts), sky, org, dir, pid_seq, n, refmax, atten
_REPLAY_ARGS = [_P, _I, _P, _I, _P, _P, _P, _P, _LL, _I, _F]

#: every C entry of the library -> (argtypes, restype); pointers and the
#: stream are c_void_p, so ctypes never cuts them to 32 bits
SIGNATURES = {
    # pos, front, left, up, step_h, step_v, off_h, off_v, w, h, refmax,
    # atten, has_rough, has_trans, seed, spp, sample, rgb, status, rec_pid,
    # work, device, stream
    "rt_trace_frame": (_FUSED_TABLES + [
        _P, _P, _P, _P, _F, _F, _I, _I, _I, _I, _I, _F, _I, _I, _U, _I, _I,
        _P, _P, _P, _P, _I, _P], _I),
    # org, dir, rid, n, refmax, atten, has_rough, has_trans, seed, rgb,
    # status, rec_pid, work, device, stream
    "rt_trace_rays": (_FUSED_TABLES + [
        _P, _P, _P, _LL, _I, _F, _I, _I, _U, _P, _P, _P, _P, _I, _P], _I),
    # sphere bounds, org, dir, n, t, pid, work, device, stream
    "rt_nearest_hit_scalar": (_HIT_TABLES + [
        _P, _P, _P, _LL, _P, _P, _P, _I, _P], _I),
    # org, dir, n, n_live, splits, t and pid of the splits, t, pid, device,
    # stream
    "rt_nearest_hit_dense": (_HIT_TABLES + [
        _P, _P, _LL, _P, _I, _P, _P, _P, _P, _I, _P], _I),
    # org, dir, n, n_live, bbox, sphere list (ids, tlo, cols, fan), triangle
    # list, t, pid, work, device, stream
    "rt_nearest_hit_listed": (_HIT_TABLES + [
        _P, _P, _LL, _P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _P, _P, _P, _I,
        _P], _I),
    # org, dir, n, n_live, tile bounds, t, pid, work, device, stream
    "rt_nearest_hit_culled": (_HIT_TABLES + [
        _P, _P, _LL, _P, _P, _P, _P, _P, _I, _P], _I),
    # tab, c_max, cnts, cam, nby, nbx, 4 flags, out, work, device, stream
    "rt_tiled_frame": ([_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _I,
                        _P], _I),
    # tab, c_max, cnts, cam, state, rows, wave_sub, 2 static bases, 4
    # flags, out, work, device, stream
    "rt_tiled_wave": ([_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                       _P, _P, _I, _P], _I),
    # sphere centers, radii (+ count), box centers, halves (+ count), tri
    # v0, v1, v2 (+ count), root_lo, root_size, coarse ids (+ count), cell
    # offsets, cell ids (+ count), skip field, res, max_per_cell, org, dir,
    # live mask, n, t, pid, steps, tests, device, stream
    "rt_octree_dda": ([_P, _P, _I, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P,
                       _I, _P, _P, _I, _P, _I, _I, _P, _P, _P, _LL, _P, _P,
                       _P, _P, _I, _P], _I),
    # sphere centers, radii (+ count), box centers, halves (+ count), tri
    # v0, v1, v2 (+ count), prim material and texture ids, material
    # response, light, mirror, roughness, solid colors, sky row, org, dir,
    # color, path, status, pid, bounce (+ the int bounce), rid, has_rough,
    # seed, last, atten, n, the six outputs, device, stream
    "rt_shade_bounce": ([_P, _P, _I, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P,
                         _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                         _P, _I, _U, _I, _F, _LL, _P, _P, _P, _P, _P, _P, _I,
                         _P], _I),
    # lo, hi, fine mask, n, root_lo (three floats), root_size, depth, counts,
    # device, stream
    "rt_octree_count": ([_P, _P, _P, _LL, _F, _F, _F, _F, _I, _P, _I, _P],
                        _I),
    # count's arguments, then offsets, cursor, ids, device, stream
    "rt_octree_fill": ([_P, _P, _P, _LL, _F, _F, _F, _F, _I, _P, _P, _P, _I,
                        _P], _I),
    # offsets, out, u8 scratch, deque scratch, res, device, stream
    "rt_octree_skip": ([_P, _P, _P, _P, _I, _I, _P], _I),
    "rt_replay_fwd": (_REPLAY_ARGS + [_P, _I, _P], _I),
    # atten2, g_color, n_glob, g_org, g_dir, out, partial, blocks, device,
    # stream
    "rt_replay_bwd": (_REPLAY_ARGS + [
        _F, _P, _I, _P, _P, _P, _P, _I, _I, _P], _I),
    # refmax, cols, device
    "rt_replay_bwd_blocks_per_sm": ([_I, _I, _I], _I),
    "rt_error_string": ([_I], ctypes.c_char_p),
}


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process."""
    lib = ctypes.CDLL(str(build().path))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err:
        msg = lib.rt_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


# ---------------------------------------------------------------------------
# Helpers shared by the launch wrappers
# ---------------------------------------------------------------------------

def on_cpu(device: torch.device) -> bool:
    """True for CPU tensors (take the plain version), False for CUDA
    tensors (launch the kernel); anything else raises."""
    if device.type == "cpu":
        return True
    if device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {device}")


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def need(t: torch.Tensor, name: str, dtype, shape, device) -> torch.Tensor:
    """Check what a kernel takes: device, dtype, shape and contiguity."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t


def stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def prim_ptrs(scene, dev: torch.device) -> list:
    """A scene's geometry as ``rt_octree_dda`` and ``rt_shade_bounce`` take
    it: sphere centers, radii and count, box centers, halves and count,
    triangle v0, v1, v2 and count (each table ``need``-checked float32 on
    ``dev``, detached)."""
    ns, nb, nt = scene.n_spheres, scene.n_boxes, scene.n_tris
    prims = []
    for name, rows, cols in (("sphere_center", ns, (3,)),
                             ("sphere_radius", ns, ()),
                             ("box_center", nb, (3,)),
                             ("box_half", nb, (3,)),
                             ("tri_v0", nt, (3,)), ("tri_v1", nt, (3,)),
                             ("tri_v2", nt, (3,))):
        prims.append(ptr(need(getattr(scene, name).detach(), name,
                              torch.float32, (rows, *cols), dev)))
        if name in ("sphere_radius", "box_half", "tri_v2"):
            prims.append(rows)
    return prims
