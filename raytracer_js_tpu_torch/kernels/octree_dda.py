"""The OCTREE search kernel: one launch for a whole nearest-hit search over
the octree accel (``csrc/octree_dda.cu``, ``octree_dda_kernel``).

It replaces the reference's device-resident DDA loop
(``raytracer_js_tpu.accel.octree.nearest_hit_octree``, a
``lax.while_loop``), not a Pallas kernel. Its plain version is
``accel/octree.nearest_hit_octree_plain``, the live-ray loop, which it
equals bit for bit in t, pid and each ray's step count; the dispatcher
``accel/octree.nearest_hit_octree`` takes the plain version for CPU tensors
and :func:`launch` for CUDA tensors. ``LAUNCHES`` counts launches.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

Tensor = torch.Tensor

LAUNCHES = {"octree_dda": 0}


def launch(scene, accel, org: Tensor, dir: Tensor,
           live: Optional[Tensor] = None
           ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Launch the search on the current stream -> (t [N] f32, pid [N] i32,
    steps [N] i32, tests [N] i32): each ray's DDA steps and candidate tests
    (its coarse ids >= 0, then each step's cell count). ``live`` ([N]
    bool, or None for every ray) marks the rays to search; the others get
    t = +inf, pid -1 and 0 steps and tests. No rays is answered here
    without a launch. Does not synchronize."""
    dev = org.device
    if dev.type != "cuda":
        raise ValueError(f"the octree kernel needs CUDA tensors, got {dev}")
    n = org.shape[0]
    f32, i32 = torch.float32, torch.int32
    _build.need(org, "org", f32, (n, 3), dev)
    _build.need(dir, "dir", f32, (n, 3), dev)
    if live is not None:
        _build.need(live, "live", torch.bool, (n,), dev)
    t = torch.empty((n,), dtype=f32, device=dev)
    pid = torch.empty((n,), dtype=i32, device=dev)
    steps = torch.empty((n,), dtype=i32, device=dev)
    tests = torch.empty((n,), dtype=i32, device=dev)
    if n == 0:
        return t, pid, steps, tests
    prims = _build.prim_ptrs(scene, dev)
    R = accel.res
    nc, nk = accel.coarse_ids.shape[0], accel.cell_ids.shape[0]
    grid = [
        _build.ptr(_build.need(accel.root_lo, "root_lo", f32, (3,), dev)),
        _build.ptr(_build.need(accel.root_size, "root_size", f32, (), dev)),
        _build.ptr(_build.need(accel.coarse_ids, "coarse_ids", i32, (nc,),
                               dev)), nc,
        _build.ptr(_build.need(accel.cell_offsets, "cell_offsets", i32,
                               (R ** 3 + 1,), dev)),
        _build.ptr(_build.need(accel.cell_ids, "cell_ids", i32, (nk,), dev)),
        nk,
        _build.ptr(_build.need(accel.skip_dist, "skip_dist", torch.uint8,
                               (R ** 3,), dev)),
        R, accel.max_per_cell]
    lib = _build.load()
    err = lib.rt_octree_dda(
        *prims, *grid, _build.ptr(org), _build.ptr(dir), _build.ptr(live), n,
        _build.ptr(t), _build.ptr(pid), _build.ptr(steps), _build.ptr(tests),
        dev.index, _build.stream(dev))
    _build.check(lib, err, "octree_dda_kernel")
    LAUNCHES["octree_dda"] += 1
    return t, pid, steps, tests
