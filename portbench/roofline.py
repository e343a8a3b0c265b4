"""The yardstick of the kernels' roofline shares: the card's peaks and the
least work each kernel's job needs, counted from the cell's inputs alone.

A bound is the larger of two times: the operations over the float32 peak,
or the bytes over the memory bandwidth. Each count is a floor that no
implementation can beat: every input and every output once, and of the
arithmetic only what every implementation must do (one intersection test
and the shading of each live ray). Only bounce 0's live rays are known from
the inputs (every camera ray is live); later bounces' live rays depend on
what the rays hit, so they count as none. No count reads anything the
program returns or keeps (its counters, its accel, its tables), so the
bound is the same whichever backend ran.
"""
from __future__ import annotations

#: one H100 SXM at its published peaks (NVIDIA data sheet, 700 W): float32
#: outside the tensor cores, and HBM3
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
#: float operations of one intersection test, counted from the tests'
#: expressions (one each for an add, multiply, compare, min/max, select,
#: sqrt or divide), the running-minimum fold included
OPS = {"sphere": 29, "box": 34}
#: bytes of a ray's origin and direction; of a search's answer (t, pid);
#: of an HDR pixel
RAY_B, HIT_B, PIXEL_B = 24, 8, 12


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take, in seconds."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def scene_bytes(n_spheres: int, n_boxes: int, n_tex: int) -> int:
    """The scene as every search and shading pass must read it once:
    sphere centers and radii, box centers and half sizes, each prim's
    material and texture ids, the texture colors."""
    return (16 * n_spheres + 24 * n_boxes + 8 * (n_spheres + n_boxes)
            + 12 * n_tex)


def min_test_ops(n_spheres: int, n_boxes: int) -> int:
    """A live ray is tested against one prim at least: the cheapest class
    the scene holds."""
    return min([OPS[k] for k, n in (("sphere", n_spheres), ("box", n_boxes))
                if n] or [0])


def frame_floor_s(n_spheres: int, n_boxes: int, n_tex: int, w: int,
                  h: int) -> float:
    """A whole frame of ``w * h`` camera rays: the scene in, the HDR image
    out, one test a camera ray (trace_fused's frame kernel)."""
    n = w * h
    return bound_s(n * min_test_ops(n_spheres, n_boxes),
                   n * PIXEL_B + scene_bytes(n_spheres, n_boxes, n_tex))


def search_floor_s(n_spheres: int, n_boxes: int, n_rays: int) -> float:
    """One nearest-hit search of ``n_rays`` live rays: each ray in, its
    answer out, the prims' geometry once, one test a ray."""
    return bound_s(n_rays * min_test_ops(n_spheres, n_boxes),
                   n_rays * (RAY_B + HIT_B) + 16 * n_spheres + 24 * n_boxes)

