"""The floors of the replay kernels (B5: ``replay_fwd_kernel``,
``replay_bwd_kernel``), counted from the cell's inputs alone, as
``roofline`` counts the search's (its peaks and ``bound_s``).

A launch replays one view: ``n_rays`` camera rays, each with its recorded
winners (``refmax`` int32), on the scene's tables. The forward reads each
ray's origin and direction and winners and writes its color; the backward
reads them and the color's cotangent and writes the cotangents of origin
and direction, and the per-prim sums (28 B a sphere: center, radius, rgb;
36 B a box; the sky's 12). Both read the scene once. Of the arithmetic
only bounce 0 is known from the inputs (every camera ray is live): one
surface recompute a ray, counted as one intersection test.
"""
from __future__ import annotations

from portbench import roofline, tracing

#: bytes of a bounce's recorded winner; of a sphere's and a box's sums;
#: of the sky's
PID_B, SPHERE_SUM_B, BOX_SUM_B, SKY_SUM_B = 4, 28, 36, 12


def _rays_in(n_rays: int, refmax: int) -> int:
    return n_rays * (roofline.RAY_B + PID_B * refmax)


def fwd_floor_s(n_spheres: int, n_boxes: int, n_tex: int, n_rays: int,
                refmax: int) -> float:
    """One forward launch over ``n_rays`` rays."""
    return roofline.bound_s(
        n_rays * roofline.min_test_ops(n_spheres, n_boxes),
        _rays_in(n_rays, refmax) + n_rays * roofline.PIXEL_B
        + roofline.scene_bytes(n_spheres, n_boxes, n_tex))


def bwd_floor_s(n_spheres: int, n_boxes: int, n_tex: int, n_rays: int,
                refmax: int) -> float:
    """One backward launch over ``n_rays`` rays."""
    return roofline.bound_s(
        n_rays * roofline.min_test_ops(n_spheres, n_boxes),
        _rays_in(n_rays, refmax) + n_rays * (roofline.PIXEL_B
                                             + roofline.RAY_B)
        + roofline.scene_bytes(n_spheres, n_boxes, n_tex)
        + SPHERE_SUM_B * n_spheres + BOX_SUM_B * n_boxes + SKY_SUM_B)


def share(ctx, run, kernel: str, floor):
    """``kernel``'s share of its roofline over the traced steps: a view's
    ``floor`` times the views the steps replayed, over the kernel's device
    time; None where the trace has no such kernel."""
    tr = run.get("trace") or {}
    t = tracing.kernel_seconds(tr, kernel)
    if t <= 0.0:
        return None
    c, s = ctx.config, ctx.spec
    launches = tr["spans"] * len(ctx.traffic["view_offsets"])
    return 100.0 * launches * floor(
        s.n_spheres, s.n_boxes, len(s.tex_rgb), c["width"] * c["height"],
        c["refmax"]) / t
