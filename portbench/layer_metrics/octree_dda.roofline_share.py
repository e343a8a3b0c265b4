"""``octree_dda_kernel``'s share of its roofline over the traced frames:
the floor of a frame's searches (``roofline.search_floor_s`` of bounce 0's
camera rays) times the frames, over the kernel's device time."""
from portbench import roofline, tracing


def read(ctx, run):
    tr = run.get("trace") or {}
    t = tracing.kernel_seconds(tr, "octree_dda")
    if t <= 0.0:
        return None
    c, s = ctx.config, ctx.spec
    rays = c["width"] * c["height"] * c["spp"]
    return 100.0 * tr["spans"] * roofline.search_floor_s(
        s.n_spheres, s.n_boxes, rays) / t
