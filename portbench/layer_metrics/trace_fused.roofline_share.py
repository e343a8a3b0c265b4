"""``trace_frame_kernel``'s (B1) share of its roofline over the traced
frames: the floor of a frame (``roofline.frame_floor_s``) times the
frames' samples, over the kernel's device time."""
from portbench import roofline, tracing


def read(ctx, run):
    tr = run.get("trace") or {}
    t = tracing.kernel_seconds(tr, "trace_frame_kernel")
    if t <= 0.0:
        return None
    c, s = ctx.config, ctx.spec
    return 100.0 * tr["spans"] * c["spp"] * roofline.frame_floor_s(
        s.n_spheres, s.n_boxes, len(s.tex_rgb), c["width"], c["height"]) / t
