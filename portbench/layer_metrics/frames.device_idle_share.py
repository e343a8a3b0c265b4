"""The device's idle share over the traced frames: 1 - the union of its
operations / the frames' host time (a frame: the call to ``render_hdr``
through the synchronize that ends it)."""


def read(ctx, run):
    tr = run.get("trace") or {}
    if not tr.get("spans") or tr.get("busy_s", 0.0) <= 0.0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["host_s"])
