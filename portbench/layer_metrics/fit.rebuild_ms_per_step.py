"""Host time inside the program's ``rt.fit.rebuild`` span (the octree
rebuilt from the moving geometry: its AABB read, the host build, the
upload), per traced fit step. None from a program without the fit's
spans, or from a trace with no device operation."""
from portbench import fit_spans


def read(ctx, run):
    tot = fit_spans.totals(ctx, run)
    if tot is None:
        return None
    return 1e3 * tot.get("rt.fit.rebuild", [0, 0.0])[1] / tot["rt.fit.step"][0]
