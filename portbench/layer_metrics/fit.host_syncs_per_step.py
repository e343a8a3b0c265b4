"""Blocking device-to-host reads of the fit (the program's ``rt.sync``
spans: the loss read, the rebuild's AABB read), per traced fit step. None
from a program without the fit's spans, or from a trace with no device
operation."""
from portbench import fit_spans


def read(ctx, run):
    tot = fit_spans.totals(ctx, run)
    if tot is None:
        return None
    return tot.get("rt.sync", [0])[0] / tot["rt.fit.step"][0]
