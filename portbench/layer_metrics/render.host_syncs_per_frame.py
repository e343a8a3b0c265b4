"""Blocking device-to-host reads on the frame path (the program's
``rt.sync`` spans), a traced frame: 0 from a program that read nothing.
None from a program without spans (no ``rt.render``), or from a trace with
no device operation."""
from portbench import spans


def read(ctx, run):
    tot = spans.totals(ctx, run)
    if tot is None:
        return None
    return tot.get("rt.sync", [0])[0] / tot["rt.render"][0]
