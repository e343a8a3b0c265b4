"""Host time inside the program's ``rt.render`` span (``render_hdr``: its
dispatch, launches and any wait inside it), a traced frame. None from a
program without the span, or from a trace with no device operation."""
from portbench import spans


def read(ctx, run):
    tot = spans.totals(ctx, run)
    if tot is None:
        return None
    n, host_s = tot["rt.render"]
    return 1e6 * host_s / n
