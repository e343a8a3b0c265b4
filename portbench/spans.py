"""The program's own span totals, for the readers of its spans and
counters: ``raytracer_js_tpu_torch.utils.profiling.SPAN_TOTALS``, each
``rt.*`` span's count and host seconds while a profiler ran. A traced run
profiles only its window, so the totals cover the window's frames: the
``tracing.PAD`` frames before the first benchmark span, then the spanned
ones. A frame is one ``render_hdr`` call, one ``rt.render`` span."""
from __future__ import annotations


def totals(ctx, run):
    """{span name: [count, host seconds]} after a traced run on the card,
    or None: after an untraced run, a trace with no device operation (a
    run on the CPU), or a program that keeps no totals (one without
    spans)."""
    tr = run.get("trace") or {}
    if not tr.get("spans") or not tr.get("ops"):
        return None
    rt = getattr(ctx.program, "rt", None)
    prof = getattr(getattr(rt, "utils", None), "profiling", None)
    tot = getattr(prof, "SPAN_TOTALS", None)
    if not tot or not tot.get("rt.render", [0])[0]:
        return None
    return tot
