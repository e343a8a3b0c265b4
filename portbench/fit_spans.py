"""The program's span totals over a traced fit window, for the readers of
the fit's spans and counters: ``SPAN_TOTALS`` of
``raytracer_js_tpu_torch.utils.profiling``, each ``rt.*`` span's count and
host seconds while a profiler ran. A traced fit run profiles whole cycles
of steps (``loops/fit.traced``), from the hook of one step to the hook of
a later one, so each step-wide span (``rt.fit.step``, ``rt.fit.opt``, the
loss read's ``rt.sync``) is counted once a step and each cycle's rebuild
once a cycle. (``spans.totals`` wants frames: ``rt.render`` spans.)"""
from __future__ import annotations


def totals(ctx, run):
    """{span name: [count, host seconds]} after a traced fit run on the
    card, or None: after an untraced run, a trace with no device
    operation (a run on the CPU), or a program that keeps no fit spans."""
    tr = run.get("trace") or {}
    if not tr.get("spans") or not tr.get("ops"):
        return None
    rt = getattr(ctx.program, "rt", None)
    prof = getattr(getattr(rt, "utils", None), "profiling", None)
    tot = getattr(prof, "SPAN_TOTALS", None)
    if not tot or not tot.get("rt.fit.step", [0])[0]:
        return None
    return tot
