"""The benchmark's own spans and the reduction of a ``torch.profiler`` trace.

The harness wraps each frame of a traced run in a span
(:func:`span`) and profiles the whole traced window. :func:`summarize`
reduces the trace in memory (nothing is exported): per span the host time
and the device's busy time (the union of its operations), the device
operations a span, device time by kernel name, and the idle gaps labelled
by what the host was doing (the innermost host event over the gap's
middle). This is ``chip_smoke.frame_breakdown``'s reduction, made general.
"""
from __future__ import annotations

import bisect
import contextlib

import torch

SPAN = "portbench.span"
#: entries of each breakdown list
TOP = 10
#: frames a traced window runs before its first span
PAD = 3


def span():
    return torch.profiler.record_function(SPAN)


@contextlib.contextmanager
def profiled(out: dict):
    """Profile the body; on exit ``out`` holds :func:`summarize`'s
    result."""
    act = torch.profiler.ProfilerActivity
    acts = [act.CPU] + ([act.CUDA] if torch.cuda.is_available() else [])
    with torch.profiler.profile(activities=acts) as prof:
        yield
    out.update(summarize(prof.events()))


def _is_device(e) -> bool:
    return "CUDA" in str(e.device_type)


def _union(iv):
    """Merged intervals of sorted (start, end) pairs."""
    out = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events) -> dict:
    """Reduce profiler events (times in microseconds) -> a summary in
    seconds: ``spans``, ``host_s`` and ``busy_s`` (summed over the spans),
    ``ops`` (device operations in the spans), ``window_s`` and
    ``window_busy_s`` (first span start to last span end), ``kernel_s`` and
    ``kernel_n`` by device operation name, ``device_ops`` and
    ``idle_gaps`` (the top entries, [name, seconds])."""
    evs = list(events)
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs
                   if e.name == SPAN and not _is_device(e))
    # the spans' own annotation on the device's timeline is no operation
    ops = sorted((e.time_range.start, e.time_range.end, e.name) for e in evs
                 if _is_device(e) and e.name != SPAN)
    host = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in evs if not _is_device(e) and e.name != SPAN)
    if not spans:
        return dict(spans=0)
    host_starts = [h[0] for h in host]

    def doing(t):
        """The innermost host event over time ``t``."""
        i = bisect.bisect_right(host_starts, t)
        while i > 0:
            i -= 1
            if host[i][1] >= t:
                return host[i][2]
            if t - host[i][0] > 5e6:
                break
        return "python between operations"

    kernel_s, kernel_n, gaps = {}, {}, {}
    host_s = busy_s = 0.0
    n_ops = 0
    lo = 0
    for a, b in spans:
        lo = bisect.bisect_left(ops, (a,), lo)
        mine = []
        for o in ops[lo:]:
            if o[0] > b:
                break
            mine.append(o)
        n_ops += len(mine)
        host_s += b - a
        for x, y, name in mine:
            kernel_s[name] = kernel_s.get(name, 0.0) + (y - x) * 1e-6
            kernel_n[name] = kernel_n.get(name, 0) + 1
        merged = _union((x, y) for x, y, _ in mine)
        busy_s += sum(y - x for x, y in merged)
        edges = [a] + [v for iv in merged for v in iv] + [b]
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            if g1 > g0:
                label = doing(0.5 * (g0 + g1))
                gaps[label] = gaps.get(label, 0.0) + (g1 - g0) * 1e-6
    w0, w1 = spans[0][0], spans[-1][1]
    window_ops = [(x, min(y, w1)) for x, y, _ in ops if w0 <= x <= w1]
    window_busy = sum(y - x for x, y in _union(sorted(window_ops)))
    return dict(
        spans=len(spans), host_s=host_s * 1e-6, busy_s=busy_s * 1e-6,
        ops=n_ops, window_s=(w1 - w0) * 1e-6,
        window_busy_s=window_busy * 1e-6, kernel_s=kernel_s,
        kernel_n=kernel_n,
        device_ops=sorted(([n[:160], s] for n, s in kernel_s.items()),
                          key=lambda r: -r[1])[:TOP],
        idle_gaps=sorted(([n[:160], s] for n, s in gaps.items()),
                         key=lambda r: -r[1])[:TOP])


def kernel_seconds(summary: dict, part: str) -> float:
    """Device seconds of the operations whose name holds ``part``."""
    return sum(s for n, s in summary.get("kernel_s", {}).items() if part in n)
