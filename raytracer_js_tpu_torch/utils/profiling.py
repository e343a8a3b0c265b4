"""Profiling and throughput observability.

Port of ``raytracer_js_tpu.utils.profiling``. The reference's only
instrumentation is a wall-clock FPS HUD with a 32-sample moving average
(main.ts:244-263) and a debug ray counter (raytracer.ts:77,98): here a
rays/s meter, the HUD's moving average, a ``torch.profiler`` trace, and
the named spans (:func:`span`) the frame path records into that trace.
"""
from __future__ import annotations

import collections
import contextlib
import pathlib
import time
from typing import Iterator, Optional

import torch


class SMA:
    """Simple moving average over a fixed window (main.ts:244-252)."""

    def __init__(self, window: int = 32):
        self.buf = collections.deque(maxlen=window)

    def add(self, x: float) -> float:
        self.buf.append(float(x))
        return self.value

    @property
    def value(self) -> float:
        return sum(self.buf) / len(self.buf) if self.buf else 0.0


class RayMeter:
    """Counts rays and wall time across frames -> rays/s (the debug ray
    counter made into a throughput meter). Time only work that ends in
    :func:`block`: a CUDA call returns before the device is done."""

    def __init__(self, sma_window: int = 32):
        self.total_rays = 0
        self.total_s = 0.0
        self.fps = SMA(sma_window)

    @contextlib.contextmanager
    def frame(self, n_rays: int) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.total_rays += n_rays
        self.total_s += dt
        self.fps.add(1.0 / dt if dt > 0 else 0.0)

    @property
    def rays_per_s(self) -> float:
        return self.total_rays / self.total_s if self.total_s else 0.0


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]) -> Iterator[None]:
    """Record a ``torch.profiler`` trace (the host, and the card when CUDA
    is available) into ``logdir/trace.json`` (Chrome trace format) when
    ``logdir`` is set; a no-op otherwise, so call sites can be
    unconditional."""
    if not logdir:
        yield
        return
    act = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        act.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=act) as prof:
        yield
    path = pathlib.Path(logdir)
    path.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path / "trace.json"))


#: what :func:`span` returns while no profiler runs: one shared no-op
_NO_SPAN = contextlib.nullcontext()
if hasattr(torch.autograd.profiler, "_is_profiler_enabled"):
    def _profiling() -> bool:
        return torch.autograd.profiler._is_profiler_enabled
else:
    _profiling = torch._C._autograd._profiler_enabled

#: span name -> [times entered, host seconds inside], summed over every
#: stretch in which a profiler ran (the spans are counted only then)
SPAN_TOTALS: dict = {}


class _Span:
    """A span while a profiler runs: a record function of the host alone
    (``_RecordFunctionFast``, an operator's scope: unlike
    ``torch.profiler.record_function`` it puts no annotation on the
    device's timeline, which a reduction of the trace would take for one
    more device operation), and its entry in :data:`SPAN_TOTALS`."""

    __slots__ = ("name", "rf", "t0")

    def __init__(self, name: str):
        self.name = name
        self.rf = torch._C._profiler._RecordFunctionFast(name)

    def __enter__(self):
        self.rf.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        self.rf.__exit__(*exc)
        tot = SPAN_TOTALS.setdefault(self.name, [0, 0.0])
        tot[0] += 1
        tot[1] += dt
        return False


def span(name: str):
    """A named span of the program, for ``with``: while a ``torch.profiler``
    runs (:func:`profile_trace`, or any other), an event ``name`` on the
    trace's host timeline, counted and timed in :data:`SPAN_TOTALS`;
    otherwise one shared no-op context, so a span costs a flag test when
    nobody traces. The frame path's spans are named ``rt.*`` (README)."""
    if _profiling():
        return _Span(name)
    return _NO_SPAN


def block(x):
    """Wait for the work of ``x``'s device (the current stream of each
    CUDA tensor in ``x``, a tensor or a list, tuple or dict of them) and
    return ``x``: the passthrough that ends a timed region."""
    items = x.values() if isinstance(x, dict) else (
        x if isinstance(x, (list, tuple)) else [x])
    for t in items:
        if isinstance(t, (list, tuple, dict)):
            block(t)
        elif isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()
    return x
