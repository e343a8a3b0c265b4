"""The program's spans as the benchmark sees them: host events that
``tracing.summarize`` labels idle gaps with and counts as no device
operation, and the span totals its readers take per frame."""
from __future__ import annotations

import types

import pytest

from portbench import harness, program, spans, tracing

READERS = ("render.host_us_per_frame", "render.host_syncs_per_frame")


def ev(name, a, b, device=False):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=a, end=b),
        device_type="DeviceType.CUDA" if device else "DeviceType.CPU")


def frames():
    """Two benchmark frames: host operators, launches, kernels, a sync."""
    return [ev(tracing.SPAN, 0, 100), ev(tracing.SPAN, 200, 300),
            ev(tracing.SPAN, 0, 100, device=True),
            ev("aten::add", 5, 20), ev("cudaLaunchKernel", 10, 12),
            ev("k1", 20, 50, True), ev("k2", 40, 60, True),
            ev("cudaDeviceSynchronize", 60, 100),
            ev("k1", 210, 240, True)]


def test_program_spans_leave_the_summary_as_it_was():
    """The program's ``rt.*`` spans are host events only: every key of the
    summary reads as without them, but for the idle gap inside one with
    no operator under it, which takes the span's name."""
    plain = tracing.summarize(frames())
    spanned = tracing.summarize(frames() + [
        ev("rt.render", 2, 98), ev("rt.fused.frame", 4, 60),
        ev("rt.render", 202, 298), ev("rt.sync", 240, 290)])
    for k in plain:
        if k != "idle_gaps":
            assert spanned[k] == plain[k], k
    before, after = dict(plain["idle_gaps"]), dict(spanned["idle_gaps"])
    assert before["python between operations"] == pytest.approx(70e-6)
    # [0, 20] is under aten::add (5-20) at its middle; [200, 210] lies in
    # rt.render with nothing under it, [240, 300] in rt.sync
    assert after["rt.render"] == pytest.approx(10e-6)
    assert after["rt.sync"] == pytest.approx(60e-6)
    assert "python between operations" not in after
    assert sum(after.values()) == pytest.approx(sum(before.values()))


def _ctx(totals):
    prof = types.SimpleNamespace(SPAN_TOTALS=totals)
    rt = types.SimpleNamespace(utils=types.SimpleNamespace(profiling=prof))
    return types.SimpleNamespace(program=types.SimpleNamespace(rt=rt))


TRACED = dict(trace=dict(spans=4, ops=8))


def test_readers_take_the_totals_per_frame(manifest):
    cell = harness.find_cell(manifest, "c4_100k.tiled_sweep_view",
                             harness.ROOT.parent)
    ctx = _ctx({"rt.render": [5, 0.05], "rt.sync": [15, 0.01]})
    us = cell.reader("render.host_us_per_frame").read(ctx, TRACED)
    syncs = cell.reader("render.host_syncs_per_frame").read(ctx, TRACED)
    assert us == pytest.approx(1e4) and syncs == 3.0
    ctx = _ctx({"rt.render": [5, 0.05]})
    assert cell.reader("render.host_syncs_per_frame").read(
        ctx, TRACED) == 0.0


@pytest.mark.parametrize("reader", READERS)
@pytest.mark.parametrize("case", ["untraced", "no_ops", "parent",
                                  "no_frames"])
def test_readers_read_nothing_without_totals(manifest, reader, case):
    """None after an untraced run, a trace with no device operation (the
    CPU), a program that keeps no totals (one without spans) and totals
    with no frame in them."""
    cell = harness.find_cell(manifest, "headline_52.fused_view",
                             harness.ROOT.parent)
    ctx = _ctx({"rt.render": [5, 0.05]})
    run = TRACED
    if case == "untraced":
        run = dict(metrics={})
    elif case == "no_ops":
        run = dict(trace=dict(spans=4, ops=0))
    elif case == "parent":
        ctx = types.SimpleNamespace(program=types.SimpleNamespace(
            rt=types.SimpleNamespace(utils=types.SimpleNamespace(
                profiling=types.SimpleNamespace()))))
    else:
        ctx = _ctx({"rt.sync": [3, 0.0]})
    assert cell.reader(reader).read(ctx, run) is None


def test_a_traced_window_counts_its_frames(small_cell):
    """The totals a traced run leaves cover the window: the lead-in frames
    and the spanned ones, one ``rt.render`` each, and nothing of set-up
    or of the comparison."""
    cell = small_cell("headline_52.fused_view")
    tot = program.rt.utils.profiling.SPAN_TOTALS
    before = list(tot.get("rt.render", [0, 0.0]))
    harness.run(cell, 5, 0.05, True, "cpu", program)
    frames_n = tracing.PAD + max(int(cell.traffic["trace_frames"]),
                                 int(cell.traffic["compare_frames"]))
    assert tot["rt.render"][0] - before[0] == frames_n
    assert spans.totals(types.SimpleNamespace(program=program),
                        TRACED) is tot
