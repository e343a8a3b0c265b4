"""Fit over the ranks: the closed loop of ``loops/fit``, each step one
``fit`` step of every rank together through the program's ``fit(...,
mesh=ctx.mesh)``, as a user runs BASELINE config 5 data-parallel over the
cards of one host.

Every rank traces, records and replays its contiguous slice of each
view's rays (``mesh.rows``), keeps the whole scene, octree and Adam state,
and the program all-reduces the loss and gradients once a step. On one
card (no mesh) the loop is ``loops/fit``'s.

Set-up is ``loops/fit``'s on every rank: the targets (each rank renders
every view whole), the start from the run's seed, the start's octree, and
a warm-up through ``fit(mesh=)`` at every shape a rank runs. The window
runs whole cycles of ``replay_every`` steps on rank 0's clock, hook to
hook as in ``loops/fit``: once a cycle the hook asks every rank
(``ctx.all_agree``) whether rank 0's window is over, so every rank stops
at the same step (a rank one step apart would wait in the all-reduce).
The traced form profiles a fixed number of steps, as ``loops/fit.traced``
does, and reads the program's count of exchanged bytes
(``sharding.ALLREDUCE``, where the program keeps one) over the traced
steps.

Every rank keeps the same steps (the reservoir draws from the run's
seed). :func:`compare` gathers every rank's rows of each kept step's
recording over ``ctx.mesh.group`` with ``torch.distributed`` itself, so
that each rank holds the whole recording, then judges the step as
``loops/fit.compare`` does, against the reference over every ray of every
view; and it reads ``replica_mismatch``: the largest |p_r - p_0| over the
trained leaves of the kept step's next parameters, against rank 0's
broadcast copy. The reasons for each limit are in
``limits/c5_1m_x4.fit.reasons.txt``.
"""
from __future__ import annotations

import math
import time
import types

import torch
import torch.distributed as dist

from portbench import harness, tracing
from portbench.loops import fit
from portbench.loops.frames import Reservoir


def run_fit(ctx, st, hook, steps: int):
    """One call of the program's ``fit`` from the start, over the ranks."""
    rt, tr = ctx.program.rt, ctx.traffic
    fc = rt.FitConfig(steps=steps, lr=float(tr["lr"]),
                      optimizer=tr["optimizer"],
                      replay_every=int(tr["replay_every"]),
                      accel_every=int(tr["accel_every"]))
    return rt.fit(st["scene"], st["rcfg"], st["cams"], st["targets"], fc,
                  seed=harness.mix(ctx.seed, 2), trainable=st["trainable"],
                  mesh=ctx.mesh, accel=st["accel"], hook=hook)


def setup(ctx):
    p, cfg, tr = ctx.program, ctx.config, ctx.traffic
    rt = p.rt
    if getattr(rt, "fit", None) is None:
        raise RuntimeError("the program has no fit(..., hook=) entry point")
    w, h = cfg["width"], cfg["height"]
    fov_h, fov_v = harness.fov(cfg)
    st = dict(rcfg=p.render_config(cfg["refmax"], cfg["spp"], "octree"),
              poses=fit.views(cfg, tr))
    st["cams"] = [p.camera(pos, w, h, fov_h, fov_v, yaw, ctx.device)
                  for pos, yaw in st["poses"]]
    layout = p.build_scene(ctx.spec, ctx.device)
    accel = p.octree(layout, cfg["octree_max_depth"])
    # pixel centres (spp 1): the sample seed changes nothing
    st["targets"] = torch.stack([
        p.render(layout, cam, st["rcfg"], seed=0, accel=accel).reshape(-1, 3)
        for cam in st["cams"]])
    del accel
    st["scene"] = fit.start_scene(
        layout, fit.start(ctx.spec, tr, ctx.stream(2)), ctx.device)
    del layout
    st["accel"] = p.octree(st["scene"], cfg["octree_max_depth"])
    names = st["names"] = rt.float_leaf_names(st["scene"])
    trained = tr["trained"]
    st["trainable"] = lambda i, _p: names[i] in trained
    run_fit(ctx, st, None, int(tr["warmup_steps"]))
    ctx.sync()
    return st


def window(ctx, st, seconds: float) -> dict:
    tr = ctx.traffic
    every = int(tr["replay_every"])
    keep = Reservoir(int(tr["compare_steps"]), ctx.stream(3))
    see = fit.keeper(ctx, st, keep)
    clock = {}

    def hook(s):
        ctx.sync()
        t = time.perf_counter()
        see(s, s.step >= every)
        if (s.step + 1) % every:
            return False
        if "t0" not in clock:
            clock["t0"], clock["s0"] = t, s.step
            return False
        clock["t"], clock["s"] = t, s.step
        # rank 0's clock decides; the others agree to whatever it says
        return ctx.all_agree(ctx.rank != 0 or t - clock["t0"] >= seconds)

    run_fit(ctx, st, hook, fit.MAX_STEPS)
    steps = clock["s"] - clock["s0"]
    span = clock["t"] - clock["t0"]
    cfg = ctx.config
    # the whole batch, every rank's rows of every view
    rays = cfg["width"] * cfg["height"] * cfg["spp"] * len(st["cams"])
    return dict(items=steps, seconds=span, kept=keep.items,
                metrics=dict(rays_per_s=steps * rays / span))


def exchanged_bytes(ctx):
    """The program's running count of bytes handed to its all-reduce, or
    None where it keeps no such count."""
    rt = ctx.program.rt
    sharding = getattr(getattr(rt, "parallel", None), "sharding", None)
    count = getattr(sharding, "ALLREDUCE", None)
    return None if count is None else int(count["bytes"])


def traced(ctx, st) -> dict:
    """``loops/fit.traced`` over the ranks: the profiler over ``1 +
    trace_cycles`` whole cycles, the benchmark's spans the last
    ``trace_cycles`` cycles' steps; ``allreduce_bytes`` the bytes the
    program handed its all-reduce over those steps (absent where it keeps
    no count)."""
    tr = ctx.traffic
    every = int(tr["replay_every"])
    first = every - 1
    spanned = first + every
    last = spanned + int(tr["trace_cycles"]) * every
    keep = Reservoir(int(tr["compare_steps"]), ctx.stream(3))
    see = fit.keeper(ctx, st, keep)
    act = torch.profiler.ProfilerActivity
    acts = [act.CPU] + ([act.CUDA] if ctx.device.type == "cuda" else [])
    prof = torch.profiler.profile(activities=acts)
    sent = {}

    def hook(s):
        ctx.sync()
        if s.step == first:
            prof.__enter__()
        if s.step >= spanned:
            with torch.profiler.record_function(fit.MARK):
                pass
        if s.step in (spanned, last):
            sent[s.step] = exchanged_bytes(ctx)
        see(s, s.step > spanned)
        if s.step == last:
            prof.__exit__(None, None, None)
            return True
        return False

    run_fit(ctx, st, hook, last + 1)
    evs = list(prof.events())
    marks = sorted(e.time_range.start for e in evs
                   if e.name == fit.MARK and "CUDA" not in str(e.device_type))
    spans = [types.SimpleNamespace(
        name=tracing.SPAN, time_range=types.SimpleNamespace(start=a, end=b),
        device_type="DeviceType.CPU") for a, b in zip(marks, marks[1:])]
    summary = tracing.summarize([e for e in evs if e.name != fit.MARK]
                                + spans)
    out = dict(items=last - spanned, seconds=summary.get("window_s", 0.0),
               kept=keep.items, trace=summary)
    if sent[last] is not None:
        out["allreduce_bytes"] = sent[last] - sent[spanned]
    return out


def gather_rows(ctx, local: torch.Tensor) -> torch.Tensor:
    """Every rank's ``local`` rows in rank order (the whole array), over
    ``ctx.mesh.group``; ``local`` as it is on one card."""
    if ctx.mesh is None:
        return local
    parts = [torch.empty_like(local) for _ in range(ctx.world)]
    dist.all_gather(parts, local.contiguous(), group=ctx.mesh.group)
    return torch.cat(parts)


def replica_mismatch(ctx, nxt) -> float:
    """The largest |p_r - p_0| over the trained leaves ``nxt`` (this
    rank's next parameters) against rank 0's copy, broadcast over
    ``ctx.mesh.group``; 0 on one card, NaN where no next step was seen."""
    if nxt is None:
        return math.nan
    worst = 0.0
    for k in sorted(nxt):
        mine = nxt[k]
        first = mine.clone()
        if ctx.mesh is not None:
            dist.broadcast(first, src=0, group=ctx.mesh.group)
        worst = max(worst, float((mine - first).abs().max()))
    return worst


def compare(ctx, st, win: dict) -> dict:
    """Gather each kept step's recording from every rank and read the
    replicas' agreement, then judge the steps as ``loops/fit.compare``
    does -> its four numbers and ``replica_mismatch`` (the worst kept
    step's)."""
    replica = 0.0
    for kept in win["kept"]:
        kept["recs"] = [gather_rows(ctx, r) for r in kept["recs"]]
        replica = fit.worst([replica,
                             replica_mismatch(ctx, kept.get("next"))])
    return dict(fit.compare(ctx, st, win), replica_mismatch=replica)
