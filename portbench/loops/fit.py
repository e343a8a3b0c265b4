"""Fit: a closed loop of inverse-rendering steps through the program's
``fit``, one in flight, as a user runs BASELINE config 5 (the JAX
package's ``bench.run_config5``).

Set-up renders the targets with the program (``render_hdr`` through
OCTREE) from the configuration's layout, draws the start from the run's
seed (:func:`start`, :func:`start_scene`), builds the start's octree, and
warms the fit up for
``warmup_steps`` steps: a recording, a rebuild, the replay, the backward
and the optimizer's step, at every shape.

The window is one more ``fit`` call from the start. Its hook, called once
a step after the gradients and before the optimizer's step, synchronizes
and reads the host's clock. The window runs from the hook of step
``replay_every - 1`` to that of a later step a whole number of cycles on,
the first at or past ``--seconds``: whole cycles of ``replay_every``
steps, each with one octree rebuild and one recording (``accel_every ==
replay_every``) and ``replay_every`` replays and optimizer steps. The
cycle before the window is its lead-in (its first recording searches
set-up's octree, not a rebuilt one). A seeded reservoir draws recording
steps of the window; the hook copies the kept step's trained parameters,
gradients, Adam moments, loss and recording, and the next step's
parameters (what the kept step's optimizer step made of them), and
:func:`compare` judges them against the plain reference
(``reference/fit``) after the window; each limit's reason is in
``limits/c5_1m.fit.reasons.txt``.
"""
from __future__ import annotations

import dataclasses
import math
import time
import types

import numpy as np
import torch

from portbench import harness, tracing
from portbench.loops.frames import Reservoir
from portbench.reference import fit as ref_fit
from portbench.reference import render as ref

#: the host event the traced window's hook leaves at each step's end
MARK = "portbench.fit.step"
#: a cap on any ``fit`` call's steps (the hook ends the window's sooner)
MAX_STEPS = 1 << 20


def views(config: dict, traffic: dict):
    """The traffic's cameras -> [(pos, yaw)]: the configuration's camera
    moved by each of ``view_offsets`` (``bench.run_config5``: (0, v - 4,
    0.5) for v = 0..7), heading ``yaw_deg``."""
    base = np.asarray(config["camera_pos"], np.float64)
    yaw = np.radians(float(traffic["yaw_deg"]))
    return [(tuple(base + np.asarray(o, np.float64)), float(yaw))
            for o in traffic["view_offsets"]]


def start(spec, traffic: dict, rng: np.random.Generator):
    """The fit's start from the layout: every sphere center moved by
    U(-jitter, jitter) per axis, and each texture of ``palette_rows``
    scaled by U(palette_scale) per channel and clipped to [0, 1]."""
    j = float(traffic["jitter"])
    centers = (spec.sphere_center
               + rng.uniform(-j, j, spec.sphere_center.shape)
               ).astype(np.float32)
    lo, hi = traffic["palette_rows"]
    tex = spec.tex_rgb.copy()
    scale = rng.uniform(*traffic["palette_scale"], tex[lo:hi].shape)
    tex[lo:hi] = np.clip(tex[lo:hi] * scale, 0.0, 1.0)
    return dataclasses.replace(spec, sphere_center=centers,
                               tex_rgb=tex.astype(np.float32))


def start_scene(layout, spec, device):
    """The program's layout scene with the two leaves :func:`start` moves
    replaced by the start's (what the program's builder gives for the
    start's spec, without building 1M spheres again)."""
    def put(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    return dataclasses.replace(
        layout, sphere_center=put(spec.sphere_center),
        textures=dataclasses.replace(layout.textures,
                                     solid_rgb=put(spec.tex_rgb)))


def setup(ctx):
    p, cfg, tr = ctx.program, ctx.config, ctx.traffic
    rt = p.rt
    if getattr(rt, "fit", None) is None:
        raise RuntimeError("the program has no fit(..., hook=) entry point")
    w, h = cfg["width"], cfg["height"]
    fov_h, fov_v = harness.fov(cfg)
    st = dict(rcfg=p.render_config(cfg["refmax"], cfg["spp"], "octree"),
              poses=views(cfg, tr))
    st["cams"] = [p.camera(pos, w, h, fov_h, fov_v, yaw, ctx.device)
                  for pos, yaw in st["poses"]]
    layout = p.build_scene(ctx.spec, ctx.device)
    accel = p.octree(layout, cfg["octree_max_depth"])
    # pixel centres (spp 1): the sample seed changes nothing
    st["targets"] = torch.stack([
        p.render(layout, cam, st["rcfg"], seed=0, accel=accel).reshape(-1, 3)
        for cam in st["cams"]])
    del accel
    st["scene"] = start_scene(layout, start(ctx.spec, tr, ctx.stream(2)),
                              ctx.device)
    del layout
    st["accel"] = p.octree(st["scene"], cfg["octree_max_depth"])
    names = st["names"] = rt.float_leaf_names(st["scene"])
    trained = tr["trained"]
    st["trainable"] = lambda i, _p: names[i] in trained
    run_fit(ctx, st, None, int(tr["warmup_steps"]))
    ctx.sync()
    return st


def run_fit(ctx, st, hook, steps: int):
    """One call of the program's ``fit`` from the start."""
    rt, tr = ctx.program.rt, ctx.traffic
    fc = rt.FitConfig(steps=steps, lr=float(tr["lr"]),
                      optimizer=tr["optimizer"],
                      replay_every=int(tr["replay_every"]),
                      accel_every=int(tr["accel_every"]))
    return rt.fit(st["scene"], st["rcfg"], st["cams"], st["targets"], fc,
                  seed=harness.mix(ctx.seed, 2), trainable=st["trainable"],
                  accel=st["accel"], hook=hook)


def _leaves(trained: dict, names):
    """[(parameter index, the reference's name)] of the trained leaves
    (``trained``: the program's name -> the reference's; ``names``: the
    program's name of each parameter)."""
    return [(i, trained[n]) for i, n in enumerate(names) if n in trained]


def copy_step(trained: dict, names, s) -> dict:
    """What the comparison needs of fit step ``s``, copied: the trained
    leaves' parameters, gradients and Adam state (the moments and the
    steps taken before this one; zeros and 0 where the optimizer keeps
    none) under the reference's leaf names."""
    keep = _leaves(trained, names)
    state = [s.optimizer.state.get(s.params[i], {}) for i, _ in keep]

    def moment(j, i, key):
        m = state[j].get(key)
        return (torch.zeros_like(s.params[i]) if m is None
                else m.detach().clone())

    return dict(
        step=s.step, loss=s.loss.clone(),
        params={k: s.params[i].detach().clone() for i, k in keep},
        grads={k: s.grads[i].clone() for i, k in keep},
        exp_avg={k: moment(j, i, "exp_avg") for j, (i, k) in enumerate(keep)},
        exp_avg_sq={k: moment(j, i, "exp_avg_sq")
                    for j, (i, k) in enumerate(keep)},
        adam_steps={k: int(state[j].get("step", 0))
                    for j, (_, k) in enumerate(keep)},
        recs=[r.clone() for r in s.recs])


def keeper(ctx, st, keep: Reservoir):
    """-> the hook's part that keeps steps, ``see(s, offer)``, called
    every step: with ``offer``, a recording step goes to the reservoir
    (copied where it wants it), and the next step's call adds that step's
    trained parameters to the copy (``next``)."""
    trained, names = ctx.traffic["trained"], st["names"]
    last = []

    def see(s, offer: bool) -> None:
        if last:
            last.pop()["next"] = {k: s.params[i].detach().clone()
                                  for i, k in _leaves(trained, names)}
        if offer and s.recorded:
            item = copy_step(trained, names, s) if keep.wants() else None
            keep.offer(item)
            if item is not None:
                last.append(item)

    return see


def window(ctx, st, seconds: float) -> dict:
    tr = ctx.traffic
    every = int(tr["replay_every"])
    keep = Reservoir(int(tr["compare_steps"]), ctx.stream(3))
    see = keeper(ctx, st, keep)
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
        return t - clock["t0"] >= seconds

    run_fit(ctx, st, hook, MAX_STEPS)
    steps = clock["s"] - clock["s0"]
    span = clock["t"] - clock["t0"]
    cfg = ctx.config
    rays = cfg["width"] * cfg["height"] * cfg["spp"] * len(st["cams"])
    return dict(items=steps, seconds=span, kept=keep.items,
                metrics=dict(rays_per_s=steps * rays / span))


def traced(ctx, st) -> dict:
    """The profiler over ``1 + trace_cycles`` whole cycles, from the hook
    of step ``replay_every - 1`` on; the program's span totals cover them
    all. The benchmark's spans are the last ``trace_cycles`` cycles' steps
    (hook to hook; the first cycle lets the profiler's buffers settle)."""
    tr = ctx.traffic
    every = int(tr["replay_every"])
    first = every - 1
    spanned = first + every
    last = spanned + int(tr["trace_cycles"]) * every
    keep = Reservoir(int(tr["compare_steps"]), ctx.stream(3))
    see = keeper(ctx, st, keep)
    act = torch.profiler.ProfilerActivity
    acts = [act.CPU] + ([act.CUDA] if ctx.device.type == "cuda" else [])
    prof = torch.profiler.profile(activities=acts)

    def hook(s):
        ctx.sync()
        if s.step == first:
            prof.__enter__()
        if s.step >= spanned:
            with torch.profiler.record_function(MARK):
                pass
        see(s, s.step > spanned)
        if s.step == last:
            prof.__exit__(None, None, None)
            return True
        return False

    run_fit(ctx, st, hook, last + 1)
    evs = list(prof.events())
    marks = sorted(e.time_range.start for e in evs
                   if e.name == MARK and "CUDA" not in str(e.device_type))
    spans = [types.SimpleNamespace(
        name=tracing.SPAN, time_range=types.SimpleNamespace(start=a, end=b),
        device_type="DeviceType.CPU") for a, b in zip(marks, marks[1:])]
    summary = tracing.summarize([e for e in evs if e.name != MARK] + spans)
    return dict(items=last - spanned, seconds=summary.get("window_s", 0.0),
                kept=keep.items, trace=summary)


def sample(ctx, n_rays: int, n_views: int):
    """``n_rays`` pixels drawn without replacement from the run's seed,
    the same number from each view (every pixel of a smaller frame) ->
    [views, n_rays / views] indices."""
    cfg = ctx.config
    n = cfg["width"] * cfg["height"]
    rng = ctx.stream(4)
    return np.stack([rng.choice(n, min(n, n_rays // n_views), replace=False)
                     for _ in range(n_views)])


def worst(values) -> float:
    """The largest of ``values``; NaN if any is (a NaN passes no limit)."""
    values = list(values)
    return math.nan if any(math.isnan(v) for v in values) else max(values)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """|got - want| / |want| (2-norms, in float64); where ``want`` is 0
    (the position gradients, where no path reaches the emitter), 0 for a
    ``got`` of 0 and inf for any other."""
    diff = float((got.double() - want.double()).norm())
    norm = float(want.double().norm())
    if norm == 0.0:
        return diff * math.inf if diff else 0.0
    return diff / norm


def compare(ctx, st, win: dict) -> dict:
    """Free the program's state, then judge each kept step against the
    reference at its own parameters -> the worst kept step's
    ``record_mismatch_share`` (the share of the sampled rays whose recorded
    winner chain is not the dense search's), ``grad_rel_err`` (the largest
    over the trained leaves of |g - g_ref| / |g_ref|, the reference
    replaying the step's recording over every ray of every view),
    ``loss_rel_err`` and ``update_rel_err`` (the largest over the trained
    leaves of |dp - dp_ref| / |dp_ref|: dp the change the step's optimizer
    step made, dp_ref the reference's Adam step from the step's moments
    with g_ref; 1 for a state left unchanged, NaN where no next step was
    seen)."""
    cfg, tr = ctx.config, ctx.traffic
    targets, poses = st["targets"], st["poses"]
    st.clear()
    ctx.free()
    base = ctx.reference_scene()
    fov_h, fov_v = harness.fov(cfg)
    rays = [ref.pixel_rays(ref.make_camera(
        pos, cfg["width"], cfg["height"], fov_h, fov_v, yaw, ctx.device))
        for pos, yaw in poses]
    pick = torch.as_tensor(sample(ctx, int(tr["sample_rays"]), len(rays)),
                           device=ctx.device)
    out = dict(record_mismatch_share=0.0, grad_rel_err=0.0, loss_rel_err=0.0,
               update_rel_err=0.0)
    lr = float(tr["lr"])
    for kept in win["kept"]:
        scene = base.with_leaves([kept["params"].get(k, getattr(base, k))
                                  for k in base.LEAVES])
        bad = 0
        for v, (org, dir) in enumerate(rays):
            i = pick[v]
            want = ref_fit.dense_chain(scene, org[i], dir[i], cfg["refmax"])
            bad += int((kept["recs"][v][i].long() != want).any(dim=1).sum())
        loss, grads = ref_fit.loss_and_grads(scene, rays, kept["recs"],
                                             targets, leaves=kept["grads"])
        g_err = worst(rel_err(g, grads[k]) for k, g in kept["grads"].items())
        l_err = abs(float(kept["loss"]) - float(loss)) / abs(float(loss))
        nxt = kept.get("next")
        u_err = math.nan if nxt is None else worst(
            rel_err(nxt[k].double() - p.double(), ref_fit.adam_step(
                grads[k], kept["exp_avg"][k], kept["exp_avg_sq"][k],
                kept["adam_steps"][k], lr))
            for k, p in kept["params"].items())
        out = dict(
            record_mismatch_share=worst([out["record_mismatch_share"],
                                         bad / pick.numel()]),
            grad_rel_err=worst([out["grad_rel_err"], g_err]),
            loss_rel_err=worst([out["loss_rel_err"], l_err]),
            update_rel_err=worst([out["update_rel_err"], u_err]))
    return out
