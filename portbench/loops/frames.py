"""Frames: a closed loop of whole frames through ``render_hdr``, one in
flight, each ended by a synchronize, as a viewer that shows every frame.

The traffic file sets the backend, the camera poses (a fixed set, jittered
around the configuration's camera; the seed orders them), the frames
warmed up, the frames a traced run traces and the frames compared with the
reference. Each frame's sample seed comes from the run's seed and the
frame's index. The timed frames are drawn for the comparison by a
reservoir (seeded), so any frame of the window may be judged.
"""
from __future__ import annotations

import math
import random
import time

import numpy as np

from portbench import harness, tracing
from portbench.reference import render as ref


def poses(config: dict, traffic: dict):
    """The traffic's fixed pose set -> [(pos, yaw)]: ``poses`` draws from a
    stream of its own (not the run's seed), uniform within ``jitter`` of
    the configuration's camera position and ``yaw_deg`` of its heading; a
    single pose is the configuration's camera itself."""
    base = np.asarray(config["camera_pos"], np.float64)
    n = int(traffic["poses"])
    if n == 1:
        return [(tuple(base), 0.0)]
    rng = np.random.default_rng(int(traffic["pose_stream"]))
    jit = np.asarray(traffic["jitter"], np.float64)
    yaw = math.radians(float(traffic["yaw_deg"]))
    return [(tuple(base + rng.uniform(-jit, jit)),
             float(rng.uniform(-yaw, yaw))) for _ in range(n)]


class Reservoir:
    """A uniform sample of ``k`` items from a stream of unknown length
    (Li's algorithm L): few random draws, none on most frames."""

    def __init__(self, k: int, seed_stream):
        self.k, self.items, self.seen = k, [], 0
        self.rng = random.Random(int(seed_stream.integers(1 << 62)))
        self.next = k - 1
        self.w = 1.0
        self._advance()

    def _advance(self):
        self.w *= math.exp(math.log(1.0 - self.rng.random()) / self.k)
        self.next += int(math.log(1.0 - self.rng.random())
                         / math.log(1.0 - self.w)) + 1

    def wants(self) -> bool:
        return self.seen < self.k or self.seen == self.next

    def offer(self, item) -> None:
        """Call once per stream item, with the item only where
        :meth:`wants` said so."""
        if self.seen < self.k:
            self.items.append(item)
        elif self.seen == self.next:
            self.items[self.rng.randrange(self.k)] = item
            self._advance()
        self.seen += 1


def setup(ctx):
    p, cfg = ctx.program, ctx.config
    tr = ctx.traffic
    st = dict(rcfg=p.render_config(cfg["refmax"], cfg["spp"],
                                   tr["backend"]))
    st["scene"] = p.build_scene(ctx.spec, ctx.device)
    st["accel"] = (p.octree(st["scene"], cfg["octree_max_depth"])
                   if tr["backend"] == "octree" else None)
    st["poses"] = poses(cfg, tr)
    st["order"] = ctx.stream(1).permutation(len(st["poses"]))
    w, h = cfg["width"], cfg["height"]
    fov_h, fov_v = harness.fov(cfg)
    st["cams"] = [p.camera(pos, w, h, fov_h, fov_v, yaw, ctx.device)
                  for pos, yaw in st["poses"]]
    st["tables"] = ([p.frame_tables(st["scene"], c) for c in st["cams"]]
                    if tr["backend"] == "tiled" else None)
    st["next"] = 0
    for _ in range(int(tr["warmup_frames"])):
        frame(ctx, st)
    ctx.sync()
    return st


def frame(ctx, st):
    """Render the next frame of the loop -> (its index, its HDR image)."""
    i = st["next"]
    st["next"] = i + 1
    k = int(st["order"][i % len(st["order"])])
    tables = None if st["tables"] is None else st["tables"][k]
    img = ctx.program.render(st["scene"], st["cams"][k], st["rcfg"],
                             seed=harness.mix(ctx.seed, i),
                             accel=st["accel"], tables=tables)
    return i, img


def _loop(ctx, st, keep: Reservoir, stop, traced: bool):
    lat = []
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        if traced:
            with tracing.span():
                i, img = frame(ctx, st)
                ctx.sync()
        else:
            i, img = frame(ctx, st)
            ctx.sync()
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        keep.offer((i, img.clone()) if keep.wants() else None)
        if stop(len(lat), t1 - t_start):
            return lat, t1 - t_start


def window(ctx, st, seconds: float) -> dict:
    k = int(ctx.traffic["compare_frames"])
    keep = Reservoir(k, ctx.stream(3))
    lat, span = _loop(ctx, st, keep, lambda n, t: t >= seconds and n >= k,
                      False)
    cfg = ctx.config
    rays = cfg["width"] * cfg["height"] * cfg["spp"]
    return dict(items=len(lat), seconds=span, kept=keep.items,
                metrics=dict(rays_per_s=len(lat) * rays / span,
                             frame_ms_p95=float(np.percentile(lat, 95))
                             * 1e3))


def traced(ctx, st) -> dict:
    keep = Reservoir(int(ctx.traffic["compare_frames"]), ctx.stream(3))
    n = max(int(ctx.traffic["trace_frames"]), keep.k)
    summary = {}
    with tracing.profiled(summary):
        # the profiler's first operations are late (its buffers): frames
        # outside any span take them
        for _ in range(tracing.PAD):
            frame(ctx, st)
        ctx.sync()
        lat, span = _loop(ctx, st, keep, lambda k, t: k >= n, True)
    return dict(items=len(lat), seconds=span, kept=keep.items,
                trace=summary)


def compare(ctx, st, win: dict) -> dict:
    """Free the program's state, then render each kept frame's pose with
    the reference -> ``mismatch_share``: the worst kept frame's share of
    pixels outside ``harness.close`` of the reference."""
    order, pose_list = st["order"], st["poses"]
    st.clear()
    ctx.free()
    cfg = ctx.config
    scene = ctx.reference_scene()
    fov_h, fov_v = harness.fov(cfg)
    worst = 0.0
    for i, img in win["kept"]:
        pos, yaw = pose_list[int(order[i % len(order)])]
        cam = ref.make_camera(pos, cfg["width"], cfg["height"], fov_h,
                              fov_v, yaw, ctx.device)
        want = ref.render_frame(scene, cam, cfg["refmax"]).color
        got = img.reshape(-1, 3).to(ctx.device)
        worst = max(worst, harness.mismatch_share(got, want.float()))
    return dict(mismatch_share=worst)
