"""The fit cell's control and faults: the program's ``fit`` with one part
put wrong. The cell's comparison (``loops/fit.compare``) must call each
run not correct.

- ``bf16``, the control: the reference's replay (``reference/fit``)
  computed in bfloat16, the precision below the float32 the
  configuration states, in the place of the program's replay (the loss
  and its gradients). The recording stays the program's: a dense
  recording of a whole step, 16.7M rays against 1M spheres, takes minutes;
- ``swapped_views``: each step's recording hands view 0's winners to view
  1 and view 1's to view 0;
- ``view_left_out``: one view's gradient left out (its loss is counted,
  its graph detached);
- ``no_opt_step``: the optimizer's step does nothing, so the state is
  left unchanged.

    python3 -m portbench.control_fit --workload c5_1m.fit --seeds 1,2,3

runs each at the cell's size (no warm-up, the shortest window: one
cycle) and prints each run's numbers beside the limits, one JSON line
each. The benchmark's own runs never run it;
``tests/test_portbench_fit.py`` holds it at a small size on the CPU and
at the cell's size on the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import types

import numpy as np
import torch

from . import harness, program
from .reference import fit as ref_fit
from .reference import render as ref
from .reference.scene import tensors

FAULTS = ("bf16", "swapped_views", "view_left_out", "no_opt_step")


def _swapped_views(real, cell, device):
    def record_views(*a, **kw):
        recs = real(*a, **kw)
        recs[0], recs[1] = recs[1], recs[0]
        return recs

    return record_views


def _view_left_out(real, cell, device):
    def replay_loss(scene, cfg, cameras, targets, recs, *a, **kw):
        n = len(cameras)
        kept = real(scene, cfg, cameras[:-1], targets[:-1], recs[:-1], *a,
                    **kw)
        last = real(scene, cfg, cameras[-1:], targets[-1:], recs[-1:], *a,
                    **kw)
        return (kept * (n - 1) + last.detach()) / n

    return replay_loss


def _no_opt_step(real, cell, device):
    def make_opt(*a, **kw):
        opt = real(*a, **kw)
        opt.step = lambda *_a, **_kw: None
        return opt

    return make_opt


def _bf16(real, cell, device, dtype=torch.bfloat16):
    """The reference replay in ``dtype`` over the program's scene leaves
    (cast, so the gradients reach the program's float32 parameters) and
    the reference's own rays of the traffic's views."""
    loop = cell.loop()
    cfg = cell.config
    fov_h, fov_v = harness.fov(cfg)
    rays = [tuple(x.to(dtype) for x in ref.pixel_rays(ref.make_camera(
        pos, cfg["width"], cfg["height"], fov_h, fov_v, yaw, device)))
        for pos, yaw in loop.views(cfg, cell.traffic)]
    ints = tensors(cell.recipe().spec(cfg, np.random.default_rng(
        int(cfg["layout_seed"]))), device)

    def replay_loss(scene, cfg_, cameras, targets, recs, *a, **kw):
        sc = ints.with_leaves([
            x.to(dtype) for x in (scene.sphere_center, scene.sphere_radius,
                                  scene.box_center, scene.box_half,
                                  scene.textures.solid_rgb)])
        total = torch.zeros((), dtype=torch.float32, device=targets.device)
        for v, rec in enumerate(recs):
            col = ref_fit.replay(sc, *rays[v], rec)
            total = total + ((col - targets[v].to(dtype)) ** 2).sum().float()
        return total / sum(r.shape[0] for r in recs)

    return replay_loss


PATCH = {"bf16": ("replay_loss", _bf16),
         "swapped_views": ("record_views", _swapped_views),
         "view_left_out": ("replay_loss", _view_left_out),
         "no_opt_step": ("_make_opt", _no_opt_step)}


def faulty(fault: str, cell, device):
    """The program with ``fault`` put into its fit: a namespace like
    ``portbench.program`` whose ``rt.fit`` runs the program's ``fit`` with
    one of the functions it calls replaced for the call."""
    name, make = PATCH[fault]
    real_fit = program.rt.fit
    mod = sys.modules[real_fit.__module__]

    def fit(*a, **kw):
        real = getattr(mod, name)
        setattr(mod, name, make(real, cell, device))
        try:
            return real_fit(*a, **kw)
        finally:
            setattr(mod, name, real)

    rt = types.SimpleNamespace(**{k: getattr(program.rt, k)
                                  for k in dir(program.rt)
                                  if not k.startswith("_")})
    rt.fit = fit
    mod_ns = types.SimpleNamespace(**{k: getattr(program, k)
                                      for k in dir(program)
                                      if not k.startswith("_")})
    mod_ns.rt = rt
    return mod_ns


def run(cell, seed: int, device, fault: str) -> dict:
    """The cell with ``fault`` in the program -> the result's fields."""
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic,
                                                  warmup_steps=0))
    return harness.run(cell, seed, 0.0, False, device,
                       faulty(fault, cell, torch.device(device)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the fit's control and faults")
    ap.add_argument("--workload", default="c5_1m.fit")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default=",".join(FAULTS))
    args = ap.parse_args(argv)
    repo = pathlib.Path(__file__).resolve().parent.parent
    manifest = harness.load_json(repo / "BENCHMARK.json")
    cell = harness.find_cell(manifest, args.workload, repo)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for s in args.seeds.split(","):
        for fault in args.faults.split(","):
            out = run(cell, int(s), device, fault)
            print(json.dumps(dict(workload=cell.name, seed=int(s),
                                  fault=fault, correct=out["correct"],
                                  checks=out["checks"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
