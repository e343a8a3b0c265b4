"""The four-card fit cell's control and faults: the program's ``fit(...,
mesh=)`` with one part put wrong. The cell's comparison
(``loops/fit_mesh.compare``) must call each run not correct.

- ``bf16``, the control: the reference's replay (``reference/fit``) of
  each rank's rows computed in bfloat16, the precision below the float32
  the configuration states, in the place of the program's replay (as
  ``control_fit``'s, on a rank's slice of each view);
- ``no_exchange``: the all-reduce left out, so each rank keeps its own
  partial loss and gradients;
- ``double_exchange``: the all-reduce done twice, so the loss and
  gradients count every rank's part ``world`` times;
- ``swapped_rows``: ranks 0 and 1 trace each other's slice of every view
  (the mesh's ``rows`` of the other rank), so their recordings come back
  in the wrong places;
- ``rank1_no_opt_step``: rank 1's optimizer step does nothing, so its
  replica stays where it started while the others move.

    python3 -m portbench.control_fit_mesh --workload c5_1m_x4.fit \
        --seeds 1,2,3

runs each at the cell's size on as many cards as the cell asks for (no
warm-up, the shortest window: one cycle), as ranks of this command
(``ranks.launch``), and prints each run's numbers beside the limits, one
JSON line each. The benchmark's own runs never run it;
``tests/test_portbench_fit_mesh.py`` holds it at a small size on two gloo
ranks on the CPU, and at the cell's size on four cards.
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
import torch.distributed as dist

from . import harness, program, ranks
from .loops import fit as fit_loop
from .reference import fit as ref_fit
from .reference import render as ref
from .reference.scene import tensors

FAULTS = ("bf16", "no_exchange", "double_exchange", "swapped_rows",
          "rank1_no_opt_step")


def _bf16(real, cell, device, dtype=torch.bfloat16):
    """The reference replay in ``dtype`` of the rows the fit hands it
    (``rows=``, the whole view on one card) over the program's scene
    leaves (cast, so the gradients reach the program's float32
    parameters), each rank's part divided by every view's whole pixel
    count as the program's is."""
    cfg = cell.config
    fov_h, fov_v = harness.fov(cfg)
    rays = [tuple(x.to(dtype) for x in ref.pixel_rays(ref.make_camera(
        pos, cfg["width"], cfg["height"], fov_h, fov_v, yaw, device)))
        for pos, yaw in fit_loop.views(cfg, cell.traffic)]
    ints = tensors(cell.recipe().spec(cfg, np.random.default_rng(
        int(cfg["layout_seed"]))), device)

    def replay_loss(scene, cfg_, cameras, targets, recs, *a,
                    rows=slice(None), **kw):
        sc = ints.with_leaves([
            x.to(dtype) for x in (scene.sphere_center, scene.sphere_radius,
                                  scene.box_center, scene.box_half,
                                  scene.textures.solid_rgb)])
        total = torch.zeros((), dtype=torch.float32, device=targets.device)
        for v, rec in enumerate(recs):
            org, dir = (x[rows] for x in rays[v])
            col = ref_fit.replay(sc, org, dir, rec)
            total = total + ((col - targets[v][rows].to(dtype)) ** 2
                             ).sum().float()
        return total / sum(c.w * c.h for c in cameras)

    return replay_loss


def _no_exchange(real, cell, device):
    def all_reduce_sum(mesh, tensors):
        return list(tensors)

    return all_reduce_sum


def _double_exchange(real, cell, device):
    def all_reduce_sum(mesh, tensors):
        return real(mesh, real(mesh, tensors))

    return all_reduce_sum


def _rank1_no_opt_step(real, cell, device):
    def make_opt(*a, **kw):
        opt = real(*a, **kw)
        if dist.is_initialized() and dist.get_rank() == 1:
            opt.step = lambda *_a, **_kw: None
        return opt

    return make_opt


#: fault -> (the module of the program's fit that holds the function, its
#: name there, the maker of its replacement); ``swapped_rows`` changes the
#: mesh the fit is given instead
PATCH = {"bf16": ("fit", "replay_loss", _bf16),
         "no_exchange": ("sharding", "all_reduce_sum", _no_exchange),
         "double_exchange": ("sharding", "all_reduce_sum",
                             _double_exchange),
         "rank1_no_opt_step": ("fit", "_make_opt", _rank1_no_opt_step)}


def swapped(mesh):
    """``mesh`` with ranks 0 and 1 trading their rows of every view."""
    if mesh is None or mesh.rank > 1:
        return mesh
    return dataclasses.replace(mesh, rank=1 - mesh.rank)


def faulty(fault: str, cell, device):
    """The program with ``fault`` put into its fit: a namespace like
    ``portbench.program`` whose ``rt.fit`` runs the program's ``fit`` with
    one of the functions it calls replaced for the call (or, for
    ``swapped_rows``, with another mesh)."""
    real_fit = program.rt.fit
    fit_mod = sys.modules[real_fit.__module__]

    if fault == "swapped_rows":
        def fit(*a, mesh=None, **kw):
            return real_fit(*a, mesh=swapped(mesh), **kw)
    else:
        where, name, make = PATCH[fault]
        mod = fit_mod if where == "fit" else fit_mod.sharding

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


def run(cell, seed: int, device, fault: str,
        place: ranks.Rank = ranks.Rank()):
    """The cell with ``fault`` in the program, this rank's part of it ->
    the result's fields on rank 0, None on the others."""
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic,
                                                  warmup_steps=0))
    return harness.run(cell, seed, 0.0, False, device,
                       faulty(fault, cell, torch.device(device)),
                       place=place)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the four-card fit's control "
                                 "and faults")
    ap.add_argument("--workload", default="c5_1m_x4.fit")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default=",".join(FAULTS))
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    repo = pathlib.Path(__file__).resolve().parent.parent
    manifest = harness.load_json(repo / "BENCHMARK.json")
    cell = harness.find_cell(manifest, args.workload, repo)
    world = int(cell.workload["chips"])
    place = ranks.this_rank()
    if place is None and world > 1:
        code, out, why = ranks.launch(
            [sys.executable, "-m", "portbench.control_fit_mesh", *argv],
            world, ranks.ALLOWANCE_S * 4)
        sys.stdout.write(out)
        if code:
            print(f"control_fit_mesh: {why}", file=sys.stderr)
        return code
    place = place or ranks.Rank()
    device = (torch.device("cuda", place.rank) if torch.cuda.is_available()
              else torch.device("cpu"))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    runs = [(int(s), f) for s in args.seeds.split(",")
            for f in args.faults.split(",")]
    for i, (seed, fault) in enumerate(runs):
        # each run's process group meets at a fresh rendezvous of its own
        at = place if place.world == 1 else dataclasses.replace(
            place, init_method=f"{place.init_method}-{i}")
        out = run(cell, seed, device, fault, at)
        if out is not None:
            print(json.dumps(dict(workload=cell.name, seed=seed,
                                  fault=fault, correct=out["correct"],
                                  checks=out["checks"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
