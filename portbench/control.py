"""The control: the reference put in the program's place, computed in
bfloat16, the precision below the float32 the configurations state. Each
cell's comparison must call it not correct.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3

runs the cell with :class:`ReferenceProgram` as the program (no warm-up,
the shortest window that yields the frames a run compares) and prints
each seed's numbers beside the cell's limits, one JSON line each. The
benchmark's own runs never run it; ``tests/test_portbench_control.py``
holds it at a small size on the CPU and at the cell's size on the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

import torch

from . import harness
from .reference import render as ref
from .reference.scene import tensors

class ReferenceProgram:
    """The program's interface (``portbench.program``) served by the
    reference in ``dtype``. Scenes keep float32 leaves; each render
    computes in ``dtype``."""

    def __init__(self, dtype=torch.bfloat16):
        self.dtype = dtype

    def build_scene(self, spec, device):
        return tensors(spec, device)

    def camera(self, pos, w, h, fov_h, fov_v, yaw, device):
        return ref.make_camera(pos, w, h, fov_h, fov_v, yaw, device)

    def render_config(self, refmax, spp, backend):
        return dict(refmax=refmax)

    def octree(self, scene, max_depth):
        return None

    def frame_tables(self, scene, cam):
        return None

    def _low(self, scene):
        return scene.with_leaves([p.to(self.dtype) for p in scene.leaves()])

    def render(self, scene, cam, cfg, seed, accel=None, tables=None):
        color = ref.render_frame(self._low(scene), cam, cfg["refmax"]).color
        return color.float().reshape(cam.h, cam.w, 3)


def run(cell, seed: int, device, program=None) -> dict:
    """The cell with the control as its program -> the result's fields."""
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic,
                                                  warmup_frames=0))
    return harness.run(cell, seed, 0.0, False, device,
                       program or ReferenceProgram())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the control's readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    repo = pathlib.Path(__file__).resolve().parent.parent
    manifest = harness.load_json(repo / "BENCHMARK.json")
    cell = harness.find_cell(manifest, args.workload, repo)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for s in args.seeds.split(","):
        out = run(cell, int(s), device)
        print(json.dumps(dict(workload=cell.name, seed=int(s),
                              correct=out["correct"],
                              checks=out["checks"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
