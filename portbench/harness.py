"""The harness: finds a cell's pieces by name, runs it, judges it.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in a file of its own under this folder, found by the
name ``BENCHMARK.json`` gives:

- ``configs/<config>.json``: the configuration as it is run; its ``scene``
  names the recipe ``scenes/<scene>.py`` that draws the scene from the
  seed;
- ``traffic/<traffic>.json``: the mix's parameters; its ``loop`` names
  the general loop ``loops/<loop>.py`` that reads them;
- ``limits/<workload>.json``: the limit of each number the cell's
  comparison with the reference gives;
- ``layer_metrics/<metric>.py``: a reader ``read(ctx, run) -> float |
  None`` of one per-layer metric.

A later cell, configuration or metric is new files and entries; no file
here names one.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import pathlib
import sys
import time
from typing import Optional

import numpy as np
import torch

from .reference.render import fp32_matmuls
from .reference.scene import tensors

ROOT = pathlib.Path(__file__).resolve().parent
#: top-level module names that may never be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracer_js_tpu")
#: a pixel agrees with the reference when every channel is within
#: ``CLOSE_ATOL + CLOSE_RTOL * |reference|`` (the project's allclose 1e-4)
CLOSE_RTOL, CLOSE_ATOL = 1e-4, 1e-4


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path):
    """A module from its file (names may hold dots)."""
    name = "portbench_piece_" + "".join(c if c.isalnum() else "_"
                                        for c in str(path))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """A workload of the manifest with its pieces loaded."""

    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    root: pathlib.Path

    def loop(self):
        return load_module(self.root / "loops" / f"{self.traffic['loop']}.py")

    def recipe(self):
        return load_module(self.root / "scenes" / f"{self.config['scene']}.py")

    def reader(self, metric: str):
        return load_module(self.root / "layer_metrics" / f"{metric}.py")


def find_cell(manifest: dict, name: str, repo: pathlib.Path,
              root: pathlib.Path = ROOT) -> Cell:
    """The manifest's workload ``name`` with its configuration, traffic,
    limits and metrics."""
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in the manifest")
    w = work[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]

    def mine(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in manifest["end_to_end"] if mine(m)]
    reported = {m["name"] for m in e2e}
    per = [m for m in manifest["per_layer"]
           if name in m.get("workloads", [name] if m["moves"] in reported
                            else [])]
    return Cell(name=name, workload=w, config=load_json(repo / conf["file"]),
                traffic=load_json(root / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(root / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per, root=root)


# ---------------------------------------------------------------------------
# Inputs from the seed
# ---------------------------------------------------------------------------

def seed64(seed: int) -> int:
    return int(seed) % (1 << 64)


def mix(seed: int, i: int) -> int:
    """A 31-bit seed from the run's seed and an index (splitmix64)."""
    z = (seed64(seed) + (i + 1) * 0x9E3779B97F4A7C15) % (1 << 64)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) % (1 << 64)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) % (1 << 64)
    return (z ^ (z >> 31)) & 0x7FFFFFFF


def fov(config: dict):
    """(fov_h, fov_v) in radians: ``fov_h`` as a multiple of pi, the
    vertical one scaled by the aspect."""
    fov_h = math.pi * float(config["fov_h_over_pi"])
    return fov_h, fov_h * config["height"] / config["width"]


# ---------------------------------------------------------------------------
# The numbers compared
# ---------------------------------------------------------------------------

def mismatch_share(got: torch.Tensor, want: torch.Tensor) -> float:
    """Share of pixels [N, 3] not within the tolerance of the reference in
    every channel (a non-finite pixel never is)."""
    ok = ((got - want).abs() <= CLOSE_ATOL + CLOSE_RTOL * want.abs()).all(-1)
    return float((~ok).double().mean())


# ---------------------------------------------------------------------------
# A run
# ---------------------------------------------------------------------------

class Ctx:
    """What a loop and a reader see of the run."""

    def __init__(self, cell: Cell, seed: int, device, program):
        self.cell, self.seed = cell, int(seed)
        self.config, self.traffic = cell.config, cell.traffic
        self.device = torch.device(device)
        self.program = program
        # the configuration's published layout: a seed orders the same
        # work, it does not change it
        self.spec = cell.recipe().spec(cell.config, np.random.default_rng(
            int(cell.config["layout_seed"])))

    def stream(self, k: int) -> np.random.Generator:
        """The run's random stream ``k`` (1: pose order, 3: the frames
        compared)."""
        return np.random.default_rng([seed64(self.seed), k])

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def free(self) -> None:
        """After the program's state was dropped: give its memory back."""
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def reference_scene(self):
        return tensors(self.spec, self.device)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        program, t_start: Optional[float] = None) -> dict:
    """One run of a cell -> the result line's fields (``checks`` last).
    ``t_start`` is the process's start on ``time.perf_counter``'s clock."""
    t_start = time.perf_counter() if t_start is None else t_start
    fp32_matmuls()
    ctx = Ctx(cell, seed, device, program)
    loop = cell.loop()
    st = loop.setup(ctx)
    setup_s = time.perf_counter() - t_start
    on_card = ctx.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(ctx.device)
    win = loop.traced(ctx, st) if trace else loop.window(ctx, st, seconds)
    peak = torch.cuda.max_memory_allocated(ctx.device) if on_card else 0
    t_ref = time.perf_counter()
    numbers = loop.compare(ctx, st, win)
    print(f"portbench: {cell.name} seed {seed}: set-up {setup_s:.3f} s, "
          f"window {win['seconds']:.3f} s ({win['items']} items), "
          f"comparison {time.perf_counter() - t_ref:.3f} s", file=sys.stderr,
          flush=True)
    checks = {k: dict(value=numbers[k], limit=cell.limits[k])
              for k in cell.limits}
    failed = sum(not (c["value"] <= c["limit"]) for c in checks.values())
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = cell.reader(m["name"]).read(ctx, win)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
    else:
        got = dict(win["metrics"], setup_s=setup_s)
        metrics = {m["name"]: dict(value=got[m["name"]], unit=m["unit"])
                   for m in cell.end_to_end}
    dev = dict(platform="gpu" if on_card else "cpu",
               kind=torch.cuda.get_device_name(ctx.device) if on_card
               else "cpu",
               count=1, memory_peak_bytes=int(peak))
    out = dict(correct=failed == 0, attempted=int(win["items"]),
               failed=int(failed), metrics=metrics, device=dev)
    if trace:
        tr = win["trace"]
        dev.update(busy_s=tr.get("window_busy_s", 0.0),
                   window_s=tr.get("window_s", 0.0))
        out["breakdown"] = dict(device_ops=tr.get("device_ops", []),
                                idle_gaps=tr.get("idle_gaps", []))
    out["checks"] = checks
    return out
