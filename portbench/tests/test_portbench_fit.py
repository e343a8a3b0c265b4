"""The fit cell (``c5_1m.fit``): its pieces found by name, its traced
readers, its start, and its comparison, which must call the bfloat16
control and two faults not correct (``control_fit``), at small sizes on
the CPU and at the cell's size on the card."""
from __future__ import annotations

import dataclasses
import json
import shutil
import types

import numpy as np
import pytest
import torch

from portbench import control_fit, harness, program, roofline_replay
from portbench.tests.test_portbench_imports import (REPO, imported_names,
                                                    top_level_modules)

torch.set_num_threads(1)

CELL = "c5_1m.fit"
READERS = ("replay_fwd.roofline_share", "replay_bwd.roofline_share",
           "fit.rebuild_ms_per_step", "fit.host_syncs_per_step")
#: over the small cell's sizes: enough spheres and rays that the faults
#: show on the sampled rays (at 400 prims most rays meet only the ground
#: and the sky, the same in every view)
OVER = dict(width=96, height=64, n_prims=3000, octree_max_depth=4)
#: the traffic cut for the CPU: the first two views, cycles of two steps
#: (a rebuild and a recording every other step), one traced cycle
TRAFFIC = dict(replay_every=2, accel_every=2, warmup_steps=3,
               trace_cycles=1, sample_rays=4096)


@pytest.fixture
def fit_cell(small_cell):
    def make(**over):
        cell = small_cell(CELL, **dict(OVER, **over))
        return dataclasses.replace(cell, traffic=dict(
            cell.traffic, view_offsets=cell.traffic["view_offsets"][:2],
            **TRAFFIC))
    return make


def test_pieces_found_by_name(tmp_path, manifest, fit_cell):
    """The cell's configuration, traffic, limits, loop and readers are
    files found by the names the manifest gives; a run reads and writes
    none of the harness's files."""
    root = tmp_path / "portbench"
    shutil.copytree(harness.ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cell = harness.find_cell(manifest, CELL, REPO, root)
    assert cell.loop().__file__ == str(root / "loops" / "fit.py")
    assert cell.config["n_prims"] == 1_000_000 and cell.config[
        "scene"] == "config4"
    assert [e["name"] for e in cell.end_to_end] == ["rays_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == [
        "frames.device_idle_share", "octree_dda.roofline_share", *READERS]
    assert set(cell.limits) == {"record_mismatch_share", "grad_rel_err",
                                "loss_rel_err", "update_rel_err"}
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]).read)
    small = fit_cell()
    small = dataclasses.replace(cell, config=small.config,
                                traffic=small.traffic)
    out = harness.run(small, 2**31 + 3, 0.0, False, "cpu", program)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"rays_per_s", "setup_s"}
    assert out["attempted"] == 2   # one whole cycle
    assert {p: p.read_bytes() for p in before} == before


def test_start_scene_is_the_builders(fit_cell):
    """The start's scene made from the layout's equals the program's
    builder run on the start's spec, leaf for leaf."""
    cell = fit_cell()
    ctx = harness.Ctx(cell, 5, "cpu", program)
    loop = cell.loop()
    spec = loop.start(ctx.spec, cell.traffic, np.random.default_rng(4))
    assert not np.array_equal(spec.sphere_center, ctx.spec.sphere_center)
    assert not np.array_equal(spec.tex_rgb, ctx.spec.tex_rgb)
    assert (spec.tex_rgb >= 0).all() and (spec.tex_rgb <= 1).all()
    got = loop.start_scene(program.build_scene(ctx.spec, "cpu"), spec, "cpu")
    want = program.build_scene(spec, "cpu")
    names = program.rt.float_leaf_names(want)
    parts = program.rt.parallel.sharding.float_partition
    for n, a, b in zip(names, parts(got)[0], parts(want)[0]):
        assert torch.equal(a, b), n


def _ctx(totals, cell):
    prof = types.SimpleNamespace(SPAN_TOTALS=totals)
    rt = types.SimpleNamespace(utils=types.SimpleNamespace(profiling=prof))
    ctx = types.SimpleNamespace(program=types.SimpleNamespace(rt=rt),
                                config=cell.config, traffic=cell.traffic)
    ctx.spec = cell.recipe().spec(cell.config, np.random.default_rng(
        cell.config["layout_seed"]))
    return ctx


def test_readers_read_the_traced_steps(manifest):
    """The span readers take the totals per step; the roofline readers a
    view's floor per replayed view over the kernel's time (at most
    100%)."""
    cell = harness.find_cell(manifest, CELL, REPO)
    tot = {"rt.fit.step": [24, 8.0], "rt.fit.rebuild": [3, 6.0],
           "rt.sync": [27, 0.04]}
    run = dict(trace=dict(spans=16, ops=9000, kernel_s={
        "void replay_fwd_kernel<2>(Tabs)": 128 * 40e-6,
        "void replay_bwd_kernel<2>(Tabs)": 128 * 150e-6}))
    ctx = _ctx(tot, cell)
    got = {m: cell.reader(m).read(ctx, run) for m in READERS}
    assert got["fit.rebuild_ms_per_step"] == pytest.approx(250.0)
    assert got["fit.host_syncs_per_step"] == pytest.approx(1.125)
    n = 1920 * 1088
    fwd = roofline_replay.fwd_floor_s(999_999, 1, 19, n, 2)
    assert fwd == pytest.approx((n * 44 + 24 + 16 * 999_999 + 8 * 10 ** 6
                                 + 12 * 19) / 3.35e12)
    assert got["replay_fwd.roofline_share"] == pytest.approx(
        100 * fwd / 40e-6)
    assert 0 < got["replay_bwd.roofline_share"] < got[
        "replay_fwd.roofline_share"] < 100
    for case in ("untraced", "no_ops", "parent"):
        c, r = ctx, run
        if case == "untraced":
            r = dict(metrics={})
        elif case == "no_ops":
            r = dict(trace=dict(spans=16, ops=0, kernel_s={}))
        else:
            c = _ctx({"rt.render": [5, 0.1]}, cell)
            r = dict(run, trace=dict(run["trace"], kernel_s={}))
        assert all(cell.reader(m).read(c, r) is None for m in READERS), case


def test_traced_run_on_the_cpu(fit_cell):
    """A traced run spans whole cycles of steps, reads nothing of the card
    on the CPU, and is judged like an untraced one."""
    cell = fit_cell()
    out = harness.run(cell, 2**31 + 9, 0.0, True, "cpu", program)
    assert out["correct"], out["checks"]
    assert out["metrics"] == {} and out["device"]["busy_s"] == 0.0
    assert out["attempted"] == 2 * int(cell.traffic["trace_cycles"])


@pytest.mark.parametrize("fault", [None, *control_fit.FAULTS])
def test_control_and_faults_fail_small(fit_cell, fault):
    """The sound program passes; the bfloat16 control and each fault
    do not."""
    cell = fit_cell()
    if fault is None:
        cell = dataclasses.replace(cell, traffic=dict(cell.traffic,
                                                      warmup_steps=0))
        out = harness.run(cell, 2**31 + 23, 0.0, False, "cpu", program)
    else:
        out = control_fit.run(cell, 2**31 + 23, "cpu", fault)
    assert out["correct"] is (fault is None), out["checks"]


def test_reference_fit_loads_nothing_of_the_program():
    code = (f"import json, sys; sys.path.insert(0, {str(REPO)!r})\n"
            "import portbench.reference.fit\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    mods = top_level_modules(code)
    assert not mods & {"raytracer_js_tpu_torch", *harness.FORBIDDEN}
    assert imported_names(harness.ROOT / "reference" / "fit.py") <= {
        "__future__", "math", "torch"}


@pytest.mark.portbench_card
def test_traced_run_reads_every_metric_on_card(card, manifest):
    cell = harness.find_cell(manifest, CELL, REPO)
    out = harness.run(cell, 2**31 + 41, 0.0, True, card, program)
    assert out["correct"], out["checks"]
    for m in ("frames.device_idle_share", "octree_dda.roofline_share",
              *READERS):
        assert out["metrics"][m]["value"] is not None, m
    for m in ("octree_dda.roofline_share", *READERS[:2]):
        assert 0 < out["metrics"][m]["value"] <= 100, m


@pytest.mark.portbench_card
@pytest.mark.parametrize("fault", control_fit.FAULTS)
def test_control_and_faults_fail_on_card(card, manifest, fault):
    cell = harness.find_cell(manifest, CELL, REPO)
    out = control_fit.run(cell, 2**31 + 43, card, fault)
    assert out["correct"] is False, out["checks"]


def test_manifest_gains_only_entries(manifest):
    """The cell is appended to the lists it joins."""
    assert manifest["workloads"][-1]["name"] == CELL
    assert manifest["configs"][-1]["name"] == "c5_1m"
    rays = next(e for e in manifest["end_to_end"]
                if e["name"] == "rays_per_s")
    idle, dda = (next(m for m in manifest["per_layer"] if m["name"] == n)
                 for n in ("frames.device_idle_share",
                           "octree_dda.roofline_share"))
    assert rays["workloads"][-1] == idle["workloads"][-1] == CELL
    assert dda["workloads"] == ["c4_100k.octree_view", CELL]
    assert [m["name"] for m in manifest["per_layer"][-4:]] == list(READERS)
    json.dumps(manifest)
