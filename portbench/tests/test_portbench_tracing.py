"""The trace reduction and the run's result line."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from portbench import harness, program, tracing

REPO = harness.ROOT.parent


def ev(name, a, b, device=False):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=a, end=b),
        device_type="DeviceType.CUDA" if device else "DeviceType.CPU")


def test_summarize():
    evs = [ev(tracing.SPAN, 0, 100), ev(tracing.SPAN, 200, 300),
           ev(tracing.SPAN, 0, 100, device=True),
           ev("aten::add", 5, 20), ev("cudaLaunchKernel", 10, 12),
           ev("k1", 20, 50, True), ev("k2", 40, 60, True),
           ev("cudaDeviceSynchronize", 60, 100),
           ev("k1", 210, 240, True)]
    s = tracing.summarize(evs)
    assert s["spans"] == 2 and s["ops"] == 3
    assert s["host_s"] == pytest.approx(200e-6)
    assert s["busy_s"] == pytest.approx(70e-6)
    assert s["window_s"] == pytest.approx(300e-6)
    assert s["kernel_n"] == {"k1": 2, "k2": 1}
    assert s["kernel_s"]["k1"] == pytest.approx(60e-6)
    gaps = dict(s["idle_gaps"])
    assert gaps["cudaLaunchKernel"] == pytest.approx(20e-6)
    assert gaps["cudaDeviceSynchronize"] == pytest.approx(40e-6)
    assert gaps["python between operations"] == pytest.approx(70e-6)
    assert tracing.kernel_seconds(s, "k") == pytest.approx(80e-6)


def test_trace_run_reads_nothing_without_a_card(small_cell):
    out = harness.run(small_cell("headline_52.fused_view"), 5, 0.05, True,
                      "cpu", program)
    assert out["metrics"] == {} and out["device"]["busy_s"] == 0.0
    assert list(out)[-1] == "checks" and set(out["breakdown"]) == {
        "device_ops", "idle_gaps"}


def test_seeds_order_the_same_work(small_cell):
    """A seed draws the order of the poses and the compared frames, never
    the scene: every seed renders the configuration's published layout."""
    cell = small_cell("c4_100k.octree_view")
    a = harness.Ctx(cell, 2**31 + 77, "cpu", program)
    b = harness.Ctx(cell, 2**31 + 78, "cpu", program)
    assert (a.spec.sphere_center == b.spec.sphere_center).all()
    order = [sorted(x.stream(1).permutation(32)) for x in (a, b)]
    assert order[0] == order[1] == list(range(32))
    assert list(a.stream(1).permutation(32)) != list(
        b.stream(1).permutation(32))
    assert list(a.stream(1).permutation(32)) == list(
        harness.Ctx(cell, 2**31 + 77, "cpu", program).stream(
            1).permutation(32))
    assert harness.mix(2**31 + 77, 3) == harness.mix(2**31 + 77, 3)
    assert 0 <= harness.mix(-5, 2**40) < 2**31


@pytest.mark.parametrize("only_benchmark", [False, True])
def test_cli_refuses_without_a_card(tmp_path, only_benchmark):
    """No card: exit code 2 and no result. A checkout with only the
    benchmark's files: no result either."""
    cwd = REPO
    if only_benchmark:
        shutil.copy(REPO / "BENCHMARK.json", tmp_path)
        shutil.copytree(harness.ROOT, tmp_path / "portbench",
                        ignore=shutil.ignore_patterns("__pycache__"))
        cwd = tmp_path
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "headline_52.fused_view", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=cwd,
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    if not only_benchmark:
        assert out.returncode == 2


def test_manifest_names_every_piece(manifest):
    for w in manifest["workloads"]:
        cell = harness.find_cell(manifest, w["name"], REPO)
        assert cell.loop() and cell.recipe()
        for m in cell.per_layer:
            assert callable(cell.reader(m["name"]).read)
        assert set(cell.limits) and all(
            isinstance(v, (int, float)) for v in cell.limits.values())
    json.dumps(manifest)


@pytest.mark.parametrize("name", [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]])
def test_plain_run_reports_its_end_to_end_metrics(small_cell, name):
    """Each cell's plain run reports its own end-to-end metrics, no more
    and no fewer."""
    cell = small_cell(name)
    out = harness.run(cell, 11, 0.0, False, "cpu", program)
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(m["value"] > 0 for m in out["metrics"].values())
