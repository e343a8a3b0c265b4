"""The four-card fit cell (``c5_1m_x4.fit``): its pieces found by name,
its readers, its loop over the ranks (``loops/fit_mesh``), and its
comparison, which must call the bfloat16 control and each fault of the
exchange not correct (``control_fit_mesh``): on two gloo ranks at a small
size on the CPU, and at the cell's size on four cards."""
from __future__ import annotations

import json
import math
import subprocess
import sys

import pytest
import torch

from portbench import control_fit_mesh, harness, program, ranks
from portbench.tests import fit_mesh_rank
from portbench.tests.test_portbench_imports import REPO

torch.set_num_threads(1)

CELL = "c5_1m_x4.fit"
NEW = ("fit.allreduce_ms_per_step", "fit.allreduce_mb_per_step")
READERS = ("frames.device_idle_share", "fit.rebuild_ms_per_step",
           "fit.host_syncs_per_step", *NEW)
#: a launch's bound in these tests: the ranks' imports, every small run
BOUND_S = 600.0
SEED = 2**31 + 29


def launch(mode: str, seed: int = SEED) -> list:
    """Two CPU ranks of ``fit_mesh_rank`` -> rank 0's result lines."""
    code, out, why = ranks.launch(
        [sys.executable, fit_mesh_rank.__file__, mode, str(seed)], 2,
        BOUND_S)
    assert code == 0, why
    return [json.loads(line) for line in out.strip().splitlines()]


def test_pieces_found_by_name(manifest):
    """The configuration is ``c5_1m``'s with its ranks and sharding, the
    traffic ``fit_replay8``'s through the loop over the ranks, and the
    limits the one-card cell's with the replicas' agreement."""
    cell = harness.find_cell(manifest, CELL, REPO)
    one = harness.find_cell(manifest, "c5_1m.fit", REPO)
    assert cell.loop().__file__ == str(harness.ROOT / "loops"
                                       / "fit_mesh.py")
    assert cell.workload["chips"] == cell.config["ranks"] == 4
    assert cell.config["shard"] == "rays"
    assert set(cell.config) == set(one.config) | {"ranks", "shard"}
    assert {k: v for k, v in cell.config.items()
            if k not in ("ranks", "shard", "deployment", "reduced")} == {
        k: v for k, v in one.config.items()
        if k not in ("deployment", "reduced")}
    assert cell.traffic == dict(one.traffic, loop="fit_mesh")
    assert cell.limits == dict(one.limits, replica_mismatch=0.0)
    assert [e["name"] for e in cell.end_to_end] == ["rays_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == list(READERS)
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]).read)


def test_manifest_gains_only_entries(manifest):
    """The configuration, the cell and the two metrics come last; the cell
    joins ``rays_per_s``'s list and three per-layer lists, and none of
    the rooflines whose floors count a whole view a launch."""
    assert manifest["configs"][-1]["name"] == "c5_1m_x4"
    assert manifest["workloads"][-1]["name"] == CELL
    assert manifest["workloads"][-2]["name"] == "c5_1m.fit"
    assert [m["name"] for m in manifest["per_layer"][-2:]] == list(NEW)
    lists = {m["name"]: m.get("workloads", [])
             for m in manifest["end_to_end"] + manifest["per_layer"]}
    for name in ("rays_per_s", *READERS):
        assert lists[name][-1] == CELL, name
    for name in ("replay_fwd.roofline_share", "replay_bwd.roofline_share",
                 "octree_dda.roofline_share"):
        assert CELL not in lists[name], name
    assert sum(w["chips"] == 4 for w in manifest["workloads"]) == 1


def test_new_readers(manifest):
    """The exchange's device time a traced step from the NCCL kernels'
    names, its megabytes a step from the program's counter; None where
    there is neither (one card, a program without the counter, an
    untraced run)."""
    cell = harness.find_cell(manifest, CELL, REPO)
    ms, mb = (cell.reader(m) for m in NEW)
    run = dict(items=16, allreduce_bytes=16 * 16_000_232, trace=dict(
        spans=16, ops=9000, kernel_s={
            "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*, "
            "unsigned long, ncclWork*)": 16 * 2e-4,
            "void replay_bwd_kernel<2>(Tabs)": 1.0}))
    assert ms.read(None, run) == pytest.approx(0.2)
    assert mb.read(None, run) == pytest.approx(16.000232)
    one_card = dict(run, trace=dict(run["trace"], kernel_s={
        "void replay_bwd_kernel<2>(Tabs)": 1.0}))
    parent = {k: v for k, v in run.items() if k != "allreduce_bytes"}
    untraced = dict(items=16, metrics={})
    assert ms.read(None, one_card) is None and ms.read(None, untraced) is None
    assert mb.read(None, parent) is None and mb.read(None, untraced) is None


def test_one_process_is_the_fit_loop():
    """Without a mesh (one rank, no process group) the loop runs
    ``loops/fit``'s fit and judges it the same way; the replicas are one
    and agree."""
    cell = fit_mesh_rank.small_cell()
    out = harness.run(cell, SEED, 0.0, False, "cpu", program)
    assert out["correct"], out["checks"]
    assert out["checks"]["replica_mismatch"]["value"] == 0.0
    assert out["attempted"] == 2


def test_two_ranks_run_the_cell():
    """Two gloo ranks run the small cell end to end through
    ``harness.run``: the window ends on both together (``all_agree``) after
    whole cycles, the step is judged over every ray of both ranks, and the
    replicas agree bit for bit."""
    (out,) = launch("run")
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == set(fit_mesh_rank.small_cell().limits)
    assert out["checks"]["replica_mismatch"]["value"] == 0.0
    assert out["attempted"] % 2 == 0 and out["attempted"] >= 2
    assert set(out["metrics"]) == {"rays_per_s", "setup_s"}
    assert out["device"]["memory_peak_bytes_per_device"] == [0, 0]


def test_two_ranks_traced_count_the_exchange():
    """A traced run on two ranks reads the exchange's bytes a step: the
    float leaves and the loss, in float32; nothing of a card."""
    (out,) = launch("traced")
    assert out["correct"], out["checks"]
    cell = fit_mesh_rank.small_cell()
    ctx = harness.Ctx(cell, SEED, "cpu", program)
    scene = program.build_scene(ctx.spec, "cpu")
    floats = sum(p.numel() for p in
                 program.rt.parallel.sharding.float_partition(scene)[0])
    assert out["metrics"] == {"fit.allreduce_mb_per_step": dict(
        value=pytest.approx(4 * (floats + 1) / 1e6), unit="MB")}


def test_control_and_faults_fail_on_two_ranks():
    """The sound program passes; the bfloat16 control and each fault of
    the exchange do not."""
    outs = launch("faults")
    assert [o["fault"] for o in outs] == [None, *control_fit_mesh.FAULTS]
    for o in outs:
        assert o["correct"] is (o["fault"] is None), (o["fault"],
                                                       o["checks"])
    worst = {o["fault"]: o["checks"] for o in outs}
    # the faults that leave the replicas apart
    for fault in ("no_exchange", "rank1_no_opt_step"):
        assert worst[fault]["replica_mismatch"]["value"] > 0.0, fault


@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards; this machine has "
                    f"{torch.cuda.device_count()}")


@pytest.mark.portbench_card
def test_traced_cell_reads_every_metric_on_four_cards(four_cards):
    got = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
         str(2**31 + 47), "--seconds", "5", "--trace", "1"], cwd=REPO,
        capture_output=True, text=True, timeout=2 * ranks.ALLOWANCE_S)
    assert got.returncode == 0, got.stderr[-4000:]
    out = json.loads(got.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == 4
    assert all(p > 0 for p in out["device"]["memory_peak_bytes_per_device"])
    for m in READERS:
        v = out["metrics"][m]["value"]
        assert v is not None and math.isfinite(v), m


@pytest.mark.portbench_card
def test_control_and_faults_fail_on_four_cards(four_cards):
    got = subprocess.run(
        [sys.executable, "-m", "portbench.control_fit_mesh", "--workload",
         CELL, "--seeds", str(2**31 + 53)], cwd=REPO, capture_output=True,
        text=True, timeout=4 * ranks.ALLOWANCE_S)
    assert got.returncode == 0, got.stderr[-4000:]
    outs = [json.loads(line) for line in got.stdout.strip().splitlines()]
    assert [o["fault"] for o in outs] == list(control_fit_mesh.FAULTS)
    for o in outs:
        print(json.dumps(o))
        assert o["correct"] is False, (o["fault"], o["checks"])
