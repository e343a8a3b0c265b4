"""The harness is data: a new configuration, traffic mix, cell and
per-layer metric are new files and manifest entries, found by name, with
no edit to a file that exists."""
from __future__ import annotations

import json
import shutil

from portbench import harness, program


def test_new_pieces_found_by_name(tmp_path, manifest):
    root = tmp_path / "portbench"
    shutil.copytree(harness.ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "configs" / "tiny_12.json").write_text(json.dumps(dict(
        layout_seed=3, scene="headline", n_spheres=10, prims=12, width=32,
        height=16, fov_h_over_pi=0.5, camera_pos=[0.0, 0.0, 0.5], refmax=3,
        spp=1)))
    (root / "traffic" / "brute_still.json").write_text(json.dumps(dict(
        loop="frames", backend="brute", poses=1, warmup_frames=1,
        compare_frames=2, trace_frames=3)))
    (root / "limits" / "tiny_12.brute_still.json").write_text(
        json.dumps({"mismatch_share": 0.0}))
    (root / "layer_metrics" / "frames.host_ms.py").write_text(
        "def read(ctx, run):\n"
        "    tr = run.get('trace') or {}\n"
        "    return 1e3 * tr['host_s'] / tr['spans'] if tr.get('spans') "
        "else None\n")
    m = json.loads(json.dumps(manifest))
    m["configs"].append(dict(name="tiny_12", source="a test",
                             file="portbench/configs/tiny_12.json",
                             reduced=[], why="a test"))
    m["workloads"].append(dict(name="tiny_12.brute_still", config="tiny_12",
                               traffic="brute_still", chips=1, why="a test"))
    for e in m["end_to_end"]:
        if "rays_per_s" == e["name"]:
            e["workloads"].append("tiny_12.brute_still")
    m["per_layer"].append(dict(name="frames.host_ms", unit="ms",
                               better="lower", source="program_span",
                               layer="render", moves="rays_per_s",
                               workloads=["tiny_12.brute_still"]))
    cell = harness.find_cell(m, "tiny_12.brute_still", tmp_path, root)
    assert cell.config["refmax"] == 3 and cell.traffic["backend"] == "brute"
    assert [e["name"] for e in cell.end_to_end] == ["rays_per_s", "setup_s"]
    assert [p["name"] for p in cell.per_layer] == ["frames.host_ms"]
    out = harness.run(cell, 3, 0.05, False, "cpu", program)
    assert out["correct"] and set(out["metrics"]) == {"rays_per_s",
                                                      "setup_s"}
    traced = harness.run(cell, 4, 0.05, True, "cpu", program)
    assert traced["correct"] and traced["metrics"]["frames.host_ms"][
        "value"] > 0
    after = {p: p.read_bytes() for p in before}
    assert after == before
