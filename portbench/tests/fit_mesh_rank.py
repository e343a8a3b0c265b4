"""A rank of the four-card fit cell at a small size on the CPU (gloo), for
``test_portbench_fit_mesh.py``:

    python fit_mesh_rank.py <mode> <seed>

started by ``ranks.launch``, which gives it its place. Rank 0 prints one
JSON line a run. Modes:

- ``run``: the rank's part of an untraced run of ``c5_1m_x4.fit`` at the
  small sizes (``harness.run`` over the ranks, the window ended by
  ``ctx.all_agree``);
- ``traced``: the same, traced;
- ``faults``: the sound program with no warm-up, then each of
  ``control_fit_mesh.FAULTS``, each run meeting at a rendezvous of its
  own.
"""
import dataclasses
import json
import pathlib
import sys

import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from portbench import control_fit_mesh, harness, program, ranks  # noqa: E402
from portbench.tests.test_portbench_fit import OVER, TRAFFIC  # noqa: E402

CELL = "c5_1m_x4.fit"


def small_cell():
    """The cell at ``test_portbench_fit``'s small sizes: its first two
    views, cycles of two steps; its ranks share the one CPU, which counts
    as one device."""
    with open(REPO / "BENCHMARK.json") as f:
        cell = harness.find_cell(json.load(f), CELL, REPO)
    cfg = {k: OVER.get(k, v) for k, v in cell.config.items()}
    return dataclasses.replace(cell, config=cfg, workload=dict(
        cell.workload, chips=1), traffic=dict(
        cell.traffic, view_offsets=cell.traffic["view_offsets"][:2],
        **TRAFFIC))


def main() -> int:
    torch.set_num_threads(1)
    mode, seed = sys.argv[1], int(sys.argv[2])
    place = ranks.this_rank()
    cell = small_cell()
    outs = []
    if mode in ("run", "traced"):
        outs.append(harness.run(cell, seed, 0.0, mode == "traced", "cpu",
                                program, place=place))
    else:
        for i, fault in enumerate((None, *control_fit_mesh.FAULTS)):
            at = dataclasses.replace(
                place, init_method=f"{place.init_method}-{i}")
            if fault is None:
                sound = dataclasses.replace(cell, traffic=dict(
                    cell.traffic, warmup_steps=0))
                out = harness.run(sound, seed, 0.0, False, "cpu", program,
                                  place=at)
            else:
                out = control_fit_mesh.run(cell, seed, "cpu", fault, at)
            if out is not None:
                out["fault"] = fault
            outs.append(out)
    for out in outs:
        if out is not None:
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
