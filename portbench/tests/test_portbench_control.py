"""The control (the reference in bfloat16 in the program's place) comes out
not correct in every cell: at a small size on the CPU, and at the cell's
own size on the card on three seeds."""
from __future__ import annotations

import pytest

from portbench import control, harness

CELLS = ["headline_52.fused_view", "c4_100k.octree_view",
         "c4_100k.tiled_sweep_view"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_small(small_cell, name):
    cell = small_cell(name, width=96, height=64, n_spheres=24, n_prims=2000)
    out = control.run(cell, 23, "cpu")
    assert out["correct"] is False, out["checks"]


@pytest.mark.portbench_card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_card(card, manifest, name):
    cell = harness.find_cell(manifest, name, harness.ROOT.parent)
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        out = control.run(cell, seed, card)
        assert out["correct"] is False, (seed, out["checks"])
