"""The roofline floors are counted from the cell's inputs alone: the same
scene and rays give the same bound whatever backend ran, and never more
than the work itself."""
from __future__ import annotations

import numpy as np
import pytest

from portbench import harness, roofline

SUMMARY = dict(spans=4, host_s=0.04, busy_s=0.03, ops=2060, window_s=0.05,
               window_busy_s=0.03,
               kernel_s={"octree_dda_kernel(Prims)": 0.004,
                         "trace_frame_kernel(Params, Cam)": 0.0004},
               kernel_n={})


class Ctx:
    def __init__(self, cell):
        self.config, self.traffic = cell.config, cell.traffic
        self.spec = cell.recipe().spec(cell.config, np.random.default_rng(
            cell.config["layout_seed"]))


@pytest.mark.parametrize("metric,cell", [
    ("octree_dda.roofline_share", "c4_100k.octree_view"),
    ("trace_fused.roofline_share", "headline_52.fused_view")])
def test_bound_depends_on_inputs_only(manifest, metric, cell):
    from portbench.conftest import REPO

    c = harness.find_cell(manifest, cell, REPO)
    reader = c.reader(metric)
    run = dict(items=8, trace=SUMMARY)
    shares = set()
    for backend in ("brute", "pallas", "fused", "octree", "tiled"):
        ctx = Ctx(c)
        ctx.traffic = dict(c.traffic, backend=backend)
        shares.add(reader.read(ctx, run))
    assert len(shares) == 1
    share = shares.pop()
    assert 0.0 < share < 100.0
    # a trace without the kernel reads nothing
    assert reader.read(Ctx(c), dict(items=8, trace=dict(
        SUMMARY, kernel_s={"other": 1.0}))) is None


def test_floors():
    # the headline frame: 1920 x 1088 HDR pixels dominate (bytes)
    b = roofline.frame_floor_s(51, 1, 11, 1920, 1088)
    assert b == pytest.approx(1920 * 1088 * 12 / roofline.PEAK_BYTES,
                              rel=1e-3)
    # a search of n rays reads each once and answers it once
    n = 1 << 20
    assert roofline.search_floor_s(99999, 1, n) == pytest.approx(
        (n * 32 + 16 * 99999 + 24) / roofline.PEAK_BYTES)
    # more rays never lower a bound
    assert roofline.search_floor_s(99999, 1, 2 * n) > \
        roofline.search_floor_s(99999, 1, n)
    assert roofline.min_test_ops(0, 1) == roofline.OPS["box"]
