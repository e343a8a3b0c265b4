"""pytest settings of the benchmark's own tests (``portbench/tests``).

``portbench_card`` marks a test that needs the card; the ``card`` fixture
decides at run time and skips without one. Run them on the card with

    python3 -m pytest portbench/tests -q -n 0 -m portbench_card
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "portbench_card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    return torch.device("cuda", 0)


@pytest.fixture
def manifest():
    with open(REPO / "BENCHMARK.json") as f:
        return json.load(f)


#: a cell's sizes cut for a CPU test: a few spheres, a small frame
SMALL = dict(width=40, height=24, n_spheres=12, n_prims=400,
             octree_max_depth=3)


@pytest.fixture
def small_cell(manifest):
    """``small_cell(name, **over)``: the manifest's cell with its sizes cut
    to ``SMALL`` (and ``over``) and a short trace."""
    from portbench import harness

    def make(name, **over):
        cell = harness.find_cell(manifest, name, REPO)
        cfg = dict(cell.config)
        for k, v in dict(SMALL, **over).items():
            if k in cfg:
                cfg[k] = v
        tr = dict(cell.traffic, warmup_frames=1, trace_frames=3)
        return dataclasses.replace(cell, config=cfg, traffic=tr)

    return make
