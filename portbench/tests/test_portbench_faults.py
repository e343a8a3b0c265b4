"""A run with the timed path broken underneath must come out not correct.

Each test drives the rest of a run (``harness.run`` on the CPU, the look
for a card skipped) with the program replaced by a broken one, once for
each fault a cell can have: a step that returns its state unchanged (the
first frame again, or the last frame one frame late); half of the batch
left out; an answer altered where it is produced. (No cell spans chips, so
none can lose an exchange between them.) The sound program passes the same
run. The window is one frame long, so the frame compared is the one after
the warm-up's, at another pose than the first: every cell's poses cycle.
"""
from __future__ import annotations

import types

import pytest

from portbench import harness, program

FRAME_CELLS = ["headline_52.fused_view", "c4_100k.octree_view",
               "c4_100k.tiled_sweep_view"]
#: sizes over the small cell's: at 400 prims most of a TILED frame is the
#: solid ground and sky, the same at every pose, and a frame at another
#: pose reads under the cell's looser limit
OVER = {"c4_100k.tiled_sweep_view": dict(n_prims=3000)}


def broken(**over):
    """The program with some entry points replaced."""
    mod = types.SimpleNamespace(**{k: getattr(program, k)
                                   for k in dir(program)
                                   if not k.startswith("_")})
    for k, v in over.items():
        setattr(mod, k, v)
    return mod


def stale_frames():
    """Every frame returns the first frame's image (its state unchanged)."""
    first = {}

    def render(scene, cam, cfg, seed, accel=None, tables=None):
        img = program.render(scene, cam, cfg, seed, accel, tables)
        return first.setdefault("img", img)

    return broken(render=render)


def late_frames():
    """Every frame returns the frame before it (a memo one frame late)."""
    last = {}

    def render(scene, cam, cfg, seed, accel=None, tables=None):
        img = program.render(scene, cam, cfg, seed, accel, tables)
        prev = last.get("img", img)
        last["img"] = img
        return prev

    return broken(render=render)


def half_frame():
    """The bottom half of the rows left out."""
    def render(scene, cam, cfg, seed, accel=None, tables=None):
        img = program.render(scene, cam, cfg, seed, accel, tables).clone()
        img[img.shape[0] // 2:] = 0.0
        return img

    return broken(render=render)


def altered_frame():
    """Each color 1% too bright where the frame is produced."""
    def render(scene, cam, cfg, seed, accel=None, tables=None):
        return program.render(scene, cam, cfg, seed, accel, tables) * 1.01

    return broken(render=render)


def run(cell, prog, seed=17):
    return harness.run(cell, seed, 0.0, False, "cpu", prog)


def frame_cases():
    """Every frame cell with every fault it can show."""
    for name in FRAME_CELLS:
        for fault in (None, stale_frames, late_frames, half_frame,
                      altered_frame):
            tag = fault.__name__ if fault else "sound"
            yield pytest.param(name, fault, id=f"{name}-{tag}")


@pytest.mark.parametrize("name,fault", list(frame_cases()))
def test_frame_faults(small_cell, name, fault):
    cell = small_cell(name, **OVER.get(name, {}))
    out = run(cell, program if fault is None else fault())
    assert out["correct"] is (fault is None), out["checks"]
