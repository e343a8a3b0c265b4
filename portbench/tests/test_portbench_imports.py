"""What a run loads: never JAX or the JAX package; the reference nothing of
the program. Top-level module names are compared whole (the port's name
begins with the JAX package's)."""
from __future__ import annotations

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

from portbench import harness

REPO = pathlib.Path(__file__).resolve().parents[2]
SETUP = r"""
import dataclasses, json, pathlib, sys
sys.path.insert(0, {repo!r})
from portbench import harness, program
manifest = json.load(open({manifest!r}))
cell = harness.find_cell(manifest, {name!r}, pathlib.Path({repo!r}))
cfg = dict(cell.config, width=32, height=16, n_spheres=6, n_prims=300,
           octree_max_depth=3)
cell = dataclasses.replace(cell, config=cfg)
ctx = harness.Ctx(cell, 2**31 + 5, "cpu", program)
cell.loop().setup(ctx)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_modules(code: str) -> set:
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("name", ["headline_52.fused_view",
                                  "c4_100k.octree_view",
                                  "c4_100k.tiled_sweep_view"])
def test_setup_loads_no_jax(name):
    mods = top_level_modules(SETUP.format(
        repo=str(REPO), manifest=str(REPO / "BENCHMARK.json"), name=name))
    assert "raytracer_js_tpu_torch" in mods
    assert not mods & set(harness.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    code = (f"import json, sys; sys.path.insert(0, {str(REPO)!r})\n"
            "import portbench.reference.render\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    mods = top_level_modules(code)
    assert not mods & {"raytracer_js_tpu_torch", *harness.FORBIDDEN}


def imported_names(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_reference_sources_import_no_program():
    files = sorted((harness.ROOT / "reference").glob("*.py"))
    assert files
    for f in files:
        assert imported_names(f) <= {"__future__", "dataclasses", "math",
                                     "typing", "numpy", "torch"}, f


def test_no_piece_imports_jax():
    for f in sorted(harness.ROOT.rglob("*.py")):
        assert not imported_names(f) & set(harness.FORBIDDEN), f
