"""Completeness: every public top-level name of the reference package
exists in the port, module by module, except the TPU-only names listed
below.

The reference's names are read from its sources (top-level functions,
classes and assignments, and each package's ``__all__``), so this test
imports neither package's JAX side; the port's modules are imported."""
import ast
import importlib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF = ROOT / "raytracer_js_tpu"

#: reference modules with no counterpart in the port
TPU_ONLY_MODULES = {
    "kernels/mathx.py",    # atan2_poly: Mosaic has no atan2; CUDA has atan2f
    "ops/gather.py",       # one-hot MXU gathers; the port indexes directly
    "oracle/__init__.py",  # the float64 oracle owns the behavior contract;
    "oracle/scalar.py",    # the tests hold the port against it through
    "oracle/camera_scan.py",  # the reference package
}

#: names of ported modules that only the TPU needs, by module
TPU_ONLY_NAMES = {
    # jax type alias (the port says Tensor)
    "*": {"Array"},
    # the RT_* tunable registry tunes TPU kernels
    "config.py": {"tunables"},
    # seeds come as explicit uint32 integers, not jax keys
    "ops/sampling.py": {"seed_from_key"},
    # the one-hot axis pick feeds the MXU gathers
    "ops/intersect.py": {"jax_onehot3"},
    # the *_jnp device builds of the candidate tables
    "accel/candidates.py": {"bounding_spheres_jnp", "prim_attr_table_jnp",
                            "pack_candidate_attrs_jnp"},
    # TPU lane layouts and tile sizes: lane-replicated tables, sublane
    # tiles, block spans of the Pallas grids
    "kernels/nearest_hit.py": {"SUB_R", "DENSE_SPAN", "SP_SUB", "SP_LANE",
                               "pack_replicated"},
    "kernels/replay_grad.py": {"RG_SUB", "LISTED_MAX_LEN",
                               "build_tile_lists"},
    # the ray-block shortlist and its thresholds: each CUDA warp culls the
    # spheres by its own cone instead
    "kernels/trace_fused.py": {"FUSE_SUB", "ExtRows",
                               "FRAME_SHORT_MIN", "SHORTLIST_MIN_SPHERES"},
    # the one-hot MXU atlas gather's group sizes
    "models/textures.py": {"ATLAS_MXU_GROUP", "ATLAS_MXU_MAX_GROUPS"},
    # the packet size of the Pallas wave kernel's (WAVE_SUB x LANE) tile
    "render_tiled.py": {"PACKET"},
}


def _public_names(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
    if path.name == "__init__.py":
        for node in tree.body:
            if (isinstance(node, ast.Assign)
                    and any(isinstance(t, ast.Name) and t.id == "__all__"
                            for t in node.targets)):
                names |= set(ast.literal_eval(node.value))
    return {n for n in names if not n.startswith("_")}


MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py")
                 if str(p.relative_to(REF)) not in TPU_ONLY_MODULES)


def test_modules_listed():
    assert len(MODULES) >= 35
    assert {"parallel/distributed.py", "demo.py", "live.py", "ops/color.py",
            "utils/profiling.py"} <= set(MODULES)


@pytest.mark.parametrize("rel", MODULES)
def test_port_has_every_public_name(rel):
    mod = "raytracer_js_tpu_torch." + rel[:-3].replace("/", ".")
    mod = mod.removesuffix(".__init__")
    port = importlib.import_module(mod)
    skip = TPU_ONLY_NAMES["*"] | TPU_ONLY_NAMES.get(rel, set())
    missing = sorted(n for n in _public_names(REF / rel) - skip
                     if not hasattr(port, n))
    assert not missing, f"{mod} lacks {missing}"


def test_tpu_only_names_are_really_missing():
    """The exclusions stay honest: a name the port gains leaves the list."""
    for rel, names in TPU_ONLY_NAMES.items():
        if rel == "*":
            continue
        mod = "raytracer_js_tpu_torch." + rel[:-3].replace("/", ".")
        port = importlib.import_module(mod)
        assert names <= _public_names(REF / rel), rel
        assert not [n for n in names if hasattr(port, n)], rel
