"""The port's imports point one way: down a stack of layers.

Every module of ``raytracer_js_tpu_torch`` is read with ``ast``, the
imports inside its functions included, and each import of a port module
is held to :data:`LAYERS`: a module imports only from its own layer or the
layers below it, never from one above, and no two modules import each
other, directly or round a longer cycle. An import of a port module inside
a function (which can hide such a cycle, or an import from above) is
refused unless :data:`LOCAL_ALLOWED` names it with its reason."""
import ast
import functools
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "raytracer_js_tpu_torch"

#: the layers, lowest first. An entry names a module, or a package and
#: every module under it not named more closely; "" is the package itself
LAYERS = (
    # leaves: constants and enums, the native scene kit, the span helper,
    # file helpers, and the vector math the camera builds on
    ("config", "native", "utils", "ops.vecmath"),
    # the scene, its materials and textures, its differentiable leaves
    # and the grad check; the camera
    ("models", "utils.validate"),
    # ray math: intersection tests, the counter RNG, colors and spaces
    ("ops",),
    # the kernels' wrappers and plain versions, with the table layout of
    # the TILED candidate tables that B7 reads
    ("kernels", "accel.candidates", "utils.parity"),
    # the octree accel: its host build and the OCTREE search dispatch
    ("accel",),
    # the wavefront loop: BRUTE, PALLAS and OCTREE bounces, the substance
    # at the camera and the grad refusal
    ("ops.trace",),
    ("render_tiled",),
    ("render",),
    # ray sharding over ranks, and the fit on top of it
    ("parallel", "optim"),
    # the front ends
    ("view", "demo", "live", ""),
)

#: (module, imported module) -> why the import stays inside a function
LOCAL_ALLOWED = {}


def _module_name(path: pathlib.Path) -> str:
    parts = path.relative_to(PKG).with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


MODULES = sorted(_module_name(p) for p in PKG.rglob("*.py"))


def _layer(module: str) -> int:
    best, at = -1, None
    for i, names in enumerate(LAYERS):
        for name in names:
            if (name == module or name == ""
                    or module.startswith(name + ".")) and len(name) > best:
                best, at = len(name), i
    assert at is not None, f"{module!r} is in no layer of LAYERS"
    return at


@functools.cache
def _imports(module: str):
    """-> [(imported port module, line, inside a function)] of ``module``."""
    path = PKG / (module.replace(".", "/") if module else "")
    path = (path / "__init__.py" if path.is_dir()
            else path.with_suffix(".py"))
    tree = ast.parse(path.read_text())
    is_pkg = path.name == "__init__.py"
    local = {id(n) for f in ast.walk(tree)
             if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
             for n in ast.walk(f)}
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level:
            base = module.split(".") if module else []
            if not is_pkg:
                base = base[:-1]
            base = base[:len(base) - (node.level - 1)]
            if node.module:
                base = base + node.module.split(".")
            target = ".".join(base)
            for alias in node.names:
                sub = ".".join(base + [alias.name])
                out.append((sub if sub in MODULES else target, node.lineno,
                            id(node) in local))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else [node.module])
            for name in names:
                if name == "raytracer_js_tpu_torch" or name.startswith(
                        "raytracer_js_tpu_torch."):
                    out.append((name.partition(".")[2], node.lineno,
                                id(node) in local))
    return tuple(out)


@functools.cache
def _graph():
    return {m: {t for t, _, _ in _imports(m) if t != m} for m in MODULES}


def _on_cycle(module: str, graph) -> list:
    """A cycle of imports through ``module`` ([] if none): the path back."""
    stack, seen = [(module, [module])], set()
    while stack:
        node, path = stack.pop()
        for nxt in graph[node]:
            if nxt == module:
                return path + [module]
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return []


def test_modules_found():
    assert {"config", "render", "render_tiled", "ops.trace",
            "models.scene", "kernels.shade"} <= set(MODULES)


@pytest.mark.parametrize("module", MODULES, ids=lambda m: m or "package")
def test_imports_point_down(module):
    """No import of ``module`` reaches a higher layer, none hides in a
    function outside :data:`LOCAL_ALLOWED`, and ``module`` is on no import
    cycle."""
    mine = _layer(module)
    up = [f"{module}:{line} -> {target}" for target, line, _ in
          _imports(module) if _layer(target) > mine]
    assert not up, f"imports from a higher layer: {up}"
    hidden = [f"{module}:{line} -> {target}" for target, line, local in
              _imports(module)
              if local and (module, target) not in LOCAL_ALLOWED]
    assert not hidden, f"port imports inside functions: {hidden}"
    cycle = _on_cycle(module, _graph())
    assert not cycle, f"import cycle: {' -> '.join(cycle)}"
