"""The PyTorch port imports and renders without jax or flax installed."""
import pathlib
import re
import subprocess
import sys

import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "raytracer_js_tpu_torch"

_DRIVE = """
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import numpy as np
import torch
torch.set_num_threads(1)
import raytracer_js_tpu_torch as rt
from raytracer_js_tpu_torch.kernels import trace_fused
from raytracer_js_tpu_torch.view import exposure, screen, view
b = rt.SceneBuilder()
b.set_sky(b.add_solid_texture((0.35, 0.45, 0.65)))
m = b.add_material(rt.ResponseType.REFLECTION, mirror=True)
b.add_sphere((4, 0, 0), 1.0, m, b.add_solid_texture((0.9, 0.2, 0.1)))
scene = b.build(device="cpu")
cam = rt.make_camera((0, 0, 0.5), 8, 8, np.pi / 2, np.pi / 2,
                     device="cpu")
hdr = rt.render_hdr(scene, cam, rt.RenderConfig(
    refmax=3, backend=rt.HitBackend.FUSED))
ldr = view.draw(exposure.accumulate(exposure.new_exposure_buffer(8, 8, device="cpu"), hdr),
                rt.ToneMapConfig())
assert tuple(hdr.shape) == (8, 8, 3) and bool(torch.isfinite(hdr).all())
from raytracer_js_tpu_torch import native
from raytracer_js_tpu_torch.accel.octree import build_octree
assert native.available(), native.build_error()
b = rt.SceneBuilder()
b.set_sky(b.add_solid_texture((0.35, 0.45, 0.65)))
m = b.add_material(rt.ResponseType.REFLECTION, mirror=True)
for k in range(6):
    b.add_sphere((4, k - 2.5, 0), 0.3, m, b.add_solid_texture((.9, .2, .1)))
scene_o = b.build(device="cpu")
accel = build_octree(scene_o, rt.OctreeConfig(max_depth=3))
img = rt.render_hdr(scene_o, cam, rt.RenderConfig(
    refmax=3, backend=rt.HitBackend.OCTREE), accel=accel)
assert bool(torch.isfinite(img).all()) and accel.cell_ids.numel() > 0
from raytracer_js_tpu_torch.kernels import nearest_hit
b = rt.SceneBuilder(atlas_hw=(8, 8))
b.set_sky_box([b.add_image_texture(np.full((8, 8, 3), k / 6, np.float32))
               for k in range(6)])
b.add_sphere((4, 0, 0), 1.0, b.add_material(rt.ResponseType.REFLECTION,
                                            mirror=True), b.add_image_texture(
    np.random.default_rng(0).uniform(0, 1, (8, 8, 3)), bilinear=True))
img = rt.render_hdr(b.build(device="cpu"), cam, rt.RenderConfig(
    refmax=2, backend=rt.HitBackend.PALLAS))
assert bool(torch.isfinite(img).all()) and float(img.max()) > 0
from raytracer_js_tpu_torch.kernels import replay_grad
from raytracer_js_tpu_torch.optim import FitConfig, fit
from raytracer_js_tpu_torch.utils import checkpoint
b = rt.SceneBuilder()
b.set_sky(b.add_solid_texture((0.35, 0.45, 0.65)))
b.add_sphere((4, 0, 0), 1.0, b.add_material(rt.ResponseType.REFLECTION,
                                            mirror=True),
             b.add_solid_texture((.9, .2, .1)))
res = fit(b.build(device="cpu"), rt.RenderConfig(refmax=2, backend=rt.HitBackend.PALLAS),
          [cam], torch.zeros((1, 64, 3)), FitConfig(steps=2, replay_every=1))
assert len(res.losses) == 2 and res.losses[1] < res.losses[0]
from raytracer_js_tpu_torch import demo, live, parallel
from raytracer_js_tpu_torch.ops import color, space
from raytracer_js_tpu_torch.parallel import distributed, dryrun
from raytracer_js_tpu_torch.utils import image, profiling, validate
assert distributed.init_distributed(device="cpu") is False
mesh = parallel.make_mesh(device="cpu")
assert distributed.topology_summary(mesh)["process_count"] == 1
assert validate.validate_scene(scene_o) == []
assert "jax" not in [k for k, v in sys.modules.items() if v is not None]
print("rendered", float(hdr.sum()), trace_fused.LAUNCHES, nearest_hit.LAUNCHES,
      replay_grad.LAUNCHES)
"""


def test_imports_and_renders_with_jax_and_flax_blocked():
    out = subprocess.run([sys.executable, "-c", _DRIVE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "rendered" in out.stdout
    # CPU tensors take the plain versions: no kernel was launched
    assert ("{'frame': 0, 'rays': 0} {'scalar': 0, 'dense': 0, "
            "'listed': 0, 'culled': 0} {'fwd': 0, 'bwd': 0}") in out.stdout


def test_no_module_imports_jax_or_flax():
    pattern = re.compile(r"^\s*(import jax|from jax|import flax|from flax)",
                         re.MULTILINE)
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 20
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    offenders += [str(f) for f in files if "flax" in f.read_text()]
    assert not offenders
    assert not pattern.search((ROOT / "chip_smoke.py").read_text())
    assert "raytracer_js_tpu." not in (ROOT / "chip_smoke.py").read_text()
