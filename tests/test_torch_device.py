"""The port's entry points build on the card unless the caller asks for
another device: on a machine without CUDA they raise, naming
``device="cpu"``, and with ``device="cpu"`` they work."""
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import raytracer_js_tpu_torch as prt
from raytracer_js_tpu_torch.config import resolve_device
from raytracer_js_tpu_torch.models.camera import camera_from_numpy
from raytracer_js_tpu_torch.models.materials import make_material_table
from raytracer_js_tpu_torch.models.scene import scene_from_numpy
from raytracer_js_tpu_torch.utils import checkpoint
from raytracer_js_tpu_torch.view import exposure


def _builder():
    b = prt.SceneBuilder()
    b.set_sky(b.add_solid_texture((0.35, 0.45, 0.65)))
    b.add_sphere((4, 0, 0), 1.0, b.add_material(prt.ResponseType.REFLECTION),
                 b.add_solid_texture((0.9, 0.2, 0.1)))
    return b


def _scene_arrays():
    """The arrays ``scene_from_numpy`` takes, from a CPU-built scene."""
    s = _builder().build(device="cpu")
    arrays = {k: getattr(s, k).numpy() for k in (
        "sphere_center", "sphere_radius", "box_center", "box_half", "tri_v0",
        "tri_v1", "tri_v2", "prim_material", "prim_texture",
        "prim_substance", "sub_refr", "default_refr")}
    for k in ("response", "light", "mirror", "roughness"):
        arrays[f"materials.{k}"] = getattr(s.materials, k).numpy()
    for k in ("kind", "ref", "solid_rgb", "atlas", "img_h", "img_w"):
        arrays[f"textures.{k}"] = getattr(s.textures, k).numpy()
    return arrays


_FLAGS = dict(sky_tex=0, has_transmission=False, has_rough=False,
              has_both=False, has_images=False, has_bilinear=False)
_CAM = {"pos": np.zeros(3), "front": np.array([1.0, 0, 0]),
        "left": np.array([0.0, 1, 0]), "up": np.array([0.0, 0, 1])}


def _restore(device, tmp_path):
    path = checkpoint.save(tmp_path / "ck", {"a": torch.ones(3)}, step=2)
    return checkpoint.restore(path, device=device)[0]["a"]


#: every entry point that takes ``device``: name -> call(device, tmp_path)
_ENTRIES = {
    "SceneBuilder.build": lambda dev, tmp: _builder().build(device=dev),
    "scene_from_numpy": lambda dev, tmp: scene_from_numpy(
        _scene_arrays(), **_FLAGS, device=dev),
    "make_camera": lambda dev, tmp: prt.make_camera(
        (0, 0, 0.5), 8, 8, 1.0, 1.0, rot_h=0.2, device=dev),
    "camera_from_numpy": lambda dev, tmp: camera_from_numpy(
        _CAM, fov_h=1.0, fov_v=1.0, w=8, h=8, device=dev),
    "make_material_table": lambda dev, tmp: make_material_table(
        [(prt.ResponseType.REFLECTION, False, True, 0.0)], device=dev),
    "new_exposure_buffer": lambda dev, tmp: exposure.new_exposure_buffer(
        4, 4, device=dev),
    "checkpoint.restore": _restore,
}


def _device_of(obj):
    for name in ("device", "pos", "response", "pixels"):
        v = getattr(obj, name, None)
        if isinstance(v, torch.device):
            return v
        if isinstance(v, torch.Tensor):
            return v.device
    return obj.device


@pytest.mark.parametrize("name", sorted(_ENTRIES))
def test_entry_point_defaults_to_the_card(name, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = _ENTRIES[name]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call(None, tmp_path)
    assert _device_of(call("cpu", tmp_path)).type == "cpu"
    assert _device_of(call(torch.device("cpu"), tmp_path)).type == "cpu"


def test_resolve_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device(torch.device("cpu")).type == "cpu"


def test_cpu_scene_renders_on_the_plain_versions():
    """A scene and camera built with ``device="cpu"`` render end to end on
    the plain versions (no kernel launch), the image on the CPU."""
    from raytracer_js_tpu_torch.kernels import trace_fused

    scene = _builder().build(device="cpu")
    cam = prt.make_camera((0, 0, 0.5), 8, 8, np.pi / 2, np.pi / 2,
                          device="cpu")
    before = dict(trace_fused.LAUNCHES)
    img = prt.render_hdr(scene, cam, prt.RenderConfig(
        refmax=2, backend=prt.HitBackend.FUSED))
    assert img.device.type == "cpu" and bool(torch.isfinite(img).all())
    assert trace_fused.LAUNCHES == before
    assert json.dumps(list(img.shape)) == "[8, 8, 3]"
