"""Shared helpers of the PyTorch-port parity tests, and tests of them.

The helpers feed one scene to both packages (``to_port_scene``,
``to_port_camera``), record the reference package's winner ids per bounce
(``jax_pid_seq``), and assert the port's parity rule (``assert_parity``):
allclose(rtol=1e-5, atol=1e-6) with equal status for every pixel except
proven winner flips, at most 0.1% of the pixels.
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from raytracer_js_tpu import RenderConfig, make_camera
from raytracer_js_tpu.ops.trace import record_paths
from raytracer_js_tpu_torch.models.camera import camera_from_numpy
from raytracer_js_tpu_torch.models.scene import scene_from_numpy
from raytracer_js_tpu_torch.utils import parity

from scenes import config1_scene

ROOT = pathlib.Path(__file__).resolve().parent.parent

_SCENE_FIELDS = ("sphere_center", "sphere_radius", "box_center", "box_half",
                 "tri_v0", "tri_v1", "tri_v2", "prim_material",
                 "prim_texture", "prim_substance", "sub_refr", "default_refr")


def jax_scene_arrays(scene) -> dict:
    """The reference ``Scene``'s arrays under ``scene_from_numpy``'s names."""
    arrays = {k: np.asarray(getattr(scene, k)) for k in _SCENE_FIELDS}
    for k in ("response", "light", "mirror", "roughness"):
        arrays[f"materials.{k}"] = np.asarray(getattr(scene.materials, k))
    for k in ("kind", "ref", "solid_rgb", "atlas", "img_h", "img_w"):
        arrays[f"textures.{k}"] = np.asarray(getattr(scene.textures, k))
    return arrays


def to_torch(x):
    """A reference array (or numpy array) as a writable torch tensor."""
    return torch.as_tensor(np.array(x))


def build_cpu(builder):
    """``builder.build()``, on the CPU for the port's builder (whose default
    device is the card)."""
    import raytracer_js_tpu_torch as prt

    if isinstance(builder, prt.SceneBuilder):
        return builder.build(device="cpu")
    return builder.build()


def to_port_scene(scene):
    return scene_from_numpy(jax_scene_arrays(scene), sky_tex=scene.sky_tex,
                            sky_box=scene.sky_box,
                            has_transmission=scene.has_transmission,
                            has_rough=scene.has_rough,
                            has_both=scene.has_both,
                            has_images=scene.textures.has_images,
                            has_bilinear=scene.textures.has_bilinear,
                            device="cpu")


def to_port_camera(cam):
    return camera_from_numpy(
        {k: np.asarray(getattr(cam, k)) for k in ("pos", "front", "left",
                                                  "up")},
        fov_h=cam.fov_h, fov_v=cam.fov_v, w=cam.w, h=cam.h, device="cpu")


def to_port_cfg(cfg):
    """The reference ``RenderConfig`` as the port's."""
    from raytracer_js_tpu_torch import HitBackend, RenderConfig as PortCfg

    return PortCfg(refmax=cfg.refmax,
                   distance_attenuation_factor=cfg.distance_attenuation_factor,
                   spp=cfg.spp, backend=HitBackend[cfg.backend.name],
                   fresnel_both=cfg.fresnel_both)


def jax_pid_seq(scene, cfg, org, dir, key=None, ray_id=None):
    """The reference's winner id per bounce [refmax, N] (BRUTE search)."""
    org = jnp.asarray(np.asarray(org))
    dir = jnp.asarray(np.asarray(dir))
    if ray_id is None:
        ray_id = jnp.arange(org.shape[0], dtype=jnp.int32)
    key = jax.random.key(0) if key is None else key
    return torch.as_tensor(np.asarray(
        record_paths(scene, cfg, org, dir, key, jnp.asarray(ray_id))).T.copy())


def assert_parity(color, status, ref_color, ref_status, prove=None,
                  prove_rounding=None):
    """The port's parity rule; returns the report."""
    rep = parity.compare(to_torch(color), to_torch(status),
                         to_torch(ref_color), to_torch(ref_status),
                         prove=prove, prove_rounding=prove_rounding)
    assert rep["ok"], rep
    return rep


def load_by_path(name: str, path: pathlib.Path):
    """Import a root script (``bench.py``, ``chip_smoke.py``) as a module
    without running its ``main``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# tests of the helpers
# ---------------------------------------------------------------------------

def test_converted_scene_keeps_every_array():
    js = config1_scene(with_glass=True, with_tri=True)
    ps = to_port_scene(js)
    for k in _SCENE_FIELDS:
        np.testing.assert_array_equal(getattr(ps, k).numpy(),
                                      np.asarray(getattr(js, k)))
    assert ps.n_prims == js.n_prims and ps.sky_tex == js.sky_tex
    assert (ps.has_transmission, ps.has_rough, ps.has_both) == (
        js.has_transmission, js.has_rough, js.has_both)


def test_converted_camera_keeps_the_pose():
    jc = make_camera((0.2, -0.3, 0.5), 40, 24, np.pi / 2, np.pi / 3,
                     rot_h=0.3, rot_v=-0.2)
    pc = to_port_camera(jc)
    for k in ("pos", "front", "left", "up"):
        np.testing.assert_array_equal(getattr(pc, k).numpy(),
                                      np.asarray(getattr(jc, k)))
    assert (pc.w, pc.h, pc.fov_h, pc.fov_v) == (40, 24, jc.fov_h, jc.fov_v)


@pytest.mark.parametrize("other,expect", [(1, True), (2, False), (-1, False)])
def test_flip_prover(other, expect):
    """Spheres 0 and 1 are tangent where the ray meets them (both at t = 4
    exactly): a proven flip. Sphere 2 is hit at t = 8, and -1 is a miss."""
    import dataclasses

    empty = torch.zeros((0, 3))
    scene = dataclasses.replace(
        to_port_scene(config1_scene()),
        sphere_center=torch.tensor([[5.0, 0.0, 0.0], [4.5, 0.0, 0.0],
                                    [9.0, 0.0, 0.0]]),
        sphere_radius=torch.tensor([1.0, 0.5, 1.0]), box_center=empty,
        box_half=empty, tri_v0=empty, tri_v1=empty, tri_v2=empty)
    rec = {"pid": torch.tensor([[0]]), "org": torch.zeros((1, 1, 3)),
           "dir": torch.tensor([[[1.0, 0.0, 0.0]]])}
    prove = parity.flip_prover(scene, rec, torch.tensor([[other]]))
    assert bool(prove(torch.tensor([0]))[0]) is expect


def test_compare_counts_flips_and_rejects_unproven():
    a = torch.zeros((10, 3))
    b = a.clone()
    b[3] = 1.0
    st = torch.zeros(10, dtype=torch.int32)
    assert not parity.compare(a, st, b, st)["ok"]
    rep = parity.compare(a, st, b, st, prove=lambda idx: idx == 3)
    # one flip in ten pixels is above the 0.1% flip budget
    assert rep["flips"] == 1 and rep["unproven"] == 0 and not rep["ok"]
    big_a, big_b = torch.zeros((2000, 3)), torch.zeros((2000, 3))
    big_b[7] = 1.0
    st2 = torch.zeros(2000, dtype=torch.int32)
    rep = parity.compare(big_a, st2, big_b, st2,
                         prove=lambda idx: torch.ones_like(idx, dtype=bool))
    assert rep["ok"] and rep["flips"] == 1 and rep["max_abs_err"] == 0.0
    st3 = st2.clone()
    st3[5] = 3
    assert not parity.compare(big_a, st2, big_a, st3)["ok"]


def test_to_port_cfg():
    from raytracer_js_tpu.config import HitBackend

    c = to_port_cfg(RenderConfig(refmax=2, spp=3, backend=HitBackend.FUSED,
                                 fresnel_both=True,
                                 distance_attenuation_factor=0.5))
    assert (c.refmax, c.spp, c.backend.name, c.fresnel_both,
            c.distance_attenuation_factor) == (2, 3, "FUSED", True, 0.5)


def test_jax_pid_seq_shape():
    js = config1_scene()
    cfg = RenderConfig(refmax=3)
    rng = np.random.default_rng(0)
    org = np.zeros((5, 3), np.float32)
    d = rng.normal(size=(5, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pid = jax_pid_seq(js, cfg, org, d)
    assert pid.shape == (3, 5)
