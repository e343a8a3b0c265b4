"""Golden images of the port against the scalar oracle.

The scenes of ``tests/test_golden.py`` (config 1 with and without glass
and a triangle, two parallel mirrors past refmax, a box's image texture,
rough mirrors on the counter RNG, bilinear textures and the cube-map sky)
rendered through the port's BRUTE and PALLAS paths on the CPU (PALLAS takes
the plain versions of kernels B3/B4), against ``oracle.render`` /
``scalar.render(seed=)`` on the reference's scene — the behavior contract,
allclose 1e-4, at the reference tests' sizes and tolerances: every pixel
within 1e-4, or, where a random-texel image meets float32 against float64
uv rounding at texel boundaries, 95% of the pixels (as there)."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from raytracer_js_tpu import (RenderConfig, ResponseType, SceneBuilder,
                              make_camera)
from raytracer_js_tpu.oracle import scalar as oracle
from raytracer_js_tpu.ops import sampling as jsamp
import raytracer_js_tpu_torch as prt

from scenes import config1_camera, config1_cfg, config1_scene
from test_torch_parity import to_port_camera, to_port_cfg, to_port_scene

BACKENDS = ("BRUTE", "PALLAS")


def _port(js, jc, cfg, backend, seed=None):
    pcfg = dataclasses.replace(to_port_cfg(cfg),
                               backend=prt.HitBackend[backend])
    return prt.render_hdr(to_port_scene(js), to_port_camera(jc), pcfg,
                          seed=seed).numpy()


def _two_mirrors():
    b = SceneBuilder()
    white = b.add_solid_texture((1.0, 1.0, 1.0))
    mirror = b.add_material(ResponseType.REFLECTION, mirror=True)
    light = b.add_material(ResponseType.REFLECTION, light=True)
    b.add_box((3.0, 0.0, 0.0), (0.5, 8.0, 8.0), mirror, white)
    b.add_box((-3.0, 0.0, 0.0), (0.5, 8.0, 8.0), mirror, white)
    b.add_sphere((0.0, 0.0, -5.5), 1.0, light, white)
    return b.build()


def _box_image():
    b = SceneBuilder(atlas_hw=(16, 16))
    b.set_sky(b.add_solid_texture((0.1, 0.1, 0.1)))
    m = b.add_material(ResponseType.REFLECTION)
    rng = np.random.default_rng(4)
    tex = b.add_image_texture(
        rng.uniform(0.0, 1.0, (16, 16, 3)).astype(np.float32))
    b.add_box((4.0, 0.0, 0.0), 2.0, m, tex)
    return b.build()


def _rough():
    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((.35, .45, .65)))
    diffuse = b.add_material(ResponseType.REFLECTION)
    rough = b.add_material(ResponseType.REFLECTION, mirror=True,
                           roughness=0.6)
    light = b.add_material(ResponseType.REFLECTION, light=True)
    b.add_box((0, 0, -51.0), 100.0, diffuse, b.add_solid_texture((.6,) * 3))
    b.add_sphere((4, 0, 0.5), 1.2, rough, b.add_solid_texture((.9, .2, .1)))
    b.add_sphere((5, .5, 4.0), 1.0, light, b.add_solid_texture((1.,) * 3))
    return b.build()


def _bilinear(bilinear=True):
    rng = np.random.default_rng(11)
    img16 = rng.uniform(0.0, 1.0, (16, 16, 3)).astype(np.float32)
    b = SceneBuilder(atlas_hw=(16, 16))
    b.set_sky(b.add_solid_texture((0.1, 0.1, 0.1)))
    m = b.add_material(ResponseType.REFLECTION)
    tex = b.add_image_texture(img16, bilinear=bilinear)
    b.add_sphere((4.0, 0.0, 0.0), 1.5, m, tex)
    return b.build()


def _sky_box(image_faces):
    rng = np.random.default_rng(12)
    b = SceneBuilder(atlas_hw=(8, 8))
    m = b.add_material(ResponseType.REFLECTION, mirror=True)
    if image_faces:
        faces = [b.add_image_texture(
            rng.uniform(0.0, 1.0, (8, 8, 3)).astype(np.float32))
            for _ in range(6)]
    else:
        faces = [b.add_solid_texture(c) for c in
                 ((1, 0, 0), (0, 1, 0), (0, 0, 1),
                  (1, 1, 0), (1, 0, 1), (0, 1, 1))]
    b.set_sky_box(faces)
    b.add_sphere((4.0, 0.0, 0.0), 1.0, m,
                 b.add_solid_texture((0.9, 0.9, 0.9)))
    return b.build()


def _cam(w, pos=(0.0, 0.0, 0.0)):
    return make_camera(pos, w, w, np.pi / 2, np.pi / 2)


#: name -> (scene, camera, config, share of pixels within 1e-4, seed key)
CASES = {
    "config1": (lambda: config1_scene(), lambda: config1_camera(32, 32),
                lambda: config1_cfg(), 1.0, None),
    "config1_glass": (lambda: config1_scene(with_glass=True),
                      lambda: config1_camera(32, 32), lambda: config1_cfg(),
                      1.0, None),
    "config1_tri": (lambda: config1_scene(with_tri=True),
                    lambda: config1_camera(32, 32), lambda: config1_cfg(),
                    1.0, None),
    "config1_glass_tri": (lambda: config1_scene(with_glass=True,
                                                with_tri=True),
                          lambda: config1_camera(32, 32),
                          lambda: config1_cfg(), 1.0, None),
    "refmax_exhaust_and_light": (_two_mirrors, lambda: _cam(16),
                                 lambda: config1_cfg(refmax=4), 1.0, None),
    "box_uv_image_texture": (_box_image, lambda: _cam(16),
                             lambda: config1_cfg(refmax=1), 0.95, None),
    "rough_counter_rng": (_rough, lambda: _cam(32, (0.0, 0.0, 0.5)),
                          lambda: RenderConfig(refmax=3), 1.0, 5),
    "bilinear_texture": (_bilinear, lambda: _cam(24),
                         lambda: config1_cfg(refmax=1), 0.95, None),
    "sky_box_solid": (lambda: _sky_box(False), lambda: _cam(24),
                      lambda: config1_cfg(refmax=2), 0.95, None),
    "sky_box_images": (lambda: _sky_box(True), lambda: _cam(24),
                       lambda: config1_cfg(refmax=2), 0.95, None),
}


@functools.lru_cache(maxsize=None)
def _golden(name):
    """(reference scene, camera, config, seed, the oracle's image)."""
    make_scene, make_cam, make_cfg, _, key = CASES[name]
    js, jc, cfg = make_scene(), make_cam(), make_cfg()
    seed = (None if key is None
            else int(jsamp.seed_from_key(jax.random.key(key))))
    ref = (oracle.render(js, jc, cfg) if seed is None
           else oracle.render(js, jc, cfg, seed=seed))
    return js, jc, cfg, seed, ref


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_port_matches_oracle(name, backend):
    js, jc, cfg, seed, ref = _golden(name)
    img = _port(js, jc, cfg, backend, seed)
    share = CASES[name][3]
    assert img.shape == ref.shape and np.isfinite(img).all()
    if share == 1.0:
        np.testing.assert_allclose(img, ref, rtol=0, atol=1e-4)
    else:
        ok = (np.abs(img - ref).max(axis=-1) <= 1e-4).mean()
        assert ok >= share, ok


def test_golden_scenes_exercise_their_paths():
    """The two-mirror scene goes black past refmax and carries attenuated
    light; bilinear filtering differs from nearest on the same texture."""
    js, jc, cfg, _, ref = _golden("refmax_exhaust_and_light")
    img = _port(js, jc, cfg, "PALLAS")
    assert (img == 0).all(axis=-1).any() and img.max() > 0
    js, jc, cfg, _, _ = _golden("bilinear_texture")
    near = _port(_bilinear(False), jc, cfg, "BRUTE")
    assert np.abs(_port(js, jc, cfg, "BRUTE") - near).max() > 0.01
