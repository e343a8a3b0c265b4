"""The BRUTE wavefront ``ops/trace.trace_rays``: the port against the
reference's, on the scene classes the fused kernels must also carry."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from raytracer_js_tpu import RenderConfig, ResponseType, SceneBuilder
from raytracer_js_tpu import make_camera
from raytracer_js_tpu.models.camera import pixel_rays
from raytracer_js_tpu.ops import sampling as jsamp
from raytracer_js_tpu.ops.trace import substance_refr_at as j_substance
from raytracer_js_tpu.ops.trace import trace_rays as j_trace
from raytracer_js_tpu_torch.ops import trace as ptrace

from scenes import config1_cfg, config1_scene
from test_torch_parity import (assert_parity, to_port_cfg, to_port_scene,
                               to_torch)


def mirror_exhaust_scene():
    """Parallel mirrors: exhaustion + emissive inverse-square paths."""
    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0.2, 0.3, 0.4)))
    white = b.add_solid_texture((1.0, 1.0, 1.0))
    mirror = b.add_material(ResponseType.REFLECTION, mirror=True)
    light = b.add_material(ResponseType.REFLECTION, light=True)
    b.add_box((3.0, 0.0, 0.0), (0.5, 8.0, 8.0), mirror, white)
    b.add_box((-3.0, 0.0, 0.0), (0.5, 8.0, 8.0), mirror, white)
    b.add_sphere((0.0, 0.0, -5.5), 1.0, light, white)
    return b.build()


def ext_scene(trans=False, rough=0.0):
    """Ground box, (rough) mirror, glass spheres with defined, undefined and
    nested substances, emitter."""
    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0.35, 0.45, 0.65)))
    diffuse = b.add_material(ResponseType.REFLECTION)
    mirror = b.add_material(ResponseType.REFLECTION, mirror=True,
                            roughness=rough)
    light = b.add_material(ResponseType.REFLECTION, light=True)
    b.add_box((0, 0, -51.0), 100.0, diffuse, b.add_solid_texture((.6,) * 3))
    b.add_sphere((4, 0, 0.5), 1.0, mirror, b.add_solid_texture((.9, .2, .1)))
    if trans:
        glass = b.add_material(ResponseType.TRANSMISSION)
        b.add_sphere((3, -1.5, 0.5), 0.8, glass,
                     b.add_solid_texture((.95, .95, 1.0)),
                     substance=b.add_substance(1.5))
        b.add_sphere((3, 1.5, 0.5), 0.7, glass,
                     b.add_solid_texture((1.0, 1.0, 1.0)))
        b.add_sphere((3, -1.5, 0.5), 0.35, glass,
                     b.add_solid_texture((0.9, 1.0, 1.0)),
                     substance=b.add_substance(1.333))
    b.add_sphere((5, .5, 4.0), 1.0, light, b.add_solid_texture((1.,) * 3))
    return b.build()


def both_scene():
    """A BOTH glass ball before a red wall and an emitter."""
    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0.35, 0.45, 0.65)))
    grey = b.add_solid_texture((0.6, 0.6, 0.6))
    white = b.add_solid_texture((1.0, 1.0, 1.0))
    red = b.add_solid_texture((0.9, 0.2, 0.1))
    diffuse = b.add_material(ResponseType.REFLECTION)
    light = b.add_material(ResponseType.REFLECTION, light=True)
    both = b.add_material(ResponseType.BOTH)
    glass = b.add_substance(1.5)
    b.add_box((0.0, 0.0, -51.0), 100.0, diffuse, grey)
    b.add_sphere((2.4, 0.0, 0.5), 0.9, both, white, glass)
    b.add_sphere((6.0, 0.0, 0.5), 1.2, diffuse, red)
    b.add_sphere((4.0, 0.0, 4.5), 1.1, light, white)
    return b.build()


def pure_sky_scene():
    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0.3, 0.6, 0.9)))
    return b.build()


def compare_trace(js, cfg, cam, key=None):
    """Both packages' trace_rays over the camera's rays -> port state."""
    key = jax.random.key(0) if key is None else key
    org, d = pixel_rays(cam)
    rid = jnp.arange(org.shape[0], dtype=jnp.int32)
    ref = j_trace(js, cfg, org, d, key, rid)
    out = ptrace.trace_rays(
        to_port_scene(js), to_port_cfg(cfg), to_torch(org), to_torch(d),
        seed=int(jsamp.seed_from_key(key)), ray_id=to_torch(rid))
    assert_parity(out.color, out.status, ref.color, ref.status)
    return out, ref


_CAM = ((0.0, 0.0, 0.5), 24, 24, np.pi / 2, np.pi / 2)


@pytest.mark.parametrize("with_glass,with_tri",
                         [(False, False), (True, False), (False, True),
                          (True, True)])
def test_trace_config1(with_glass, with_tri):
    out, _ = compare_trace(config1_scene(with_glass, with_tri),
                           config1_cfg(), make_camera(*_CAM))
    assert set(out.status.unique().tolist()) >= {1, 2, 3}


def test_trace_mirror_exhaust():
    out, _ = compare_trace(mirror_exhaust_scene(), RenderConfig(refmax=4),
                           make_camera((0.0, 0.0, 0.0), 16, 16, np.pi / 2,
                                       np.pi / 2))
    assert (out.status == 4).any() and (out.status == 1).any()


@pytest.mark.parametrize("trans", [False, True])
def test_trace_rough(trans):
    """Same counter-RNG streams: roughness 0.4, a seeded key."""
    compare_trace(ext_scene(trans=trans, rough=0.4), RenderConfig(refmax=3),
                  make_camera(*_CAM), key=jax.random.key(11))


def test_trace_pure_sky():
    out, _ = compare_trace(pure_sky_scene(), RenderConfig(refmax=2),
                           make_camera((0, 0, 0), 8, 8, np.pi / 2, np.pi / 2))
    assert (out.status == 3).all()


@pytest.mark.parametrize("fresnel", [False, True])
def test_trace_both(fresnel):
    compare_trace(both_scene(), RenderConfig(refmax=4, fresnel_both=fresnel),
                  make_camera(*_CAM), key=jax.random.key(7))


def test_substance_refr_at():
    js = ext_scene(trans=True)
    rng = np.random.default_rng(0)
    pts = rng.uniform([1.5, -3, -1], [4.5, 3, 2], (500, 3)).astype(np.float32)
    cur = rng.uniform(1.0, 2.0, 500).astype(np.float32)
    jt, jd = j_substance(js, jnp.asarray(pts), jnp.asarray(cur))
    pt, pd = ptrace.substance_refr_at(to_port_scene(js), torch.as_tensor(pts),
                                      torch.as_tensor(cur))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    assert 0 < pd.float().mean() < 1


def test_nearest_hit_brute_ties_take_the_lowest_pid():
    from raytracer_js_tpu_torch import ResponseType as RT
    from raytracer_js_tpu_torch import SceneBuilder as PB

    b = PB()
    m = b.add_material(RT.REFLECTION)
    t = b.add_solid_texture((1, 1, 1))
    b.add_sphere((5, 0, 0), 1.0, m, t)
    b.add_sphere((4.5, 0, 0), 0.5, m, t)      # tangent on the ray at t = 4
    b.add_box((4.5, 0, 0), 1.0, m, t)         # face at x = 4 too
    s = b.build(device="cpu")
    tt, pid = ptrace.nearest_hit_brute(s, torch.zeros((1, 3)),
                                       torch.tensor([[1.0, 0, 0]]))
    assert float(tt[0]) == 4.0 and int(pid[0]) == 0
