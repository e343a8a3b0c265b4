"""Scene builder and camera: the port against the reference."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from raytracer_js_tpu import make_camera as j_make_camera
from raytracer_js_tpu.models import camera as jcam
from raytracer_js_tpu.models.scene import prim_aabbs as j_aabbs
from raytracer_js_tpu.models.scene import prim_volumes as j_volumes
from raytracer_js_tpu_torch.models import camera as pcam
from raytracer_js_tpu_torch.models.scene import prim_aabbs, prim_volumes

from scenes import config1_scene
from test_torch_parity import (ROOT, jax_scene_arrays, load_by_path,
                               to_port_camera, to_port_scene)


def _port_arrays(scene) -> dict:
    out = {k: getattr(scene, k).numpy() for k in (
        "sphere_center", "sphere_radius", "box_center", "box_half", "tri_v0",
        "tri_v1", "tri_v2", "prim_material", "prim_texture",
        "prim_substance", "sub_refr", "default_refr")}
    for k in ("response", "light", "mirror", "roughness"):
        out[f"materials.{k}"] = getattr(scene.materials, k).numpy()
    for k in ("kind", "ref", "solid_rgb", "atlas", "img_h", "img_w"):
        out[f"textures.{k}"] = getattr(scene.textures, k).numpy()
    return out


def assert_same_scene(port, ref):
    pa, ja = _port_arrays(port), jax_scene_arrays(ref)
    assert pa.keys() == ja.keys()
    for k in pa:
        assert pa[k].shape == ja[k].shape, k
        assert pa[k].dtype == ja[k].dtype, k
        np.testing.assert_array_equal(pa[k], ja[k], err_msg=k)
    for k in ("sky_tex", "sky_box", "has_transmission", "has_rough",
              "has_both", "n_spheres", "n_boxes", "n_tris"):
        assert getattr(port, k) == getattr(ref, k), k
    for k in ("has_images", "has_bilinear"):
        assert getattr(port.textures, k) == getattr(ref.textures, k), k


@pytest.mark.parametrize("with_glass,with_tri",
                         [(False, False), (True, False), (False, True),
                          (True, True)])
def test_builder_config1(with_glass, with_tri):
    smoke = load_by_path("chip_smoke", ROOT / "chip_smoke.py")
    assert_same_scene(smoke.config1_scene(with_glass, with_tri, device="cpu"),
                      config1_scene(with_glass, with_tri))


def test_builder_flags_and_defaults():
    from raytracer_js_tpu import ResponseType, SceneBuilder as JB
    from raytracer_js_tpu_torch import SceneBuilder as PB

    for make in (lambda b: None,
                 lambda b: b.add_sphere((1, 0, 0), 0.5, b.add_material(
                     ResponseType.BOTH), b.add_solid_texture((1, 1, 1))),
                 lambda b: b.add_box((1, 0, 0), (1, 2, 3), b.add_material(
                     ResponseType.REFLECTION, mirror=True, roughness=0.3),
                     b.add_solid_texture((1, 0, 1)))):
        jb, pb = JB(), PB()
        make(jb)
        make(pb)
        assert_same_scene(pb.build(device="cpu"), jb.build())


def test_prim_aabbs_and_volumes():
    js = config1_scene(with_glass=True, with_tri=True)
    ps = to_port_scene(js)
    for a, b in zip(prim_aabbs(ps), j_aabbs(js)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(prim_volumes(ps).numpy(),
                               np.asarray(j_volumes(js)), rtol=1e-6)


def test_unported_textures_raise():
    """Image textures and cube-map skies are ported; what the builder does
    not take (an image that is not [H, W, 3], a sky box of other than six
    faces) raises."""
    from raytracer_js_tpu_torch import SceneBuilder

    b = SceneBuilder()
    with pytest.raises(ValueError, match=r"\[H, W, 3\]"):
        b.add_image_texture(np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError, match="6 faces"):
        b.set_sky_box([0] * 5)
    img = b.add_image_texture(np.zeros((4, 4, 3), np.float32))
    b.set_sky_box([img] * 6)
    scene = b.build(device="cpu")
    assert scene.sky_box == (img,) * 6 and scene.textures.has_images


_CAMS = [((0.0, 0.0, 0.5), 32, 32, np.pi / 2, np.pi / 2, 0.0, 0.0),
         ((0.2, -0.3, 0.5), 40, 24, np.pi / 2, np.pi / 3, 0.3, -0.2),
         ((1.0, 2.0, 3.0), 17, 9, 1.1, 0.7, -1.3, 0.4)]


@pytest.mark.parametrize("args", _CAMS)
def test_make_camera_and_pixel_rays(args):
    jc = j_make_camera(*args[:5], rot_h=args[5], rot_v=args[6])
    pc = pcam.make_camera(*args[:5], rot_h=args[5], rot_v=args[6],
                          device="cpu")
    for k in ("pos", "front", "left", "up"):
        np.testing.assert_allclose(getattr(pc, k).numpy(),
                                   np.asarray(getattr(jc, k)), atol=1e-6)
    # from one pose, the rays agree to f32 rounding of cos/sin
    jo, jd = jcam.pixel_rays(jc)
    po, pd = pcam.pixel_rays(to_port_camera(jc))
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), atol=1e-6)
    assert pd.shape == (args[1] * args[2], 3)


def test_rotate_and_move():
    jc = j_make_camera((0, 0, 0), 8, 8, 1.0, 1.0)
    pc = pcam.make_camera((0, 0, 0), 8, 8, 1.0, 1.0, device="cpu")
    jc = jcam.move(jcam.rotate_v(jcam.rotate_h(jc, 0.7), -0.4, lock=True),
                   (1.0, -2.0, 0.5))
    pc = pcam.move(pcam.rotate_v(pcam.rotate_h(pc, 0.7), -0.4, lock=True),
                   (1.0, -2.0, 0.5))
    for k in ("pos", "front", "left", "up"):
        np.testing.assert_allclose(getattr(pc, k).numpy(),
                                   np.asarray(getattr(jc, k)), atol=1e-6)
    # a locked pitch past vertical is rejected
    jl = jcam.rotate_v(jc, 2.5, lock=True)
    pl = pcam.rotate_v(pc, 2.5, lock=True)
    np.testing.assert_allclose(pl.up.numpy(), np.asarray(jl.up), atol=1e-6)
