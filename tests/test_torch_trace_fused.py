"""The fused kernels' plain versions against the reference's fused Pallas
kernels (interpret mode) and the BRUTE wavefront; the CPU dispatch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from raytracer_js_tpu import RenderConfig, make_camera
from raytracer_js_tpu.kernels import trace_fused as jtf
from raytracer_js_tpu.models.camera import pixel_rays
from raytracer_js_tpu.ops import sampling as jsamp
from raytracer_js_tpu.ops.trace import trace_rays as j_trace
from raytracer_js_tpu_torch.kernels import trace_fused as tf
from raytracer_js_tpu_torch.ops import trace as ptrace
from raytracer_js_tpu_torch.utils import parity

from scenes import config1_cfg, config1_scene
from test_torch_parity import (assert_parity, jax_pid_seq, to_port_camera,
                               to_port_cfg, to_port_scene, to_torch)
from test_torch_trace import ext_scene, mirror_exhaust_scene


def _frame_case(js, jc, cfg, key=None, sample=0):
    """Port frame plain version vs the reference frame kernel (colors) and
    the reference BRUTE wavefront (statuses), with the flip proof."""
    key = jax.random.key(0) if key is None else key
    seed = int(jsamp.seed_from_key(key))
    ps, pc = to_port_scene(js), to_port_camera(jc)
    img, status, rec = tf.trace_frame_fused_plain(
        ps, to_port_cfg(cfg), pc, seed=seed, sample=sample, record=True)
    ref_img = jtf.trace_frame_fused(js, cfg, jc, key=key, sample=sample)
    org, d = pixel_rays(jc)
    rid = jnp.arange(org.shape[0], dtype=jnp.int32) * cfg.spp + sample
    ref = j_trace(js, cfg, org, d, key, rid)
    prove = parity.flip_prover(ps, rec, jax_pid_seq(js, cfg, org, d, key, rid))
    assert img.shape == (jc.h, jc.w, 3) and status.shape == (jc.h, jc.w)
    assert_parity(img, status, ref_img, ref.status.reshape(jc.h, jc.w),
                  prove=prove)
    return img, status


def test_frame_config1_glass_tri():
    js = config1_scene(with_glass=True, with_tri=True)
    jc = make_camera((0.0, 0.0, 0.5), 16, 16, np.pi / 2, np.pi / 2)
    _, status = _frame_case(js, jc, config1_cfg())
    assert set(status.unique().tolist()) >= {1, 2, 3}


def test_frame_nonsquare_offgrid_rotated():
    js = config1_scene(with_glass=True, with_tri=True)
    jc = make_camera((0.2, -0.3, 0.5), 40, 24, np.pi / 2, np.pi / 3,
                     rot_h=0.3, rot_v=-0.2)
    _frame_case(js, jc, config1_cfg())


@pytest.mark.parametrize("sample", [0, 1])
def test_frame_rough_spp2(sample):
    js = ext_scene(trans=True, rough=0.4)
    jc = make_camera((0.0, 0.0, 0.5), 16, 12, np.pi / 2, np.pi / 3)
    _frame_case(js, jc, RenderConfig(refmax=3, spp=2),
                key=jax.random.key(11), sample=sample)


def test_frame_mirror_exhaust():
    jc = make_camera((0.0, 0.0, 0.0), 16, 16, np.pi / 2, np.pi / 2)
    _, status = _frame_case(mirror_exhaust_scene(), jc, RenderConfig(refmax=4))
    assert (status == 4).any()


@pytest.mark.parametrize("name", ["config1_glass_tri", "rough_trans"])
def test_rays_plain_vs_reference_kernel_and_brute(name):
    if name == "config1_glass_tri":
        js, cfg, key = (config1_scene(True, True), config1_cfg(),
                        jax.random.key(0))
    else:
        js, cfg, key = (ext_scene(trans=True, rough=0.4),
                        RenderConfig(refmax=3), jax.random.key(5))
    seed = int(jsamp.seed_from_key(key))
    # camera rays plus random rays (general |d|, origins off the camera)
    jo, jd = pixel_rays(make_camera((0.0, 0.0, 0.5), 16, 16, np.pi / 2,
                                    np.pi / 2))
    rng = np.random.default_rng(1)
    ro = rng.uniform([-1, -2, 0], [2, 2, 1.5], (256, 3)).astype(np.float32)
    rd = rng.normal(size=(256, 3)).astype(np.float32)
    rd *= rng.uniform(0.5, 2.0, (256, 1)).astype(np.float32)
    org = np.concatenate([np.asarray(jo), ro])
    d = np.concatenate([np.asarray(jd), rd])
    rid = np.arange(org.shape[0], dtype=np.int32) * 3 + 1
    ps, pcfg = to_port_scene(js), to_port_cfg(cfg)

    color, status, rec = tf.trace_rays_fused_plain(
        ps, pcfg, to_torch(org), to_torch(d), seed=seed,
        ray_id=to_torch(rid), record=True)
    ref_c, ref_s = jtf.trace_rays_fused(js, cfg, jnp.asarray(org),
                                        jnp.asarray(d), key=key,
                                        ray_id=jnp.asarray(rid))
    prove = parity.flip_prover(ps, rec, jax_pid_seq(js, cfg, org, d, key,
                                                    rid))
    assert_parity(color, status, ref_c, ref_s, prove=prove)
    # and against the port's own BRUTE wavefront, the semantic reference
    brute = ptrace.trace_rays(ps, pcfg, to_torch(org), to_torch(d),
                              seed=seed, ray_id=to_torch(rid))
    assert_parity(color, status, brute.color, brute.status, prove=prove)


def test_pack_tables_layout():
    js = config1_scene(with_glass=True, with_tri=True)
    ps = to_port_scene(js)
    jc = make_camera((0.3, 0.1, 0.5), 8, 8, 1.0, 1.0)
    tabs = tf.pack_tables(ps, cam_pos=to_port_camera(jc).pos)
    assert tabs.sph.shape == (13, 5) and tabs.box.shape == (13, 1)
    assert tabs.tri.shape == (17, 1) and tabs.has_trans
    c = np.asarray(js.sphere_center)
    r = np.asarray(js.sphere_radius)
    np.testing.assert_allclose(tabs.sph[tf.S_CCMR].numpy(),
                               (c * c).sum(1) - r * r, rtol=1e-6)
    o = np.asarray(jc.pos)
    np.testing.assert_allclose(tabs.sph[tf.S_C0].numpy(),
                               ((c - o) ** 2).sum(1) - r * r, rtol=1e-5)
    # modes: diffuse 0, mirror 1, light 2, glass 3; the glass substance 1.5
    np.testing.assert_array_equal(tabs.sph[tf.S_MODE].numpy(), [0, 1, 0, 2, 3])
    np.testing.assert_array_equal(tabs.sph[tf.S_REFR].numpy(),
                                  [-1, -1, -1, -1, 1.5])
    gn = tabs.tri[tf.T_GX:tf.T_GZ + 1, 0].numpy()
    np.testing.assert_allclose(np.linalg.norm(gn), 1.0, rtol=1e-6)


def test_cpu_wrappers_take_the_plain_versions():
    js = config1_scene(with_glass=True, with_tri=True)
    ps = to_port_scene(js)
    pc = to_port_camera(make_camera((0.0, 0.0, 0.5), 12, 10, np.pi / 2,
                                    np.pi / 2))
    pcfg = to_port_cfg(config1_cfg())
    before = dict(tf.LAUNCHES)
    img = tf.trace_frame_fused(ps, pcfg, pc)
    want = tf.trace_frame_fused_plain(ps, pcfg, pc)[0]
    assert torch.equal(img, want)
    from raytracer_js_tpu_torch.models.camera import pixel_rays as p_rays

    org, d = p_rays(pc)
    color, status = tf.trace_rays_fused(ps, pcfg, org, d)
    want_c, want_s, _ = tf.trace_rays_fused_plain(ps, pcfg, org, d)
    assert torch.equal(color, want_c) and torch.equal(status, want_s)
    assert tf.LAUNCHES == before == {"frame": 0, "rays": 0}


def test_launchers_refuse_cpu_tensors():
    ps = to_port_scene(config1_scene())
    tabs = tf.pack_tables(ps)
    pc = to_port_camera(make_camera((0.0, 0.0, 0.5), 4, 4, np.pi / 2,
                                    np.pi / 2))
    one = torch.ones(())
    with pytest.raises(ValueError, match="CUDA"):
        tf.launch_frame(tabs, pc, one, one, refmax=1, atten=1.0, seed=0,
                        spp=1, sample=0)
    with pytest.raises(ValueError, match="CUDA"):
        tf.launch_rays(tabs, one, one, torch.zeros((4, 3)),
                       torch.ones((4, 3)), torch.zeros(4, dtype=torch.int32),
                       refmax=1, atten=1.0, seed=0)
    assert tf.LAUNCHES == {"frame": 0, "rays": 0}


def test_supports_gate():
    from test_torch_trace import both_scene

    assert tf.supports(to_port_scene(config1_scene(True, True)))
    assert tf.supports_frame(to_port_scene(ext_scene(True, 0.5)))
    assert not tf.supports(to_port_scene(both_scene()))


def test_box_edge_tie_takes_the_x_face():
    """A ray meets a mirror box exactly on its x/y edge: the slab tie goes
    to x (x > y > z), so the reflection reaches the emitter; the y face
    would send it to the sky."""
    from raytracer_js_tpu import ResponseType, SceneBuilder

    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0.2, 0.3, 0.4)))
    white = b.add_solid_texture((1.0, 1.0, 1.0))
    b.add_box((0.0, 0.0, 0.0), 2.0,
              b.add_material(ResponseType.REFLECTION, mirror=True), white)
    b.add_sphere((-1 - 3 / np.sqrt(2), -1 + 3 / np.sqrt(2), 0.0), 0.5,
                 b.add_material(ResponseType.REFLECTION, light=True), white)
    js = b.build()
    org = np.array([[-3.0, -3.0, 0.0], [-3.0, -2.0, 0.0]], np.float32)
    d = np.array([[1.0, 1.0, 0.0], [1.0, 0.0, 0.0]], np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cfg = RenderConfig(refmax=3)
    ps, pcfg = to_port_scene(js), to_port_cfg(cfg)
    color, status, _ = tf.trace_rays_fused_plain(ps, pcfg, to_torch(org),
                                                 to_torch(d))
    assert status.tolist() == [1, 3]
    ref_c, ref_s = jtf.trace_rays_fused(js, cfg, jnp.asarray(org),
                                        jnp.asarray(d))
    assert_parity(color, status, ref_c, ref_s)
    brute = ptrace.trace_rays(ps, pcfg, to_torch(org), to_torch(d))
    assert_parity(color, status, brute.color, brute.status)
