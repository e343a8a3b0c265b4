"""The per-warp sphere cull of kernels B1 and B2 (``trace_fused.fused_cull``
and ``cull_counts``, the plain form of what ``trace_frame_kernel`` and
``trace_rays_kernel`` evaluate before each bounce's search): it never drops
a sphere that a live ray of its warp hits, so a plain trace whose search
leaves the culled spheres out (as the kernels do) is ``trace_core_plain``
bit for bit;
the sphere tests each ray needs, the warps run and a dense search runs are
ordered. And the frame wrapper: its camera arguments are the values the
first design's camera array carried, and the tables it keeps on the scene
follow an in-place edit of a scene tensor.

Scenes (``chip_smoke.py``'s recipes, port scenes on the CPU): the headline
scene (``bench.build_scene(50)``) under a 192x96 camera at refmax 2, the
600-sphere near-miss field (three shared-memory windows in the kernels)
under a 45x21 camera at refmax 3 (partial warps at the right edge), and
the rough + glass scene under a 40x24 camera at refmax 3. The frame layout
takes the cameras' rays with B1's warps (32-pixel row strips); the
wavefront layout takes them scaled to non-unit lengths with B2's warps (32
consecutive rays). One case holds the culled frame against the reference's
fused frame kernel (interpret mode).

Tolerances: bit for bit between the port's plain forms; against the
reference, ``assert_parity`` (rtol 1e-5 / atol 1e-6 and equal statuses
but for proven winner flips)."""
import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from raytracer_js_tpu import make_camera as j_make_camera
from raytracer_js_tpu.kernels import trace_fused as jtf
from raytracer_js_tpu.ops import sampling as jsamp
from raytracer_js_tpu_torch import HitBackend, RenderConfig, render_hdr
from raytracer_js_tpu_torch.kernels import nearest_hit as nh
from raytracer_js_tpu_torch.kernels import trace_fused as tf
from raytracer_js_tpu_torch.models.camera import angle_steps, pixel_rays
from raytracer_js_tpu_torch.utils import parity

from scenes import config1_cfg, config1_scene
from test_torch_parity import (ROOT, assert_parity, jax_pid_seq,
                               load_by_path, to_port_camera, to_port_cfg,
                               to_port_scene)

SCENES = ("headline", "near_miss_600", "rough_glass")
LAYOUTS = ("frame", "rays")


@pytest.fixture(scope="module")
def smoke():
    return load_by_path("chip_smoke", ROOT / "chip_smoke.py")


@pytest.fixture(scope="module")
def scenes(smoke):
    """name -> (scene, camera, refmax)."""
    cam = smoke.make_camera
    return {
        "headline": (smoke.headline_scene(device="cpu"),
                     cam((0.0, 0.0, 0.5), 192, 96, np.pi / 2, np.pi / 4,
                         device="cpu"), 2),
        "near_miss_600": (smoke.near_miss_field(device="cpu"),
                          cam((0.0, 0.0, 0.5), 45, 21, 1.3, 0.7,
                              device="cpu"), 3),
        "rough_glass": (smoke.rough_scene(device="cpu"),
                        cam((0.0, 0.0, 0.5), 40, 24, 1.4, 0.9,
                            device="cpu"), 3),
    }


def _rays(scene, cam, layout):
    """(org, dir, lanes, unit_d, has_c0) of a layout: the camera's rays
    with B1's warps, or scaled to lengths 0.5-2 with B2's."""
    org, d = pixel_rays(cam)
    if layout == "frame":
        return org, d, tf.frame_lanes(cam.w, cam.h), True, True
    scale = np.random.default_rng(4).uniform(0.5, 2.0, (org.shape[0], 1))
    return (org, d * torch.as_tensor(scale, dtype=torch.float32),
            tf.ray_lanes(org.shape[0]), False, False)


def _trace(scene, cam, refmax, layout):
    """(tables, lanes, unit_d, the recorded plain trace of the layout)."""
    org, d, lanes, unit_d, has_c0 = _rays(scene, cam, layout)
    tabs = tf.pack_tables(scene, cam_pos=cam.pos if has_c0 else None)
    return tabs, lanes, unit_d, lambda: tf.trace_core_plain(
        org, d, tabs, refmax=refmax, atten=1.0, unit_d=unit_d,
        has_c0=has_c0, rid=torch.arange(org.shape[0], dtype=torch.int32),
        refr0=scene.default_refr, refr_def=scene.default_refr, record=True)


def _cull_spheres(monkeypatch, lanes, alive):
    """Make ``trace_core_plain``'s search leave out the spheres each ray's
    warp culls, as the kernels do: ``sphere_t`` (called once a bounce)
    returns +inf for them. The cull of bounce b is taken over ``alive[b]``
    of the dense trace: until the culled trace first differs from it, the
    two have the same rays and live lanes, so a first difference is one
    that the kernels' cull makes. -> the count of spheres left out at each
    bounce, filled as the trace runs."""
    ray_warp = torch.empty(alive.shape[1], dtype=torch.long)
    ray_warp[lanes[lanes >= 0]] = torch.nonzero(lanes >= 0)[:, 0] // tf.WARP
    dense, left_out = tf.sphere_t, []

    def culled(tabs, ox, oy, oz, dx, dy, dz, use_c0, unit_d):
        keep = tf.fused_cull(tabs, torch.stack([ox, oy, oz], dim=1),
                             torch.stack([dx, dy, dz], dim=1),
                             alive[len(left_out)], lanes)[ray_warp]
        left_out.append(int((~keep).sum()))
        return torch.where(keep, dense(tabs, ox, oy, oz, dx, dy, dz, use_c0,
                                       unit_d), torch.inf)

    monkeypatch.setattr(tf, "sphere_t", culled)
    return left_out


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", SCENES)
def test_cull_never_drops_a_sphere_a_live_ray_hits(scenes, name, layout):
    scene, cam, refmax = scenes[name]
    tabs, lanes, unit_d, run = _trace(scene, cam, refmax, layout)
    _c, _s, rec = run()
    ray_warp = torch.empty(rec["alive"].shape[1], dtype=torch.long)
    ray_warp[lanes[lanes >= 0]] = torch.nonzero(lanes >= 0)[:, 0] // tf.WARP
    hits_seen = 0
    for b in range(refmax):
        alive = rec["alive"][b]
        o, d = rec["org"][b], rec["dir"][b]
        t = tf.sphere_t(tabs, o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1],
                        d[:, 2], layout == "frame" and b == 0, unit_d)
        hits = torch.isfinite(t) & alive[:, None]
        inc = tf.fused_cull(tabs, o, d, alive, lanes)
        assert not bool((hits & ~inc[ray_warp]).any()), f"bounce {b}"
        hits_seen += int(hits.sum())
        if b == 0:
            # the cull cuts work: some warp leaves some sphere out
            assert int(inc.sum()) < inc.numel()
    assert hits_seen > 100


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", SCENES)
def test_culled_trace_is_the_dense_trace_bit_for_bit(scenes, name, layout,
                                                     monkeypatch):
    scene, cam, refmax = scenes[name]
    _tabs, lanes, _u, run = _trace(scene, cam, refmax, layout)
    c0, s0, r0 = run()
    left_out = _cull_spheres(monkeypatch, lanes, r0["alive"])
    c1, s1, r1 = run()
    assert len(left_out) == refmax and left_out[0] > 0
    assert torch.equal(c0.view(torch.int32), c1.view(torch.int32))
    assert torch.equal(s0, s1) and torch.equal(r0["pid"], r1["pid"])
    assert int((r0["pid"] >= 0).sum()) > 100


@pytest.mark.parametrize("name", SCENES)
def test_needed_streamed_all_counts_are_ordered(scenes, name):
    scene, cam, refmax = scenes[name]
    tabs, lanes, _u, run = _trace(scene, cam, refmax, "frame")
    _c, _s, rec = run()
    counts = tf.cull_counts(tabs, rec, lanes)
    assert counts.shape == (refmax, lanes.shape[0] // tf.WARP)
    every = torch.arange(rec["alive"].shape[1])
    for b in range(refmax):
        alive = rec["alive"][b]
        need = tf.fused_cull(tabs, rec["org"][b], rec["dir"][b], alive,
                             every, group=1)[alive]
        live_lanes = (alive[lanes.clamp(min=0)] & (lanes >= 0)).reshape(
            -1, tf.WARP).sum(1)
        streamed = int((counts[b] * live_lanes).sum())
        every_test = int(alive.sum()) * scene.n_spheres
        assert int(need.sum()) <= streamed <= every_test, b
    assert int(counts[0].sum()) < counts.shape[1] * scene.n_spheres


def test_cull_counts_skip_warps_without_a_live_ray(scenes):
    scene, cam, refmax = scenes["rough_glass"]
    tabs, lanes, _u, run = _trace(scene, cam, refmax, "frame")
    _c, _s, rec = run()
    counts = tf.cull_counts(tabs, rec, lanes)
    live = (rec["alive"][:, lanes.clamp(min=0)] & (lanes >= 0)).reshape(
        refmax, -1, tf.WARP).any(-1)
    assert bool((~live).any()) and bool(live[1:].any())
    assert bool((counts[~live] == 0).all())
    assert bool((counts[live] > 0).any())


def test_frame_and_ray_lanes():
    lanes = tf.frame_lanes(45, 3)
    assert lanes.shape == (3 * 64,)
    row1 = lanes[64:128]
    assert row1[:45].tolist() == list(range(45, 90))
    assert bool((row1[45:] == -1).all())
    r = tf.ray_lanes(70)
    assert r.shape == (96,) and r[69] == 69 and bool((r[70:] == -1).all())


def test_cone_include_mask_is_the_prefix_form(scenes):
    scene, cam, _ = scenes["headline"]
    org, d = pixel_rays(cam)
    balls = tf.pack_tables(scene).balls
    live = 5000
    mask = torch.arange(org.shape[0]) < live
    assert torch.equal(nh.cone_include(org, d, live, balls),
                       nh.cone_include(org, d, mask, balls))


def test_camera_args_are_the_first_designs_camera_array(scenes):
    """The frame kernel now takes the pose by pointer and the steps by
    value; they are the floats its first design read from one [18] array
    built per frame: pos, front, left, up, step_h, step_v, off_h, off_v."""
    _scene, cam, _ = scenes["rough_glass"]
    pose_steps = tf.camera_args(cam)
    steps = torch.tensor(angle_steps(cam), dtype=torch.float32)
    first = torch.cat([cam.pos, cam.front, cam.left, cam.up, steps])
    got = torch.cat([*pose_steps[:4], torch.tensor(pose_steps[4:],
                                                   dtype=torch.float32)])
    assert torch.equal(got, first)
    assert [type(v) for v in pose_steps[4:]] == [float, float, int, int]


def test_scene_tables_follow_an_in_place_edit(smoke, monkeypatch):
    scene = smoke.headline_scene(device="cpu")
    cam = smoke.make_camera((0.0, 0.0, 0.5), 48, 24, np.pi / 2, np.pi / 4,
                            device="cpu")
    cfg = RenderConfig(refmax=2, backend=HitBackend.FUSED)
    first = tf.scene_tables(scene)
    assert tf.scene_tables(scene) is first          # kept, not rebuilt
    img0 = render_hdr(scene, cam, cfg)
    # the CUDA wrapper launches with the kept tables
    seen = []
    monkeypatch.setattr(tf, "launch_frame",
                        lambda tabs, *a, **k: seen.append(tabs))
    tf.trace_frame_fused_cuda(scene, cfg, cam)
    assert seen[-1] is first
    # move the sphere that the camera's middle pixel sees, in place
    pid = tf.trace_frame_fused_plain(scene, cfg, cam, record=True)[2]["pid"]
    k = int(pid[0, 12 * 48 + 24])
    assert 0 <= k < scene.n_spheres
    scene.sphere_center[k, 2] += 0.5
    edited = tf.scene_tables(scene)
    assert edited is not first
    want = tf.pack_tables(scene)
    assert torch.equal(edited.sph, want.sph)
    assert torch.equal(edited.balls, want.balls)
    assert torch.equal(edited.sph[tf.S_CZ, k], first.sph[tf.S_CZ, k] + 0.5)
    tf.trace_frame_fused_cuda(scene, cfg, cam)
    assert seen[-1] is edited
    img1 = render_hdr(scene, cam, cfg)
    assert not torch.equal(img0, img1)
    # a material edit too
    scene.materials.roughness[0] += 0.25
    assert tf.scene_tables(scene) is not edited


def test_culled_frame_holds_against_the_reference_kernel(monkeypatch):
    js = config1_scene(with_glass=True, with_tri=True)
    jc = j_make_camera((0.2, -0.3, 0.5), 40, 24, np.pi / 2, np.pi / 3,
                       rot_h=0.3, rot_v=-0.2)
    cfg = config1_cfg()
    key = jax.random.key(0)
    ps, pc, pcfg = to_port_scene(js), to_port_camera(jc), to_port_cfg(cfg)
    org, d = pixel_rays(pc)
    tabs = tf.pack_tables(ps, cam_pos=pc.pos)
    refr0, refr_def = tf._refr_args(ps, None)

    def run():
        return tf.trace_core_plain(
            org, d, tabs, refmax=int(pcfg.refmax),
            atten=float(pcfg.distance_attenuation_factor), unit_d=True,
            has_c0=True, rid=torch.arange(org.shape[0], dtype=torch.int32),
            seed=int(jsamp.seed_from_key(key)), refr0=refr0,
            refr_def=refr_def, record=True)

    _c, _s, dense_rec = run()
    left_out = _cull_spheres(monkeypatch, tf.frame_lanes(pc.w, pc.h),
                             dense_rec["alive"])
    color, status, rec = run()
    assert left_out[0] > 0
    ref_img = jtf.trace_frame_fused(js, cfg, jc, key=key)
    from raytracer_js_tpu.models.camera import pixel_rays as j_pixel_rays
    from raytracer_js_tpu.ops.trace import trace_rays as j_trace
    import jax.numpy as jnp

    jo, jd = j_pixel_rays(jc)
    rid = jnp.arange(jo.shape[0], dtype=jnp.int32)
    ref = j_trace(js, cfg, jo, jd, key, rid)
    prove = parity.flip_prover(ps, rec, jax_pid_seq(js, cfg, jo, jd, key,
                                                    rid))
    assert_parity(color.reshape(jc.h, jc.w, 3), status.reshape(jc.h, jc.w),
                  ref_img, ref.status.reshape(jc.h, jc.w), prove=prove)
