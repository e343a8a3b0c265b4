"""The public leftovers against the reference package: ``ops/color``,
``ops/space``, ``ops/sampling.ball_sample`` and
``hemisphere_ball_sample``, ``utils/validate``, ``utils/profiling``,
``utils/image``, ``view/exposure.reset``, ``view/view.draw_rgba`` and
``progressive_render``, and the ``demo`` and ``live`` entry points.

Tolerances: color and space ops equal the reference's (the same float32
operations; exact for predicates, rtol 1e-6 for arithmetic); ball samples
draw bit-identical uniforms, and their cos/sin/exp/log differ from XLA's
CPU versions by at most one float32 ulp (2.4e-7 allowed at magnitudes up
to 1); images rendered by the port agree with its own calls bit for bit.
"""
import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from raytracer_js_tpu.ops import color as jcolor
from raytracer_js_tpu.ops import sampling as jsamp
from raytracer_js_tpu.ops import space as jspace
from raytracer_js_tpu.view import exposure as jex
from raytracer_js_tpu.view import view as jview
from raytracer_js_tpu_torch import HitBackend, RenderConfig, make_camera
from raytracer_js_tpu_torch.config import ToneMapConfig, ToneMapperKind
from raytracer_js_tpu_torch.ops import color as pcolor
from raytracer_js_tpu_torch.ops import sampling as psamp
from raytracer_js_tpu_torch.ops import space as pspace
from raytracer_js_tpu_torch.optim.fit import step_seed
from raytracer_js_tpu_torch.render import render_hdr
from raytracer_js_tpu_torch.utils import profiling
from raytracer_js_tpu_torch.utils.validate import (SceneValidationError,
                                                   assert_rays_sane,
                                                   finite_or_debug,
                                                   validate_scene)
from raytracer_js_tpu_torch.view import exposure as pex
from raytracer_js_tpu_torch.view import view as pview

from scenes import config1_cfg, config1_scene
from test_torch_parity import to_port_cfg, to_port_scene

RNG = np.random.default_rng(11)


def _t(x):
    return torch.as_tensor(np.asarray(x))


# ---------------------------------------------------------------------------
# ops/space
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cov", [0, 1, 2])
def test_point_in_space_matches_reference(cov):
    """Points on the lo and hi faces, inside and outside, every coverage
    mode: the same booleans as the reference."""
    pts = np.concatenate([RNG.uniform(-0.5, 1.5, (300, 3)),
                          RNG.integers(0, 2, (60, 3)).astype(np.float64)]
                         ).astype(np.float32)
    pos, size = np.zeros(3, np.float32), np.ones(3, np.float32)
    want = np.asarray(jspace.point_in_space(
        jnp.asarray(pts), jnp.asarray(pos), jnp.asarray(size),
        jspace.RangeCoverage(cov)))
    got = pspace.point_in_space(_t(pts), _t(pos), _t(size),
                                pspace.RangeCoverage(cov)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


def test_point_in_space_coverage_modes():
    pos, size = torch.zeros(3), torch.ones(3)
    lo, hi = torch.zeros(3), torch.ones(3)
    rc = pspace.RangeCoverage
    assert bool(pspace.point_in_space(lo, pos, size, rc.CLOSE_OPEN))
    assert not bool(pspace.point_in_space(hi, pos, size, rc.CLOSE_OPEN))
    assert not bool(pspace.point_in_space(lo, pos, size, rc.OPEN_CLOSE))
    assert bool(pspace.point_in_space(hi, pos, size, rc.OPEN_CLOSE))
    assert bool(pspace.point_in_space(lo, pos, size, rc.FULL))
    assert bool(pspace.point_in_space(hi, pos, size, rc.FULL))


def test_containment_and_overlap_match_reference():
    """Random box pairs (many disjoint, many nested): containment, overlap
    box, non-emptiness and volume as the reference computes them."""
    n = 400
    pa = RNG.uniform(-1, 1, (n, 3)).astype(np.float32)
    sa = RNG.uniform(0.1, 2, (n, 3)).astype(np.float32)
    pb = RNG.uniform(-1, 1, (n, 3)).astype(np.float32)
    sb = RNG.uniform(0.1, 2, (n, 3)).astype(np.float32)
    edge = RNG.uniform(0.1, 2, n).astype(np.float32)
    J, P = [jnp.asarray(a) for a in (pa, sa, pb, sb)], [_t(a) for a in
                                                         (pa, sa, pb, sb)]
    np.testing.assert_array_equal(pspace.space_in_space(*P).numpy(),
                                  np.asarray(jspace.space_in_space(*J)))
    np.testing.assert_array_equal(
        pspace.aabb_in_space(P[0], _t(edge), P[2], P[3]).numpy(),
        np.asarray(jspace.aabb_in_space(J[0], jnp.asarray(edge), J[2],
                                        J[3])))
    for g, w in zip(pspace.get_overlap_space(*P),
                    jspace.get_overlap_space(*J)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    vol = pspace.aabb_overlap_volume(*P).numpy()
    np.testing.assert_allclose(vol, np.asarray(jspace.aabb_overlap_volume(
        *J)), rtol=1e-6)
    assert (vol == 0).any() and (vol > 0).any()
    # the reference test's hand values
    assert bool(pspace.space_in_space(torch.full((3,), 0.25),
                                      torch.full((3,), 0.5), torch.zeros(3),
                                      torch.ones(3)))
    assert float(pspace.aabb_overlap_volume(
        torch.zeros(3), torch.ones(3), torch.full((3,), 0.5),
        torch.ones(3))) == 0.125


# ---------------------------------------------------------------------------
# ops/color
# ---------------------------------------------------------------------------

def test_color_ops_match_reference():
    top = RNG.uniform(-0.2, 1.2, (64, 4)).astype(np.float32)
    bot = RNG.uniform(0, 1, (64, 4)).astype(np.float32)
    fac = RNG.uniform(0, 2, 64).astype(np.float32)
    pt, pb, jt, jb = _t(top), _t(bot), jnp.asarray(top), jnp.asarray(bot)
    pairs = [
        (pcolor.mul_color(pt, pb), jcolor.mul_color(jt, jb)),
        (pcolor.scale_color(pt, _t(fac)),
         jcolor.scale_color(jt, jnp.asarray(fac))),
        (pcolor.scale_color(pt, _t(fac), scale_alpha=True),
         jcolor.scale_color(jt, jnp.asarray(fac), scale_alpha=True)),
        (pcolor.scale_color(pt[:, :3], 0.5), jcolor.scale_color(jt[:, :3],
                                                                0.5)),
        (pcolor.clamp_color(pt), jcolor.clamp_color(jt)),
        (pcolor.overlay_color(pt, pb), jcolor.overlay_color(jt, jb)),
        (pcolor.luma(pt), jcolor.luma(jt)),
        (pcolor.color(_t(top[:, 0]), 0.5, _t(top[:, 2])),
         jcolor.color(jt[:, 0], 0.5, jt[:, 2])),
    ]
    for got, want in pairs:
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
    # 50% red over solid blue: half red, half blue, alpha 1
    out = pcolor.overlay_color(pcolor.color(1.0, 0.0, 0.0, 0.5),
                               pcolor.color(0.0, 0.0, 1.0, 1.0))
    np.testing.assert_allclose(out.numpy(), [0.5, 0.0, 0.5, 1.0])


# ---------------------------------------------------------------------------
# ops/sampling: ball samples
# ---------------------------------------------------------------------------

ULP_ATOL = 2.4e-7   # two float32 ulps at 1: the transcendentals' rounding

def _ids(n=1 << 14):
    return (np.arange(n, dtype=np.int64) * 7919) % (1 << 32)


@pytest.mark.parametrize("bounce", [0, 3])
def test_ball_sample_matches_reference(bounce):
    ids = _ids()
    seed = psamp.DEFAULT_SEED
    for salt in (psamp.SALT_Z, psamp.SALT_PHI, psamp.SALT_R):
        np.testing.assert_array_equal(
            psamp.ray_uniform(seed, _t(ids), bounce, salt).numpy(),
            np.asarray(jsamp.ray_uniform(jnp.uint32(seed),
                                         jnp.asarray(ids.astype(np.uint32)),
                                         jnp.uint32(bounce), salt)))
    got = psamp.ball_sample(seed, _t(ids), bounce).numpy()
    want = np.asarray(jsamp.ball_sample(jnp.uint32(seed),
                                        jnp.asarray(ids.astype(np.uint32)),
                                        bounce))
    assert got.shape == (len(ids), 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ULP_ATOL)


@pytest.mark.parametrize("normal", [(0.0, 0.0, 1.0), (0.6, -0.8, 0.0)])
def test_hemisphere_sample_matches_reference(normal):
    ids = _ids()
    n = np.broadcast_to(np.asarray(normal, np.float32), (len(ids), 3))
    got = psamp.hemisphere_ball_sample(7, _t(ids), _t(n.copy()), 1).numpy()
    want = np.asarray(jsamp.hemisphere_ball_sample(
        jnp.uint32(7), jnp.asarray(ids.astype(np.uint32)), jnp.asarray(n),
        1))
    np.testing.assert_allclose(got, want, rtol=0, atol=ULP_ATOL)
    assert (got @ np.asarray(normal) >= -1e-7).all()


def test_ball_sample_radial_cdf_and_isotropy():
    """Uniform in the ball: r^3 ~ U(0, 1) (mean 1/2, deciles by chi^2),
    directions isotropic (test_sampling_stats.py:25-49)."""
    v = psamp.ball_sample(psamp.DEFAULT_SEED, _t(np.arange(1 << 14))).numpy()
    r3 = np.sum(v * v, axis=-1) ** 1.5
    assert np.all(r3 <= 1.0 + 1e-6) and abs(r3.mean() - 0.5) < 0.01
    hist, _ = np.histogram(r3, bins=10, range=(0.0, 1.0))
    expect = len(r3) / 10
    assert np.sum((hist - expect) ** 2 / expect) < 33.0
    d = v / np.linalg.norm(v, axis=-1, keepdims=True)
    assert np.all(np.abs(d.mean(axis=0)) < 0.02)
    np.testing.assert_allclose(d.T @ d / len(d), np.eye(3) / 3.0, atol=0.02)


# ---------------------------------------------------------------------------
# utils/validate
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_scene():
    return to_port_scene(config1_scene(with_glass=True, with_tri=True))


def test_valid_scene_passes(port_scene):
    assert validate_scene(port_scene) == []


@pytest.mark.parametrize("field,change,match", [
    ("prim_material", lambda x: x + 99, "material id"),
    ("sphere_radius", lambda x: -x, "radius"),
    ("sphere_center", lambda x: torch.where(
        torch.arange(x.numel()).reshape(x.shape) == 0, float("nan"), x),
     "sphere_center"),
])
def test_bad_scene_caught(port_scene, field, change, match):
    bad = dataclasses.replace(port_scene,
                              **{field: change(getattr(port_scene, field))})
    with pytest.raises(SceneValidationError, match=match):
        validate_scene(bad)


def test_non_strict_collects(port_scene):
    bad = dataclasses.replace(port_scene,
                              sphere_radius=-port_scene.sphere_radius,
                              prim_texture=port_scene.prim_texture + 99)
    assert len(validate_scene(bad, strict=False)) == 2


def test_ray_sanity_and_finite_report(capsys):
    org = torch.zeros((4, 3))
    d = torch.tensor([[1.0, 0.0, 0.0]]).repeat(4, 1)
    assert_rays_sane(org, d)
    with pytest.raises(SceneValidationError, match="not unit"):
        assert_rays_sane(org, d * 3.0)
    bad = org.clone()
    bad[0, 0] = float("nan")
    with pytest.raises(SceneValidationError, match="non-finite"):
        assert_rays_sane(bad, d)
    assert finite_or_debug(org, "org") is org
    assert capsys.readouterr().err == ""
    finite_or_debug(bad, "org")
    assert "1 non-finite lanes in org" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# utils/profiling, utils/image
# ---------------------------------------------------------------------------

def test_profiling_meters_and_trace(tmp_path):
    sma = profiling.SMA(window=2)
    for x in (1.0, 2.0, 4.0):
        sma.add(x)
    assert sma.value == 3.0
    meter = profiling.RayMeter()
    with meter.frame(1000):
        x = profiling.block(torch.ones(4) * 2)
    assert meter.total_rays == 1000 and meter.rays_per_s > 0
    assert profiling.block([x, {"a": x}])[0] is x
    with profiling.profile_trace(None):
        pass
    with profiling.profile_trace(str(tmp_path / "tr")):
        torch.ones(8).sum()
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0


def test_image_file_texture_roundtrip(tmp_path, monkeypatch):
    """PNG -> loader (test_golden.py:74-90), then the loaded image as a
    texture: a render of a box textured with it equals the render of the
    array it was written from, to 8 bits. Without PIL the loader raises TextureError naming PIL and the
    texture loader falls back."""
    pytest.importorskip("PIL")
    import raytracer_js_tpu_torch as rt
    from raytracer_js_tpu_torch.utils.image import (TextureError,
                                                    load_image,
                                                    load_texture_image)
    from raytracer_js_tpu_torch.view.screen import write_png

    img = np.zeros((8, 8, 3), np.float32)
    img[:, :4] = (1.0, 0.0, 0.0)
    img[:, 4:] = (0.0, 0.0, 1.0)
    p = write_png(tmp_path / "t.png", img)
    loaded = load_texture_image(p)
    np.testing.assert_allclose(loaded, img, atol=1 / 255)
    np.testing.assert_array_equal(load_image(p, hflip=True), loaded[:, ::-1])
    assert load_texture_image(p, size=(4, 2)).shape == (4, 2, 3)
    bad = load_texture_image(tmp_path / "missing.png",
                             fallback=(0.3, 0.2, 0.1))
    np.testing.assert_allclose(bad, np.full((1, 1, 3), [0.3, 0.2, 0.1],
                                            np.float32))
    with pytest.raises(TextureError, match="failed to decode"):
        load_image(tmp_path / "missing.png")

    def frame(texture):
        b = rt.SceneBuilder(atlas_hw=(8, 8))
        b.set_sky(b.add_solid_texture((0.0, 0.0, 0.0)))
        m = b.add_material(rt.ResponseType.REFLECTION, light=True)
        b.add_box((4.0, 0.0, 0.0), 2.0, m, b.add_image_texture(texture))
        return render_hdr(b.build(device="cpu"), make_camera(
            (0, 0, 0), 16, 16, 1.2, 1.2, device="cpu"), RenderConfig(
                refmax=1, backend=HitBackend.PALLAS))

    # the file's colors (to 8 bits) in the frame, as the array's
    from_file = frame(loaded)
    torch.testing.assert_close(from_file, frame(img), rtol=0, atol=1 / 255)
    assert float(from_file[..., 0].max()) > 0.05

    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(TextureError, match="PIL"):
        load_image(p)
    np.testing.assert_allclose(load_texture_image(p, fallback=(1, 1, 1)),
                               np.ones((1, 1, 3)))


# ---------------------------------------------------------------------------
# view: reset, draw_rgba, progressive_render
# ---------------------------------------------------------------------------

def test_reset():
    buf = pex.accumulate(pex.new_exposure_buffer(1, 1, device="cpu"),
                         torch.ones((1, 1, 3)))
    buf = pex.reset(buf)
    assert int(buf.frame_count) == 0 and buf.frame_count.dtype == torch.int32
    assert torch.equal(buf.pixels, torch.zeros((1, 1, 3)))


@pytest.mark.parametrize("kind", [ToneMapperKind.IDENTITY,
                                  ToneMapperKind.STDDEV_AROUND_MEAN])
def test_draw_rgba_matches_reference(kind):
    """Tone map, opaque alpha, then a HUD layer composited as color.ts:59-65
    (test_view.py:93-121): the reference's RGBA image."""
    from raytracer_js_tpu.config import ToneMapConfig as JTC
    from raytracer_js_tpu.config import ToneMapperKind as JTK

    frame = RNG.uniform(0, 2, (6, 5, 3)).astype(np.float32)
    hud = RNG.uniform(0, 1, (6, 5, 4)).astype(np.float32)
    jbuf = jex.accumulate(jex.new_exposure_buffer(6, 5), jnp.asarray(frame))
    pbuf = pex.accumulate(pex.new_exposure_buffer(6, 5, device="cpu"),
                          _t(frame))
    want = np.asarray(jview.draw_rgba(jbuf, JTC(kind=JTK(int(kind))),
                                      overlays=(hud,)))
    got = pview.draw_rgba(pbuf, ToneMapConfig(kind=kind), overlays=(hud,))
    assert tuple(got.shape) == (6, 5, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    base = pview.draw_rgba(pbuf, ToneMapConfig(kind=kind))
    assert torch.equal(base[..., 3], torch.ones((6, 5)))


def _rough_scene():
    import raytracer_js_tpu_torch as rt

    b = rt.SceneBuilder()
    b.set_sky(b.add_solid_texture((0.4, 0.5, 0.6)))
    rough = b.add_material(rt.ResponseType.REFLECTION, mirror=True,
                           roughness=0.5)
    b.add_sphere((4.0, 0.0, 0.0), 1.5, rough, b.add_solid_texture((1, 1, 1)))
    b.add_box((0.0, 0.0, -51.0), 100.0, b.add_material(
        rt.ResponseType.REFLECTION), b.add_solid_texture((0.9, 0.2, 0.1)))
    return b.build(device="cpu")


@pytest.mark.parametrize("backend", [HitBackend.BRUTE, HitBackend.FUSED])
def test_progressive_render_frames(backend):
    """One frame: the tone-mapped render_hdr of step_seed(seed, 0), at half
    weight; four frames of a rough scene: the port's own render_hdr +
    accumulate loop with step_seed(seed, f), bit for bit; the frames
    differ."""
    scene = _rough_scene()
    cam = make_camera((0, 0, 0), 12, 10, 1.4, 1.3, device="cpu")
    cfg = RenderConfig(refmax=2, backend=backend)
    tone = ToneMapConfig(kind=ToneMapperKind.IDENTITY)
    one = pview.progressive_render(scene, cam, cfg, tone, frames=1, seed=5)
    single = render_hdr(scene, cam, cfg, seed=step_seed(5, 0))
    assert torch.equal(one, torch.clamp(single * 0.5, 0, 1))
    four = pview.progressive_render(scene, cam, cfg, tone, frames=4, seed=5)
    buf = pex.new_exposure_buffer(10, 12, device="cpu")
    frames = [render_hdr(scene, cam, cfg, seed=step_seed(5, f))
              for f in range(4)]
    for fr in frames:
        buf = pex.accumulate(buf, fr)
    assert torch.equal(four, pview.draw(buf, tone))
    assert not torch.equal(frames[0], frames[1])


def test_progressive_render_converges_against_single_frame():
    """A deterministic scene: after 3 identical frames the buffer holds 3/4
    of the frame (test_view.py:143-161)."""
    js = config1_scene()
    scene, cfg = to_port_scene(js), to_port_cfg(config1_cfg())
    cam = make_camera((0.0, 0.0, 0.5), 8, 8, np.pi / 2, np.pi / 2,
                      device="cpu")
    out = pview.progressive_render(scene, cam, cfg, ToneMapConfig(
        kind=ToneMapperKind.IDENTITY), frames=3)
    single = torch.clamp(render_hdr(scene, cam, cfg), 0, 1)
    torch.testing.assert_close(out, single * 0.75, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# demo and live
# ---------------------------------------------------------------------------

def test_demo_scene_matches_reference():
    from raytracer_js_tpu.demo import build_demo_scene as j_build
    from raytracer_js_tpu_torch.demo import build_demo_scene
    from test_torch_parity import jax_scene_arrays

    want = to_port_scene(j_build(7, 12))
    got = build_demo_scene(7, 12, device="cpu")
    for k in jax_scene_arrays(j_build(7, 12)):
        obj_g, obj_w = got, want
        for part in k.split("."):
            obj_g, obj_w = getattr(obj_g, part), getattr(obj_w, part)
        assert torch.equal(obj_g, obj_w), k
    assert (got.has_transmission, got.has_rough) == (want.has_transmission,
                                                    want.has_rough)


def test_demo_main_writes_frames(tmp_path, capsys):
    from raytracer_js_tpu_torch import demo

    assert demo.main(["--device", "cpu", "--size", "16", "--frames", "2",
                      "--out", str(tmp_path / "d.png")]) == 0
    assert "frames=2" in capsys.readouterr().out
    assert demo.main(["--device", "cpu", "--size", "16", "--frames", "1",
                      "--orbit", "2", "--out", str(tmp_path / "o.png")]) == 0
    assert "wrote 2 poses" in capsys.readouterr().out
    written = sorted(p.name for p in tmp_path.iterdir())
    assert len(written) == 3 and written[0].startswith("d.")
    assert written[1].startswith("o_000.") and written[2].startswith("o_001.")


def test_live_session_logic():
    """Keys move and rotate the camera, any motion resets the exposure
    (main.ts:285/:325), 't' cycles the tone mapper, 'q' quits, the ANSI
    canvas holds two pixels a cell (test_view.py:163-195); the same moves
    as the reference's."""
    from raytracer_js_tpu import live as jlive
    from raytracer_js_tpu.models.camera import make_camera as j_make_camera
    from raytracer_js_tpu_torch.live import (LiveState, ansi_frame,
                                             apply_key, tick)

    scene, cfg = to_port_scene(config1_scene()), to_port_cfg(config1_cfg())
    cam = make_camera((0, 0, 0.5), 8, 8, np.pi / 2, np.pi / 2, device="cpu")
    st = LiveState(camera=cam, buf=pex.new_exposure_buffer(8, 8,
                                                           device="cpu"))
    st = tick(st, scene, cfg,
              lambda s, c, seed: render_hdr(s, c, cfg, seed=seed), 3)
    assert int(st.buf.frame_count) == 1
    st2 = apply_key(st, "w")
    assert st2.moved and int(st2.buf.frame_count) == 0
    np.testing.assert_allclose(float(st2.camera.pos[0]),
                               float(st.camera.pos[0]) + 0.1, atol=1e-6)
    st3 = apply_key(apply_key(st2, "LEFT"), "r")
    np.testing.assert_allclose(st3.camera.front.numpy(), [1, 0, 0],
                               atol=1e-6)
    st4 = apply_key(st3, "t")
    assert st4.mapper == 1 and not st4.moved
    assert apply_key(st4, "q").quit
    assert not apply_key(st4, "x").moved
    # every key's pose as the reference's
    jst = jlive.LiveState(camera=j_make_camera((0, 0, 0.5), 8, 8, np.pi / 2,
                                               np.pi / 2),
                          buf=jex.new_exposure_buffer(8, 8))
    pst = LiveState(camera=cam, buf=pex.new_exposure_buffer(8, 8,
                                                            device="cpu"))
    for k in ["w", "a", "LEFT", "UP", "d", " ", "s", "RIGHT", "c", "DOWN"]:
        jst, pst = jlive.apply_key(jst, k), apply_key(pst, k)
        for f in ("pos", "front", "left", "up"):
            np.testing.assert_allclose(getattr(pst.camera, f).numpy(),
                                       np.asarray(getattr(jst.camera, f)),
                                       rtol=1e-6, atol=1e-6)
    img = np.zeros((8, 8, 3), np.float32)
    img[0, 0] = 1.0
    s = ansi_frame(torch.as_tensor(img))
    assert s.count("▀") == 32 and "38;2;255;255;255" in s
    assert s == jlive.ansi_frame(img)
