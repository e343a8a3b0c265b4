"""Render frontend and view: the port against the reference."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from raytracer_js_tpu import make_camera
from raytracer_js_tpu.render import render_hdr as j_render_hdr
from raytracer_js_tpu.render import render_rays as j_render_rays
from raytracer_js_tpu.config import HitBackend as JB
from raytracer_js_tpu.config import ToneMapConfig as JTC
from raytracer_js_tpu.config import ToneMapperKind as JTK
from raytracer_js_tpu.models.camera import pixel_rays
from raytracer_js_tpu.ops import sampling as jsamp
from raytracer_js_tpu.view import exposure as jex
from raytracer_js_tpu.view import screen as jscreen
from raytracer_js_tpu.view import view as jview
import raytracer_js_tpu_torch as rt
from raytracer_js_tpu_torch.render import render_rays as p_render_rays
from raytracer_js_tpu_torch.config import ToneMapConfig as PTC
from raytracer_js_tpu_torch.config import ToneMapperKind as PTK
from raytracer_js_tpu_torch.kernels import trace_fused as tf
from raytracer_js_tpu_torch.models.camera import pixel_rays as p_pixel_rays
from raytracer_js_tpu_torch.utils import parity
from raytracer_js_tpu_torch.view import exposure as pex
from raytracer_js_tpu_torch.view import screen as pscreen
from raytracer_js_tpu_torch.view import view as pview

from scenes import config1_cfg, config1_scene
from test_torch_parity import (ROOT, assert_parity, load_by_path,
                               to_port_camera, to_port_cfg, to_port_scene,
                               to_torch)
from test_torch_trace import both_scene, ext_scene


def _render_both(js, jc, cfg, key=None, grazing=False):
    """Both packages' render_hdr -> the port's image. ``grazing`` admits
    pixels whose primary ray grazes a sphere too closely for float32 to
    fix t to the tolerance (``utils/parity.grazing_prover``): XLA on the
    CPU fuses multiply-adds, the port rounds every operation."""
    key = jax.random.key(0) if key is None else key
    ref = np.asarray(j_render_hdr(js, jc, cfg, key=key))
    ps, pc = to_port_scene(js), to_port_camera(jc)
    out = rt.render_hdr(ps, pc, to_port_cfg(cfg),
                        seed=int(jsamp.seed_from_key(key)))
    assert out.shape == ref.shape and out.dtype == torch.float32
    zeros = np.zeros(ref.shape[:2], np.int32)
    prover = parity.grazing_prover(ps, *p_pixel_rays(pc)) if grazing else None
    assert_parity(out, zeros, ref, zeros, prove_rounding=prover)
    return out


@pytest.mark.parametrize("backend", [JB.FUSED, JB.BRUTE])
def test_render_hdr_config1(backend):
    js = config1_scene(with_glass=True, with_tri=True)
    jc = make_camera((0.0, 0.0, 0.5), 32, 32, np.pi / 2, np.pi / 2)
    _render_both(js, jc, config1_cfg(backend=backend))


def test_render_hdr_fused_rough_spp2():
    js = ext_scene(trans=True, rough=0.6)
    jc = make_camera((0.0, 0.0, 0.5), 24, 16, np.pi / 2, np.pi / 3)
    from raytracer_js_tpu import RenderConfig

    _render_both(js, jc, RenderConfig(refmax=2, spp=2, backend=JB.FUSED),
                 key=jax.random.key(11))


def test_render_hdr_fused_routes_both_scenes_to_brute():
    from raytracer_js_tpu import RenderConfig

    jc = make_camera((0.0, 0.0, 0.5), 12, 12, np.pi / 2, np.pi / 2)
    cfg = RenderConfig(refmax=3, backend=JB.FUSED, fresnel_both=True)
    out = _render_both(both_scene(), jc, cfg, key=jax.random.key(7))
    brute = rt.render_hdr(to_port_scene(both_scene()), to_port_camera(jc),
                          to_port_cfg(RenderConfig(refmax=3,
                                                   fresnel_both=True)),
                          seed=int(jsamp.seed_from_key(jax.random.key(7))))
    assert torch.equal(out, brute)


def test_render_rays_fused():
    js = config1_scene(with_glass=True, with_tri=True)
    cfg = config1_cfg(backend=JB.FUSED)
    org, d = pixel_rays(make_camera((0.1, 0.2, 0.5), 16, 16, np.pi / 2,
                                    np.pi / 2))
    rid = jnp.arange(org.shape[0], dtype=jnp.int32)
    ref = np.asarray(j_render_rays(js, cfg, org, d, jax.random.key(0), rid))
    out = p_render_rays(to_port_scene(js), to_port_cfg(cfg), to_torch(org),
                        to_torch(d))
    zeros = np.zeros(ref.shape[0], np.int32)
    assert_parity(out, zeros, ref, zeros)
    assert tf.LAUNCHES == {"frame": 0, "rays": 0}


def _many_spheres(n):
    b = rt.SceneBuilder()
    m = b.add_material(rt.ResponseType.REFLECTION)
    tex = b.add_solid_texture((0.5, 0.5, 0.5))
    rng = np.random.default_rng(0)
    for c in rng.uniform(-5.0, 5.0, (n, 3)):
        b.add_sphere(c + [10.0, 0.0, 0.0], 0.1, m, tex)
    return b.build(device="cpu")


@pytest.mark.parametrize("backend", ["PALLAS", "OCTREE", "TILED"])
def test_unported_backends_raise(backend):
    """What each backend ported runs: OCTREE without an accel (the dense
    search, as the reference falls back) and with one (the grid DDA, the
    dense frame to rtol 1e-5), PALLAS's
    listed and culled variants (B6, B8) and TILED on scenes above
    ``TILED_MIN_PRIMS`` (kernels B7 and B6; smaller ones render on
    PALLAS)."""
    from raytracer_js_tpu_torch.kernels import nearest_hit as nh
    from raytracer_js_tpu_torch.render import TILED_MIN_PRIMS

    ps = to_port_scene(config1_scene())
    pc = to_port_camera(make_camera((0, 0, 0.5), 8, 8, 1.0, 1.0))
    cfg = rt.RenderConfig(refmax=2, backend=rt.HitBackend[backend])
    if backend == "PALLAS":
        org, d = torch.zeros((2, 3)), torch.ones((2, 3))
        # a tile bound that reaches everything: B8 is B4
        tb = torch.tensor([[0.0, 0.0, 0.0, 1e3]])
        assert all(torch.equal(a, b) for a, b in zip(
            nh.nearest_hit_pallas(ps, org, d, tile_bounds=tb),
            nh.nearest_hit_pallas_plain(ps, org, d)))
        ids = (torch.zeros((1, 1), dtype=torch.int32), torch.zeros((1, 1)))
        assert all(torch.equal(a, b) for a, b in zip(
            nh.nearest_hit_pallas(ps, org, d, tile_ids=ids),
            nh.nearest_hit_pallas_plain(ps, org, d)))
    elif backend == "OCTREE":
        brute = rt.render_hdr(ps, pc, rt.RenderConfig(
            refmax=2, backend=rt.HitBackend.BRUTE))
        assert torch.equal(rt.render_hdr(ps, pc, cfg), brute)
        from raytracer_js_tpu_torch.models.camera import pixel_rays as rays

        org, d = rays(pc)
        assert torch.equal(p_render_rays(ps, cfg, org, d),
                           brute.reshape(-1, 3))
        from raytracer_js_tpu_torch.accel.octree import build_octree

        accel = build_octree(ps, rt.OctreeConfig(max_depth=3))
        img = rt.render_hdr(ps, pc, cfg, accel=accel)
        torch.testing.assert_close(img, brute, rtol=1e-5, atol=1e-6)
        assert torch.equal(p_render_rays(ps, cfg, org, d, accel=accel),
                           img.reshape(-1, 3))
    else:
        big = _many_spheres(TILED_MIN_PRIMS + 1)
        img = rt.render_hdr(big, pc, cfg)
        pallas = rt.render_hdr(big, pc, rt.RenderConfig(
            refmax=2, backend=rt.HitBackend.PALLAS))
        assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
        torch.testing.assert_close(img, pallas, rtol=1e-5, atol=1e-6)


def test_render_hdr_pallas_config1():
    """PALLAS on config 1 (7 prims: kernel B3's plain version) against the
    reference's PALLAS render."""
    from raytracer_js_tpu import RenderConfig

    js = config1_scene(with_glass=True, with_tri=True)
    jc = make_camera((0.0, 0.0, 0.5), 32, 32, np.pi / 2, np.pi / 2)
    _render_both(js, jc, RenderConfig(refmax=3, backend=JB.PALLAS))


@pytest.mark.parametrize("both", [False, True])
def test_render_hdr_tiled_routes_to_pallas(both):
    """TILED at or below TILED_MIN_PRIMS prims, and on BOTH scenes,
    renders exactly as PALLAS."""
    from raytracer_js_tpu import RenderConfig

    js = both_scene() if both else config1_scene(True, True)
    jc = make_camera((0.0, 0.0, 0.5), 16, 12, np.pi / 2, np.pi / 3)
    cfg = RenderConfig(refmax=3, backend=JB.TILED, fresnel_both=both)
    out = _render_both(js, jc, cfg, key=jax.random.key(3))
    pallas = rt.render_hdr(to_port_scene(js), to_port_camera(jc),
                           rt.RenderConfig(refmax=3,
                                           backend=rt.HitBackend.PALLAS,
                                           fresnel_both=both),
                           seed=int(jsamp.seed_from_key(jax.random.key(3))))
    assert torch.equal(out, pallas)


def test_render_rays_pallas_headline_camera_class():
    """render_rays with PALLAS against the reference's, on rays that are
    not a camera grid (random origins and lengths)."""
    from raytracer_js_tpu import RenderConfig

    js = config1_scene(with_glass=True, with_tri=True)
    cfg = RenderConfig(refmax=3, backend=JB.PALLAS)
    rng = np.random.default_rng(2)
    org = rng.uniform([-1, -2, 0], [2, 2, 1.5], (200, 3)).astype(np.float32)
    d = rng.normal(size=(200, 3)).astype(np.float32)
    rid = jnp.arange(200, dtype=jnp.int32)
    ref = np.asarray(j_render_rays(js, cfg, jnp.asarray(org), jnp.asarray(d),
                                   jax.random.key(0), rid))
    out = p_render_rays(to_port_scene(js), to_port_cfg(cfg), to_torch(org),
                        to_torch(d))
    zeros = np.zeros(ref.shape[0], np.int32)
    assert_parity(out, zeros, ref, zeros)


def _hdr(seed=0, h=16, w=20):
    rng = np.random.default_rng(seed)
    return (rng.lognormal(-1.0, 1.5, (h, w, 3))).astype(np.float32)


def test_exposure_accumulate_and_luma():
    jb, pb = jex.new_exposure_buffer(16, 20), pex.new_exposure_buffer(
        16, 20, device="cpu")
    for s in range(3):
        f = _hdr(s)
        jb = jex.accumulate(jb, jnp.asarray(f))
        pb = pex.accumulate(pb, torch.as_tensor(f))
    np.testing.assert_allclose(pb.pixels.numpy(), np.asarray(jb.pixels),
                               rtol=1e-6)
    assert int(pb.frame_count) == int(jb.frame_count) == 3
    np.testing.assert_allclose(pex.luma(pb.pixels).numpy(),
                               np.asarray(jex.luma(jb.pixels)), rtol=1e-6)
    capped = pex.new_exposure_buffer(16, 20, max_frames=1, device="cpu")
    capped = pex.accumulate(pex.accumulate(capped, torch.ones(16, 20, 3)),
                            torch.zeros(16, 20, 3))
    assert int(capped.frame_count) == 1 and float(capped.pixels.min()) == 0.5


@pytest.mark.parametrize("kind", ["IDENTITY", "STDDEV_AROUND_MEAN",
                                  "ABSDEV_AROUND_MEAN", "DR_LIMITED"])
def test_tonemap_and_draw(kind):
    f = _hdr(4)
    jb = jex.accumulate(jex.new_exposure_buffer(16, 20), jnp.asarray(f))
    pb = pex.accumulate(pex.new_exposure_buffer(16, 20, device="cpu"),
                        torch.as_tensor(f))
    j = np.asarray(jview.draw(jb, JTC(kind=JTK[kind], dynamic_range=5)))
    p = pview.draw(pb, PTC(kind=PTK[kind], dynamic_range=5)).numpy()
    np.testing.assert_allclose(p, j, rtol=1e-5, atol=1e-6)
    assert p.min() >= 0.0 and p.max() <= 1.0


def test_write_png_and_npy(tmp_path):
    from PIL import Image

    img = np.linspace(0, 1, 8 * 6 * 3, dtype=np.float32).reshape(8, 6, 3)
    path = pscreen.write_png(tmp_path / "port.png", torch.as_tensor(img))
    ref = jscreen.write_png(tmp_path / "ref.png", img)
    assert path.suffix == ".png"
    np.testing.assert_array_equal(np.asarray(Image.open(path)),
                                  np.asarray(Image.open(ref)))
    np.testing.assert_array_equal(pscreen.to_rgba(img), jscreen.to_rgba(img))
    npy = pscreen.write_npy(tmp_path / "hdr", torch.as_tensor(img))
    np.testing.assert_array_equal(np.load(npy), img)


def test_chip_smoke_headline_scene_is_bench_build_scene(monkeypatch):
    """The smoke test's headline scene is the benchmark's, array for array.
    bench.py sets a default JAX cache directory in the environment; the
    monkeypatch keeps it from leaking into later tests' subprocesses."""
    from test_torch_scene_camera import assert_same_scene

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    bench = load_by_path("bench", ROOT / "bench.py")
    smoke = load_by_path("chip_smoke", ROOT / "chip_smoke.py")
    port, ref = smoke.headline_scene(device="cpu"), bench.build_scene(50)
    assert_same_scene(port, ref)
    assert port.n_prims == 52 and port.n_spheres == 51
