"""Image textures, cube-map skies, the atlas builder, meshes, and the PALLAS
render path on image scenes: the port against the reference.

Tolerance: the port's parity rule, allclose(rtol=1e-5, atol=1e-6). The render
cameras are off the texel grid (odd sizes, irrational field of view): on a
grid-aligned camera an equirect u or v can land exactly on a texel
boundary, where one ULP of atan2 picks the neighbouring texel."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import raytracer_js_tpu as jrt
from raytracer_js_tpu import make_camera
from raytracer_js_tpu.config import HitBackend as JB
from raytracer_js_tpu.models import textures as jtex
from raytracer_js_tpu.models.camera import pixel_rays
from raytracer_js_tpu.ops.trace import sky_color as j_sky_color
from raytracer_js_tpu.render import render_rays as j_render_rays
from raytracer_js_tpu.utils import mesh as jmesh
import raytracer_js_tpu_torch as prt
from raytracer_js_tpu_torch.kernels import nearest_hit as nh
from raytracer_js_tpu_torch.kernels import trace_fused as tf
from raytracer_js_tpu_torch.models import textures as ptex
from raytracer_js_tpu_torch.ops import trace as ptrace
from raytracer_js_tpu_torch.render import render_rays as p_render_rays
from raytracer_js_tpu_torch.utils import mesh as pmesh

from scenes import config1_scene
from test_torch_parity import (ROOT, assert_parity, build_cpu, load_by_path,
                               to_port_camera, to_port_cfg, to_port_scene,
                               to_torch)
from test_torch_render import _render_both
from test_torch_scene_camera import assert_same_scene

#: an off-grid camera (see the module docstring)
_CAM = ((0.05, -0.1, 0.4), 29, 23, 1.45, 1.2)


def _cam(**kw):
    return make_camera(*_CAM, **kw)


# ---------------------------------------------------------------------------
# Scene recipes, run on either package's builder (``pkg`` is the package)
# ---------------------------------------------------------------------------

def box_uv_scene(pkg):
    """``tests/test_golden.py:50``: an image-textured box (six-face uv)."""
    b = pkg.SceneBuilder(atlas_hw=(16, 16))
    b.set_sky(b.add_solid_texture((0.1, 0.1, 0.1)))
    m = b.add_material(pkg.ResponseType.REFLECTION)
    rng = np.random.default_rng(4)
    tex = b.add_image_texture(rng.uniform(0.0, 1.0, (16, 16, 3))
                              .astype(np.float32))
    b.add_box((4.0, 0.0, 0.0), 2.0, m, tex)
    return build_cpu(b)


def bilinear_scene(pkg, bilinear=True):
    """``tests/test_golden.py:145``: a sphere with a filtered image."""
    img16 = np.random.default_rng(11).uniform(0.0, 1.0, (16, 16, 3)).astype(
        np.float32)
    b = pkg.SceneBuilder(atlas_hw=(16, 16))
    b.set_sky(b.add_solid_texture((0.1, 0.1, 0.1)))
    m = b.add_material(pkg.ResponseType.REFLECTION)
    b.add_sphere((4.0, 0.0, 0.0), 1.5, m,
                 b.add_image_texture(img16, bilinear=bilinear))
    return build_cpu(b)


def sky_box_scene(pkg, image_faces):
    """``tests/test_golden.py:173``: a cube-map sky around a mirror ball."""
    rng = np.random.default_rng(12)
    b = pkg.SceneBuilder(atlas_hw=(8, 8))
    m = b.add_material(pkg.ResponseType.REFLECTION, mirror=True)
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
    return build_cpu(b)


def mixed_images_scene(pkg):
    """``tests/test_golden.py:221``: native-size images of two sizes, an
    image sky, nearest and bilinear sampling."""
    yy, xx = np.mgrid[0:97, 0:53].astype(np.float32)
    big = np.stack([yy / 97, xx / 53, 0.5 + 0.3 * yy / 97], -1)
    yy, xx = np.mgrid[0:17, 0:23].astype(np.float32)
    small = np.stack([0.2 + 0.7 * xx / 23, yy / 17, 0.8 - 0.5 * yy / 17],
                     -1).astype(np.float32)
    b = pkg.SceneBuilder()
    b.set_sky(b.add_image_texture(big))
    t_small = b.add_image_texture(small)
    t_big_bl = b.add_image_texture(big, bilinear=True)
    diffuse = b.add_material(pkg.ResponseType.REFLECTION)
    light = b.add_material(pkg.ResponseType.REFLECTION, light=True)
    b.add_sphere((4.0, -1.2, 0.0), 1.0, diffuse, t_small)
    b.add_sphere((4.0, 1.2, 0.0), 1.0, diffuse, t_big_bl)
    b.add_sphere((4.0, 0.0, 4.0), 0.8, light,
                 b.add_solid_texture((1.0, 1.0, 1.0)))
    return build_cpu(b)


_RECIPES = {
    "box_uv": box_uv_scene,
    "bilinear": bilinear_scene,
    "nearest": lambda pkg: bilinear_scene(pkg, bilinear=False),
    "sky_box_solid": lambda pkg: sky_box_scene(pkg, False),
    "sky_box_image": lambda pkg: sky_box_scene(pkg, True),
    "mixed_images": mixed_images_scene,
}


def _bench():
    return load_by_path("bench", ROOT / "bench.py")


def _smoke():
    return load_by_path("chip_smoke", ROOT / "chip_smoke.py")


# ---------------------------------------------------------------------------
# Builder, atlas and meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(_RECIPES))
def test_builder_atlas_matches_reference(name):
    port, ref = _RECIPES[name](prt), _RECIPES[name](jrt)
    assert_same_scene(port, ref)
    assert port.textures.has_images == (name != "sky_box_solid")


def test_builder_resizes_to_atlas_hw_and_clears_the_sky_box():
    for pkg in (prt, jrt):
        b = pkg.SceneBuilder(atlas_hw=(4, 6))
        b.add_image_texture(np.arange(9 * 5 * 3, dtype=np.float32)
                            .reshape(9, 5, 3) / 135)
        sky = b.add_solid_texture((0.2, 0.3, 0.4))
        b.set_sky_box([sky] * 6)
        b.set_sky(sky)
        if pkg is prt:
            port = b.build(device="cpu")
        else:
            ref = b.build()
    assert_same_scene(port, ref)
    assert port.sky_box is None and port.textures.atlas.shape == (1, 4, 6, 3)


@pytest.mark.parametrize("subdiv", [0, 1, 2, 3])
def test_icosphere_and_grid_plane(subdiv):
    for got, want in ((pmesh.icosphere(subdiv, 1.2, (6.0, 0.0, 1.0)),
                       jmesh.icosphere(subdiv, 1.2, (6.0, 0.0, 1.0))),
                      (pmesh.grid_plane(3, 2 + subdiv, 2.0, (0, 0, -1)),
                       jmesh.grid_plane(3, 2 + subdiv, 2.0, (0, 0, -1)))):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert pmesh.icosphere(subdiv)[1].shape == (20 * 4 ** subdiv, 3)


def test_chip_smoke_config3_scene_is_bench_config3(monkeypatch):
    """The smoke test's config-3 scene is the benchmark's, array for array
    (bench.py sets a default JAX cache directory in the environment; the
    monkeypatch keeps it from leaking into later tests' subprocesses)."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    port, ref = _smoke().config3_scene(device="cpu"), _bench().build_config3_scene()
    assert_same_scene(port, ref)
    assert (port.n_prims, port.n_tris, port.n_spheres) == (5124, 5120, 3)
    assert port.textures.has_images and not port.textures.has_bilinear


# ---------------------------------------------------------------------------
# Sampling and the sky
# ---------------------------------------------------------------------------

def test_sample_nearest_and_bilinear_mixed_sizes():
    js = mixed_images_scene(jrt)
    ps = to_port_scene(js)
    rng = np.random.default_rng(0)
    n = 3000
    tex_id = rng.integers(0, ps.textures.kind.shape[0], n).astype(np.int32)
    u = rng.uniform(0.0, 1.0, n).astype(np.float32)
    v = rng.uniform(0.0, 1.0, n).astype(np.float32)
    u[:4] = [0.0, 1.0 - 2.0 ** -23, 0.5, 1.0]      # edges and the clamp
    v[:4] = [1.0 - 2.0 ** -23, 0.0, 1.0, 0.5]
    ref = np.asarray(jtex.sample(js.textures, jnp.asarray(tex_id),
                                 jnp.asarray(u), jnp.asarray(v)))
    out = ptex.sample(ps.textures, torch.as_tensor(tex_id),
                      torch.as_tensor(u), torch.as_tensor(v))
    assert out.shape == (n, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)
    kinds = set(ps.textures.kind[torch.as_tensor(tex_id).long()].tolist())
    assert kinds == {0, 1, 2}


def test_sample_solid_only_is_a_row_gather():
    ps = to_port_scene(config1_scene())
    ids = torch.tensor([0, 3, 99, -2])
    got = ptex.sample(ps.textures, ids, torch.zeros(4), torch.zeros(4))
    want = ps.textures.solid_rgb[torch.tensor([0, 3, 4, 0])]
    assert torch.equal(got, want)


def _directions(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    axes = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                     [0, 0, 1], [0, 0, -1], [1, 1, 1], [-1, 1, -1]],
                    np.float32)
    return np.concatenate([axes, d * rng.uniform(0.3, 3.0, (n, 1))
                           .astype(np.float32)])


@pytest.mark.parametrize("name", ["sky_box_solid", "sky_box_image",
                                  "mixed_images"])
def test_sky_color(name):
    """Cube-map skies (solid and image faces) and an equirect image sky."""
    js = _RECIPES[name](jrt)
    d = _directions(600, seed=3)
    ref = np.asarray(j_sky_color(js, jnp.asarray(d)))
    out = ptrace.sky_color(to_port_scene(js), torch.as_tensor(d))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)
    if name == "sky_box_solid":
        np.testing.assert_array_equal(
            out[:6].numpy(), [(1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0),
                              (1, 0, 1), (0, 1, 1)])


# ---------------------------------------------------------------------------
# The PALLAS render path on image scenes
# ---------------------------------------------------------------------------

def _count_plain_searches(monkeypatch):
    """Count calls of B3's and B4's plain versions."""
    calls = {"scalar": 0, "dense": 0}
    for kind, name in (("scalar", "nearest_hit_pallas_scalar_plain"),
                       ("dense", "nearest_hit_pallas_plain")):
        fn = getattr(nh, name)

        def run(*a, _fn=fn, _kind=kind, **kw):
            calls[_kind] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(nh, name, run)
    return calls


@pytest.mark.parametrize("subdiv,kernel", [(2, "scalar"), (3, "dense")])
def test_render_hdr_pallas_config3_class(monkeypatch, subdiv, kernel):
    """BASELINE config 3 cut to a subdivision-2 or -3 icosphere (324 or
    1284 prims: B3 or B4), refmax 3, with its checker texture and image
    sky."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    js = _bench().build_config3_scene(subdiv=subdiv)
    calls = _count_plain_searches(monkeypatch)
    out = _render_both(js, make_camera((0.0, 0.0, 0.5), 31, 27, 1.5, 1.4),
                       jrt.RenderConfig(refmax=3, backend=JB.PALLAS),
                       grazing=True)
    assert calls == {"scalar": 0, "dense": 0, kernel: 3}
    assert bool(torch.isfinite(out).all()) and float(out.max()) > 0


@pytest.mark.parametrize("name", sorted(_RECIPES))
def test_render_hdr_pallas_golden_scenes(name):
    refmax = 2 if name.startswith("sky_box") else 1
    _render_both(_RECIPES[name](jrt), _cam(),
                 jrt.RenderConfig(refmax=refmax, backend=JB.PALLAS),
                 grazing=True)


@pytest.mark.parametrize("name", ["mixed_images", "sky_box_image"])
def test_render_rays_pallas(name):
    """The same rays through both packages' ``render_rays``."""
    js = _RECIPES[name](jrt)
    cfg = jrt.RenderConfig(refmax=3, backend=JB.PALLAS)
    org, d = pixel_rays(_cam(rot_h=0.2, rot_v=-0.1))
    rid = jnp.arange(org.shape[0], dtype=jnp.int32)
    ref = np.asarray(j_render_rays(js, cfg, org, d, jax.random.key(0), rid))
    out = p_render_rays(to_port_scene(js), to_port_cfg(cfg), to_torch(org),
                        to_torch(d))
    zeros = np.zeros(ref.shape[0], np.int32)
    assert_parity(out, zeros, ref, zeros)


def test_fused_on_image_scenes_takes_the_loop():
    """FUSED on an image-textured or cube-map scene renders through the
    wavefront loop, exactly as BRUTE does, and launches nothing."""
    for name in ("box_uv", "sky_box_solid"):
        js = _RECIPES[name](jrt)
        out = _render_both(js, _cam(), jrt.RenderConfig(refmax=2,
                                                        backend=JB.FUSED))
        brute = prt.render_hdr(to_port_scene(js), to_port_camera(_cam()),
                               prt.RenderConfig(refmax=2))
        assert torch.equal(out, brute)
    assert tf.LAUNCHES == {"frame": 0, "rays": 0}
