"""The TILED frame candidate tables (``accel/candidates``), the TILED
dispatch of ``render_hdr`` on an image scene, and the smoke test's config-4
scene: the port against the reference.

Tables and counts are held bit for bit (the host build is numpy, expression
for expression). Frames: the port's parity rule, allclose(rtol=1e-5,
atol=1e-6) with proven winner flips at most 0.1% of the pixels."""
import inspect

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import raytracer_js_tpu as jrt
from raytracer_js_tpu import RenderConfig, make_camera
from raytracer_js_tpu.accel import candidates as jcand
from raytracer_js_tpu.config import HitBackend as JB
from raytracer_js_tpu.render_tiled import frame_tables as j_frame_tables
import raytracer_js_tpu_torch as prt
from raytracer_js_tpu_torch import render_tiled as prtl
from raytracer_js_tpu_torch.accel import candidates as pcand
from raytracer_js_tpu_torch.kernels import trace_tiled as ptt
from raytracer_js_tpu_torch.models.camera import pixel_rays
from raytracer_js_tpu_torch.utils import parity

from test_tiled_fast import _tiny_scene
from test_torch_parity import (ROOT, assert_parity, load_by_path,
                               to_port_camera, to_port_cfg, to_port_scene)
from test_torch_scene_camera import assert_same_scene
from test_torch_textures import mixed_images_scene


def _mixed_classes():
    """Spheres, boxes and triangles, glass (mode 3), an emitter, and an
    image-textured sphere (packed rgb 1)."""
    b = jrt.SceneBuilder(atlas_hw=(8, 8))
    b.set_sky(b.add_solid_texture((0.3, 0.4, 0.6)))
    diffuse = b.add_material(jrt.ResponseType.REFLECTION)
    mirror = b.add_material(jrt.ResponseType.REFLECTION, mirror=True)
    light = b.add_material(jrt.ResponseType.REFLECTION, light=True)
    glass = b.add_material(jrt.ResponseType.TRANSMISSION)
    img = b.add_image_texture(np.random.default_rng(1).uniform(
        0.0, 1.0, (8, 8, 3)).astype(np.float32))
    rng = np.random.default_rng(4)
    pal = [b.add_solid_texture(rng.uniform(0.2, 1.0, 3)) for _ in range(4)]
    b.add_box((0.0, 0.0, -21.0), 40.0, diffuse, pal[0])
    b.add_box((5.0, -2.0, 0.5), (1.0, 0.6, 1.4), mirror, pal[1])
    for i in range(40):
        c = rng.uniform([2.5, -4.0, -0.3], [9.0, 4.0, 3.0], 3)
        b.add_sphere(c, float(rng.uniform(0.1, 0.5)),
                     (diffuse, mirror, glass)[i % 3],
                     img if i % 7 == 0 else pal[i % 4],
                     b.add_substance(1.4) if i % 3 == 2 else -1)
    for i in range(12):
        v0 = rng.uniform([3.0, -3.0, -0.5], [8.0, 3.0, 2.5], 3)
        b.add_triangle(v0, v0 + rng.uniform(-0.8, 0.8, 3),
                       v0 + rng.uniform(-0.8, 0.8, 3), diffuse, pal[i % 4])
    b.add_sphere((5.0, 0.0, 5.0), 1.0, light, pal[2])
    return b.build()


_CASES = {
    # one tile, and partial edge tiles on an off-grid camera
    "tiny_one_tile": (_tiny_scene, ((0.0, 0.0, 0.5), 128, 32, np.pi / 2,
                                    np.pi / 8)),
    "tiny_edge_tiles": (_tiny_scene, ((0.05, -0.1, 0.45), 150, 40, 1.45,
                                      1.2)),
    "mixed_classes": (_mixed_classes, ((0.1, 0.2, 0.5), 131, 37, 1.5, 1.1)),
}


@pytest.mark.parametrize("name", sorted(_CASES))
def test_frame_candidates_bit_equal(name):
    make, cam_args = _CASES[name]
    js = make()
    jc = make_camera(*cam_args)
    j_tab, j_cnt, j_cmax = jcand.frame_candidates(js, jc, 32, 128)
    p_tab, p_cnt, p_cmax = pcand.frame_candidates(
        to_port_scene(js), to_port_camera(jc), ptt.TILE_SUB, ptt.LANE)
    assert p_cmax == j_cmax and p_cmax % ptt.CHUNK == 0
    assert p_tab.dtype == torch.float32 and p_cnt.dtype == torch.float32
    np.testing.assert_array_equal(p_tab.numpy(), np.asarray(j_tab))
    np.testing.assert_array_equal(p_cnt.numpy(), np.asarray(j_cnt))
    raw_j = jcand.frame_candidates(js, jc, 32, 128, raw=True)
    raw_p = pcand.frame_candidates(to_port_scene(js), to_port_camera(jc),
                                   32, 128, raw=True)
    for a, b in zip(raw_p, raw_j):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_frame_tables_and_overflow():
    js = _mixed_classes()
    jc = make_camera((0.1, 0.2, 0.5), 131, 37, 1.5, 1.1)
    ps, pc = to_port_scene(js), to_port_camera(jc)
    tab, cnts, c_max, grid = prtl.frame_tables(ps, pc)
    j_tab, j_cnt, j_cmax, j_grid = j_frame_tables(js, jc)
    np.testing.assert_array_equal(tab.numpy(), np.asarray(j_tab))
    assert c_max == j_cmax
    # the packet rounds' cell grid, at the default row budget
    assert isinstance(grid, pcand.CellGrid)
    assert (grid.c_max, grid.budget, grid.base) == (
        j_grid.c_max, j_grid.budget, j_grid.base)
    # the candidate counts cover all three classes
    assert (cnts[:, 0:3].sum(dim=0) > 0).all()
    with pytest.raises(ValueError, match="overflow"):
        pcand.frame_candidates(ps, pc, 32, 128, c_max=16)


def test_bounding_spheres_and_scene_bbox():
    js = _mixed_classes()
    ps = to_port_scene(js)
    jc, jr = jcand.bounding_spheres_jnp(js)
    pc, pr = pcand.bounding_spheres(ps)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(pr.numpy(), np.asarray(jr), rtol=1e-6)
    from raytracer_js_tpu.kernels import trace_tiled as jtt

    for a, b in zip(ptt._scene_bbox(ps), jtt._scene_bbox(js)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_render_hdr_tiled_image_scene(monkeypatch):
    """render_hdr TILED on an image scene (image sky, nearest and bilinear
    textures) with cached tables: the record pass on the solidified twin
    plus the flat replay shading, against the reference's. The camera is
    off the texel grid."""
    js = mixed_images_scene(jrt)
    jc = make_camera((0.05, -0.1, 0.4), 29, 23, 1.45, 1.2)
    cfg = RenderConfig(refmax=3, backend=JB.TILED)
    ref = np.asarray(jrt.render_hdr(js, jc, cfg, key=jax.random.key(0),
                                    tables=j_frame_tables(js, jc)))
    ps, pc = to_port_scene(js), to_port_camera(jc)
    calls = []
    real = prtl._replay_shaded_frame

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    # render_hdr checks grad once, then runs the frame's unchecked body
    monkeypatch.setattr(prtl, "_replay_shaded_frame", spy)
    out = prt.render_hdr(ps, pc, to_port_cfg(cfg),
                         tables=prtl.frame_tables(ps, pc))
    assert calls == [1]
    zeros = np.zeros(ref.shape[:2], np.int32)
    assert_parity(out, zeros, ref, zeros,
                  prove_rounding=parity.grazing_prover(ps, *pixel_rays(pc)))
    # without tables a scene this small renders on PALLAS, as in the
    # reference
    pallas = prt.render_hdr(ps, pc, prt.RenderConfig(
        refmax=3, backend=prt.HitBackend.PALLAS))
    assert torch.equal(prt.render_hdr(ps, pc, to_port_cfg(cfg)), pallas)


def test_chip_smoke_config4_scene_is_bench_config4(monkeypatch):
    """The smoke test's config-4 scene is the benchmark's, array for array,
    at a small prim count (both scene builds loop in Python); the default
    count is config 4's 100,000."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    bench = load_by_path("bench", ROOT / "bench.py")
    smoke = load_by_path("chip_smoke", ROOT / "chip_smoke.py")
    port, ref = smoke.config4_scene(2000, device="cpu"), bench.build_config4_scene(2000)
    assert_same_scene(port, ref)
    assert (port.n_prims, port.n_spheres, port.n_boxes) == (2000, 1999, 1)
    assert inspect.signature(smoke.config4_scene).parameters[
        "n_prims"].default == 100_000
    cam = smoke.config4_camera("cpu")
    assert (cam.w, cam.h) == (1920, 1088)
    assert cam.fov_v == pytest.approx(np.pi / 2 * 1088 / 1920)
