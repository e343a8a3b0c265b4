"""The OCTREE backend's frames and the TILED transmission frame with the
octree ``accel``, on the port against the reference package and its
oracle (BASELINE configs 1-3 at test sizes; ``tests/test_configs.py``)."""
import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import raytracer_js_tpu as jrt
import raytracer_js_tpu.render_tiled as jrtl
from raytracer_js_tpu.accel.octree import build_octree as j_build
from raytracer_js_tpu.config import HitBackend as JB
from raytracer_js_tpu.config import OctreeConfig as JOctreeConfig
from raytracer_js_tpu.ops import sampling as jsamp
from raytracer_js_tpu.oracle import scalar as oracle
from raytracer_js_tpu.utils.mesh import icosphere as j_icosphere
from raytracer_js_tpu.utils.mesh import mesh_stats as j_mesh_stats
import raytracer_js_tpu_torch as prt
from raytracer_js_tpu_torch import render_tiled as prtl
from raytracer_js_tpu_torch.accel.octree import build_octree
from raytracer_js_tpu_torch.config import OctreeConfig
from raytracer_js_tpu_torch.models.camera import pixel_rays
from raytracer_js_tpu_torch.ops.trace import record_paths
from raytracer_js_tpu_torch.render import render_rays
from raytracer_js_tpu_torch.utils import parity
from raytracer_js_tpu_torch.utils.mesh import icosphere, mesh_stats

from scenes import config1_camera, config1_cfg, config1_scene
from test_configs import config2_scene, config3_scene
from test_torch_parity import (ROOT, assert_parity, load_by_path,
                               to_port_camera, to_port_cfg, to_port_scene)
from test_torch_scene_camera import assert_same_scene
from test_torch_trace import ext_scene


def _port(js, jc, depth):
    ps = to_port_scene(js)
    return ps, to_port_camera(jc), build_octree(
        ps, OctreeConfig(max_depth=depth))


def test_config1_glass_tri_octree_matches_reference_and_brute():
    js = config1_scene(with_glass=True, with_tri=True)
    jc = config1_camera(24, 24)
    jcfg = config1_cfg(backend=JB.OCTREE)
    ref = np.asarray(jrt.render_hdr(js, jc, jcfg,
                                    accel=j_build(js, JOctreeConfig(
                                        max_depth=3))))
    ps, pc, pa = _port(js, jc, 3)
    cfg = to_port_cfg(jcfg)
    img = prt.render_hdr(ps, pc, cfg, accel=pa)
    zeros = np.zeros((pc.h, pc.w), np.int32)
    assert_parity(img, zeros, ref, zeros,
                  prove_rounding=parity.grazing_prover(ps, *pixel_rays(pc)))
    brute = prt.render_hdr(ps, pc, to_port_cfg(config1_cfg()))
    torch.testing.assert_close(img, brute, rtol=1e-5, atol=1e-6)
    # render_rays and record_paths take the same accel
    org, dirs = pixel_rays(pc)
    assert torch.equal(render_rays(ps, cfg, org, dirs, accel=pa),
                       img.reshape(-1, 3))
    rec = record_paths(ps, cfg, org, dirs, accel=pa)
    assert torch.equal(rec, record_paths(
        ps, to_port_cfg(config1_cfg()), org, dirs))


def test_config2_octree_matches_oracle_and_reference():
    js = config2_scene()
    jc = jrt.make_camera((0, 0, 0.5), 24, 24, np.pi / 2, np.pi / 2)
    jcfg = jrt.RenderConfig(refmax=2, backend=JB.OCTREE)
    ps, pc, pa = _port(js, jc, 4)
    img = prt.render_hdr(ps, pc, to_port_cfg(jcfg), accel=pa)
    ref_oracle = oracle.render(js, jc, jrt.RenderConfig(refmax=2))
    np.testing.assert_allclose(img.numpy(), ref_oracle, rtol=0, atol=1e-4)
    ref = np.asarray(jrt.render_hdr(js, jc, jcfg, accel=j_build(
        js, JOctreeConfig(max_depth=4))))
    zeros = np.zeros((pc.h, pc.w), np.int32)
    assert_parity(img, zeros, ref, zeros,
                  prove_rounding=parity.grazing_prover(ps, *pixel_rays(pc)))


def test_config3_5k_mesh_octree_matches_brute():
    """The 5120-triangle mesh class with a depth-4 octree against the dense
    search (``tests/test_configs.py:90-104``)."""
    js = config3_scene(subdiv=4)
    st = mesh_stats(*icosphere(4))
    assert st == j_mesh_stats(*j_icosphere(4))
    assert st["n_tris"] == 5120 and js.n_tris == 5120
    jc = jrt.make_camera((0, 0, 0.5), 32, 32, np.pi / 2, np.pi / 2)
    ps, pc, pa = _port(js, jc, 4)
    img = prt.render_hdr(ps, pc, prt.RenderConfig(
        refmax=2, backend=prt.HitBackend.OCTREE), accel=pa)
    assert bool(torch.isfinite(img).all())
    brute = prt.render_hdr(ps, pc, prt.RenderConfig(refmax=2))
    torch.testing.assert_close(img, brute, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("subdiv", [1, 3])
def test_mesh_stats_equal_the_reference(subdiv):
    v, f = icosphere(subdiv, radius=1.5, center=(1.0, 2.0, 0.0))
    assert mesh_stats(v, f) == j_mesh_stats(*j_icosphere(
        subdiv, radius=1.5, center=(1.0, 2.0, 0.0)))


def test_tiled_transmission_frame_with_accel():
    """A TILED frame of a glass scene (defined, undefined and nested
    substances) with the octree serving its substance query equals the
    same frame with the dense query, and the reference's TILED frame with
    its accel; the image-scene replay wrapper carries the accel too."""
    js = ext_scene(trans=True, rough=0.3)
    jc = jrt.make_camera((0.0, 0.0, 0.5), 97, 45, 1.4, 0.9)
    jcfg = jrt.RenderConfig(refmax=3, backend=JB.TILED)
    key = jax.random.key(2)
    ref, j_diag = jrtl.render_frame_tiled(
        js, jcfg, jc, key=key, with_diag=True,
        accel=j_build(js, JOctreeConfig(max_depth=3)))
    assert int(j_diag["unresolved"]) == 0
    ps, pc, pa = _port(js, jc, 3)
    cfg = to_port_cfg(jcfg)
    seed = int(jsamp.seed_from_key(key))
    tables = prtl.frame_tables(ps, pc)
    img, diag = prtl.render_frame_tiled(ps, cfg, pc, tables=tables,
                                        seed=seed, accel=pa, with_diag=True)
    assert int(diag["unresolved"]) == 0
    dense = prtl.render_frame_tiled(ps, cfg, pc, tables=tables, seed=seed)
    assert torch.equal(img, dense)
    zeros = np.zeros((pc.h, pc.w), np.int32)
    assert_parity(img, zeros, np.asarray(ref), zeros,
                  prove_rounding=parity.grazing_prover(ps, *pixel_rays(pc)))
    assert torch.equal(prt.render_hdr(ps, pc, cfg, seed=seed, tables=tables,
                                      accel=pa), img)
    shaded = prtl.render_frame_tiled_replay_shaded(
        ps, cfg, pc, tables=tables, seed=seed, accel=pa)
    torch.testing.assert_close(shaded, img, rtol=1e-4, atol=1e-5)


def test_chip_smoke_octree_scenes():
    """The smoke test's config-2 scene is ``tests/test_configs.py``'s array
    for array; its glass variant of config 4 keeps config 4's layout, with
    every third small sphere glass of a 1.5 substance and every 30th glass
    of undefined substance."""
    smoke = load_by_path("chip_smoke", ROOT / "chip_smoke.py")
    assert_same_scene(smoke.config2_scene(device="cpu"), config2_scene())
    cam = smoke.config2_camera("cpu")
    assert (cam.w, cam.h) == (256, 256)
    glass = smoke.config4_glass_scene(2000, device="cpu")
    c4 = smoke.config4_scene(2000, device="cpu")
    assert torch.equal(glass.sphere_center, c4.sphere_center)
    assert torch.equal(glass.sphere_radius, c4.sphere_radius)
    assert glass.has_transmission and not c4.has_transmission
    resp = glass.materials.response[glass.prim_material.long()]
    trans = resp == int(prt.ResponseType.TRANSMISSION)
    i = torch.arange(glass.n_spheres)
    small = i < glass.n_spheres - 1
    assert torch.equal(trans[:glass.n_spheres][small],
                       ((i % 3 == 0) | (i % 30 == 1))[small])
    sub = glass.prim_substance[:glass.n_spheres]
    assert torch.equal(sub[small] >= 0, (i % 3 == 0)[small])
    assert float(glass.sub_refr[int(sub[0])]) == pytest.approx(1.5)
