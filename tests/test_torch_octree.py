"""The port's octree (``raytracer_js_tpu_torch.accel.octree``) against the
reference package's: the host build array for array, the directory and
walkers, the per-candidate device tests, the grid DDA and the grid
substance query."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from raytracer_js_tpu.accel import octree as jo
from raytracer_js_tpu.config import OctreeConfig as JOctreeConfig
from raytracer_js_tpu.models.scene import prim_aabbs as j_prim_aabbs
from raytracer_js_tpu.ops.trace import substance_refr_at as j_substance
from raytracer_js_tpu_torch.accel import octree as po
from raytracer_js_tpu_torch.config import OctreeConfig
from raytracer_js_tpu_torch.models.scene import prim_aabbs
from raytracer_js_tpu_torch.ops.trace import (nearest_hit_brute,
                                              substance_refr_at)
from raytracer_js_tpu_torch.utils import parity

from test_octree import _random_scene
from test_torch_parity import to_port_scene

_ARRAYS = ("root_lo", "root_size", "coarse_ids", "cell_offsets", "cell_ids",
           "skip_dist")


def _assert_same_accel(pa, ja):
    for k in _ARRAYS:
        a, b = getattr(pa, k).numpy(), np.asarray(getattr(ja, k))
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert (pa.max_depth, pa.l_cut, pa.max_per_cell) == (
        ja.max_depth, ja.l_cut, ja.max_per_cell)


def _rays(n, seed, span=6.0):
    rng = np.random.default_rng(seed)
    org = rng.uniform(-span, span, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return org, d


@pytest.fixture(scope="module")
def mixed():
    js = _random_scene(30)
    return js, to_port_scene(js)


def test_prim_aabbs_equal_the_reference_bit_for_bit(mixed):
    js, ps = mixed
    for a, b in zip(prim_aabbs(ps), j_prim_aabbs(js)):
        assert torch.equal(a, torch.as_tensor(np.array(b)))


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_build_equals_the_reference_bit_for_bit(mixed, depth):
    js, ps = mixed
    pa = po.build_octree(ps, OctreeConfig(max_depth=depth))
    ja = jo.build_octree(js, JOctreeConfig(max_depth=depth))
    _assert_same_accel(pa, ja)
    assert pa.res == 1 << depth and pa.cell_ids.device.type == "cpu"
    # the big straddler is coarse, every small prim is in the grid
    assert ps.n_spheres + ps.n_boxes - 1 in pa.coarse_ids.tolist()


def test_build_empty_scene():
    from raytracer_js_tpu import SceneBuilder

    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0.5, 0.5, 0.5)))
    js = b.build()
    ps = to_port_scene(js)
    pa = po.build_octree(ps, OctreeConfig(max_depth=2), l_cut=0)
    _assert_same_accel(pa, jo.build_octree(js, JOctreeConfig(max_depth=2),
                                           l_cut=0))
    stats = {}
    t, pid = po.nearest_hit_octree(
        ps, pa, torch.zeros((4, 3)),
        torch.tensor([[1.0, 0.0, 0.0]]).repeat(4, 1), stats=stats)
    assert bool((pid == -1).all()) and bool(torch.isinf(t).all())
    assert stats == {"steps": 0, "ray_steps": 0, "tests": 0}


def test_like_pins_shapes_and_refuses_growth(mixed):
    js, ps = mixed
    base_p = po.build_octree(ps, OctreeConfig(max_depth=3))
    base_j = jo.build_octree(js, JOctreeConfig(max_depth=3))
    # move the small prims a little: the rebuild pads to the pinned shapes
    moved_j = js.replace(sphere_center=js.sphere_center + 0.05)
    moved_p = dataclasses.replace(ps, sphere_center=ps.sphere_center + 0.05)
    pa = po.build_octree(moved_p, OctreeConfig(max_depth=3), like=base_p)
    ja = jo.build_octree(moved_j, JOctreeConfig(max_depth=3), like=base_j)
    _assert_same_accel(pa, ja)
    assert pa.cell_ids.shape == base_p.cell_ids.shape
    assert pa.coarse_ids.shape == base_p.coarse_ids.shape
    # a pinned accel of a smaller capacity refuses the rebuild
    tight = dataclasses.replace(base_p, cell_ids=base_p.cell_ids[:3])
    with pytest.raises(ValueError, match="pinned capacity"):
        po.build_octree(ps, OctreeConfig(max_depth=3), like=tight)
    with pytest.raises(ValueError, match="pinned capacity"):
        po.build_octree(ps, OctreeConfig(max_depth=4), like=base_p)


def test_skip_field_fallback_equals_the_reference():
    rng = np.random.default_rng(4)
    occ = rng.uniform(size=(16, 16, 16)) < 0.01
    np.testing.assert_array_equal(po._chebyshev_dist_np(occ, cap=15),
                                  jo._chebyshev_dist_np(occ, cap=15))
    from scipy import ndimage

    exact = ndimage.distance_transform_cdt(~occ, metric="chessboard")
    # the fallback never promises more empty space than there is
    assert (po._chebyshev_dist_np(occ, cap=15) <= exact).all()


def test_covering_levels_and_morton_equal_the_reference():
    rng = np.random.default_rng(0)
    lo = rng.uniform(0, 0.9, (200, 3))
    hi = lo + rng.uniform(1e-3, 0.1, (200, 3))
    for a, b in zip(po.covering_levels(lo, hi, np.zeros(3), 1.0, 6),
                    jo.covering_levels(lo, hi, np.zeros(3), 1.0, 6)):
        np.testing.assert_array_equal(a, b)
    ix, iy, iz = rng.integers(0, 16, (3, 50))
    np.testing.assert_array_equal(po._morton3(ix, iy, iz, 4),
                                  jo._morton3(ix, iy, iz, 4))
    # the insertion-depth invariant (test/octree-entity.test.ts:52-64)
    level, cell = po.covering_levels(np.array([[0.0] * 3, [0.25] * 3]),
                                     np.array([[0.5] * 3, [0.75] * 3]),
                                     np.zeros(3), 1.0, 4)
    assert level.tolist() == [1, 0] and cell[0].tolist() == [0, 0, 0]


def _octant_scene(builder):
    """8 half-size spheres, one per octant of the unit cube."""
    b = builder()
    b.set_sky(b.add_solid_texture((0, 0, 0)))
    m = b.add_material(0)
    t = b.add_solid_texture((1, 1, 1))
    for code in range(8):
        c = np.array([(code >> 0) & 1, (code >> 1) & 1, (code >> 2) & 1])
        b.add_sphere(c * 0.5 + 0.25, 0.25, m, t)
    return b


def test_walkers_equal_the_reference_and_its_itineraries(mixed):
    """walk_cells, octant_code and the reference's canonical one-level
    itineraries (test/octree-space-walker.test.ts:22-36): the diagonal ray
    visits octants [0, 1, 3, 7], its reverse [7, 6, 4, 0]."""
    from raytracer_js_tpu import SceneBuilder

    js = _octant_scene(SceneBuilder).build()
    pa = po.build_octree(to_port_scene(js), OctreeConfig(max_depth=1))
    ja = jo.build_octree(js, JOctreeConfig(max_depth=1))
    d = np.ones(3) / np.sqrt(3)
    start = pa.root_lo.numpy() + 1e-5
    far = pa.root_lo.numpy() + float(pa.root_size) - 1e-5
    assert [po.octant_code(c) for c in po.walk_cells(pa, start, d)] == [
        0, 1, 3, 7]
    assert [po.octant_code(c) for c in po.walk_cells(pa, far, -d)] == [
        7, 6, 4, 0]
    js2, ps2 = mixed
    for depth in (1, 2, 4):
        pa = po.build_octree(ps2, OctreeConfig(max_depth=depth))
        ja = jo.build_octree(js2, JOctreeConfig(max_depth=depth))
        org, dirs = _rays(16, depth)
        for o, dd in zip(org, dirs):
            assert po.walk_cells(pa, o, dd) == jo.walk_cells(ja, o, dd)
        lo = pa.root_lo.numpy()
        # entry from outside the root (octree_space.ts:259-277)
        path = po.walk_cells(pa, lo + np.array(
            [-1.0, 0.1 * float(pa.root_size), 0.1 * float(pa.root_size)]),
            np.array([1.0, 0.0, 0.0]))
        assert path[0][0] == 0 and len(path) == pa.res
    for c in ((0, 0, 0), (1, 0, 1), (1, 1, 1)):
        assert po.octant_code(c) == jo.octant_code(c)


def test_node_directory_and_walk_nodes_equal_the_reference():
    """Ancestors before children, near to far
    (test/octree-space-walker.test.ts:38-71)."""
    from raytracer_js_tpu import SceneBuilder

    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0, 0, 0)))
    m = b.add_material(0)
    t = b.add_solid_texture((1, 1, 1))
    b.add_sphere((0.5, 0.5, 0.5), 0.3, m, t)           # straddles: level 0
    b.add_sphere((0.125, 0.125, 0.125), 0.12, m, t)    # level-2 near corner
    b.add_sphere((0.875, 0.875, 0.875), 0.12, m, t)    # level-2 far corner
    js = b.build()
    ps = to_port_scene(js)
    cfg, jcfg = OctreeConfig(max_depth=2), JOctreeConfig(max_depth=2)
    pdir = po.build_node_directory(ps, cfg)
    jdir = jo.build_node_directory(js, jcfg)
    for a, b_ in zip(pdir, jdir):
        np.testing.assert_array_equal(a, b_)
    pa = po.build_octree(ps, cfg, l_cut=0)
    ja = jo.build_octree(js, jcfg, l_cut=0)
    d = np.ones(3) / np.sqrt(3)
    start = pa.root_lo.numpy() + 1e-5
    stops = po.walk_nodes(pa, pdir, start, d)
    assert stops == jo.walk_nodes(ja, jdir, start, d)
    assert stops[0][0] == 0
    l2 = [s for s in stops if s[0] == 2]
    assert l2[0][1] == (0, 0, 0) and l2[-1][1] == (3, 3, 3)
    empty = to_port_scene(SceneBuilder().build())
    assert all(a.size == 0 for a in po.build_node_directory(empty))


def test_device_queries_equal_the_reference(mixed):
    """prim_hit_t, prim_contains and point_query_candidates per (ray,
    candidate), with padding ids and every class."""
    js, ps = mixed
    rng = np.random.default_rng(2)
    org = rng.uniform(-6, 6, (64, 1, 3)).astype(np.float32)
    pid = rng.integers(-1, ps.n_prims, (64, 7)).astype(np.int32)
    # each (ray, candidate) aims near its candidate's AABB center
    lo, hi = (np.asarray(a) for a in j_prim_aabbs(js))
    aim = 0.5 * (lo + hi)[np.clip(pid, 0, None)] + rng.normal(
        0, 0.4, (64, 7, 3))
    dirs = (aim - org) / np.linalg.norm(aim - org, axis=-1, keepdims=True)
    dirs = dirs.astype(np.float32)
    t_p = po.prim_hit_t(ps, torch.as_tensor(org), torch.as_tensor(dirs),
                        torch.as_tensor(pid))
    t_j = np.asarray(jo.prim_hit_t(js, jnp.asarray(org), jnp.asarray(dirs),
                                   jnp.asarray(pid)))
    np.testing.assert_array_equal(np.isinf(t_p.numpy()), np.isinf(t_j))
    fin = np.isfinite(t_j)
    np.testing.assert_allclose(t_p.numpy()[fin], t_j[fin], rtol=1e-5,
                               atol=1e-6)
    assert fin.sum() > 20
    pid_c = rng.integers(-1, ps.n_prims, (300, 5)).astype(np.int32)
    near = (0.5 * (lo + hi)[np.clip(pid_c, 0, None)]
            + rng.normal(0, 0.3, (300, 5, 3))).astype(np.float32)
    c_p = po.prim_contains(ps, torch.as_tensor(near), torch.as_tensor(pid_c))
    c_j = np.asarray(jo.prim_contains(js, jnp.asarray(near),
                                      jnp.asarray(pid_c)))
    np.testing.assert_array_equal(c_p.numpy(), c_j)
    assert c_j.sum() > 50 and (~c_j).sum() > 50
    pts = rng.uniform(-5, 5, (300, 3)).astype(np.float32)
    for depth in (2, 4):
        pa = po.build_octree(ps, OctreeConfig(max_depth=depth))
        ja = jo.build_octree(js, JOctreeConfig(max_depth=depth))
        cand_p = po.point_query_candidates(pa, torch.as_tensor(pts))
        cand_j = np.asarray(jo.point_query_candidates(ja, jnp.asarray(pts)))
        np.testing.assert_array_equal(cand_p.numpy(), cand_j)


def _step_by_step(scene, accel, org, dir):
    """The reference's full-width masked DDA loop, transcribed to torch
    without compaction: every ray is computed at every step, dead ones
    masked. The specification of ``nearest_hit_octree``'s live-ray loop."""
    n = org.shape[0]
    R = accel.res
    cell_sz = accel.root_size / R
    t_best = torch.full((n,), float("inf"))
    pid_best = torch.full((n,), -1, dtype=torch.int32)
    ids = accel.coarse_ids[None, :].expand(n, -1)
    tc = po.prim_hit_t(scene, org[:, None], dir[:, None], ids)
    t0, j0 = tc.min(dim=1)
    upd = t0 < t_best
    t_best = torch.where(upd, t0, t_best)
    pid_best = torch.where(upd & torch.isfinite(t0), ids.gather(
        1, j0[:, None])[:, 0], pid_best)
    inv = 1.0 / torch.where(dir.abs() < 1e-12,
                            torch.where(dir < 0, -1e-12, 1e-12), dir)
    lo, hi = accel.root_lo, accel.root_lo + accel.root_size
    ta, tb = (lo - org) * inv, (hi - org) * inv
    t_exit = torch.maximum(ta, tb).min(dim=-1).values
    t_cur = torch.clamp(torch.minimum(ta, tb).max(dim=-1).values, min=0.0)
    alive = t_cur <= t_exit
    step_pos = (dir >= 0).float()
    dt_cheb = cell_sz / dir.abs().max(dim=-1).values
    eps_t = 1e-4 * dt_cheb
    j = torch.arange(accel.max_per_cell, dtype=torch.int32)
    nk = accel.cell_ids.shape[0]
    for _ in range(3 * R + 2):
        if not bool(alive.any()):
            break
        p = org + (t_cur + eps_t)[:, None] * dir
        cell = torch.clamp(torch.floor((p - lo) / cell_sz).to(torch.int32),
                           0, R - 1)
        lin = ((cell[:, 0] * R + cell[:, 1]) * R + cell[:, 2]).long()
        base = accel.cell_offsets[lin]
        cnt = accel.cell_offsets[lin + 1] - base
        idx = torch.clamp(base[:, None] + j, 0, nk - 1).long()
        pid = torch.where((j < cnt[:, None]) & alive[:, None],
                          accel.cell_ids[idx], -1)
        t = po.prim_hit_t(scene, org[:, None], dir[:, None], pid)
        t_min, jm = t.min(dim=1)
        upd = t_min < t_best
        t_best = torch.where(upd, t_min, t_best)
        pid_best = torch.where(upd, pid.gather(1, jm[:, None])[:, 0],
                               pid_best)
        nb = lo + (cell.float() + step_pos) * cell_sz
        t_exit_cell = ((nb - org) * inv).min(dim=-1).values
        k = accel.skip_dist[lin].float()
        t_jump = t_cur + torch.clamp(k - 2.0, min=0.0) * dt_cheb
        t_new = torch.maximum(torch.maximum(t_exit_cell, t_jump),
                              t_cur + eps_t)
        done = (~torch.isinf(t_best) & (t_best <= t_new)) | (t_new > t_exit)
        alive_n = alive & ~done
        t_cur = torch.where(alive_n, t_new, t_cur)
        alive = alive_n
    return t_best, torch.where(torch.isfinite(t_best), pid_best, -1)


@pytest.mark.parametrize("depth", [2, 3, 4])
def test_dda_matches_reference_brute_and_the_full_width_loop(mixed, depth):
    js, ps = mixed
    pa = po.build_octree(ps, OctreeConfig(max_depth=depth))
    ja = jo.build_octree(js, JOctreeConfig(max_depth=depth))
    org, dirs = _rays(256, depth)
    o, d = torch.as_tensor(org), torch.as_tensor(dirs)
    stats = {}
    t_p, p_p = po.nearest_hit_octree(ps, pa, o, d, stats=stats)
    assert p_p.dtype == torch.int32 and stats["steps"] >= 1
    assert stats["ray_steps"] >= stats["steps"]
    # the live-ray loop is the full-width loop, bit for bit
    t_s, p_s = _step_by_step(ps, pa, o, d)
    assert torch.equal(t_p, t_s) and torch.equal(p_p, p_s)
    # against the reference's DDA: pids equal but proven flips, t within
    # the rounding of another summation order
    t_j, p_j = jo.nearest_hit_octree(js, ja, jnp.asarray(org),
                                     jnp.asarray(dirs))
    rep = parity.compare_hits(ps, o, d, t_p, p_p,
                              torch.as_tensor(np.array(t_j)),
                              torch.as_tensor(np.array(p_j)),
                              rounding_slack=True)
    assert rep["ok"] and rep["hits"] > 40, rep
    # against the port's dense search (tests/test_octree.py's tolerance:
    # the dense sphere test factors the quadratic)
    t_b, p_b = nearest_hit_brute(ps, o, d)
    hit = p_b >= 0
    np.testing.assert_allclose(t_p[hit].numpy(), t_b[hit].numpy(),
                               rtol=1e-4, atol=1e-6)
    assert torch.equal(p_p[~hit], p_b[~hit])
    assert float((p_p[hit] != p_b[hit]).float().mean()) < 0.02


def test_dda_rays_from_inside_and_axis_parallel(mixed):
    """Origins inside the grid and rays parallel to an axis (the 1e-12
    clamp of the inverse direction) against the full-width loop and the
    reference."""
    js, ps = mixed
    pa = po.build_octree(ps, OctreeConfig(max_depth=3))
    ja = jo.build_octree(js, JOctreeConfig(max_depth=3))
    org, _ = _rays(6 * 8, 11, span=3.0)
    axes = np.repeat(np.concatenate([np.eye(3), -np.eye(3)]), 8, axis=0)
    o, d = torch.as_tensor(org), torch.as_tensor(axes.astype(np.float32))
    t_p, p_p = po.nearest_hit_octree(ps, pa, o, d)
    t_s, p_s = _step_by_step(ps, pa, o, d)
    assert torch.equal(t_p, t_s) and torch.equal(p_p, p_s)
    t_j, p_j = jo.nearest_hit_octree(js, ja, jnp.asarray(org),
                                     jnp.asarray(axes, jnp.float32))
    rep = parity.compare_hits(ps, o, d, t_p, p_p,
                              torch.as_tensor(np.array(t_j)),
                              torch.as_tensor(np.array(p_j)),
                              rounding_slack=True)
    assert rep["ok"], rep


def _substance_scene():
    """tests/test_octree.py's 40 glass prims with defined, undefined and
    nested substances."""
    from raytracer_js_tpu import ResponseType, SceneBuilder

    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0.1, 0.1, 0.1)))
    glass = b.add_substance(1.5)
    water = b.add_substance(1.333)
    trans = b.add_material(ResponseType.TRANSMISSION)
    tex = b.add_solid_texture((1.0, 1.0, 1.0))
    rng = np.random.default_rng(11)
    for i in range(40):
        c = rng.uniform(-2, 2, 3)
        sub = [glass, water, -1][i % 3]
        if i % 2:
            b.add_sphere(c, float(rng.uniform(0.2, 0.9)), trans, tex, sub)
        else:
            b.add_box(c, float(rng.uniform(0.3, 1.2)), trans, tex, sub)
    b.add_box((5.0, 5.0, 5.0), 2.0, trans, tex, water)
    b.add_sphere((5.0, 5.0, 5.0), 0.4, trans, tex, glass)
    b.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), trans, tex, glass)
    return b.build(), rng


@pytest.mark.parametrize("depth", [2, 4])
def test_grid_substance_query_equals_dense(depth):
    js, rng = _substance_scene()
    ps = to_port_scene(js)
    pa = po.build_octree(ps, OctreeConfig(max_depth=depth))
    pts = torch.as_tensor(np.concatenate([
        rng.uniform(-3, 7, (512, 3)),
        [[5.0, 5.0, 5.0], [5.0, 5.0, 6.5], [100.0, 0.0, 0.0],
         [np.inf, 0.0, 0.0]],
    ]).astype(np.float32))
    cur = torch.linspace(1.0, 1.2, pts.shape[0])
    r_d, f_d = substance_refr_at(ps, pts, cur)
    r_g, f_g = substance_refr_at(ps, pts, cur, accel=pa)
    assert torch.equal(r_g, r_d) and torch.equal(f_g, f_d)
    assert float(r_g[-4]) == pytest.approx(1.5)       # innermost wins
    assert 0 < int((~f_d).sum()) < pts.shape[0]       # undefined somewhere
    ja = jo.build_octree(js, JOctreeConfig(max_depth=depth))
    r_j, f_j = j_substance(js, jnp.asarray(pts[:-1].numpy()),
                           jnp.asarray(cur[:-1].numpy()), accel=ja)
    np.testing.assert_array_equal(r_g[:-1].numpy(), np.asarray(r_j))
    np.testing.assert_array_equal(f_g[:-1].numpy(), np.asarray(f_j))


def test_accel_moves_between_devices(mixed):
    _, ps = mixed
    pa = po.build_octree(ps, OctreeConfig(max_depth=2))
    moved = pa.to("cpu")
    assert moved.skip_dist.device.type == "cpu"
    assert moved.max_per_cell == pa.max_per_cell
    assert all(torch.equal(getattr(moved, k), getattr(pa, k))
               for k in _ARRAYS)
