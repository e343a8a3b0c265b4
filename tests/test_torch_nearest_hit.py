"""Kernels B3 (scalar) and B4 (dense): their plain versions against the
reference's Pallas kernels (interpret mode on the CPU), the CPU dispatch,
the PALLAS routing of ``ops/trace.nearest_hit``, and the edge form of the
triangle table the streaming kernels (B4, B6, B8) read.

Tolerance: t within rtol 1e-5 / atol 1e-6 and equal pids, except proven
winner flips (``utils/parity.compare_hits``), at most 0.1% of the rays; the
edge form against the vertex form: bit for bit."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from raytracer_js_tpu import ResponseType, SceneBuilder, make_camera
from raytracer_js_tpu.kernels import nearest_hit as jnh
from raytracer_js_tpu.models.camera import pixel_rays
from raytracer_js_tpu_torch import HitBackend, RenderConfig
from raytracer_js_tpu_torch.kernels import nearest_hit as nh
from raytracer_js_tpu_torch.ops import trace as ptrace
from raytracer_js_tpu_torch.utils import parity

from scenes import config1_scene
from test_torch_parity import ROOT, load_by_path, to_port_scene

_KERNELS = {
    "scalar": (nh.nearest_hit_pallas_scalar_plain,
               jnh.nearest_hit_pallas_scalar),
    "dense": (nh.nearest_hit_pallas_plain, jnh.nearest_hit_pallas),
}


def rand_rays(n, seed=0, lo=-6, hi=6):
    rng = np.random.default_rng(seed)
    org = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return org, d / np.linalg.norm(d, axis=1, keepdims=True)


def camera_rays(w, h):
    org, d = pixel_rays(make_camera((0.0, 0.0, 0.5), w, h, np.pi / 2,
                                    np.pi / 2))
    return np.array(org), np.array(d)


def near_miss_field(n, seed=0):
    """Spheres in a block ahead of the camera (``tests/test_pallas.py``'s
    multi-tile near-miss field)."""
    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0.35, 0.45, 0.65)))
    m = b.add_material(ResponseType.REFLECTION)
    tex = b.add_solid_texture((0.8, 0.3, 0.2))
    rng = np.random.default_rng(seed)
    for _ in range(n):
        p = rng.uniform(-4, 4, 3)
        p[0] += 8
        b.add_sphere(tuple(p), 0.25, m, tex)
    return b.build()


def spheres_only_scene():
    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0.5, 0.5, 0.5)))
    m = b.add_material(ResponseType.REFLECTION)
    tex = b.add_solid_texture((1, 1, 1))
    b.add_sphere((3.0, 0.0, 0.0), 1.0, m, tex)
    b.add_sphere((-2.0, 1.0, 0.5), 1.5, m, tex)
    return b.build()


def box_edge_scene():
    """A box [-1, 1]^3 and a sphere. Rays: 0 meets the box exactly on its
    x/y edge, 1 hits its -x face, 2 runs in the plane of its top face
    (a miss), 3 passes beside it (a miss)."""
    b = SceneBuilder()
    m = b.add_material(ResponseType.REFLECTION, mirror=True)
    white = b.add_solid_texture((1.0, 1.0, 1.0))
    b.add_sphere((-1 - 3 / np.sqrt(2), -1 + 3 / np.sqrt(2), 0.0), 0.5, m,
                 white)
    b.add_box((0.0, 0.0, 0.0), 2.0, m, white)
    org = np.array([[-3.0, -3.0, 0.0], [-3.0, 0.5, 0.25], [-3.0, 0.0, 1.0],
                    [-3.0, -2.0, 0.0]], np.float32)
    d = np.array([[1.0, 1.0, 0.0], [1.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                  [1.0, 0.0, 0.0]], np.float32)
    return b.build(), org, d / np.linalg.norm(d, axis=1, keepdims=True)


def check_kernel(kind, js, org, d, **kw):
    """Port plain version vs the reference kernel -> (t, pid, report)."""
    plain, ref = _KERNELS[kind]
    ps = to_port_scene(js)
    org_t, d_t = torch.as_tensor(org), torch.as_tensor(d)
    t, pid = plain(ps, org_t, d_t, **kw)
    rt, rpid = ref(js, jnp.asarray(org), jnp.asarray(d), **kw)
    assert t.dtype == torch.float32 and pid.dtype == torch.int32
    assert t.shape == pid.shape == (org.shape[0],)
    rep = parity.compare_hits(ps, org_t, d_t, t, pid,
                              torch.as_tensor(np.array(rt)),
                              torch.as_tensor(np.array(rpid)),
                              rounding_slack=True)
    assert rep["ok"], rep
    return t, pid, rep


@pytest.mark.parametrize("kind", ["scalar", "dense"])
def test_config1_glass_tri(kind):
    """Spheres, a box and a triangle; 300 random rays (not a multiple of
    128 or 256) plus camera rays."""
    ro, rd = rand_rays(300, seed=5)
    co, cd = camera_rays(16, 16)
    _, pid, rep = check_kernel(kind, config1_scene(True, True),
                               np.concatenate([ro, co]),
                               np.concatenate([rd, cd]))
    assert set(pid.unique().tolist()) >= {-1, 0, 1, 6}


@pytest.mark.parametrize("kind", ["scalar", "dense"])
def test_spheres_only(kind):
    org, d = rand_rays(97, seed=3)
    _, pid, _ = check_kernel(kind, spheres_only_scene(), org, d)
    assert (pid >= 0).any() and (pid < 0).any()


@pytest.mark.parametrize("kind,n", [("scalar", 384), ("dense", 600)])
def test_near_miss_field(kind, n):
    """More than one 512-sphere span for B4; B3's largest scene. Most rays
    pass close to several spheres: the phantom-hit class of an inexact
    sphere dot."""
    org, d = camera_rays(32, 32)
    _, pid, rep = check_kernel(kind, near_miss_field(n), org, d)
    assert 0.05 < rep["hits"] / rep["rays"] < 0.95


@pytest.mark.parametrize("kind", ["scalar", "dense"])
def test_ray_on_box_edge(kind):
    js, org, d = box_edge_scene()
    t, pid, _ = check_kernel(kind, js, org, d)
    assert pid.tolist() == [1, 1, -1, -1]
    assert float(t[0]) == pytest.approx(2.0 * np.sqrt(2.0), rel=1e-6)
    assert float(t[1]) == 2.0


@pytest.mark.parametrize("kind", ["scalar", "dense"])
def test_empty_scene(kind):
    org, d = rand_rays(33, seed=1)
    t, pid, _ = check_kernel(kind, SceneBuilder().build(), org, d)
    assert torch.isinf(t).all() and (pid == -1).all()


@pytest.mark.parametrize("n_live", [0, 300, 700])
def test_dense_n_live(n_live):
    """Rows before n_live equal the reference's; rows at or past it report
    (+inf, -1) (the reference skips only whole 128-ray blocks past n_live,
    so its rows past n_live inside a straddling block are not compared)."""
    js = config1_scene(True, True)
    org, d = rand_rays(1000, seed=9)
    ps = to_port_scene(js)
    org_t, d_t = torch.as_tensor(org), torch.as_tensor(d)
    t, pid = nh.nearest_hit_pallas_plain(ps, org_t, d_t, n_live=n_live)
    rt, rpid = jnh.nearest_hit_pallas(js, jnp.asarray(org), jnp.asarray(d),
                                      n_live=jnp.int32(n_live))
    live = slice(0, n_live)
    rep = parity.compare_hits(ps, org_t[live], d_t[live], t[live], pid[live],
                              torch.as_tensor(np.array(rt))[live],
                              torch.as_tensor(np.array(rpid))[live],
                              rounding_slack=True)
    assert rep["ok"], rep
    assert torch.isinf(t[n_live:]).all() and (pid[n_live:] == -1).all()
    # n_live given as a tensor, and the full wavefront, agree
    t2, pid2 = nh.nearest_hit_pallas_plain(ps, org_t, d_t,
                                           n_live=torch.tensor(n_live))
    full_t, full_pid = nh.nearest_hit_pallas_plain(ps, org_t, d_t)
    assert torch.equal(t2, t) and torch.equal(pid2, pid)
    assert torch.equal(full_pid[live], pid[live])


def test_plain_versions_chunk_without_changing_a_bit(monkeypatch):
    js = config1_scene(True, True)
    ps = to_port_scene(js)
    org, d = map(torch.as_tensor, rand_rays(257, seed=2))
    want = [f(ps, org, d) for f in (nh.nearest_hit_pallas_scalar_plain,
                                    nh.nearest_hit_pallas_plain)]
    monkeypatch.setattr(nh, "PLAIN_CHUNK_ELEMS", 7 * ps.n_prims)
    got = [f(ps, org, d) for f in (nh.nearest_hit_pallas_scalar_plain,
                                   nh.nearest_hit_pallas_plain)]
    for (gt, gp), (wt, wp) in zip(got, want):
        assert torch.equal(gt, wt) and torch.equal(gp, wp)


def test_cpu_wrappers_take_the_plain_versions():
    ps = to_port_scene(config1_scene(True, True))
    org, d = map(torch.as_tensor, rand_rays(50, seed=4))
    before = dict(nh.LAUNCHES)
    for wrap, plain in ((nh.nearest_hit_pallas_scalar,
                         nh.nearest_hit_pallas_scalar_plain),
                        (nh.nearest_hit_pallas, nh.nearest_hit_pallas_plain)):
        (t, pid), (wt, wp) = wrap(ps, org, d), plain(ps, org, d)
        assert torch.equal(t, wt) and torch.equal(pid, wp)
    assert nh.LAUNCHES == before == {"scalar": 0, "dense": 0, "listed": 0,
                                   "culled": 0}


def test_launchers_refuse_cpu_tensors():
    ps = to_port_scene(config1_scene())
    tabs = nh.pack_tables(ps)
    org, d = torch.zeros((4, 3)), torch.ones((4, 3))
    with pytest.raises(ValueError, match="CUDA"):
        nh.launch_scalar(tabs, org, d)
    with pytest.raises(ValueError, match="CUDA"):
        nh.launch_dense(nh.stream_tables(tabs), org, d)
    assert nh.LAUNCHES == {"scalar": 0, "dense": 0, "listed": 0,
                           "culled": 0}


def test_pack_tables_layout():
    js = config1_scene(with_glass=True, with_tri=True)
    tabs = nh.pack_tables(to_port_scene(js))
    assert (tabs.n_sph, tabs.n_box, tabs.n_tri) == (5, 1, 1)
    assert tabs.sph.shape == (4, 5) and tabs.box.shape == (6, 1)
    assert tabs.tri.shape == (9, 1)
    c, r = np.asarray(js.sphere_center), np.asarray(js.sphere_radius)
    np.testing.assert_allclose(tabs.sph[3].numpy(), (c * c).sum(1) - r * r,
                               rtol=1e-6)
    np.testing.assert_array_equal(tabs.tri[6:9, 0].numpy(),
                                  np.asarray(js.tri_v2)[0])
    empty = nh.pack_tables(to_port_scene(SceneBuilder().build()))
    assert empty.sph.shape == (4, 1) and empty.n_prims == 0


@pytest.mark.parametrize("arg,item", [
    ({"tile_bounds": torch.zeros((1, 4))}, "B8"),
    ({"tile_ids": (torch.zeros((1, 1)), torch.zeros((1, 1)))}, "B6"),
    ({"tri_tile_ids": (torch.zeros((1, 1)), torch.zeros((1, 1)))}, "B6"),
    ({"sph_fan": 4}, "B6")])
def test_listed_and_culled_variants_raise(arg, item):
    """Both variants run and give B4's result: the cone-culled one (B8) on
    rays of every direction keeps every tile (cos_t < 0.25), a list naming
    every (one-tile) class streams the whole scene (B6), and a fan without
    a list is the dense search, as in the reference."""
    ps = to_port_scene(config1_scene(with_glass=True, with_tri=True))
    org, d = map(torch.as_tensor, rand_rays(100, seed=4))
    t, pid = nh.nearest_hit_pallas(ps, org, d, **arg)
    want_t, want_pid = nh.nearest_hit_pallas_plain(ps, org, d)
    assert torch.equal(pid, want_pid) and torch.equal(t, want_t)
    assert int((pid >= 0).sum()) > 10


@pytest.mark.parametrize("n,want", [(0, "dense"), (52, "scalar"),
                                    (384, "scalar"), (385, "dense")])
def test_pallas_dispatch_by_prim_count(monkeypatch, n, want):
    """ops/trace.nearest_hit under PALLAS: 1..384 prims -> B3, otherwise
    (the empty scene included) -> B4, on detached inputs with no graph."""
    calls = []

    def spy(name, fn):
        def run(scene, org, dir, **kw):
            calls.append((name, org.requires_grad, torch.is_grad_enabled()))
            return fn(scene, org, dir, **kw)
        return run

    monkeypatch.setattr(nh, "nearest_hit_pallas_scalar",
                        spy("scalar", nh.nearest_hit_pallas_scalar))
    monkeypatch.setattr(nh, "nearest_hit_pallas",
                        spy("dense", nh.nearest_hit_pallas))
    ps = to_port_scene(near_miss_field(n))
    org, d = map(torch.as_tensor, camera_rays(4, 4))
    org.requires_grad_(True)
    t, pid = ptrace.nearest_hit(ps, RenderConfig(backend=HitBackend.PALLAS),
                                org, d)
    assert calls == [(want, False, False)]
    assert not t.requires_grad
    bt, bpid = ptrace.nearest_hit_brute(ps, org.detach(), d)
    assert torch.equal(pid, bpid)


def _bits(x):
    return x.contiguous().view(torch.int32)


def _edge_fields():
    """The triangle edge/vertex field of ``chip_smoke.py`` (rays aimed at
    shared grid vertices and edge midpoints, and at free triangles'
    vertices) and a near-miss field: camera rays over the same triangles,
    most of which pass close to an edge -> {name: (scene, org, dir)}."""
    smoke = load_by_path("chip_smoke", ROOT / "chip_smoke.py")
    scene, org, d = smoke.tri_edge_field(device="cpu")
    co, cd = camera_rays(48, 40)
    return {"edge_vertex": (scene, org, d),
            "near_miss": (scene, torch.as_tensor(co), torch.as_tensor(cd))}


@pytest.mark.parametrize("field", ["edge_vertex", "near_miss"])
def test_triangle_edge_form_is_the_vertex_form(field):
    """The streaming kernels read triangles as (v0, e1 = v1 - v0, e2 = v2 -
    v0), subtracted once on the table's device: the edge table equals the
    in-test subtraction bit for bit, the test on it equals the vertex-form
    test bit for bit, and padded triangles are never hit."""
    scene, org, d = _edge_fields()[field]
    tabs = nh.pack_tables(scene)
    tri = tabs.tri
    edges = nh.edge_table(tri)
    assert torch.equal(_bits(edges[0:3]), _bits(tri[0:3]))
    assert torch.equal(_bits(edges[3:6]), _bits(tri[3:6] - tri[0:3]))
    assert torch.equal(_bits(edges[6:9]), _bits(tri[6:9] - tri[0:3]))
    r = nh._rays(org, d)
    t_v, t_e = nh._tri(r, tri), nh._tri_edges(r, edges)
    assert torch.equal(_bits(t_v), _bits(t_e))
    hits = torch.isfinite(t_v).any(dim=1)
    assert 0.05 < float(hits.float().mean()) < 0.99
    # the streaming tables: padded to whole tiles, padding all-zero edges
    st = nh.stream_tables(tabs)
    assert st.tri.shape == (9, -(-tabs.n_tri // nh.BLOCK_K) * nh.BLOCK_K)
    assert torch.equal(_bits(st.tri[:, :tabs.n_tri]), _bits(edges))
    assert not st.tri[:, tabs.n_tri:].any()
    pad = nh._tri_edges(r, st.tri[:, tabs.n_tri:])
    assert bool(torch.isinf(pad).all())


@pytest.mark.parametrize("field", ["edge_vertex", "near_miss"])
def test_divide_skip_never_rejects_a_hit(field):
    """The kernels' warp-uniform skip of 1 / det and the tail: its
    predicate holds on no lane whose test passes (so a warp that skips
    folds nothing it would have), and it holds on many lanes that miss."""
    scene, org, d = _edge_fields()[field]
    edges = nh.edge_table(nh.pack_tables(scene).tri)
    r = nh._rays(org, d)
    t = nh._tri_edges(r, edges)
    miss = nh.tri_certain_miss(r, edges)
    assert not bool((miss & torch.isfinite(t)).any())
    assert float(miss.float().mean()) > 0.5
    # on padded (all-zero) triangles every lane certainly misses
    assert bool(nh.tri_certain_miss(r, torch.zeros((9, 3))).all())


def test_dense_splits_merge_to_the_unsplit_scan():
    """B4 splits each block's scan over tile ranges of every class (boxes
    in split 0) and merges the splits' (t, pid) by the least t, a tie to
    the lowest pid: that rule, written out here on the plain side, gives
    the unsplit scan's t and pid bit for bit, with ties in t across a split
    present. This checks the rule, not the CUDA merge (nh_merge_kernel has
    no CPU form): chip_smoke.py holds the kernel to the plain scan bit for
    bit on split scans, ties across a split among them (B4 case i). The
    split count follows the tiles and is capped by the partial results'
    size."""
    ps = to_port_scene(near_miss_field(600))
    org, d = map(torch.as_tensor, camera_rays(24, 24))
    tabs = nh.pack_tables(ps)
    # sphere 256 (the first of tile 2) is a copy of sphere 255 (the last of
    # tile 1): exact ties in t across a split boundary
    tabs = dataclasses.replace(tabs, sph=torch.cat(
        [tabs.sph[:, :256], tabs.sph[:, 255:599]], 1))
    off = torch.tensor([[-0.3, 0.02 * k, -0.01 * k] for k in range(8)])
    org = torch.cat([org, ps.sphere_center[255] + off])
    d = torch.cat([d, torch.tensor([[1.0, 0.0, 0.0]]).expand(8, 3)])
    want_t, want_pid = nh._search_plain(tabs, org, d, nh._sphere_dense)
    r = nh._rays(org, d)
    t_all = nh._sphere_dense(r, tabs.sph)                  # [rays, 600]
    n_t = -(-tabs.n_sph // nh.BLOCK_K)
    for splits in (2, 3, 5):
        t_best = torch.full_like(want_t, float("inf"))
        pid = torch.full_like(want_pid, -1)
        for s in range(splits):
            lo = n_t * s // splits * nh.BLOCK_K
            hi = min(n_t * (s + 1) // splits * nh.BLOCK_K, tabs.n_sph)
            if lo >= hi:
                continue
            ts, ks = t_all[:, lo:hi].min(dim=1)
            ps_ = torch.where(torch.isfinite(ts), ks + lo, -1)
            take = (ps_ >= 0) & ((pid < 0) | (ts < t_best)
                                 | ((ts == t_best) & (ps_ < pid)))
            t_best = torch.where(take, ts, t_best)
            pid = torch.where(take, ps_, pid)
        assert torch.equal(_bits(t_best), _bits(want_t))
        assert torch.equal(pid.to(torch.int32), want_pid)
    # the copy's ties go to the lower pid
    assert bool((want_pid == 255).any()) and not bool((want_pid == 256).any())
    st = nh.stream_tables(nh.pack_tables(to_port_scene(near_miss_field(
        5000))))
    assert nh.dense_splits(st, 65536) == 2
    assert nh.dense_splits(st, 1 << 21) == 2
    assert nh.dense_splits(st, 1 << 22) == 1
    small = nh.stream_tables(nh.pack_tables(ps))
    assert nh.dense_splits(small, 1000) == 1
