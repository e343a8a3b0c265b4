"""Kernel B6 (the listed nearest hit) and the TILED sweep machinery that
feeds it: the plain version against the reference's Pallas kernel
(interpret mode on the CPU), the Morton permutation and the per-block tile
selection against the reference's, the exit group (``group``: 32 rays, the
kernel's warp, or 128, the first design's block) changing the slots
streamed but never t or pid, and a sweep-mode frame that reaches B6's
plain version.

Tolerance: t within rtol 1e-5 / atol 1e-6 and equal pids, except proven
winner flips (``utils/parity.compare_hits``, at most 0.1% of the rays); a
grazing sphere hit may differ by more in t where float32 rounding leaves it
undetermined (XLA on the CPU fuses multiply-adds; ``rounding_slack``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import raytracer_js_tpu as jrt
import raytracer_js_tpu.render_tiled as jrtl
from raytracer_js_tpu import RenderConfig, make_camera
from raytracer_js_tpu.config import HitBackend as JB
from raytracer_js_tpu.kernels import nearest_hit as jnh
from raytracer_js_tpu_torch import render_tiled as prtl
from raytracer_js_tpu_torch.kernels import nearest_hit as nh
from raytracer_js_tpu_torch.models.camera import pixel_rays
from raytracer_js_tpu_torch.utils import parity

from test_torch_parity import (assert_parity, to_port_camera, to_port_cfg,
                               to_port_scene)


def sphere_field(n=700, seed=11):
    """``tests/test_tiled_fast.py``'s listed-cull field: a ground box and
    ``n`` small diffuse and mirror spheres."""
    b = jrt.SceneBuilder()
    b.set_sky(b.add_solid_texture((0.35, 0.45, 0.65)))
    diffuse = b.add_material(jrt.ResponseType.REFLECTION)
    mirror = b.add_material(jrt.ResponseType.REFLECTION, mirror=True)
    rng = np.random.default_rng(seed)
    pal = [b.add_solid_texture(rng.uniform(0.2, 1.0, 3)) for _ in range(6)]
    b.add_box((0.0, 0.0, -21.0), 40.0, diffuse, pal[0])
    for i in range(n):
        c = rng.uniform([2.0, -4.0, -0.5], [10.0, 4.0, 4.0], 3)
        b.add_sphere(c, float(rng.uniform(0.05, 0.2)),
                     mirror if i % 3 == 0 else diffuse, pal[i % 6])
    return b.build()


def mesh_scene():
    """``tests/test_tiled_fast.py``'s listed-mesh scene: 1280 triangles."""
    from raytracer_js_tpu.utils.mesh import icosphere

    b = jrt.SceneBuilder()
    b.set_sky(b.add_solid_texture((0.35, 0.45, 0.65)))
    diffuse = b.add_material(jrt.ResponseType.REFLECTION)
    mirror = b.add_material(jrt.ResponseType.REFLECTION, mirror=True)
    b.add_box((0.0, 0.0, -21.0), 40.0, diffuse,
              b.add_solid_texture((0.5, 0.5, 0.5)))
    v, f = icosphere(3, radius=1.2, center=(5.0, 0.0, 1.0))
    b.add_mesh(v, f, mirror, b.add_solid_texture((0.9, 0.75, 0.3)))
    b.add_sphere((4.0, -2.0, 0.5), 0.7, diffuse,
                 b.add_solid_texture((0.8, 0.2, 0.2)))
    return b.build()


def field_rays(n, seed=0, target=(6.0, 0.0, 1.5)):
    """Rays from a box near the camera toward the field, plus a few that
    leave the scene (sky rays end the stream at their bbox exit)."""
    rng = np.random.default_rng(seed)
    org = rng.uniform([0.0, -1.0, 0.0], [1.5, 1.0, 1.0], (n, 3))
    aim = np.asarray(target) + rng.normal(0.0, 2.0, (n, 3))
    d = aim - org
    d[: n // 8] = rng.normal(size=(n // 8, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org.astype(np.float32), d.astype(np.float32)


_LISTED = {
    # name: (scene, class, LISTED_MAX_TILES)
    "spheres": (sphere_field, "sph", 2048),
    "triangles": (mesh_scene, "tri", 2048),
    "sphere_fan": (sphere_field, "sph", 2),
}


@pytest.mark.parametrize("group", [32, 128])
@pytest.mark.parametrize("name", sorted(_LISTED))
def test_listed_matches_reference_kernel(name, group, monkeypatch):
    """B6's plain version, exit groups of ``group`` rays, against
    ``nearest_hit_pallas(tile_ids=...)`` on the same Morton-permuted scene
    and the same lists (the port's permutation, tile bounds and lists equal
    the reference's), with n_live < N; and against B4's plain version on
    the same rays (the cull is exact): 0 flips, whatever the group."""
    make, cls, max_tiles = _LISTED[name]
    monkeypatch.setattr(jrtl, "LISTED_MAX_TILES", max_tiles)
    monkeypatch.setattr(prtl, "LISTED_MAX_TILES", max_tiles)
    js = make()
    ps = to_port_scene(js)
    j_sw, p_sw = jrtl._sweep_perm(js), prtl._sweep_perm(ps)
    k = 1 if cls == "sph" else 2
    assert p_sw[3 - k] is None and j_sw[3 - k] is None
    j_perm, j_tb, j_fan = j_sw[k]
    p_perm, p_tb, p_fan = p_sw[k]
    np.testing.assert_array_equal(p_perm.numpy(), np.asarray(j_perm))
    np.testing.assert_allclose(p_tb.numpy(), np.asarray(j_tb), rtol=1e-6,
                               atol=1e-6)
    assert p_fan == j_fan and (p_fan > 1) == (name == "sphere_fan")

    n, n_live = 512, 470
    org, d = field_rays(n)
    work = np.arange(n) < n_live
    j_ids = jrtl._block_tile_select(jnp.asarray(org), jnp.asarray(d),
                                    jnp.asarray(work), j_tb)
    p_ids = prtl._block_tile_select(torch.as_tensor(org), torch.as_tensor(d),
                                    torch.as_tensor(work), p_tb)
    np.testing.assert_array_equal(p_ids[0].numpy(), np.asarray(j_ids[0]))
    np.testing.assert_allclose(p_ids[1].numpy(), np.asarray(j_ids[1]),
                               rtol=1e-5, atol=1e-6)
    kw = ({"tile_ids": j_ids, "sph_fan": j_fan} if cls == "sph"
          else {"tri_tile_ids": j_ids, "tri_fan": j_fan})
    j_t, j_pid = jnh.nearest_hit_pallas(j_sw[0], jnp.asarray(org),
                                        jnp.asarray(d),
                                        n_live=jnp.int32(n_live), **kw)
    pkw = ({"tile_ids": p_ids, "sph_fan": p_fan} if cls == "sph"
           else {"tri_tile_ids": p_ids, "tri_fan": p_fan})
    o, dd = torch.as_tensor(org), torch.as_tensor(d)
    t, pid, slots = nh.nearest_hit_listed_plain(p_sw[0], o, dd, n_live,
                                                work=True, group=group,
                                                **pkw)
    # rows past n_live report a miss (the reference leaves them to its
    # caller)
    assert torch.isinf(t[n_live:]).all() and (pid[n_live:] == -1).all()
    live = slice(0, n_live)
    rep = parity.compare_hits(p_sw[0], o[live], dd[live], t[live], pid[live],
                              torch.as_tensor(np.array(j_t)[live]),
                              torch.as_tensor(np.array(j_pid)[live]),
                              rounding_slack=True)
    assert rep["ok"] and rep["hits"] > 100, rep
    # one count per exit group; every live group streamed, none ran past
    # the list, and groups wholly past n_live streamed nothing
    n_cols = p_ids[0].shape[1]
    assert slots.shape == (8, 128 // group, 2)
    used = slots[..., 0 if cls == "sph" else 1].reshape(-1)
    live_groups = -(-n_live // group)
    assert (used[:live_groups] > 0).all() and (used[live_groups:] == 0).all()
    assert int(used.max()) <= -(-n_cols // 16) * 16
    b_t, b_pid = nh.nearest_hit_pallas_plain(p_sw[0], o, dd, n_live=n_live)
    rep = parity.compare_hits(p_sw[0], o, dd, t, pid, b_t, b_pid)
    assert rep["ok"] and rep["flips"] == 0, rep


@pytest.mark.parametrize("name", sorted(_LISTED))
def test_warp_exit_streams_less_same_hits(name, monkeypatch):
    """Exit groups of one warp (the kernel's) give the block rule's t and
    pid bit for bit, never stream more slots than the block around them,
    and stream fewer somewhere on the near-miss field; every ray streams
    at least what it needs (``listed_need``: the slots below its own final
    hit or exit, in whole chunks), which the block streams too."""
    make, cls, max_tiles = _LISTED[name]
    monkeypatch.setattr(prtl, "LISTED_MAX_TILES", max_tiles)
    ps = to_port_scene(make())
    sw = prtl._sweep_perm(ps)
    k = 1 if cls == "sph" else 2
    n, n_live = 512, 470
    org, d = map(torch.as_tensor, field_rays(n))
    ids = prtl._block_tile_select(org, d, torch.arange(n) < n_live,
                                  sw[k][1])
    kw = ({"tile_ids": ids, "sph_fan": sw[k][2]} if cls == "sph"
          else {"tri_tile_ids": ids, "tri_fan": sw[k][2]})
    li = nh.listed_inputs(sw[0], n, **kw)
    t32, pid32, s32 = nh.nearest_hit_listed_plain(sw[0], org, d, n_live,
                                                  inputs=li, work=True)
    t128, pid128, s128 = nh.nearest_hit_listed_plain(
        sw[0], org, d, n_live, inputs=li, work=True, group=128)
    assert torch.equal(t32, t128) and torch.equal(pid32, pid128)
    assert s32.shape == (8, 4, 2) and s128.shape == (8, 1, 2)
    assert bool((s32 <= s128).all())
    c = 0 if cls == "sph" else 1
    if name == "spheres":
        assert int(s32[..., c].sum()) < 4 * int(s128[..., c].sum())
    need = nh.listed_need(li, org, d, t32, n_live)
    assert need.shape == (n, 2) and int(need[:, 1 - c].sum()) == 0
    assert (need[n_live:] == 0).all() and int(need[:, c].max()) > 0
    per_warp = s32[..., c].reshape(-1)[:n // 32].repeat_interleave(32)
    assert bool((need[:, c] <= per_warp).all())


def test_sweep_keys_match_reference():
    """Morton keys (uint32 spreads in int64), binning cells, direction bins
    and the robust extent (``jnp.median``: the mean of the two middle values
    on an even count) equal the reference's."""
    js = sphere_field(699)          # 700 prims: an even count
    ps = to_port_scene(js)
    assert ps.n_prims % 2 == 0
    for a, b in zip(prtl._robust_extent(ps), jrtl._robust_extent(js)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rng = np.random.default_rng(3)
    pts = rng.uniform([-2.0, -6.0, -2.0], [12.0, 6.0, 6.0],
                      (2000, 3)).astype(np.float32)
    dirs = rng.normal(size=(2000, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    tp, jp = torch.as_tensor(pts), jnp.asarray(pts)
    for bits in (6, 8):
        np.testing.assert_array_equal(
            prtl._morton_key(ps, tp, bits).numpy(),
            np.asarray(jrtl._morton_key(js, jp, bits)))
    np.testing.assert_array_equal(prtl._pos_cell(ps, tp).numpy(),
                                  np.asarray(jrtl._pos_cell(js, jp)))
    np.testing.assert_array_equal(
        prtl._dir_bin(torch.as_tensor(dirs)).numpy(),
        np.asarray(jrtl._dir_bin(jnp.asarray(dirs))))


def test_listed_dispatch_padding_and_refusals():
    """``nearest_hit_pallas`` with lists on CPU tensors runs the plain
    version; the lists are padded as the reference pads them; the launcher
    refuses CPU tensors; ``tile_bounds`` dispatches to B8's plain version,
    whose launcher refuses CPU tensors too."""
    ps = to_port_scene(sphere_field())
    sw = prtl._sweep_perm(ps)
    org, d = map(torch.as_tensor, field_rays(300, seed=2))
    work = torch.ones(384, dtype=torch.bool)
    pad = lambda x, v: torch.cat([x, torch.full((84, 3), v)])  # noqa: E731
    ids = prtl._block_tile_select(pad(org, 0.0), pad(d, 1.0), work, sw[1][1])
    t, pid = nh.nearest_hit_pallas(sw[0], org, d, tile_ids=ids)
    t2, pid2 = nh.nearest_hit_listed_plain(sw[0], org, d, tile_ids=ids)
    assert torch.equal(t, t2) and torch.equal(pid, pid2)
    li = nh.listed_inputs(sw[0], org.shape[0], tile_ids=ids)
    l_ids, l_tlo = li.sph_list
    assert l_ids.shape == (8, 16) and l_ids.dtype == torch.int32
    assert torch.isinf(l_tlo[3:]).all() and (l_ids[3:] == 0).all()
    assert torch.isinf(li.tabs.sph[3, ps.n_spheres:]).all()
    assert li.tabs.sph.shape[1] % nh.BLOCK_K == 0
    # the kernel's array-of-structs copy of the padded sphere table, and its
    # edge form of the padded triangle table
    st = li.stream
    assert torch.equal(st.sph4, li.tabs.sph.T) and st.sph4.is_contiguous()
    assert torch.equal(st.tri, nh.edge_table(li.tabs.tri))
    with pytest.raises(ValueError, match="power of two"):
        nh.nearest_hit_listed_plain(sw[0], org, d, tile_ids=ids, group=48)
    with pytest.raises(ValueError, match="CUDA"):
        nh.launch_listed(li, org, d)
    with pytest.raises(ValueError, match="rows"):
        nh.listed_inputs(sw[0], 1000, tile_ids=ids)
    t3, pid3 = nh.nearest_hit_pallas(sw[0], org, d, tile_bounds=sw[1][1])
    t4, pid4 = nh.nearest_hit_culled_plain(sw[0], org, d, sw[1][1])
    assert torch.equal(t3, t4) and torch.equal(pid3, pid4)
    with pytest.raises(ValueError, match="CUDA"):
        nh.launch_culled(nh.stream_tables(nh.pack_tables(sw[0])), org, d,
                         sw[1][1])
    assert nh.LAUNCHES == {"scalar": 0, "dense": 0, "listed": 0,
                           "culled": 0}


def test_sweep_frame_reaches_listed_plain(monkeypatch):
    """``render_frame_tiled`` on the 700-sphere field with LISTED_MIN_TILES
    lowered, so the port's sweep round searches with B6's plain version
    while the reference's (64-tile floor) runs dense: the frames agree,
    since the listed cull is exact, and no ray is left unresolved."""
    js = sphere_field()
    jc = make_camera((0.0, 0.0, 0.5), 128, 32, np.pi / 2, np.pi / 2 / 4)
    cfg = RenderConfig(refmax=2, backend=JB.BRUTE)
    ref, j_diag = jrtl.render_frame_tiled(js, cfg, jc, with_diag=True)
    assert int(j_diag["unresolved"]) == 0
    ps, pc = to_port_scene(js), to_port_camera(jc)
    monkeypatch.setattr(prtl, "LISTED_MIN_TILES", 1)
    calls = []
    real = nh.nearest_hit_listed_plain

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(nh, "nearest_hit_listed_plain", spy)
    img, diag = prtl.render_frame_tiled(ps, to_port_cfg(cfg), pc,
                                        with_diag=True)
    assert int(diag["unresolved"]) == 0 and diag["rounds"] >= 1
    assert len(calls) == diag["rounds"]
    zeros = np.zeros((pc.h, pc.w), np.int32)
    assert_parity(img, zeros, np.asarray(ref), zeros,
                  prove_rounding=parity.grazing_prover(ps, *pixel_rays(pc)))
