"""The TILED packet tables (``accel/candidates``: the cell grid, the packet
cones, the grid and rowwise selections, the attribute rows) and kernel
B7-wave's plain version (``kernels/trace_tiled.wave_bounce_plain``): the
port against the reference, the kernel in interpret mode on the CPU.

Tolerances, each with its reason:

* the host grid build is numpy in both packages, expression for
  expression: every field is equal bit for bit;
* the attribute rows are equal bit for bit but for the triangles' unit
  normal columns (11-13), which no kernel reads (the kernels recompute the
  normal from the edges): XLA on the CPU fuses the cross product's and the
  norm's multiply-adds, so those differ in the last bits (rtol 1e-6);
* the packet cones sum 1024 rays in another order than XLA: o0, ro, the
  axis and cos_t agree to a few float32 ulps (atol 1e-6), and so do the
  tables' t_lo, t_safe and counts rows (rtol 1e-6); the pid columns are
  equal, as no cell or prim lies within those ulps of a cone boundary on
  these rays (a flip would show as a pid difference, and none occurs);
* the wavefront planes: the parity rule, allclose(rtol 1e-5, atol 1e-6)
  with equal status and winner, except proven winner flips and sphere
  hits whose difference float32 rounding explains (the mirror map of
  ``test_torch_tiled._assert_planes``)."""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import raytracer_js_tpu as jrt
from raytracer_js_tpu import make_camera
from raytracer_js_tpu.accel import candidates as jcand
from raytracer_js_tpu.kernels import trace_tiled as jtt
from raytracer_js_tpu_torch.accel import candidates as pcand
from raytracer_js_tpu_torch.config import RayStatus
from raytracer_js_tpu_torch.kernels import trace_tiled as tt
from raytracer_js_tpu_torch.models.camera import pixel_rays
from raytracer_js_tpu_torch.utils import parity

from test_torch_candidates import _mixed_classes
from test_torch_parity import to_port_camera, to_port_scene
from test_torch_tiled import B0_MAX_ROUNDING_FRAC
from test_torch_trace import ext_scene

_ALIVE = int(RayStatus.ALIVE)


def packet_scene(n=120, seed=5):
    """``tests/test_tiled.py``'s mixed scene: a ground box (a straddler
    outside the grid's extent), spheres, boxes and triangles, mirrors and
    an emitter."""
    b = jrt.SceneBuilder()
    b.set_sky(b.add_solid_texture((0.35, 0.45, 0.65)))
    diffuse = b.add_material(jrt.ResponseType.REFLECTION)
    mirror = b.add_material(jrt.ResponseType.REFLECTION, mirror=True)
    light = b.add_material(jrt.ResponseType.REFLECTION, light=True)
    rng = np.random.default_rng(seed)
    pal = [b.add_solid_texture(rng.uniform(0.2, 1.0, 3)) for _ in range(6)]
    b.add_box((0.0, 0.0, -21.0), 40.0, diffuse, pal[0])
    for i in range(n):
        c = rng.uniform([2.0, -4.0, -0.5], [10.0, 4.0, 4.0], 3)
        m = [diffuse, mirror, diffuse][i % 3]
        if i % 5 == 4:
            b.add_box(c, float(rng.uniform(0.2, 0.6)), m, pal[i % 6])
        elif i % 7 == 6:
            b.add_triangle(c, c + rng.uniform(-0.6, 0.6, 3),
                           c + rng.uniform(-0.6, 0.6, 3), m, pal[i % 6])
        else:
            b.add_sphere(c, float(rng.uniform(0.15, 0.5)), m, pal[i % 6])
    b.add_sphere((6.0, 0.0, 6.0), 1.0, light, pal[1])
    return b.build()


def _packet_rays(n=4096, seed=0):
    """Rays from a box near the camera toward the scene (coherent in runs
    of 1024), a tenth of them dead, some with a cleared horizon."""
    rng = np.random.default_rng(seed)
    org = rng.uniform([0.0, -1.0, 0.0], [1.0, 1.0, 1.0], (n, 3))
    aim = np.array([6.0, 0.0, 1.0]) + rng.normal(0.0, 1.5, (n, 3))
    d = aim - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    alive = rng.uniform(size=n) < 0.9
    t_done = np.where(rng.uniform(size=n) < 0.3, rng.uniform(0, 2, n), 0.0)
    return (org.astype(np.float32), d.astype(np.float32), alive,
            t_done.astype(np.float32))


def test_cell_grid_bit_equal():
    """Every field of the grid, at g = 8 and 16, on a scene whose ground
    box lies outside the grid's extent (the per-class global lists)."""
    js = packet_scene()
    ps = to_port_scene(js)
    for g, c_sel in ((8, 256), (16, 4096)):
        jg = jcand.build_cell_grid(js, g=g, c_sel=c_sel)
        pg = pcand.build_cell_grid(ps, g=g, c_sel=c_sel)
        for f in dataclasses.fields(pg):
            a, b = getattr(pg, f.name), getattr(jg, f.name)
            if isinstance(a, torch.Tensor):
                assert a.device == ps.device
                np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                              err_msg=f.name)
            else:
                assert a == b, f.name
        assert pg.glob_b.shape[0] == 1 and pg.c_max % pcand.SEG_ALIGN == 0
    with pytest.raises(ValueError, match="empty"):
        pcand.build_cell_grid(to_port_scene(jrt.SceneBuilder().build()))


def test_prim_attr_table_and_packing():
    js = _mixed_classes()
    ps = to_port_scene(js)
    j_tab = np.asarray(jcand.prim_attr_table_jnp(js))
    p_tab = pcand.prim_attr_table(ps).numpy()
    other = np.r_[0:11, 14:20]
    np.testing.assert_array_equal(p_tab[:, other], j_tab[:, other])
    np.testing.assert_allclose(p_tab[:, 11:14], j_tab[:, 11:14], rtol=1e-6,
                               atol=1e-7)
    pid = np.array([-1, 0, 3, ps.n_spheres, ps.n_spheres + 1,
                    ps.n_prims - 1, -1], np.int32)
    t_lo = np.linspace(0.5, 3.5, pid.shape[0]).astype(np.float32)
    j_rows = np.asarray(jcand.pack_candidate_attrs_jnp(
        js, jnp.asarray(pid), jnp.asarray(t_lo)))
    p_rows = pcand.pack_candidate_attrs(ps, torch.as_tensor(pid),
                                        torch.as_tensor(t_lo)).numpy()
    np.testing.assert_array_equal(p_rows[:, other], j_rows[:, other])
    assert np.isinf(p_rows[pid < 0, 0]).all()


@pytest.mark.parametrize("path", ["grid", "rowwise"])
def test_packet_tables_match_reference(path):
    js = packet_scene()
    ps = to_port_scene(js)
    org, d, alive, t_done = _packet_rays()
    jx = [jnp.asarray(x) for x in (org, d, alive)]
    px = [torch.as_tensor(x) for x in (org, d, alive)]
    for a, b in zip(pcand.packet_cones(*px, 1024),
                    jcand.packet_cones(*jx, 1024)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    if path == "grid":
        # a small budget: some packets drop cells, so t_safe is finite
        jg = jcand.build_cell_grid(js, c_sel=128)
        pg = pcand.build_cell_grid(ps, c_sel=128)
        ref = jcand.packet_candidates_grid(js, jg, *jx, 1024,
                                           t_done=jnp.asarray(t_done))
        got = pcand.packet_candidates_grid(ps, pg, *px, 1024,
                                           t_done=torch.as_tensor(t_done))
        width = pg.c_max
    else:
        ref = jcand.packet_candidates(js, *jx, 1024, 96,
                                      t_done=jnp.asarray(t_done))
        got = pcand.packet_candidates(ps, *px, 1024, 96,
                                      t_done=torch.as_tensor(t_done))
        width = 96
    tab, cnts, t_safe = (x.numpy() for x in got)
    j_tab, j_cnts, j_safe = (np.asarray(x) for x in ref)
    assert tab.shape == (4 * width, pcand.N_ATTR)
    assert np.isfinite(t_safe).any()
    np.testing.assert_array_equal(tab[:, 1], j_tab[:, 1])
    np.testing.assert_array_equal(cnts[:, :3], j_cnts[:, :3])
    np.testing.assert_allclose(t_safe, j_safe, rtol=1e-6)
    np.testing.assert_allclose(cnts[:, 3:], j_cnts[:, 3:], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tab[:, 0], j_tab[:, 0], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tab[:, 2:11], j_tab[:, 2:11])


# ---------------------------------------------------------------------------
# B7-wave's plain version against the reference's wavefront kernel
# ---------------------------------------------------------------------------

def _bounce1_wavefront(js, cam_args):
    """The wavefront after bounce 0 of a frame (the port's plain frame
    kernel): mirror continuations alive, everything else terminated."""
    ps = to_port_scene(js)
    pc = to_port_camera(make_camera(*cam_args))
    tab, cnts, c_max = pcand.frame_candidates(ps, pc, tt.TILE_SUB, tt.LANE)
    st = tt.frame_bounce0_plain(ps, pc, tab, cnts, c_max)
    return ps, [st[k].reshape(-1, tt.LANE) for k in tt.STATE_NAMES[:11]]


def _camera_wavefront(js, cam_args):
    """Primary rays of a 128-wide frame, a few dead and a few at the
    bounce cap (status 7: they pass through)."""
    ps = to_port_scene(js)
    org, d = pixel_rays(to_port_camera(make_camera(*cam_args)))
    n = org.shape[0]
    rng = np.random.default_rng(2)
    status = np.where(rng.uniform(size=n) < 0.05, int(RayStatus.KEEP),
                      _ALIVE)
    status[rng.uniform(size=n) < 0.02] = 7
    col = rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32)
    path = rng.uniform(0.0, 2.0, n).astype(np.float32)
    planes = [org[:, k] for k in range(3)] + [d[:, k] for k in range(3)] + [
        torch.as_tensor(col[:, k]) for k in range(3)] + [
        torch.as_tensor(path), torch.as_tensor(status.astype(np.int32))]
    return ps, [p.reshape(-1, tt.LANE).contiguous() for p in planes]


_CAM = ((0.03, -0.02, 0.5), 128, 32, 1.53, 0.41)
_WAVE = {
    # name: (scene, wavefront, tables, c_sel / c_max, wave_sub)
    "grid": (packet_scene, _camera_wavefront, "grid", 4096, 8),
    "rowwise": (packet_scene, _camera_wavefront, "rowwise", 256, 8),
    "truncated": (packet_scene, _camera_wavefront, "grid", 32, 8),
    "rough_glass": (lambda: ext_scene(trans=True, rough=0.6),
                    _bounce1_wavefront, "grid", 4096, 8),
    "image": (_mixed_classes, _bounce1_wavefront, "grid", 4096, 8),
    "wave_sub_1": (packet_scene, _bounce1_wavefront, "grid", 64, 1),
}


_HIT_ONLY = ("t", "u", "v", "nx", "ny", "nz")


def _assert_wave_planes(ps, org, dirs, port, ref):
    """Every output plane of the port's wavefront bounce against the
    reference's, ray by ray (``org``/``dirs`` the rays' inputs). The t, u,
    v and normal planes are held on final hits (pid >= 0): elsewhere they
    carry the best candidate of a ray whose hit is not final, which the
    renderer never reads."""
    pid_p = port["pid"].reshape(-1)
    pid_j = torch.as_tensor(np.array(ref[tt.STATE_NAMES.index("pid")])
                            ).reshape(-1).to(torch.int32)

    def p(k):
        x = port[k].reshape(-1)
        return torch.where(pid_p >= 0, x, 0.0) if k in _HIT_ONLY else x

    def j(k):
        x = torch.as_tensor(np.array(ref[tt.STATE_NAMES.index(k)])
                            ).reshape(-1)
        return torch.where(pid_j >= 0, x, 0.0) if k in _HIT_ONLY else x

    rec = {"pid": pid_p[None], "org": org[None], "dir": dirs[None]}
    prove = parity.flip_prover(ps, rec, pid_j[None])

    def fin(x):
        return torch.where(torch.isfinite(x), x, 0.0)

    sph = (pid_p >= 0) & (pid_p < ps.n_spheres) & (pid_p == pid_j)
    inv_r = 1.0 / ps.sphere_radius[pid_p.long().clamp(0, ps.n_spheres - 1)]
    dt = (parity.sphere_t_bound(ps, pid_j, org, dirs)
          + 2.0 ** -23 * fin(j("t")).abs().double())
    allow = 8.0 * dt * torch.clamp(inv_r, min=1.0).double() + 1e-6
    n = org.shape[0]
    zero = torch.zeros(n)
    names = [("ox", "oy", "oz"), ("dx", "dy", "dz"), ("cr", "cg", "cb"),
             ("path", "t", "u"), ("v",)]
    if "nx" in port:
        names.append(("nx", "ny", "nz"))
    for group in names:
        a = torch.stack([fin(p(k)) for k in group]
                        + [zero] * (3 - len(group)), -1)
        b = torch.stack([fin(j(k)) for k in group]
                        + [zero] * (3 - len(group)), -1)

        def ratio(idx, a=a, b=b):
            err = (a[idx] - b[idx]).abs().max(dim=1).values.double()
            return torch.where(sph[idx], err / allow[idx], torch.inf) <= 1.0

        rep = parity.compare(a, p("status") * 100000 + pid_p, b,
                             j("status") * 100000 + pid_j, prove=prove,
                             prove_rounding=ratio,
                             max_rounding_frac=B0_MAX_ROUNDING_FRAC)
        assert rep["ok"], (group, rep)


@functools.lru_cache(maxsize=None)
def _wave_case(name):
    """One wavefront case, its packet tables and the reference's planes
    (computed once per module worker)."""
    make, wavefront, kind, size, wave_sub = _WAVE[name]
    js = make()
    ps, cols = wavefront(js, _CAM)
    packet = wave_sub * tt.LANE
    org = torch.stack([c.reshape(-1) for c in cols[0:3]], -1)
    dirs = torch.stack([c.reshape(-1) for c in cols[3:6]], -1)
    alive = cols[10].reshape(-1) == _ALIVE
    if kind == "grid":
        grid = pcand.build_cell_grid(ps, c_sel=size)
        tab, cnts, t_safe = pcand.packet_candidates_grid(ps, grid, org, dirs,
                                                         alive, packet)
        c_max, bases = grid.c_max, grid.base[1:]
    else:
        tab, cnts, t_safe = pcand.packet_candidates(ps, org, dirs, alive,
                                                    packet, size)
        c_max, bases = size, None
    ref = jtt.wave_bounce(js, [jnp.asarray(c.numpy()) for c in cols],
                          jnp.asarray(tab.numpy()), jnp.asarray(cnts.numpy()),
                          c_max, wave_sub=wave_sub, static_bases=bases)
    return ps, cols, org, dirs, (tab, cnts, t_safe, c_max, bases), ref


@pytest.mark.parametrize("rule", ["warp", "block"])
@pytest.mark.parametrize("name", sorted(_WAVE))
def test_wave_bounce_plain_matches_reference(name, rule):
    """Exit groups of one warp (32 rays, the kernel's) or of the first
    design's blocks (two rows of 128, one row for one-row packets): every
    plane against the reference's."""
    wave_sub = _WAVE[name][4]
    ps, cols, org, dirs, (tab, cnts, t_safe, c_max, bases), ref = \
        _wave_case(name)
    n = cols[0].numel()
    group = tt.GROUP if rule == "warp" else tt.LANE * tt.group_rows(wave_sub)
    port = tt.wave_bounce_plain(ps, cols, tab, cnts, c_max, wave_sub=wave_sub,
                                static_bases=bases, work=True, group=group)
    if rule == "warp":
        # the CPU wrapper is the plain version with the kernel's group
        same = tt.wave_bounce(ps, cols, tab, cnts, c_max, wave_sub=wave_sub,
                              static_bases=bases, work=True)
        assert all(torch.equal(same[k], port[k]) for k in port)
    flags = tt._flags(ps)
    assert set(port) == set(tt.STATE_NAMES[:18 if flags["want_normal"]
                                           else 15]) | {"chunks"}
    assert port["status"].dtype == torch.int32 and tt.LAUNCHES["wave"] == 0
    chunks = port.pop("chunks")
    assert chunks.shape == (n // group, 3)
    assert int(chunks.sum()) > 0
    _assert_wave_planes(ps, org, dirs, port, ref)
    # rays the tables leave unresolved pass through unchanged
    st_in, st_out = cols[10].reshape(-1), port["status"].reshape(-1)
    unres = (st_in == _ALIVE) & (st_out == _ALIVE) & (port["pid"].reshape(
        -1) < 0)
    if name == "truncated":
        assert bool(torch.isfinite(t_safe).any()) and int(unres.sum()) > 0
    for k in tt.STATE_NAMES[:10]:
        assert torch.equal(port[k].reshape(-1)[unres],
                           cols[tt.STATE_NAMES.index(k)].reshape(-1)[unres])
    # rays at the bounce cap, and dead rays, are not touched and fold
    # nothing
    keep = st_in != _ALIVE
    assert torch.equal(st_out[keep], st_in[keep])
    assert bool(torch.isinf(port["t"].reshape(-1)[keep]).all())
    if name == "image":
        assert flags["want_uv"]
    if name == "rough_glass":
        assert flags["want_normal"] and flags["has_trans"]


def _per_ray(chunks, group):
    """Chunks per exit group [G, 3] -> per ray [G * group, 3]."""
    return chunks.repeat_interleave(group, dim=0)


@pytest.mark.parametrize("name", ["image", "wave_sub_1"])
def test_wave_need_within_warp_within_block(name):
    """On a divergent wavefront (mirror continuations out of bounce 0): the
    exit group changes no plane (bit for bit), and each ray needs no more
    chunks than its warp scans, which scans no more than the first
    design's block; the warps scan less than the blocks."""
    ps, cols, _org, _dirs, (tab, cnts, _ts, c_max, bases), _ref = \
        _wave_case(name)
    wave_sub = _WAVE[name][4]
    blk = tt.LANE * tt.group_rows(wave_sub)
    run = {g: tt.wave_bounce_plain(ps, cols, tab, cnts, c_max, wave_sub,
                                   bases, work=True, group=g)
           for g in (tt.GROUP, blk)}
    warp, block = run[tt.GROUP].pop("chunks"), run[blk].pop("chunks")
    assert all(torch.equal(parity_bits(run[tt.GROUP][k]),
                           parity_bits(run[blk][k])) for k in run[blk])
    need = tt.wave_need(ps, cols, tab, cnts, c_max, run[tt.GROUP]["t"],
                        wave_sub, bases)
    assert need.shape == (cols[0].numel(), 3) and need.dtype == torch.int32
    w, b = _per_ray(warp, tt.GROUP), _per_ray(block, blk)
    assert bool((need <= w).all()) and bool((w <= b).all())
    assert int(w.sum()) < int(b.sum())
    alive = (cols[10] == _ALIVE).reshape(-1)
    assert bool((need[~alive] == 0).all()) and int(need.sum()) > 0


def parity_bits(x):
    """A plane as int32 bits, so a bit-for-bit comparison holds NaNs."""
    return x.contiguous().view(torch.int32) if x.dtype == torch.float32 else x


def test_wave_inputs_are_checked():
    js = packet_scene()
    ps, cols = _camera_wavefront(js, _CAM)
    grid = pcand.build_cell_grid(ps)
    org = torch.stack([c.reshape(-1) for c in cols[0:3]], -1)
    dirs = torch.stack([c.reshape(-1) for c in cols[3:6]], -1)
    tab, cnts, _ = pcand.packet_candidates_grid(
        ps, grid, org, dirs, cols[10].reshape(-1) == _ALIVE, 1024)
    with pytest.raises(ValueError, match="multiple"):
        tt.wave_bounce(ps, cols, tab, cnts, grid.c_max, wave_sub=3)
    with pytest.raises(ValueError, match="shape"):
        tt.wave_bounce(ps, cols, tab[:-1], cnts, grid.c_max)
    with pytest.raises(ValueError, match="CUDA"):
        tt.launch_wave(ps, cols, tab, cnts, grid.c_max,
                       static_bases=grid.base[1:])
    assert (tt.group_rows(8), tt.group_rows(1), tt.group_rows(3)) == (2, 1, 1)
    with pytest.raises(ValueError, match="exit group"):
        tt.wave_bounce_plain(ps, cols, tab, cnts, grid.c_max, group=2048)
