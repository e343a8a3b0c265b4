"""Kernel B8 (the cone-culled nearest hit) and the sweep rounds' gating:
B8's plain version against the reference's culled Pallas kernel
(interpret mode on the CPU) and against the port's B4 plain version, and
sweep-mode frames with ``SWEEP_CULL`` and without ``SWEEP_LISTED``.

Tolerances: B8's plain version equals B4's bit for bit (t and pid),
whatever its exit group (``group``: 32 rays, the kernel's warp, or 128,
the first design's block): the cull is conservative and the fold order is
B4's. Against the reference's
kernel the pids are equal and t is held to the parity rule with float32
rounding slack for grazing sphere hits (its o.c and d.c dots are a matrix
product, XLA fuses multiply-adds on the CPU: ``parity.compare_hits``).
Frames: the port's parity rule, allclose(rtol 1e-5, atol 1e-6) with proven
flips and grazing-sphere rounding."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import raytracer_js_tpu.render_tiled as jrtl
from raytracer_js_tpu import RenderConfig, make_camera
from raytracer_js_tpu.config import HitBackend as JB
from raytracer_js_tpu.kernels import nearest_hit as jnh
from raytracer_js_tpu_torch import render_tiled as prtl
from raytracer_js_tpu_torch.kernels import nearest_hit as nh
from raytracer_js_tpu_torch.models.camera import pixel_rays
from raytracer_js_tpu_torch.utils import parity

from test_torch_listed import field_rays, sphere_field
from test_torch_parity import (assert_parity, to_port_camera, to_port_cfg,
                               to_port_scene)

_CAM = ((0.0, 0.0, 0.5), 128, 32, np.pi / 2, np.pi / 2 / 4)


def _rays(kind):
    """(org, dir, n_live): camera rays of a 128x32 frame (coherent 128-ray
    blocks, the cull fires), or ``field_rays`` with random directions (wide
    cones: cos_t < 0.25 keeps every tile)."""
    if kind == "camera":
        org, d = pixel_rays(to_port_camera(make_camera(*_CAM)))
        return org.numpy(), d.numpy(), org.shape[0] - 200
    org, d = field_rays(512)
    return org, d, 470


@pytest.mark.parametrize("group", [32, 128])
@pytest.mark.parametrize("kind", ["camera", "wide"])
def test_culled_matches_reference_and_dense(kind, group):
    js = sphere_field()
    ps = to_port_scene(js)
    j_sw, p_sw = jrtl._sweep_perm(js), prtl._sweep_perm(ps)
    np.testing.assert_allclose(p_sw[1][1].numpy(), np.asarray(j_sw[1][1]),
                               rtol=1e-6, atol=1e-6)
    org, d, n_live = _rays(kind)
    o, dd = torch.as_tensor(org), torch.as_tensor(d)
    tb = p_sw[1][1]
    t, pid, tiles = nh.nearest_hit_culled_plain(p_sw[0], o, dd, tb, n_live,
                                                work=True, group=group)
    # equal to B4 bit for bit, rows past n_live included (+inf, -1)
    b_t, b_pid = nh.nearest_hit_pallas_plain(p_sw[0], o, dd, n_live=n_live)
    assert torch.equal(t, b_t) and torch.equal(pid, b_pid)
    j_t, j_pid = jnh.nearest_hit_pallas(
        j_sw[0], jnp.asarray(org), jnp.asarray(d),
        n_live=jnp.int32(n_live), tile_bounds=j_sw[1][1])
    live = slice(0, n_live)
    np.testing.assert_array_equal(pid[live].numpy(), np.asarray(j_pid)[live])
    rep = parity.compare_hits(p_sw[0], o[live], dd[live], t[live], pid[live],
                              torch.as_tensor(np.array(j_t)[live]),
                              torch.as_tensor(np.array(j_pid)[live]),
                              rounding_slack=True)
    assert rep["ok"] and rep["flips"] == 0 and rep["hits"] > 100, rep
    n_blk, n_t = -(-org.shape[0] // nh.BLOCK_R), tb.shape[0]
    live_g = -(-n_live // group)
    assert tiles.shape == (n_blk, 128 // group)
    tiles = tiles.reshape(-1)
    assert (tiles[live_g:] == 0).all()
    if kind == "camera":
        # coherent groups skip tiles
        assert int(tiles[:live_g].min()) < n_t
    else:
        assert bool((tiles[:live_g] == n_t).all())


def test_warp_cones_stream_less():
    """The kernel's per-warp cones keep no more sphere tiles than the block
    cone around them (each warp's rays are a subset), and fewer somewhere
    on the camera rays; every ray's own tiles (``group=1``: apex 0, angle
    0) lie within its warp's."""
    ps = to_port_scene(sphere_field())
    tb = prtl._sweep_perm(ps)[1][1]
    org, d, n_live = _rays("camera")
    o, dd = torch.as_tensor(org), torch.as_tensor(d)
    inc = {g: nh.culled_tiles(o, dd, n_live, tb, ps.n_spheres, group=g)
           for g in (1, 32, 128)}
    assert inc[1].shape == (o.shape[0], tb.shape[0])
    warp_of_block = inc[128].repeat_interleave(4, dim=0)
    assert bool((inc[32] <= warp_of_block).all())
    assert int(inc[32].sum()) < int(warp_of_block.sum())
    own = inc[1][:n_live]
    assert bool((own <= inc[32].repeat_interleave(32, dim=0)[:n_live]).all())


@pytest.mark.parametrize("group", [32, 128])
def test_culled_block_sums_and_cone(group):
    """The prologue's sums run in the kernel's fixed order: a shuffle-down
    tree over each warp (the kernel's group is one warp), then, for the
    first design's 128-ray block, the four warp sums left to right; a
    group whose live rays point every way keeps every tile (cos_t <
    0.25)."""
    x = torch.arange(256, dtype=torch.float32).reshape(-1, group) * 0.37
    want = []
    for row in x:
        w = []
        for k in range(group // 32):
            v = row[32 * k:32 * k + 32].clone()
            for off in (16, 8, 4, 2, 1):
                v = v[:off] + v[off:2 * off]
            w.append(v[0])
        acc = w[0]
        for v in w[1:]:
            acc = acc + v
        want.append(acc)
    assert torch.equal(nh._group_sum(x, group), torch.stack(want))
    ps = to_port_scene(sphere_field())
    tb = prtl._sweep_perm(ps)[1][1]
    org, d = map(torch.as_tensor, field_rays(256))
    inc = nh.culled_tiles(org, d, 128, tb, ps.n_spheres, group=group)
    assert inc.shape == (256 // group, tb.shape[0])
    assert bool(inc[:128 // group].all())


def _sweep_frames(monkeypatch, listed, cull):
    """The reference's and the port's sweep frames of the 700-sphere field
    with ``SWEEP_LISTED``/``SWEEP_CULL`` set in both packages -> (ref, port
    image, port diag, which plain search versions ran)."""
    js = sphere_field()
    jc = make_camera(*_CAM)
    cfg = RenderConfig(refmax=2, backend=JB.BRUTE)
    for mod in (jrtl, prtl):
        monkeypatch.setattr(mod, "SWEEP_LISTED", listed)
        monkeypatch.setattr(mod, "SWEEP_CULL", cull)
    ref, j_diag = jrtl.render_frame_tiled(js, cfg, jc, with_diag=True)
    assert int(j_diag["unresolved"]) == 0
    ps, pc = to_port_scene(js), to_port_camera(jc)
    calls = []
    for name in ("nearest_hit_pallas_plain", "nearest_hit_listed_plain",
                 "nearest_hit_culled_plain"):
        real = getattr(nh, name)

        def spy(*a, real=real, name=name, **kw):
            calls.append((name, a[0].sphere_center.shape[0] and bool(
                torch.equal(a[0].sphere_center, ps.sphere_center))))
            return real(*a, **kw)

        monkeypatch.setattr(nh, name, spy)
    img, diag = prtl.render_frame_tiled(ps, to_port_cfg(cfg), pc,
                                        with_diag=True)
    return ps, pc, np.asarray(ref), img, diag, calls


@pytest.mark.parametrize("listed,cull", [(False, True), (False, False)])
def test_sweep_frame_cull_and_unlisted(monkeypatch, listed, cull):
    """``SWEEP_CULL`` without lists: every sweep round searches with B8's
    plain version on the Morton-permuted scene. Neither: the whole-table
    B4 on the scene as given. Both frames equal the reference's."""
    ps, pc, ref, img, diag, calls = _sweep_frames(monkeypatch, listed, cull)
    assert int(diag["unresolved"]) == 0 and diag["rounds"] >= 1
    # the culled version runs B4's scan inside, so count the entry calls
    entry = [c for c in calls if c[0] != "nearest_hit_pallas_plain"]
    if cull:
        assert [c[0] for c in entry] == (["nearest_hit_culled_plain"]
                                         * diag["rounds"])
        # the permuted scene
        assert not any(c[1] for c in entry)
    else:
        assert not entry and len(calls) == diag["rounds"]
        assert all(c[1] for c in calls)
    zeros = np.zeros((pc.h, pc.w), np.int32)
    assert_parity(img, zeros, ref, zeros,
                  prove_rounding=parity.grazing_prover(ps, *pixel_rays(pc)))
