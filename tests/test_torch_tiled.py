"""Kernel B7 (the TILED frame entry) and the sweep-mode frame renderer: the
plain versions against the reference's Pallas kernel (interpret mode on the
CPU) and ``render_frame_tiled``.

Tolerance: the port's parity rule, allclose(rtol=1e-5, atol=1e-6) with
equal status and winner per pixel, except proven winner flips (at most 0.1%
of the pixels) and sphere hits whose difference float32 rounding explains
(XLA on the CPU fuses multiply-adds; ``utils/parity.grazing_prover``, and
for bounce 0's planes the mirror map of ``_assert_planes``). The port's
atan2 differs from the reference's polynomial by up to 9e-8 rad, far inside
atol on u and v."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import raytracer_js_tpu as jrt
import raytracer_js_tpu.render_tiled as jrtl
from raytracer_js_tpu import RenderConfig, make_camera
from raytracer_js_tpu.accel import candidates as jcand
from raytracer_js_tpu.config import HitBackend as JB
from raytracer_js_tpu.kernels import trace_tiled as jtt
from raytracer_js_tpu.ops import sampling as jsamp
import raytracer_js_tpu_torch as prt
from raytracer_js_tpu_torch import render_tiled as prtl
from raytracer_js_tpu_torch.accel import candidates as pcand
from raytracer_js_tpu_torch.kernels import trace_tiled as tt
from raytracer_js_tpu_torch.models.camera import pixel_rays
from raytracer_js_tpu_torch.ops.trace import trace_rays
from raytracer_js_tpu_torch.utils import parity

from test_tiled_fast import _tiny_scene
from test_torch_candidates import _mixed_classes
from test_torch_parity import (assert_parity, to_port_camera, to_port_cfg,
                               to_port_scene)
from test_torch_trace import ext_scene

_B0_CASES = {
    "one_tile": (_tiny_scene, ((0.0, 0.0, 0.5), 128, 32, np.pi / 2,
                               np.pi / 8)),
    "edge_tiles": (_tiny_scene, ((0.05, -0.1, 0.45), 150, 40, 1.45, 1.2)),
    # image texture (uv of spheres, boxes and triangles), glass
    "image_uv_trans": (_mixed_classes, ((0.1, 0.2, 0.5), 131, 37, 1.5,
                                        1.1)),
    "rough_trans": (lambda: ext_scene(trans=True, rough=0.6),
                    ((0.0, 0.0, 0.5), 97, 45, 1.4, 0.9)),
}
#: share of a bounce-0 plane's pixels the mirror map may prove: every
#: mirror direction and normal of a sphere hit differs from the reference's
#: in its last bits (the readings on these cases are at most 9.8%, the
#: normals of the image scene)
B0_MAX_ROUNDING_FRAC = 0.15


def _assert_planes(ps, pc, port, ref):
    """Every plane of the port's bounce 0 against the reference's on the
    frame's pixels."""
    h, w = pc.h, pc.w
    org, dirs = pixel_rays(pc)

    def p(k):
        return port[k][:h, :w].reshape(-1)

    def j(k):
        return torch.as_tensor(np.array(jnp.asarray(ref[k])[:h, :w])).reshape(
            -1)

    assert torch.equal(p("status"), j("status").to(torch.int32))
    pid_p, pid_j = p("pid"), j("pid").to(torch.int32)
    rec = {"pid": pid_p[None], "org": org[None], "dir": dirs[None]}
    prove = parity.flip_prover(ps, rec, pid_j[None])

    def fin(x):
        return torch.where(torch.isfinite(x), x, 0.0)

    sph = (pid_p >= 0) & (pid_p < ps.n_spheres) & (pid_p == pid_j)
    inv_r = 1.0 / ps.sphere_radius[pid_p.long().clamp(0, ps.n_spheres - 1)]
    # what float32 leaves undetermined of t on the pixel's ray, plus one ulp
    # of t: it depends on the ray and the sphere, not on the two results
    dt = (parity.sphere_t_bound(ps, pid_j, org, dirs)
          + 2.0 ** -23 * fin(j("t")).abs().double())
    allow = 8.0 * dt * torch.clamp(inv_r, min=1.0).double() + 1e-6

    def ratio(a, b, idx):
        err = (a[idx] - b[idx]).abs().max(dim=1).values.double()
        return torch.where(sph[idx], err / allow[idx], torch.inf)

    zero = torch.zeros(h * w)
    triples = [("ox", "oy", "oz"), ("dx", "dy", "dz"), ("cr", "cg", "cb"),
               ("path", "t", "u"), ("v",)]
    if "nx" in port:
        triples.append(("nx", "ny", "nz"))
    for names in triples:
        a = torch.stack([fin(p(k)) for k in names]
                        + [zero] * (3 - len(names)), -1)
        b = torch.stack([fin(j(k)) for k in names]
                        + [zero] * (3 - len(names)), -1)
        # the mirror map: a sphere hit's hit point, normal and reflection
        # follow from t by a map with Lipschitz constant at most 4 / r, so
        # the two sides' roundings of t move them by at most 8 dt / r
        rep = parity.compare(
            a, pid_p, b, pid_j, prove=prove,
            prove_rounding=lambda idx: ratio(a, b, idx) <= 1.0,
            max_rounding_frac=B0_MAX_ROUNDING_FRAC)
        assert rep["ok"], (names, rep)


@pytest.mark.parametrize("name", sorted(_B0_CASES))
def test_frame_bounce0_plain_matches_reference(name):
    make, cam_args = _B0_CASES[name]
    js = make()
    jc = make_camera(*cam_args)
    ps, pc = to_port_scene(js), to_port_camera(jc)
    ref = jtt.frame_bounce0(js, jc, *jcand.frame_candidates(js, jc, 32, 128))
    tab, cnts, c_max, _ = prtl.frame_tables(ps, pc)
    port = tt.frame_bounce0(ps, pc, tab, cnts, c_max, work=True)
    flags = tt._flags(ps)
    assert set(port) == set(tt.STATE_NAMES[:18 if flags["want_normal"]
                                           else 15]) | {"chunks"}
    nby, nbx = -(-pc.h // 32), -(-pc.w // 128)
    assert port["cr"].shape == (nby * 32, nbx * 128)
    assert port["status"].dtype == torch.int32
    _assert_planes(ps, pc, port, ref)
    # padding pixels stay MISS; all-padding groups scan nothing
    pad = torch.ones_like(port["status"], dtype=torch.bool)
    pad[:pc.h, :pc.w] = False
    assert (port["status"][pad] == int(prt.RayStatus.MISS)).all()
    chunks = port.pop("chunks")
    assert chunks.shape == (nby * nbx * tt.GROUPS_PER_TILE, 3)
    live = tt.to_groups(~pad, nby, nbx).any(dim=1)
    g_tile = torch.arange(chunks.shape[0]) // tt.GROUPS_PER_TILE
    listed = cnts[g_tile, :3] > 0
    assert torch.equal(chunks > 0, live[:, None] & listed)
    assert bool((chunks.sum(1) * tt.CHUNK <= c_max).all())
    assert tt.LAUNCHES == {"frame": 0, "wave": 0}


def test_group_layout_round_trips():
    """Warps (the kernels' exit groups: 32 rays of a row, in the order of
    their work rows) and the first design's 256-ray blocks (two rows)."""
    x = torch.arange(64 * 256, dtype=torch.float32).reshape(64, 256)
    g = tt.to_groups(x, 2, 2)
    assert g.shape == (2 * 2 * tt.GROUPS_PER_TILE, tt.GROUP)
    assert tt.GROUPS_PER_TILE == tt.TILE_SUB * tt.LANE // 32
    # warp 3 of row 2 of tile (0, 1): row 2, columns 224-255
    assert torch.equal(g[tt.GROUPS_PER_TILE + 2 * 4 + 3], x[2, 224:256])
    assert torch.equal(tt.from_groups(g, 2, 2), x)
    blk = tt.to_groups(x, 2, 2, group=tt.GROUP_SUB * tt.LANE)
    per_tile = tt.TILE_SUB // tt.GROUP_SUB
    assert blk.shape == (2 * 2 * per_tile, 256)
    # block 1 of tile (0, 1): rows 2-3, columns 128-255
    assert torch.equal(blk[per_tile + 1], x[2:4, 128:256].reshape(-1))
    assert torch.equal(tt.from_groups(blk, 2, 2, group=256), x)
    with pytest.raises(ValueError, match="exit group"):
        tt.frame_bounce0_plain(None, None, None, None, 16, group=96)


@pytest.mark.parametrize("name", ["edge_tiles", "image_uv_trans"])
def test_frame_need_within_warp_within_block(name):
    """Bounce 0 with the kernel's warps and with the first design's 256-ray
    blocks: every plane bit for bit; each ray needs no more chunks than its
    warp scans (``frame_need``), which scans no more than its block."""
    make, cam_args = _B0_CASES[name]
    ps, pc = to_port_scene(make()), to_port_camera(make_camera(*cam_args))
    tab, cnts, c_max, _ = prtl.frame_tables(ps, pc)
    run = {g: tt.frame_bounce0_plain(ps, pc, tab, cnts, c_max, work=True,
                                     group=g) for g in (tt.GROUP, 256)}
    warp, block = run[tt.GROUP].pop("chunks"), run[256].pop("chunks")
    for k in run[256]:
        a, b = run[tt.GROUP][k], run[256][k]
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), k
    nby, nbx = -(-pc.h // 32), -(-pc.w // 128)
    need = tt.frame_need(ps, pc, tab, cnts, c_max, run[tt.GROUP]["t"])
    assert need.shape == (nby * 32, nbx * 128, 3)
    per_ray = [torch.stack([tt.from_groups(c[:, k:k + 1].expand(-1, g)
                                           .contiguous(), nby, nbx, g)
                            for k in range(3)], -1)
               for c, g in ((warp, tt.GROUP), (block, 256))]
    assert bool((need <= per_ray[0]).all())
    assert bool((per_ray[0] <= per_ray[1]).all())
    pad = torch.ones_like(run[256]["status"], dtype=torch.bool)
    pad[:pc.h, :pc.w] = False
    assert bool((need[pad] == 0).all()) and int(need.sum()) > 0


@pytest.fixture(scope="module")
def tiny_ref():
    """The reference's sweep frame of the tiny scene (one 128x32 tile),
    with its recording."""
    js = _tiny_scene()
    jc = make_camera((0.0, 0.0, 0.5), 128, 32, np.pi / 2, np.pi / 8)
    cfg = RenderConfig(refmax=2, backend=JB.BRUTE)
    img, diag, rec = jrtl.render_frame_tiled(js, cfg, jc, with_diag=True,
                                             with_record=True)
    assert int(diag["unresolved"]) == 0
    return js, jc, cfg, np.array(img), np.array(rec)


def test_sweep_frame_many_rounds_and_record(tiny_ref, monkeypatch):
    """Sweep mode with a forced-small slice (8 slices, several rounds a
    bounce), ``with_diag`` and ``with_record``: the frame and the recording
    match the reference's, nothing is left unresolved, and the recording
    replays to the same frame."""
    js, jc, cfg, ref, ref_rec = tiny_ref
    ps, pc = to_port_scene(js), to_port_camera(jc)
    monkeypatch.setattr(prtl, "SWEEP_SLICE", 512)
    img, diag, rec = prtl.render_frame_tiled(ps, to_port_cfg(cfg), pc,
                                             with_diag=True, with_record=True)
    assert int(diag["unresolved"]) == 0 and diag["rounds"] >= 2
    assert rec.shape == (pc.h * pc.w, cfg.refmax) and rec.dtype == torch.int32
    zeros = np.zeros((pc.h, pc.w), np.int32)
    assert_parity(img, zeros, ref, zeros)
    org, dirs = pixel_rays(pc)
    rep = parity.compare(img.reshape(-1, 3), rec[:, 0],
                         torch.as_tensor(ref).reshape(-1, 3),
                         torch.as_tensor(ref_rec[:, 0]),
                         prove=parity.flip_prover(
                             ps, {"pid": rec[:, 0][None], "org": org[None],
                                  "dir": dirs[None]},
                             torch.as_tensor(ref_rec[:, 0])[None]))
    assert rep["ok"], rep
    agree = (rec == torch.as_tensor(ref_rec)).all(dim=1).float().mean()
    assert float(agree) >= 1.0 - parity.MAX_FLIP_FRAC
    replay = trace_rays(ps, to_port_cfg(cfg), org, dirs, pid_seq=rec).color
    torch.testing.assert_close(replay.reshape(img.shape), img, rtol=1e-4,
                               atol=1e-5)
    # the default slice takes the bounce in one round
    monkeypatch.undo()
    img1 = prtl.render_frame_tiled(ps, to_port_cfg(cfg), pc)
    assert torch.equal(img1, img)


def test_sweep_frame_skybox_and_bilinear():
    """A cube-map sky and a bilinear image texture ride the glue: the
    kernel applies no sky, image winners sample in the glue."""
    rng = np.random.default_rng(3)
    b = jrt.SceneBuilder(atlas_hw=(8, 8))
    faces = [b.add_solid_texture(c) for c in
             ((1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (1, 0, 1),
              (0, 1, 1))]
    b.set_sky_box(faces)
    diffuse = b.add_material(jrt.ResponseType.REFLECTION)
    mirror = b.add_material(jrt.ResponseType.REFLECTION, mirror=True)
    tex = b.add_image_texture(
        rng.uniform(0.0, 1.0, (8, 8, 3)).astype(np.float32), bilinear=True)
    b.add_box((0.0, 0.0, -21.0), 40.0, diffuse, tex)
    b.add_sphere((4.0, 0.0, 0.5), 1.2, mirror,
                 b.add_solid_texture((0.9, 0.9, 0.9)))
    js = b.build()
    jc = make_camera((0.03, -0.02, 0.5), 128, 32, 1.53, 0.41)
    cfg = RenderConfig(refmax=2, backend=JB.BRUTE)
    ref, j_diag = jrtl.render_frame_tiled(js, cfg, jc, with_diag=True)
    ps, pc = to_port_scene(js), to_port_camera(jc)
    assert not tt._flags(ps)["sky_solid"] and tt._flags(ps)["want_uv"]
    img, diag = prtl.render_frame_tiled(ps, to_port_cfg(cfg), pc,
                                        with_diag=True)
    assert int(diag["unresolved"]) == 0
    zeros = np.zeros((pc.h, pc.w), np.int32)
    assert_parity(img, zeros, np.asarray(ref), zeros,
                  prove_rounding=parity.grazing_prover(ps, *pixel_rays(pc)))


def test_sweep_frame_rough_and_glass():
    """Rough scatter and refraction ride the glue with the reference's RNG
    streams (seed, rid, bounce), the bounce a per-ray tensor in the sweep
    rounds; render_hdr TILED with cached tables and spp 2 averages the
    samples."""
    js = ext_scene(trans=True, rough=0.6)
    jc = make_camera((0.0, 0.0, 0.5), 97, 45, 1.4, 0.9)
    cfg = RenderConfig(refmax=3, spp=2, backend=JB.TILED)
    key = jax.random.key(5)
    ref = np.asarray(jrt.render_hdr(js, jc, cfg, key=key,
                                    tables=jrtl.frame_tables(js, jc)))
    ps, pc = to_port_scene(js), to_port_camera(jc)
    out = prt.render_hdr(ps, pc, to_port_cfg(cfg),
                         seed=int(jsamp.seed_from_key(key)),
                         tables=prtl.frame_tables(ps, pc))
    zeros = np.zeros((pc.h, pc.w), np.int32)
    assert_parity(out, zeros, ref, zeros,
                  prove_rounding=parity.grazing_prover(ps, *pixel_rays(pc)))


def _both_scene():
    """``tests/test_both.py``'s BOTH glass ball before a red wall and a
    light, on the port's SceneBuilder."""
    b = prt.SceneBuilder()
    b.set_sky(b.add_solid_texture((0.35, 0.45, 0.65)))
    grey = b.add_solid_texture((0.6, 0.6, 0.6))
    white = b.add_solid_texture((1.0, 1.0, 1.0))
    diffuse = b.add_material(prt.ResponseType.REFLECTION)
    light = b.add_material(prt.ResponseType.REFLECTION, light=True)
    both = b.add_material(prt.ResponseType.BOTH)
    glass = b.add_substance(1.5)
    b.add_box((0.0, 0.0, -51.0), 100.0, diffuse, grey)
    b.add_sphere((2.4, 0.0, 0.5), 0.9, both, white, glass)
    b.add_sphere((6.0, 0.0, 0.5), 1.2, diffuse,
                 b.add_solid_texture((0.9, 0.2, 0.1)))
    b.add_sphere((4.0, 0.0, 4.5), 1.1, light, white)
    return b.build(device="cpu")


def test_tiled_refuses_fresnel_both():
    """The TILED kernels have no Fresnel-BOTH split: a direct TILED frame of
    a BOTH scene with ``fresnel_both`` rendered BOTH as terminal without a
    word; it now raises, naming PALLAS. ``render_hdr`` still sends BOTH
    scenes to PALLAS, cached tables or not."""
    ps = _both_scene()
    pc = prt.make_camera((0.0, 0.0, 0.5), 16, 8, np.pi / 2, np.pi / 4,
                         device="cpu")
    cfg = prt.RenderConfig(refmax=3, backend=prt.HitBackend.TILED,
                           fresnel_both=True)
    tables = prtl.frame_tables(ps, pc)
    for frame in (prtl.render_frame_tiled,
                  prtl.render_frame_tiled_replay_shaded):
        with pytest.raises(ValueError, match="PALLAS"):
            frame(ps, cfg, pc, tables=tables)
    pallas = prt.render_hdr(ps, pc, dataclasses.replace(
        cfg, backend=prt.HitBackend.PALLAS), seed=5)
    assert torch.equal(prt.render_hdr(ps, pc, cfg, seed=5, tables=tables),
                       pallas)
    # without the split, BOTH is terminal in every backend: TILED renders
    terminal = dataclasses.replace(cfg, fresnel_both=False)
    assert tuple(prtl.render_frame_tiled(ps, terminal, pc,
                                         tables=tables).shape) == (8, 16, 3)


def test_unported_tiled_parts_raise(monkeypatch):
    """The TILED path has no unported part left: the octree ``accel=``
    renders (its substance query is the dense one's; the frame is the
    frame without it). The frame kernel's launcher refuses CPU
    tensors."""
    from raytracer_js_tpu_torch.accel.octree import build_octree

    ps = to_port_scene(_tiny_scene())
    pc = to_port_camera(make_camera((0, 0, 0.5), 16, 8, 1.0, 0.5))
    cfg = prt.RenderConfig(refmax=2, backend=prt.HitBackend.TILED)
    accel = build_octree(ps, prt.OctreeConfig(max_depth=2))
    plain = prtl.render_frame_tiled(ps, cfg, pc)
    assert torch.equal(prtl.render_frame_tiled(ps, cfg, pc, accel=accel),
                       plain)
    assert torch.equal(prt.render_hdr(ps, pc, cfg, accel=accel),
                       prt.render_hdr(ps, pc, cfg))
    tab, cnts, c_max, _ = prtl.frame_tables(ps, pc)
    ca = tt._cam_array(pc, ps.textures.solid_rgb[ps.sky_tex],
                       *tt._scene_bbox(ps))
    with pytest.raises(ValueError, match="CUDA"):
        tt.launch_frame(tab, cnts, ca, c_max, 1, 1, **tt._flags(ps))
