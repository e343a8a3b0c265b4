"""Big-scene frame renderer: the TILED backend.

Port of ``raytracer_js_tpu.render_tiled`` (BASELINE configs 4 and 5):

* bounce 0 — kernel B7 (``kernels/trace_tiled.frame_bounce0``) builds the
  rays from the camera and scans per-tile candidate tables
  (``accel/candidates.frame_candidates``, host-built once per camera pose);
* bounces >= 1, scenes of at most ``SWEEP_MAX_PRIMS`` prims — sweep rounds
  (:func:`_rescue_round`): the still-working rays are sorted by (position
  cell, direction bin) and compacted to the front; with ``SWEEP_LISTED``
  each 128-ray block gets a conservative list of Morton-ordered 128-sphere
  (and 128-triangle) tiles (:func:`_block_tile_select`) and kernel B6
  (``kernels/nearest_hit``, listed) finds the winners; with ``SWEEP_CULL``
  instead kernel B8 culls sphere tiles by each block's cone; else B4
  searches the whole table. ``ops/trace._bounce`` shades and respawns
  with ``pid_override``;
* bounces >= 1, larger scenes — packet rounds (:func:`packet_bounce`): the
  working rays are sorted into coherent packets, each packet gets its own
  candidate table from the cell grid of :func:`frame_tables`
  (``accel/candidates.packet_candidates_grid``), kernel B7-wave
  (``kernels/trace_tiled.wave_bounce``) advances every ray its table
  resolves, and unresolved rays march through their proven-empty horizon;
  ``EXTRA_ROUNDS`` retries bin finer, and whole-table rescue rounds (B4)
  finish what is left.

The terminal semantics (EXHAUST blackout, light-hit inverse-square
attenuation) are applied at the end (:func:`_epilogue`). Image textures,
image and cube-map skies (:func:`_apply_images`), rough scatter and
refraction (:func:`_respawn_glue`) ride the glue between the kernels.

The octree ``accel=`` (``accel/octree``) serves the transmission substance
query of the glue and of the sweep and rescue rounds: without it the query
is dense, [rays, prims] per call, which does not fit the card at 100k prims
and a full frame. What raises: inputs that require grad (the kernels return detached values, so a loss would get
partial gradients); and BOTH scenes with ``fresnel_both`` (the kernels have
no Fresnel split; ``render_hdr`` sends BOTH scenes to PALLAS). The
reference's ``RT_*`` environment knobs are module constants here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .accel import candidates as cand
from .config import (EPS_ADVANCE, JS_EPSILON, HitBackend, RayStatus,
                     RenderConfig, ResponseType)
from .kernels import nearest_hit as nh
from .kernels import trace_tiled as tt
from .kernels.nearest_hit import BLOCK_K, BLOCK_R
from .models import textures as tex_mod
from .models.camera import pixel_rays
from .models.scene import Scene
from .ops import sampling
from .ops import trace as trace_mod
from .ops.vecmath import refract
from .utils.profiling import span

Tensor = torch.Tensor

#: scenes at or below this primitive count run sweep rounds for bounces
#: >= 1; above it, packet rounds
SWEEP_MAX_PRIMS = 1048576
#: the compacted live prefix one sweep round processes; overflow live rays
#: take another round
SWEEP_SLICE = 655360
#: listed id-table width cap: classes with more 128-prim tiles get a
#: supertile fan
LISTED_MAX_TILES = 2048
#: sweep rounds search with per-block tile lists (kernel B6)
SWEEP_LISTED = True
#: sweep rounds cull sphere tiles in the kernel by each block's cone (kernel
#: B8) where nothing was listed (the reference measured it slower than the
#: lists and keeps it opt-in)
SWEEP_CULL = False
#: a class is listed only with at least this many (super)tiles: below it
#: the per-chunk exits cost more than the dense stream saves
LISTED_MIN_TILES = 64

#: packet rounds: retry rounds beyond refmax - 1 for rays their truncated
#: tables left unresolved
EXTRA_ROUNDS = 10
#: ceiling on the rowwise packet tables' candidate budget
ESC_MAX = 1 << 14
#: rays a whole-table rescue round resolves (B4 over the compacted slice)
RESCUE_CAP = 65536
#: packets per segment: a packet round works on the segments that hold a
#: live ray (live rays sort to the front)
SEG_PACKETS = 128
#: packet height in rows of 128 rays
WAVE_SUB = tt.WAVE_SUB

#: internal status marking rays at the bounce cap, so the shading pass
#: leaves them alone without losing their ALIVE-ness
_CAP = 7
_ALIVE = int(RayStatus.ALIVE)
_MISS = int(RayStatus.MISS)
_NAMES = ("ox", "oy", "oz", "dx", "dy", "dz", "cr", "cg", "cb", "path",
          "status")


def supports(scene: Scene) -> bool:
    """The full shading model rides this path: image textures and skies
    (uv from the kernels, the atlas sampled in the glue), roughness and
    transmission (the glue)."""
    return True


def frame_tables(scene: Scene, cam, packet_c_max: int = 4096):
    """Host-side bounce-0 candidate tables and the packet rounds' cell grid
    (cache them across frames while the camera pose and the geometry are
    unchanged) -> ``(tab, cnts, c_max, grid)``; ``packet_c_max`` sizes the
    grid's per-packet row budget."""
    tab, cnts, c_max = cand.frame_candidates(scene, cam, tt.TILE_SUB,
                                             tt.LANE)
    grid = cand.build_cell_grid(scene, c_sel=packet_c_max)
    return tab, cnts, c_max, grid


def _dir_bin(d: Tensor) -> Tensor:
    """Coarse direction bin (4 levels per axis, 64 bins)."""
    q = torch.clamp(((d + 1.0) * 2.0).to(torch.int32), 0, 3)
    return (q[:, 0] * 4 + q[:, 1]) * 4 + q[:, 2]


_MASK32 = 0xFFFFFFFF


def _spread3(x: Tensor) -> Tensor:
    """Spread the low 8 bits of x so consecutive bits land 3 apart (uint32
    arithmetic in int64 holders masked to 32 bits)."""
    x = x.to(torch.int64) & 0xFF
    x = ((x * 0x00010001) & _MASK32) & 0xFF0000FF
    x = ((x * 0x00000101) & _MASK32) & 0x0F00F00F
    x = ((x * 0x00000011) & _MASK32) & 0xC30C30C3
    x = ((x * 0x00000005) & _MASK32) & 0x49249249
    return x


def _median(x: Tensor) -> Tensor:
    """The reference's ``jnp.median``: the mean of the two middle values
    ((lo + hi) * 0.5) on an even count."""
    s = torch.sort(x).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def _robust_extent(scene: Scene):
    """(lo, hi) of the SMALL-primitive population (huge straddlers like the
    ground box are left out: they would flatten every quantization)."""
    centers, radii = cand.bounding_spheres(scene)
    med = (_median(radii) if radii.shape[0]
           else torch.tensor(1.0, device=scene.device))
    small = radii <= 8.0 * med + 1e-12
    big = 1e30
    lo = torch.where(small[:, None], centers - radii[:, None], big).min(
        dim=0).values
    hi = torch.where(small[:, None], centers + radii[:, None], -big).max(
        dim=0).values
    return lo, hi


def _morton_key(scene: Scene, org: Tensor, bits: int = 8) -> Tensor:
    """Morton code of positions over the robust extent -> i32."""
    lo, hi = _robust_extent(scene)
    rel = (org - lo) / torch.clamp(hi - lo, min=1e-20)
    q = torch.clamp((rel * (1 << bits)).to(torch.int32), 0, (1 << bits) - 1)
    code = (_spread3(q[:, 0]) | (_spread3(q[:, 1]) << 1)
            | (_spread3(q[:, 2]) << 2))
    return code.to(torch.int32)


def _pos_cell(scene: Scene, org: Tensor, grid: int = 16) -> Tensor:
    """Binning cell over the small-primitive population bounds."""
    lo, hi = _robust_extent(scene)
    rel = (org - lo) / torch.clamp(hi - lo, min=1e-20)
    q = torch.clamp((rel * grid).to(torch.int32), 0, grid - 1)
    return (q[:, 0] * grid + q[:, 1]) * grid + q[:, 2]


def _apply_images(scene: Scene, colors, dirs, status, prev_alive, pid, u, v):
    """Image-texture and (image or cube-map) sky modulation for one bounce:
    the kernel leaves image-textured winners at identity and skips the sky
    when the scene has images or a sky box; this samples the atlas for
    image-kind winners and applies the sky to rays that MISSed this
    bounce. ``colors`` [n, 3]; the masks [n]."""
    hit = pid >= 0
    pid_c = torch.clamp(pid.long(), 0, max(scene.n_prims - 1, 0))
    tex_id = scene.prim_texture[pid_c]
    kind = scene.textures.kind[torch.clamp(
        tex_id.long(), 0, scene.textures.kind.shape[0] - 1)]
    is_img = hit & tex_mod.is_image_kind(kind)
    smp = tex_mod.sample(scene.textures, tex_id, u, v)
    colors = torch.where(is_img[:, None], colors * smp, colors)
    newly_miss = prev_alive & (status == _MISS)
    return torch.where(newly_miss[:, None],
                       colors * trace_mod.sky_color(scene, dirs), colors)


def _respawn_glue(scene: Scene, seed, rid, bounce, refr, org, dirs, status,
                  pid, t, nrm, accel=None):
    """Rough-scatter and transmission continuations for one bounce, as
    ``ops/trace._bounce`` does them: the kernel reflects mirror winners and
    leaves transmission winners (mode 3) untouched. Rough mirror winners get
    the counter-RNG scatter (same (seed, rid, bounce) streams as every
    backend), re-advancing the origin; transmission winners advance along
    the old direction, query the innermost containing substance and refract
    (Snell + TIR); ``accel`` (the octree) serves the substance query.
    ``nrm`` is the flipped winner normal. Returns ``(org, dirs, refr)``."""
    alive = status == _ALIVE
    cont = alive & (pid >= 0)
    pid_c = torch.clamp(pid.long(), 0, max(scene.n_prims - 1, 0))
    mat_id = scene.prim_material[pid_c].long()
    mat = scene.materials
    resp = mat.response[mat_id]
    if scene.has_rough:
        rough = mat.roughness[mat_id]
        m_r = (cont & (resp == int(ResponseType.REFLECTION))
               & mat.mirror[mat_id] & (rough > 0.0))
        # invert the kernel's eps-advance to recover the hit point
        hit = org - EPS_ADVANCE * dirs
        scat = sampling.scatter_direction(seed, rid, bounce, dirs, nrm, rough)
        dirs = torch.where(m_r[:, None], scat, dirs)
        org = torch.where(m_r[:, None], hit + EPS_ADVANCE * scat, org)
    if scene.has_transmission:
        is_t = cont & (resp == int(ResponseType.TRANSMISSION))
        hit = org + t[:, None] * dirs
        adv = hit + EPS_ADVANCE * dirs
        target, do_refract = trace_mod.substance_refr_at(scene, adv, refr,
                                                         accel=accel)
        eta = refr / torch.clamp(target, min=1e-6)
        refr_dir, _tir = refract(dirs, nrm, eta)
        new_dir = torch.where(do_refract[:, None], refr_dir, dirs)
        new_refr = torch.where(do_refract, target, refr)
        dirs = torch.where(is_t[:, None], new_dir, dirs)
        org = torch.where(is_t[:, None], adv, org)
        refr = torch.where(is_t, new_refr, refr)
    return org, dirs, refr


def _block_tile_select(org: Tensor, dirs: Tensor, working: Tensor,
                       tb: Tensor):
    """Per-ray-block conservative tile selection for B6 -> (ids [B, T] i32
    in ascending t_lo order, tlo [B, T] f32, +inf on excluded slots).

    Blocks are consecutive 128-ray runs of the (cell, direction)-sorted
    slice; each gets an apex ball (o0, ro) over its WORKING rays and a
    direction cone (axis = mean direction, cos_t = worst alignment), and a
    Morton tile is included iff the ball-cone can reach its bounding sphere
    (the identity of ``accel/candidates.cone_include_np``), so the cull is
    exact. The sort is stable (the reference's ``argsort``), so equal t_lo
    keep tile order: a t tie across tiles goes to the first tile streamed.
    """
    n = org.shape[0]
    assert n % BLOCK_R == 0, (n, BLOCK_R)
    nb = n // BLOCK_R

    def norm(v):
        return torch.sqrt((v * v).sum(-1))

    o = org.reshape(nb, BLOCK_R, 3)
    d = dirs.reshape(nb, BLOCK_R, 3)
    m = working.reshape(nb, BLOCK_R, 1).to(org.dtype)
    cnt_live = torch.clamp(m.sum(dim=1), min=1.0)             # [B, 1]
    o0 = (o * m).sum(dim=1) / cnt_live                        # [B, 3]
    ro = torch.sqrt(torch.max(((o - o0[:, None]) ** 2).sum(-1) * m[..., 0],
                              dim=1).values)                  # [B]
    ax = (d * m).sum(dim=1)
    ax = ax / torch.clamp(norm(ax)[:, None], min=1e-20)
    d_n = d / torch.clamp(norm(d)[..., None], min=1e-20)
    cos_t = torch.where(m[..., 0] > 0, (d_n * ax[:, None]).sum(-1),
                        1.0).min(dim=1).values
    use_cone = cos_t >= 0.25
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t ** 2, min=0.0))
    v = tb[None, :, :3] - o0[:, None, :]                      # [B, T, 3]
    dist = norm(v)
    rr = tb[None, :, 3] + ro[:, None]
    inside = dist <= rr * (1.0 + 1e-5) + 1e-7
    sin_a = torch.clamp(rr / torch.clamp(dist, min=1e-20), max=1.0)
    cos_a = torch.sqrt(torch.clamp(1.0 - sin_a ** 2, min=0.0))
    cos_b = (v * ax[:, None]).sum(-1) / torch.clamp(dist, min=1e-20)
    include = (inside
               | (cos_b >= cos_a * cos_t[:, None] - sin_a * sin_t[:, None]
                  - 1e-5)
               | ~use_cone[:, None])
    # conservative per-(block, tile) entry distance, the sort key
    t_lo = torch.where(include, torch.clamp(dist - rr, min=0.0), torch.inf)
    tlo_sorted, order = torch.sort(t_lo, dim=1, stable=True)
    return order.to(torch.int32), tlo_sorted


def _sweep_perm(scene: Scene):
    """Morton-permuted prim tables plus per-(super)tile bounds for the
    listed search -> (scene_view, sph, tri), each class entry ``(perm [n]
    i32, tb [T, 4] f32, fan)`` or None; None when no class takes part.

    Only the geometry is permuted: winners map back to global ids before
    shading, so id-indexed tables stay as they are. A class takes part with
    at least 4 * BLOCK_K primitives.
    """
    def class_fan(n):
        # coarsen the listed granularity until the id table fits
        # LISTED_MAX_TILES (super)tiles
        fan = 1
        while -(-(-(-n // BLOCK_K)) // fan) > LISTED_MAX_TILES:
            fan *= 2
        return fan

    def norm(v):
        return torch.sqrt((v * v).sum(-1))

    def tile_bounds(c_p, r_p, fan):
        blk = BLOCK_K * fan
        n = c_p.shape[0]
        t = -(-n // blk)
        pad = t * blk - n
        cp = torch.cat([c_p, c_p[-1:].expand(pad, 3)]) if pad else c_p
        rp = torch.cat([r_p, r_p.new_zeros(pad)]) if pad else r_p
        cpt = cp.reshape(t, blk, 3)
        rpt = rp.reshape(t, blk)
        tc = 0.5 * (cpt.min(dim=1).values + cpt.max(dim=1).values)
        tr = torch.max(norm(cpt - tc[:, None]) + rpt, dim=1).values
        return torch.cat([tc, tr[:, None]], dim=1)

    scene_p = scene
    sph = tri = None
    if scene.n_spheres >= 4 * BLOCK_K:
        code = _morton_key(scene, scene.sphere_center, bits=8)
        perm = torch.argsort(code, stable=True).to(torch.int32)
        c_p = scene.sphere_center[perm.long()]
        r_p = scene.sphere_radius[perm.long()]
        scene_p = dataclasses.replace(scene_p, sphere_center=c_p,
                                      sphere_radius=r_p)
        fan = class_fan(scene.n_spheres)
        sph = (perm, tile_bounds(c_p, r_p, fan), fan)
    if scene.n_tris >= 4 * BLOCK_K:
        cent = (scene.tri_v0 + scene.tri_v1 + scene.tri_v2) / 3.0
        code = _morton_key(scene, cent, bits=8)
        perm = torch.argsort(code, stable=True).to(torch.int32)
        pl = perm.long()
        v0, v1, v2 = scene.tri_v0[pl], scene.tri_v1[pl], scene.tri_v2[pl]
        scene_p = dataclasses.replace(scene_p, tri_v0=v0, tri_v1=v1,
                                      tri_v2=v2)
        c_p = cent[pl]
        r_p = torch.maximum(torch.maximum(norm(v0 - c_p), norm(v1 - c_p)),
                            norm(v2 - c_p))
        fan = class_fan(scene.n_tris)
        tri = (perm, tile_bounds(c_p, r_p, fan), fan)
    if sph is None and tri is None:
        return None
    return scene_p, sph, tri


def _read_any(x: Tensor) -> bool:
    """``bool(x.any())``, the frame path's blocking device-to-host read, in
    an ``rt.sync`` span: the spans count the reads and time the waits."""
    with span("rt.sync"):
        return bool(x.any())


def _epilogue(cr, cg, cb, path, status, atten: float):
    """EXHAUST blackout and the light-hit inverse-square law."""
    exhausted = status == _ALIVE
    status = torch.where(exhausted, int(RayStatus.EXHAUST), status)
    pa = path * atten
    isl = 1.0 / (JS_EPSILON + pa * pa)
    lit = status == int(RayStatus.LIGHT)
    scale = torch.where(exhausted, 0.0, torch.where(lit, isl, 1.0))
    return cr * scale, cg * scale, cb * scale, status


def _rescue_round(scene: Scene, cfg: RenderConfig, flat, bounce, refr, seed,
                  rid, shader, cap: int, sweep_tab=None, rec=None,
                  accel=None):
    """One sweep round: sort the still-working rays to the front in
    (position cell, direction bin) order, search the first ``cap`` of them
    (with ``sweep_tab``, the :func:`_sweep_perm` tables: B6 listed per
    128-ray block for each class with ``LISTED_MIN_TILES`` tiles when
    ``SWEEP_LISTED``, else B8 culling the sphere tiles when ``SWEEP_CULL``;
    B4 whole-table otherwise), shade and respawn through ``shader`` (the
    frame's ``ops/trace._shader``) with ``pid_override``, and scatter the
    state back. Each round fully resolves up to ``cap`` working rays (hit, miss
    or continuation).

    ``flat`` holds the 11 state columns [n]; ``bounce``/``refr`` [n];
    ``rec`` ([n, refmax] i32, -1-initialized) switches on path recording:
    each resolved ray's winner is written at its bounce column; ``accel``
    serves the substance query. Returns the updated ``(flat, bounce, refr,
    rec)``.
    """
    with span("rt.tiled.round"):
        n = flat[0].shape[0]
        cap = min(cap, n)
        working = (flat[10] == _ALIVE) & (bounce < cfg.refmax)
        if not _read_any(working):
            return flat, bounce, refr, rec
        org_a = torch.stack(flat[0:3], -1)
        dir_a = torch.stack(flat[3:6], -1)
        key = (_pos_cell(scene, org_a) * 64 + _dir_bin(dir_a)).to(torch.int32)
        key = torch.where(working, key, 1 << 30)
        perm = torch.sort(key, stable=True).indices
        flat_s = [f[perm] for f in flat]
        bounce_s, refr_s = bounce[perm], refr[perm]
        rid_s = rid[perm] if rid is not None else None
        rec_s = rec[perm] if rec is not None else None
        sl = [f[:cap] for f in flat_s]
        org = torch.stack(sl[0:3], -1)
        dirs = torch.stack(sl[3:6], -1)
        # working rays are the sorted prefix: the search skips every block
        # past them
        nl = torch.clamp(working.sum(), max=cap).to(torch.int32)
        work_sl = (sl[10] == _ALIVE) & (bounce_s[:cap] < cfg.refmax)
        if sweep_tab is not None:
            scene_s, sph_e, tri_e = sweep_tab
            kw = {}
            if SWEEP_LISTED:
                if sph_e is not None and sph_e[1].shape[0] >= LISTED_MIN_TILES:
                    kw["tile_ids"] = _block_tile_select(org, dirs, work_sl,
                                                        sph_e[1])
                    kw["sph_fan"] = sph_e[2]
                if tri_e is not None and tri_e[1].shape[0] >= LISTED_MIN_TILES:
                    kw["tri_tile_ids"] = _block_tile_select(org, dirs, work_sl,
                                                            tri_e[1])
                    kw["tri_fan"] = tri_e[2]
            if (not kw and SWEEP_CULL and sph_e is not None and sph_e[2] == 1
                    and sph_e[1].shape[0] <= LISTED_MAX_TILES):
                # the in-kernel block-cone cull of sphere tiles (B8)
                kw["tile_bounds"] = sph_e[1]
            _t, pid = nh.nearest_hit_pallas(scene_s, org, dirs, n_live=nl,
                                            **kw)
            # winners map back from permuted-class to global ids
            pid = pid.long()
            if sph_e is not None:
                loc = torch.clamp(pid, 0, max(scene.n_spheres - 1, 0))
                pid = torch.where((pid >= 0) & (pid < scene.n_spheres),
                                  sph_e[0].long()[loc], pid)
            if tri_e is not None:
                b_end = scene.n_spheres + scene.n_boxes
                loc = torch.clamp(pid - b_end, 0, max(scene.n_tris - 1, 0))
                pid = torch.where(pid >= b_end, b_end + tri_e[0].long()[loc],
                                  pid)
        else:
            _t, pid = nh.nearest_hit_pallas(scene, org, dirs, n_live=nl)
        pid = torch.where(work_sl, pid, -1).to(torch.int32)
        st = trace_mod.RayState(
            org=org, dir=dirs, color=torch.stack(sl[6:9], -1), path=sl[9],
            refr=refr_s[:cap], status=torch.where(work_sl, _ALIVE, torch.where(
                sl[10] == _ALIVE, _CAP, sl[10])).to(torch.int32))
        rng = (seed, rid_s[:cap]) if scene.has_rough else None
        out, alive = shader(cfg, st, rng, bounce_s[:cap], pid_override=pid,
                            accel=accel)
        cont = work_sl & alive
        status_out = torch.where(out.status == _CAP, _ALIVE, out.status).to(
            torch.int32)
        new_sl = [out.org[:, 0], out.org[:, 1], out.org[:, 2],
                  out.dir[:, 0], out.dir[:, 1], out.dir[:, 2],
                  out.color[:, 0], out.color[:, 1], out.color[:, 2],
                  out.path, status_out]
        # scatter back: position k of the sorted order is ray perm[k]
        flat_n = []
        for a, f in zip(new_sl, flat_s):
            g = torch.empty_like(f)
            g[perm] = torch.cat([a.to(f.dtype), f[cap:]])
            flat_n.append(g)
        bounce_n = torch.empty_like(bounce)
        bounce_n[perm] = torch.cat([bounce_s[:cap] + cont.to(bounce.dtype),
                                    bounce_s[cap:]])
        refr_n = torch.empty_like(refr)
        refr_n[perm] = torch.cat([out.refr, refr_s[cap:]])
        if rec is not None:
            # a working slice ray records its winner (-1 = resolved miss) at
            # its current bounce column
            upd = (work_sl[:, None] & (bounce_s[:cap, None] == torch.arange(
                cfg.refmax, device=rec.device)))
            head = torch.where(upd, pid[:, None], rec_s[:cap])
            rec_n = torch.empty_like(rec)
            rec_n[perm] = torch.cat([head, rec_s[cap:]])
            rec = rec_n
        return flat_n, bounce_n, refr_n, rec


def packet_bounce(scene: Scene, cols, c_max: int, t_done: Tensor,
                  rng=None, fine_key: bool = False, grid=None,
                  accel=None):
    """One packet round: sort the live rays into coherent packets, build
    each packet's candidate table, advance every ray its table resolves
    (B7-wave), march the unresolved ones, and un-sort.

    ``cols`` = the 11 state columns [n] (status may hold the ``_CAP``
    mark: such rays pass through). ``t_done`` [n] is each ray's proven
    clear horizon. ``rng`` = (seed, rid, bounce, refr) for rough or
    transmission scenes. ``fine_key`` bins by fine Morton position first
    (retry rounds). ``grid`` is :func:`frame_tables`' cell grid (None: the
    rowwise tables of ``c_max`` rows); ``accel`` serves the glue's
    substance query. Only the segments of
    ``SEG_PACKETS`` packets that hold a live ray are worked (live rays sort
    to the front): the reference's per-segment ``lax.cond`` as a host loop
    over the live prefix, one sync a round. Returns (cols, t_done,
    resolved hit [n] bool, refr [n], winner [n] i32: global ids, -1 for a
    miss or an unresolved ray).
    """
    lane = tt.LANE
    packet = WAVE_SUB * lane
    n = cols[0].shape[0]
    dev = scene.device
    org = torch.stack(cols[0:3], -1)
    dirs = torch.stack(cols[3:6], -1)
    alive = cols[10] == _ALIVE
    # primary key: the quantized cleared horizon, so stuck rays cluster
    # apart from fresh ones
    s_lo, s_hi = _robust_extent(scene)
    diag = cand._norm3(s_hi - s_lo) + 1e-6
    qt = torch.clamp((t_done / (diag / 16.0)).to(torch.int32), 0, 63)
    if fine_key:
        # Morton-major: spatially compact packets keep d_c below the
        # resolution radius; direction only orders within a cell
        key = ((((qt << 18) + _morton_key(scene, org, bits=6)) << 6)
               + _dir_bin(dirs))
    else:
        key = (qt * 4096 + _pos_cell(scene, org)) * 64 + _dir_bin(dirs)
    key = torch.where(alive, key.to(torch.int32), 1 << 30)
    perm = torch.sort(key, stable=True).indices
    need_glue = scene.has_rough or scene.has_transmission
    flat_s = [c[perm] for c in cols]
    t_done_s = t_done[perm]
    if need_glue:
        seed, rid, bounce, refr = rng
        rid_s, bounce_s, refr_s = rid[perm], bounce[perm], refr[perm]
    else:
        refr_s = torch.zeros((n,), dtype=torch.float32, device=dev)
    alive_s = alive[perm]
    org_s, dir_s = org[perm], dirs[perm]

    n_packets = n // packet
    seg_n = min(SEG_PACKETS, n_packets) * packet
    n_live = int(alive_s.sum())
    new_flat = [f.clone() for f in flat_s]
    pid_o = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u_o = torch.zeros((n,), dtype=torch.float32, device=dev)
    v_o = torch.zeros_like(u_o)
    t_safe_ray = torch.zeros_like(u_o)
    refr_o = refr_s.clone()
    table = cand.prim_attr_table(scene) if grid is not None else None
    for i0 in range(0, -(-n_live // seg_n) * seg_n, seg_n):
        i1 = min(i0 + seg_n, n)
        s_org = org_s[i0:i1]
        if grid is not None:
            tab, cnts, t_safe = cand.packet_candidates_grid(
                scene, grid, s_org, dir_s[i0:i1], alive_s[i0:i1], packet,
                t_done=t_done_s[i0:i1], table=table)
            kc_max, bases = grid.c_max, grid.base[1:]
        else:
            tab, cnts, t_safe = cand.packet_candidates(
                scene, s_org, dir_s[i0:i1], alive_s[i0:i1], packet, c_max,
                t_done=t_done_s[i0:i1])
            kc_max, bases = c_max, None
        outs = tt.wave_bounce(
            scene, [f[i0:i1].reshape(-1, lane) for f in flat_s], tab, cnts,
            kc_max, wave_sub=WAVE_SUB, static_bases=bases)
        fl = [outs[k].reshape(-1) for k in _NAMES]
        pid_seg = outs["pid"].reshape(-1)
        d_c = cand._norm3(s_org - torch.repeat_interleave(cnts[:, 4:7],
                                                          packet, dim=0))
        t_safe_ray[i0:i1] = torch.repeat_interleave(t_safe, packet) - d_c
        if need_glue:
            nrm = torch.stack([outs[k].reshape(-1)
                               for k in ("nx", "ny", "nz")], -1)
            org2, dir2, refr_o[i0:i1] = _respawn_glue(
                scene, seed, rid_s[i0:i1], bounce_s[i0:i1], refr_s[i0:i1],
                torch.stack(fl[0:3], -1), torch.stack(fl[3:6], -1), fl[10],
                pid_seg, outs["t"].reshape(-1), nrm, accel=accel)
            fl[0:3] = [org2[:, 0], org2[:, 1], org2[:, 2]]
            fl[3:6] = [dir2[:, 0], dir2[:, 1], dir2[:, 2]]
        for f, a in zip(new_flat, fl):
            f[i0:i1] = a
        pid_o[i0:i1] = pid_seg
        u_o[i0:i1] = outs["u"].reshape(-1)
        v_o[i0:i1] = outs["v"].reshape(-1)

    if scene.textures.has_images or scene.sky_box is not None:
        colors = _apply_images(scene, torch.stack(new_flat[6:9], -1),
                               torch.stack(new_flat[3:6], -1), new_flat[10],
                               alive_s, pid_o, u_o, v_o)
        new_flat[6:9] = [colors[:, 0], colors[:, 1], colors[:, 2]]
    # march the unresolved rays: the round proved no hit in [0,
    # t_safe_ray), so advancing the origin through it is exact (the path
    # takes the advance); the margin guards the f32 error of t_safe
    res_hit = pid_o >= 0
    unres = alive_s & ~res_hit & (new_flat[10] == _ALIVE)
    t_adv = torch.where(unres, torch.clamp(t_safe_ray - 1e-4 * diag,
                                           min=0.0), 0.0)
    for i in range(3):
        new_flat[i] = new_flat[i] + t_adv * new_flat[3 + i]
    new_flat[9] = new_flat[9] + t_adv
    # what stays proven clear ahead of the new origin
    t_done_s = torch.where(
        unres, torch.clamp(torch.maximum(t_done_s, t_safe_ray) - t_adv,
                           min=0.0), t_done_s)

    def unsort(x):
        out = torch.empty_like(x)
        out[perm] = x
        return out

    return ([unsort(f) for f in new_flat], unsort(t_done_s),
            unsort(res_hit), unsort(refr_o), unsort(pid_o))



def _refuse(scene: Scene, cfg: RenderConfig, cam) -> None:
    """What the TILED frame does not render raises (module docstring).
    The public frames check; their bodies (:func:`_tiled_frame`,
    :func:`_replay_shaded_frame`), which ``render.render_hdr`` calls once
    per sample after its own check, do not."""
    trace_mod.refuse_grad(scene, cam.pos, cam.front, cam.left, cam.up,
                          backend="TILED")
    if scene.has_both and cfg.fresnel_both:
        raise ValueError("the TILED kernels have no Fresnel-BOTH split: "
                         "render BOTH scenes with fresnel_both through "
                         "HitBackend.PALLAS (render_hdr sends them there)")


def render_frame_tiled(scene: Scene, cfg: RenderConfig, cam, tables=None,
                       seed: Optional[int] = None, sample: int = 0,
                       accel=None, with_diag: bool = False,
                       with_record: bool = False, packet_c_max: int = 4096):
    """Full-frame HDR render via the tiled kernels -> [h, w, 3].

    Bounce 0 runs kernel B7 over the exact (untruncated) frustum candidate
    tables. Later bounces, on scenes of at most ``SWEEP_MAX_PRIMS`` prims,
    run sweep rounds (:func:`_rescue_round`) until no ray is working, at
    most ``(refmax + 3) * ceil(n / SWEEP_SLICE)``; on larger scenes,
    ``refmax - 1`` packet rounds (:func:`packet_bounce`), up to
    ``EXTRA_ROUNDS`` retry rounds binned by fine position, then whole-table
    rescue rounds of ``RESCUE_CAP`` rays (B4), at most ``(refmax + 3) *
    ceil(n / RESCUE_CAP)``. ``with_diag`` adds ``{"unresolved": rays still
    working when the rounds ran out (0 == the frame is exact), "rounds":
    sweep or rescue rounds run}`` (packet mode adds ``"packet_rounds"``);
    ``with_record`` adds ``pid_seq [h*w, refmax]`` i32, the winner of every
    pixel ray per bounce (-1 = miss), which ``ops/trace.trace_rays``
    replays (``pid_seq=``). Return orders: img | (img, diag) | (img, rec) |
    (img, diag, rec).

    ``tables`` — an optional cached :func:`frame_tables` result (a legacy
    3-tuple without the cell grid makes packet rounds select rowwise,
    ``packet_c_max`` rows a packet). ``seed``/``sample`` key the
    counter-RNG streams of rough scenes (rid = (y*w + x)*spp + sample, as
    every backend). ``accel`` — the scene's ``accel/octree.OctreeAccel``:
    the transmission substance query searches its grid instead of every
    prim (the same answers).
    """
    _refuse(scene, cfg, cam)
    return _tiled_frame(scene, cfg, cam, tables, seed, sample, accel,
                        with_diag, with_record, packet_c_max)


def _tiled_frame(scene: Scene, cfg: RenderConfig, cam, tables=None,
                 seed: Optional[int] = None, sample: int = 0, accel=None,
                 with_diag: bool = False, with_record: bool = False,
                 packet_c_max: int = 4096):
    """:func:`render_frame_tiled` without the :func:`_refuse` check."""
    if seed is None:
        seed = sampling.DEFAULT_SEED
    if tables is None:
        tables = frame_tables(scene, cam, packet_c_max=packet_c_max)
    tab, cnts, c_max = tables[:3]
    grid = tables[3] if len(tables) > 3 else None
    dev = scene.device
    need_glue = scene.has_rough or scene.has_transmission
    st = tt.frame_bounce0(scene, cam, tab, cnts, c_max)
    hp, wp = st["cr"].shape
    n = hp * wp
    xi = torch.arange(wp, device=dev).repeat(hp)
    yi = torch.arange(hp, device=dev).repeat_interleave(wp)
    valid = (xi < cam.w) & (yi < cam.h)
    flat = {k: v.reshape(-1) for k, v in st.items()}
    if need_glue:
        rid = torch.where(valid, (yi * cam.w + xi) * cfg.spp + sample,
                          0).to(torch.int32)
        refr = trace_mod.start_substance(scene, cam.pos).expand(n).contiguous()
    else:
        rid = None
        refr = torch.zeros((n,), dtype=torch.float32, device=dev)
    if scene.textures.has_images or scene.sky_box is not None:
        # padding pixels started MISS; everything else was ALIVE
        colors = _apply_images(
            scene, torch.stack([flat["cr"], flat["cg"], flat["cb"]], -1),
            torch.stack([flat["dx"], flat["dy"], flat["dz"]], -1),
            flat["status"], valid, flat["pid"], flat["u"], flat["v"])
        flat.update(cr=colors[:, 0], cg=colors[:, 1], cb=colors[:, 2])
    if need_glue:
        # bounce-0 scatter and refraction continuations (bounce index 0)
        org0, dir0, refr = _respawn_glue(
            scene, seed, rid, torch.zeros_like(rid), refr,
            torch.stack([flat["ox"], flat["oy"], flat["oz"]], -1),
            torch.stack([flat["dx"], flat["dy"], flat["dz"]], -1),
            flat["status"], flat["pid"], flat["t"],
            torch.stack([flat["nx"], flat["ny"], flat["nz"]], -1),
            accel=accel)
        flat.update(ox=org0[:, 0], oy=org0[:, 1], oz=org0[:, 2],
                    dx=dir0[:, 0], dy=dir0[:, 1], dz=dir0[:, 2])

    cols = [flat[k] for k in _NAMES]
    unresolved = torch.zeros((), dtype=torch.int32, device=dev)
    rounds = packet_rounds = 0
    rec = None
    if with_record:
        rec = torch.full((n, cfg.refmax), -1, dtype=torch.int32, device=dev)
        rec[:, 0] = torch.where(valid, flat["pid"], -1)

    def working(cols, bounce):
        return (cols[10] == _ALIVE) & (bounce < cfg.refmax)

    if cfg.refmax > 1:
        # rays continuing out of bounce 0 have spent one bounce
        bounce = (cols[10] == _ALIVE).to(torch.int32)
        # the shade is chosen once a frame
        shader = trace_mod._shader(scene, cols[0])
        if scene.n_prims <= SWEEP_MAX_PRIMS:
            cap = min(n, SWEEP_SLICE)
            sweep_tab = (_sweep_perm(scene) if SWEEP_LISTED or SWEEP_CULL
                         else None)
        else:
            t_done = torch.zeros((n,), dtype=torch.float32, device=dev)
            c_round = min(packet_c_max, ESC_MAX)
            for fine in [False] * (cfg.refmax - 1) + [True] * EXTRA_ROUNDS:
                if not _read_any(working(cols, bounce)):
                    break
                # rays at the bounce cap pass through the packet round
                capped = (cols[10] == _ALIVE) & (bounce >= cfg.refmax)
                cols[10] = torch.where(capped, _CAP, cols[10]).to(
                    torch.int32)
                rng = (seed, rid, bounce, refr) if need_glue else None
                cols, t_done, res_hit, refr, pid_o = packet_bounce(
                    scene, cols, c_round, t_done, rng=rng, fine_key=fine,
                    grid=grid, accel=accel)
                if rec is not None:
                    # the winner goes to the pre-increment bounce column
                    col = torch.arange(cfg.refmax, device=dev)
                    rec = torch.where(res_hit[:, None]
                                      & (bounce[:, None] == col),
                                      pid_o[:, None], rec)
                bounce = bounce + (res_hit & (cols[10] == _ALIVE)).to(
                    torch.int32)
                cols[10] = torch.where(cols[10] == _CAP, _ALIVE,
                                       cols[10]).to(torch.int32)
                packet_rounds += 1
            # whole-table rescue rounds (B4) finish the stragglers
            cap = min(n, RESCUE_CAP)
            sweep_tab = None
        max_rounds = (cfg.refmax + 3) * (-(-n // cap))
        while rounds < max_rounds and _read_any(working(cols, bounce)):
            cols, bounce, refr, rec = _rescue_round(
                scene, cfg, cols, bounce, refr, seed, rid, shader, cap=cap,
                sweep_tab=sweep_tab, rec=rec, accel=accel)
            rounds += 1
        unresolved = working(cols, bounce).sum().to(torch.int32)
    cr, cg, cb, _ = _epilogue(cols[6], cols[7], cols[8], cols[9], cols[10],
                              float(cfg.distance_attenuation_factor))
    img = torch.stack([cr, cg, cb], -1).reshape(hp, wp, 3)[:cam.h, :cam.w]
    return _rtl_outs(img, unresolved, rec, cam, hp, wp, cfg, with_diag,
                     with_record, rounds=rounds, packet_rounds=(packet_rounds
                                    if scene.n_prims > SWEEP_MAX_PRIMS
                                    and cfg.refmax > 1 else None))


def render_frame_tiled_replay_shaded(scene: Scene, cfg: RenderConfig, cam,
                                     tables=None, seed: Optional[int] = None,
                                     sample: int = 0, accel=None,
                                     with_diag: bool = False):
    """Image-scene TILED frame = a record pass on the texture-solidified
    twin of the scene + one flat replay-shading pass -> [h, w, 3].

    The search and the respawn never read texture colors, so the TILED
    search runs on the twin with ``with_record=True`` and the real scene is
    shaded once with ``ops/trace.trace_rays(pid_seq=rec)``: the same
    winners, RNG streams (seed, rid, bounce), substance chains and paths.
    ``accel`` serves the substance query of both passes.
    """
    _refuse(scene, cfg, cam)
    return _replay_shaded_frame(scene, cfg, cam, tables, seed, sample, accel,
                                with_diag)


def _replay_shaded_frame(scene: Scene, cfg: RenderConfig, cam, tables=None,
                         seed: Optional[int] = None, sample: int = 0,
                         accel=None, with_diag: bool = False):
    """:func:`render_frame_tiled_replay_shaded` without the :func:`_refuse`
    check."""
    tex = scene.textures
    twin = dataclasses.replace(
        scene, textures=dataclasses.replace(
            tex, kind=torch.zeros_like(tex.kind), has_images=False,
            has_bilinear=False), sky_box=None)
    out = _tiled_frame(twin, cfg, cam, tables=tables, seed=seed,
                       sample=sample, accel=accel, with_diag=with_diag,
                       with_record=True)
    diag, rec = (out[1], out[2]) if with_diag else (None, out[1])
    org, dirs = pixel_rays(cam)
    n = org.shape[0]
    rid = torch.arange(n, dtype=torch.int32, device=org.device) * cfg.spp \
        + sample
    refr0 = trace_mod.start_substance(scene, cam.pos).expand(n)
    st = trace_mod.trace_rays(
        scene, dataclasses.replace(cfg, backend=HitBackend.BRUTE), org, dirs,
        sampling.DEFAULT_SEED if seed is None else seed, rid,
        start_refr=refr0, pid_seq=rec, accel=accel)
    img = st.color.reshape(cam.h, cam.w, 3)
    return (img, diag) if with_diag else img


def _rtl_outs(img, unresolved, rec, cam, hp, wp, cfg, with_diag,
              with_record, rounds=None, packet_rounds=None):
    """Assemble render_frame_tiled's return tuple (img | +diag | +rec)."""
    outs = (img,)
    if with_diag:
        diag = {"unresolved": unresolved}
        if rounds is not None:
            diag["rounds"] = rounds
        if packet_rounds is not None:
            diag["packet_rounds"] = packet_rounds
        outs = outs + (diag,)
    if with_record:
        rec = rec.reshape(hp, wp, cfg.refmax)[:cam.h, :cam.w]
        outs = outs + (rec.reshape(-1, cfg.refmax),)
    return outs if len(outs) > 1 else img
