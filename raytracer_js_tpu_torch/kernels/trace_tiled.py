"""Tiled candidate-list bounce kernels B7 (frame and wavefront entries) and
their plain version.

Port of ``raytracer_js_tpu.kernels.trace_tiled``: the big-scene (100k+
prim) path. Per ray tile of ``TILE_SUB`` x ``LANE`` pixels, the kernel scans
the tile's *candidate table* (``accel/candidates.frame_candidates``: the
exact conservative set of primitives any ray of the tile could hit,
type-segregated, each segment sorted by a lower-bound entry distance
``t_lo``) in chunks of ``CHUNK`` rows, and stops a segment once every live
ray's best hit (capped at its scene-bbox exit) precedes the next chunk's
``t_lo``. One call performs ONE bounce — hit search, winner extraction,
shading, mirror respawn — and returns the whole ray state. Directions must
be unit (camera rays are; mirror reflections keep them so), which drops the
|d|^2 terms of the sphere quadratic.

The early exit is taken per *exit group* of ``GROUP`` = 32 rays (one
warp) rather than per 4096-ray tile: the exit is conservative, so a smaller
group can only stop sooner where the rest of the scan could not change its
live rays' results, and rays that are not alive fold nothing. The plain
versions take the group's size as ``group`` (32, the kernels'; 256 = two
rows of ``LANE``, the first design's blocks): every plane is the same
whatever the group, and the chunks scanned per group differ. They exit per
the same groups as the kernels, so the two agree bit for bit.
:func:`wave_need` and :func:`frame_need` count the chunks each ray needs:
those up to its own exit, given its final hit.

- :func:`frame_bounce0` — bounce 0 over the frame, rays built in the kernel
  from the camera pose (the closed form of ``models/camera.pixel_rays``).
  CUDA tensors launch ``tiled_frame_kernel`` (``csrc/trace_tiled.cu``); CPU
  tensors run :func:`frame_bounce0_plain`. ``LAUNCHES["frame"]`` counts
  launches.
- :func:`wave_bounce` — one bounce of a packetized wavefront (the packet
  rounds of ``render_tiled``): 11 state planes [rows, LANE] in, every
  packet of ``wave_sub`` rows scanning its own table. CUDA tensors launch
  ``tiled_wave_kernel``; CPU tensors run :func:`wave_bounce_plain`.
  ``LAUNCHES["wave"]`` counts launches. An exit group never spans two
  packets.

The shading is ``ops/trace._bounce``'s for this path's in-kernel part:
solid colors modulate, emissive hits end LIGHT, mirrors reflect and
respawn, transmission winners (mode 3) are left to the glue; image
textures, image skies, rough scatter and refraction are applied by
``render_tiled``'s glue from the (t, pid, u, v, normal) planes.
"""
from __future__ import annotations

import math

import torch

from ..accel.candidates import N_ATTR, SEG_ALIGN, bounding_spheres
from ..config import EPS_ADVANCE, RayStatus
from ..models.camera import Camera, angle_steps
from ..models.scene import Scene
from ..ops.intersect import INF as _INF, MT_EPS as _MT_EPS
from ..ops.intersect import SLAB_DIR_EPS as _SLAB_EPS, safe_inv as _safe_inv
from . import _build
from ._build import need as _need, ptr as _ptr

Tensor = torch.Tensor

#: kernel launches since the last reset (the plain version does not count)
LAUNCHES = {"frame": 0, "wave": 0}

#: ray-tile sublanes (rays per tile = TILE_SUB * LANE)
TILE_SUB = 32
LANE = 128
#: candidates per early-exit check == the tables' segment alignment
CHUNK = SEG_ALIGN
#: rays per exit group: one warp of the kernels
GROUP = 32
#: rows of LANE rays per exit group of the first design (256-thread blocks)
GROUP_SUB = 2
#: wavefront packet height in rows (packet = WAVE_SUB * LANE rays): smaller
#: than a frame tile, since packets of divergent rays need tight cones
WAVE_SUB = 8
GROUPS_PER_TILE = TILE_SUB * LANE // GROUP

# camera/constants layout (f32): 0-2 pos, 3-5 front, 6-8 left, 9-11 up,
# 12 step_h, 13 step_v, 14 off_h, 15 off_v, 16-18 sky rgb, 19 w, 20 h,
# 21-23 scene bbox lo, 24-26 scene bbox hi, 27 spare
TCAM_SLOTS = 28

STATE_NAMES = ("ox", "oy", "oz", "dx", "dy", "dz", "cr", "cg", "cb",
               "path", "status", "t", "pid", "u", "v", "nx", "ny", "nz")
_INT_PLANES = ("status", "pid")

_EPS_UV = 2.0 ** -52
# uv scales as multiplications by f32 reciprocals: PyTorch's CUDA division
# by a Python scalar multiplies by its reciprocal, so a division here would
# round differently on the card than on the CPU (and than in the kernel)
_INV_TWO_PI = 1.0 / (2.0 * math.pi)
_INV_PI = 1.0 / math.pi
_INV_SIX = 1.0 / 6.0
_ALIVE, _LIGHT, _KEEP, _MISS = (int(RayStatus.ALIVE), int(RayStatus.LIGHT),
                                int(RayStatus.KEEP), int(RayStatus.MISS))


def _scene_bbox(scene: Scene):
    """Conservative scene bounds from the primitive bounding spheres."""
    c, r = bounding_spheres(scene)
    lo = torch.min(c - r[:, None], dim=0).values - 1e-3
    hi = torch.max(c + r[:, None], dim=0).values + 1e-3
    return lo, hi


def _cam_array(cam: Camera, sky_rgb: Tensor, bb_lo: Tensor,
               bb_hi: Tensor) -> Tensor:
    """[TCAM_SLOTS] f32 camera/constants array (layout above)."""
    dev = cam.device
    f32 = torch.float32
    step_h, step_v, off_h, off_v = angle_steps(cam)
    return torch.cat([
        cam.pos.to(f32), cam.front.to(f32), cam.left.to(f32),
        cam.up.to(f32),
        torch.tensor([step_h, step_v, float(off_h), float(off_v)], dtype=f32,
                     device=dev),
        sky_rgb.to(f32).reshape(3).to(dev),
        torch.tensor([float(cam.w), float(cam.h)], dtype=f32, device=dev),
        bb_lo.to(f32).reshape(3).to(dev), bb_hi.to(f32).reshape(3).to(dev),
        torch.zeros((TCAM_SLOTS - 27,), dtype=f32, device=dev),
    ]).contiguous()


def _flags(scene: Scene) -> dict:
    """Kernel flags for a scene: want_uv, sky_solid, has_trans,
    want_normal. Cube-map skies are sampled in the glue, so the kernel must
    not apply its solid sky even on image-free scenes."""
    has_img = bool(scene.textures.has_images)
    sky_glue = has_img or scene.sky_box is not None
    return dict(want_uv=has_img, sky_solid=not sky_glue,
                has_trans=bool(scene.has_transmission),
                want_normal=bool(scene.has_rough or scene.has_transmission))


# ---------------------------------------------------------------------------
# Group layout: frame planes [h_pad, w_pad] <-> exit groups [G, group]
# ---------------------------------------------------------------------------

def _check_group(group: int, rays: int) -> None:
    """An exit group is a run of at most LANE rays of one row, or whole
    rows, and never spans two tables of ``rays`` rays."""
    ok = (group >= 1 and rays % group == 0
          and (LANE % group == 0 if group <= LANE else group % LANE == 0))
    if not ok:
        raise ValueError(f"an exit group of {group} rays does not tile "
                         f"{rays}-ray tables of {LANE}-ray rows")


def _group_shape(group: int):
    """(rows, lanes) of an exit group of ``group`` rays."""
    return max(group // LANE, 1), min(group, LANE)


def to_groups(plane: Tensor, nby: int, nbx: int,
              group: int = GROUP) -> Tensor:
    """[h_pad, w_pad] -> [tiles * groups per tile, group]: group g =
    (tile * TILE_SUB + row) * (LANE / group) + run for groups within a row,
    tile * (TILE_SUB / rows) + row block for groups of whole rows; tile =
    by * nbx + bx (the kernels' order of work rows)."""
    gr, gl = _group_shape(group)
    p = plane.reshape(nby, TILE_SUB // gr, gr, nbx, LANE // gl, gl)
    return p.permute(0, 3, 1, 4, 2, 5).reshape(-1, group)


def from_groups(groups: Tensor, nby: int, nbx: int,
                group: int = GROUP) -> Tensor:
    """Inverse of :func:`to_groups`."""
    gr, gl = _group_shape(group)
    p = groups.reshape(nby, nbx, TILE_SUB // gr, LANE // gl, gr, gl)
    return p.permute(0, 2, 4, 1, 3, 5).reshape(nby * TILE_SUB, nbx * LANE)


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def _sphere_t(blk, ox, oy, oz, dx, dy, dz, o_dot_o, o_dot_d):
    cx, cy, cz, ccmr = blk[..., 2], blk[..., 3], blk[..., 4], blk[..., 5]
    b_half = o_dot_d - (dx * cx + dy * cy + dz * cz)
    c = o_dot_o - 2.0 * (ox * cx + oy * cy + oz * cz) + ccmr
    disc = b_half * b_half - c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t = torch.where(-b_half - sq >= 0.0, -b_half - sq, sq - b_half)
    return t, (disc >= 0.0) & (t >= 0.0)


def _box_t(blk, ox, oy, oz, ix, iy, iz):
    cx, cy, cz = blk[..., 2], blk[..., 3], blk[..., 4]
    hx, hy, hz = blk[..., 5], blk[..., 6], blk[..., 7]
    tax = (cx - hx - ox) * ix
    tbx = (cx + hx - ox) * ix
    tay = (cy - hy - oy) * iy
    tby = (cy + hy - oy) * iy
    taz = (cz - hz - oz) * iz
    tbz = (cz + hz - oz) * iz
    t_en = torch.maximum(torch.maximum(torch.minimum(tax, tbx),
                                       torch.minimum(tay, tby)),
                         torch.minimum(taz, tbz))
    t_ex = torch.minimum(torch.minimum(torch.maximum(tax, tbx),
                                       torch.maximum(tay, tby)),
                         torch.maximum(taz, tbz))
    t = torch.where(t_en >= 0.0, t_en, t_ex)
    return t, (t_en <= t_ex) & (t >= 0.0)


def _tri_t(blk, ox, oy, oz, dx, dy, dz):
    v0x, v0y, v0z = blk[..., 2], blk[..., 3], blk[..., 4]
    e1x, e1y, e1z = blk[..., 5], blk[..., 6], blk[..., 7]
    e2x, e2y, e2z = blk[..., 8], blk[..., 9], blk[..., 10]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = 1.0 / torch.where(det.abs() < _MT_EPS, _MT_EPS, det)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = (sx * px + sy * py + sz * pz) * inv_det
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = ((det.abs() >= _MT_EPS) & (u >= 0.0) & (v >= 0.0)
          & (u + v <= 1.0) & (t >= 0.0))
    return t, ok


def _exit_terms(state: dict, cnts: Tensor, bb_lo: Tensor, bb_hi: Tensor):
    """Each ray's distance d_c from its table's cone apex and its
    scene-bbox exit t_exit_bb, [G, R] each: its exit horizon is
    min(t_best, t_exit_bb) + d_c."""
    ox, oy, oz = state["ox"], state["oy"], state["oz"]
    ix, iy, iz = (_safe_inv(state[k]) for k in ("dx", "dy", "dz"))
    o0x, o0y, o0z = cnts[:, 4:5], cnts[:, 5:6], cnts[:, 6:7]
    d_c = torch.sqrt((ox - o0x) ** 2 + (oy - o0y) ** 2 + (oz - o0z) ** 2)
    ex_x = torch.maximum((bb_lo[0] - ox) * ix, (bb_hi[0] - ox) * ix)
    ex_y = torch.maximum((bb_lo[1] - oy) * iy, (bb_hi[1] - oy) * iy)
    ex_z = torch.maximum((bb_lo[2] - oz) * iz, (bb_hi[2] - oz) * iz)
    return d_c, torch.minimum(torch.minimum(ex_x, ex_y), ex_z)


def _segments(cnts: Tensor, static_bases):
    """(counts [G, 3], box base [G], triangle base [G]) of each group's
    table: the segments at ``static_bases`` or after the padded counts."""
    cnt = cnts[:, 0:3].to(torch.int64)

    def pad_chunk(x):
        return (x + CHUNK - 1) // CHUNK * CHUNK

    if static_bases is None:
        base_b = pad_chunk(cnt[:, 0])
        base_t = base_b + pad_chunk(cnt[:, 1])
    else:
        base_b = torch.full_like(cnt[:, 0], int(static_bases[0]))
        base_t = torch.full_like(cnt[:, 0], int(static_bases[1]))
    return cnt, base_b, base_t


def need_plain(tab: Tensor, c_max: int, g_tile: Tensor, cnts: Tensor,
               bb_lo: Tensor, bb_hi: Tensor, state: dict, t: Tensor,
               static_bases=None) -> Tensor:
    """The chunks of each segment each ray needs -> [G, R, 3] i32 (state
    and ``t`` [G, R] as :func:`bounce_tile_plain` takes and gives them).

    A ray's need is what its own exit rule scans given its final hit ``t``
    (the least any exit group scans for it): chunk 0, then each next chunk
    while min(t, t_exit_bb) + d_c exceeds that chunk's first t_lo; 0 for a
    ray that is not alive and for an empty segment. It never exceeds the
    chunks its exit group scanned, whatever the group's size."""
    tab3 = tab.reshape(-1, c_max, N_ATTR)
    dev = t.device
    alive = state["status"] == _ALIVE
    d_c, t_exit_bb = _exit_terms(state, cnts, bb_lo, bb_hi)
    reach = (torch.minimum(t, t_exit_bb) + d_c).contiguous()
    cnt, base_b, base_t = _segments(cnts, static_bases)
    out = []
    for base, count in ((torch.zeros_like(base_b), cnt[:, 0]),
                        (base_b, cnt[:, 1]), (base_t, cnt[:, 2])):
        n_ch = (count + CHUNK - 1) // CHUNK                   # [G]
        width = int(n_ch.max()) - 1 if n_ch.numel() else 0
        need = n_ch[:, None].expand_as(reach)
        if width > 0:
            c = torch.arange(1, width + 1, device=dev)
            rows = torch.clamp(base[:, None] + CHUNK * c, max=c_max - 1)
            tlo = torch.where(c < n_ch[:, None],
                              tab3[g_tile[:, None], rows, 0], _INF)
            # the first chunk c >= 1 whose t_lo is at least the reach ends
            # the scan: the first c whose running maximum of t_lo is
            top = torch.cummax(tlo, dim=1).values.contiguous()
            need = torch.minimum(1 + torch.searchsorted(top, reach),
                                 n_ch[:, None])
        out.append(torch.where(alive & (count[:, None] > 0), need, 0))
    return torch.stack(out, -1).to(torch.int32)


def bounce_tile_plain(tab: Tensor, c_max: int, g_tile: Tensor,
                      cnts: Tensor, bb_lo: Tensor, bb_hi: Tensor,
                      sky: Tensor, state: dict, *, want_uv: bool,
                      sky_solid: bool, has_trans: bool, want_normal: bool,
                      static_bases=None):
    """One traverse -> intersect -> shade -> respawn pass over exit groups:
    the plain version of the kernel's ``bounce_tile``.

    ``tab`` is the [tiles * c_max, N_ATTR] candidate table; group g reads
    tile ``g_tile[g]``'s rows and its ``cnts`` row [G, 8] (cnt_s, cnt_b,
    cnt_t, t_safe, o0x, o0y, o0z, ro). ``state`` holds the 11 ray columns
    (``STATE_NAMES[:11]``) as [G, R] tensors: R rays per exit group. Returns
    ``(planes, chunks)``: the 15 (+3 normal) output columns by name and the
    chunks each group scanned per class [G, 3]. Rays that are not alive
    fold nothing (t = +inf, no winner), so no plane depends on R.

    Resolution: a hit is final iff it precedes ``t_safe - d_c`` (d_c: the
    ray's distance from the table's cone apex), a miss iff the ray leaves
    the scene bounds first; unresolved rays pass through unchanged.
    ``static_bases = (base_b, base_t)`` puts the box and triangle segments
    at fixed rows (cell-grid tables); else they follow the counts.
    """
    ox, oy, oz = state["ox"], state["oy"], state["oz"]
    dx, dy, dz = state["dx"], state["dy"], state["dz"]
    status = state["status"]
    dev = ox.device
    n_g = ox.shape[0]
    tab3 = tab.reshape(-1, c_max, N_ATTR)
    alive = status == _ALIVE
    o_dot_d = ox * dx + oy * dy + oz * dz
    o_dot_o = ox * ox + oy * oy + oz * oz
    ix, iy, iz = _safe_inv(dx), _safe_inv(dy), _safe_inv(dz)
    t_safe = cnts[:, 3:4]
    d_c, t_exit_bb = _exit_terms(state, cnts, bb_lo, bb_hi)
    cnt, base_b, base_t = _segments(cnts, static_bases)
    t_best = torch.full_like(ox, _INF)
    jwin = torch.full(ox.shape, -1, dtype=torch.int64, device=dev)
    chunks = torch.zeros((n_g, 3), dtype=torch.int32, device=dev)
    any_alive = alive.any(dim=1)
    k_off = torch.arange(CHUNK, device=dev)

    def ray(x, gi):
        return x[gi][:, :, None]                             # [g, R, 1]

    def scan_segment(seg, base, count):
        nonlocal t_best, jwin
        end = base + count
        open_ = (count > 0) & any_alive
        ci = 0
        while bool(open_.any()):
            gi = torch.nonzero(open_).flatten()
            j0 = base[gi] + ci * CHUNK                       # [g]
            rows = j0[:, None] + k_off                       # [g, CHUNK]
            blk = tab3[g_tile[gi][:, None], rows][:, None]   # [g, 1, C, A]
            if seg == 0:
                t, valid = _sphere_t(blk, ray(ox, gi), ray(oy, gi),
                                     ray(oz, gi), ray(dx, gi), ray(dy, gi),
                                     ray(dz, gi), ray(o_dot_o, gi),
                                     ray(o_dot_d, gi))
            elif seg == 1:
                t, valid = _box_t(blk, ray(ox, gi), ray(oy, gi), ray(oz, gi),
                                  ray(ix, gi), ray(iy, gi), ray(iz, gi))
            else:
                t, valid = _tri_t(blk, ray(ox, gi), ray(oy, gi), ray(oz, gi),
                                  ray(dx, gi), ray(dy, gi), ray(dz, gi))
            valid = (valid & (rows < end[gi][:, None])[:, None, :]
                     & alive[gi][:, :, None])
            # the first minimum of the chunk, then the kernel's strict <
            t_c, k_c = torch.where(valid, t, _INF).min(dim=2)
            tb = t_best[gi]
            upd = t_c < tb
            t_best[gi] = torch.where(upd, t_c, tb)
            jwin[gi] = torch.where(upd, j0[:, None] + k_c, jwin[gi])
            chunks[gi, seg] += 1
            nxt = base[gi] + (ci + 1) * CHUNK
            next_tlo = tab3[g_tile[gi], torch.clamp(nxt, max=c_max - 1), 0]
            done = (~alive[gi] | (torch.minimum(t_best[gi], t_exit_bb[gi])
                                  + d_c[gi] <= next_tlo[:, None])).all(dim=1)
            open_[gi] = ~done & (nxt < end[gi])
            ci += 1

    scan_segment(0, torch.zeros_like(base_b), cnt[:, 0])
    scan_segment(1, base_b, cnt[:, 1])
    scan_segment(2, base_t, cnt[:, 2])

    # ---- winner attributes: row jwin of the tile's table ------------------
    win = jwin >= 0
    row = tab3[g_tile[:, None], torch.clamp(jwin, min=0)]    # [G, R, A]
    zero = torch.zeros_like(ox)
    one = torch.ones_like(ox)
    is_sph = win & (jwin < base_b[:, None])
    is_box = (jwin >= base_b[:, None]) & (jwin < base_t[:, None])
    is_tri = jwin >= base_t[:, None]
    wr = torch.where(win, row[..., 14], one)
    wg = torch.where(win, row[..., 15], one)
    wb = torch.where(win, row[..., 16], one)
    w_mode = torch.where(win, row[..., 17], zero)
    pid = torch.where(win, row[..., 1].to(torch.int32), -1)
    # geometry g0..g8: sphere (c, 1/r), box (c, h), tri (v0, e1, e2); zero
    # past each class's columns and for misses
    g = []
    for k in range(9):
        m = is_tri | (is_box if k < 6 else False) | (is_sph if k < 3 else False)
        g.append(torch.where(m, row[..., 2 + k], zero))
    g[3] = torch.where(is_sph, row[..., 6], g[3])

    # ---- winner normal (+ uv) ----------------------------------------------
    t_fin = torch.where(t_best < _INF, t_best, 0.0)
    hx_ = ox + t_fin * dx
    hy_ = oy + t_fin * dy
    hz_ = oz + t_fin * dz
    nx = (hx_ - g[0]) * g[3]
    ny = (hy_ - g[1]) * g[3]
    nz = (hz_ - g[2]) * g[3]
    if want_uv:
        # sphere equirect uv from the unflipped (hit - c) / r direction
        u_out = torch.atan2(ny, nx) * _INV_TWO_PI + 0.5 - _EPS_UV
        v_out = (torch.atan2(nz, torch.sqrt(nx * nx + ny * ny)) * _INV_PI
                 + 0.5 - _EPS_UV)
    else:
        u_out = zero
        v_out = zero
    # box: the winning slab axis -> face normal (x > y > z tie order)
    bcx, bcy, bcz, bhx, bhy, bhz = g[0], g[1], g[2], g[3], g[4], g[5]
    tax = (bcx - bhx - ox) * ix
    tbx = (bcx + bhx - ox) * ix
    tay = (bcy - bhy - oy) * iy
    tby = (bcy + bhy - oy) * iy
    taz = (bcz - bhz - oz) * iz
    tbz = (bcz + bhz - oz) * iz
    t0x, t1x = torch.minimum(tax, tbx), torch.maximum(tax, tbx)
    t0y, t1y = torch.minimum(tay, tby), torch.maximum(tay, tby)
    t0z, t1z = torch.minimum(taz, tbz), torch.maximum(taz, tbz)
    t_en = torch.maximum(torch.maximum(t0x, t0y), t0z)
    t_ex = torch.minimum(torch.minimum(t1x, t1y), t1z)
    entering = t_en >= 0.0
    wx = (entering & (t0x == t_en)) | (~entering & (t1x == t_ex))
    wy = ((entering & (t0y == t_en)) | (~entering & (t1y == t_ex))) & ~wx
    wz = ~wx & ~wy
    sxn = torch.where(dx < 0.0, 1.0, -1.0)
    syn = torch.where(dy < 0.0, 1.0, -1.0)
    szn = torch.where(dz < 0.0, 1.0, -1.0)
    nx = torch.where(is_box, torch.where(wx, sxn, 0.0), nx)
    ny = torch.where(is_box, torch.where(wy, syn, 0.0), ny)
    nz = torch.where(is_box, torch.where(wz, szn, 0.0), nz)
    if want_uv:
        axis = torch.where(wx, 0, torch.where(wy, 1, 2))
        sgn = torch.where(wx, sxn, torch.where(wy, syn, szn))
        outward = torch.where(entering, sgn, -sgn)
        face = (axis * 2 + (outward > 0.0).to(torch.int64)).to(torch.float32)
        clip_hi = 1.0 - 2.0 ** -23
        rx = torch.clamp((hx_ - (bcx - bhx)) / (2.0 * bhx), 0.0, clip_hi)
        ry = torch.clamp((hy_ - (bcy - bhy)) / (2.0 * bhy), 0.0, clip_hi)
        rz = torch.clamp((hz_ - (bcz - bhz)) / (2.0 * bhz), 0.0, clip_hi)
        u_loc = torch.where(axis == 0, ry, rx)
        v_loc = torch.where(axis == 2, ry, rz)
        u_out = torch.where(is_box, (face + u_loc) * _INV_SIX, u_out)
        v_out = torch.where(is_box, v_loc, v_out)
    # tri: the geometric normal and barycentric uv from (v0, e1, e2)
    e1x, e1y, e1z = g[3], g[4], g[5]
    e2x, e2y, e2z = g[6], g[7], g[8]
    gx = e1y * e2z - e1z * e2y
    gy = e1z * e2x - e1x * e2z
    gz = e1x * e2y - e1y * e2x
    g_inv = 1.0 / torch.sqrt(torch.clamp(gx * gx + gy * gy + gz * gz,
                                         min=1e-40))
    nx = torch.where(is_tri, gx * g_inv, nx)
    ny = torch.where(is_tri, gy * g_inv, ny)
    nz = torch.where(is_tri, gz * g_inv, nz)
    if want_uv:
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        inv_det = 1.0 / torch.where(det.abs() < _MT_EPS, _MT_EPS, det)
        sx_, sy_, sz_ = ox - g[0], oy - g[1], oz - g[2]
        bu = (sx_ * px + sy_ * py + sz_ * pz) * inv_det
        qx = sy_ * e1z - sz_ * e1y
        qy = sz_ * e1x - sx_ * e1z
        qz = sx_ * e1y - sy_ * e1x
        bv = (dx * qx + dy * qy + dz * qz) * inv_det
        u_out = torch.where(is_tri, bu, u_out)
        v_out = torch.where(is_tri, bv, v_out)
    # flip toward the incoming ray (sphere inside view, tri winding); box
    # face normals already oppose the ray
    flip = torch.where((is_sph | is_tri) & (dx * nx + dy * ny + dz * nz > 0.0),
                       -1.0, 1.0)
    nx, ny, nz = nx * flip, ny * flip, nz * flip
    n_inv = 1.0 / torch.sqrt(torch.clamp(nx * nx + ny * ny + nz * nz,
                                         min=1e-20))
    nx, ny, nz = nx * n_inv, ny * n_inv, nz * n_inv

    # ---- resolution, shading and respawn -----------------------------------
    t_safe_ray = t_safe - d_c
    hit = alive & win & (t_best <= t_safe_ray)
    lit = hit & (w_mode > 1.5) & (w_mode < 2.5)
    cont = hit & (w_mode > 0.5) & (w_mode < 1.5)
    cont_t = (hit & (w_mode > 2.5)) if has_trans else torch.zeros_like(hit)
    keep = hit & ~lit & ~cont & ~cont_t
    miss = alive & ~win & (t_safe_ray > t_exit_bb)
    col = []
    for c, w, s in ((state["cr"], wr, sky[0]), (state["cg"], wg, sky[1]),
                    (state["cb"], wb, sky[2])):
        if sky_solid:
            col.append(torch.where(hit, c * w, torch.where(miss, c * s, c)))
        else:
            col.append(torch.where(hit, c * w, c))
    path = torch.where(hit, state["path"] + t_best, state["path"])
    status = torch.where(lit, _LIGHT, torch.where(
        keep, _KEEP, torch.where(miss, _MISS, status))).to(torch.int32)
    d_dot_n = dx * nx + dy * ny + dz * nz
    rdx = dx - 2.0 * d_dot_n * nx
    rdy = dy - 2.0 * d_dot_n * ny
    rdz = dz - 2.0 * d_dot_n * nz
    out = dict(ox=torch.where(cont, hx_ + EPS_ADVANCE * rdx, ox),
               oy=torch.where(cont, hy_ + EPS_ADVANCE * rdy, oy),
               oz=torch.where(cont, hz_ + EPS_ADVANCE * rdz, oz),
               dx=torch.where(cont, rdx, dx), dy=torch.where(cont, rdy, dy),
               dz=torch.where(cont, rdz, dz), cr=col[0], cg=col[1],
               cb=col[2], path=path, status=status, t=t_best,
               pid=torch.where(hit, pid, -1).to(torch.int32),
               u=u_out, v=v_out)
    if want_normal:
        out.update(nx=nx, ny=ny, nz=nz)
    return out, chunks


def _frame_shape(cam: Camera):
    nbx = -(-cam.w // LANE)
    nby = -(-cam.h // TILE_SUB)
    return nby, nbx


def _frame_inputs(scene: Scene, cam: Camera, tab: Tensor, cnts: Tensor,
                  c_max: int):
    """Check the tables and build the camera array -> (cam_arr, nby, nbx)."""
    if cam.device != scene.device:
        raise ValueError(f"camera on {cam.device}, scene on {scene.device}")
    nby, nbx = _frame_shape(cam)
    dev = scene.device
    if c_max % CHUNK:
        raise ValueError(f"c_max {c_max} is not a multiple of {CHUNK}")
    _need(tab, "candidate table", torch.float32,
          (nby * nbx * c_max, N_ATTR), dev)
    _need(cnts, "candidate counts", torch.float32, (nby * nbx, 8), dev)
    sky_rgb = scene.textures.solid_rgb[scene.sky_tex]
    bb_lo, bb_hi = _scene_bbox(scene)
    return _cam_array(cam, sky_rgb, bb_lo, bb_hi), nby, nbx


def _frame_state(ca: Tensor, nby: int, nbx: int) -> dict:
    """Bounce 0's 11 state planes [h_pad, w_pad] from the camera array:
    the closed form of ``models/camera.pixel_rays``, padding pixels of
    partial edge tiles MISS."""
    dev = ca.device
    hp, wp = nby * TILE_SUB, nbx * LANE
    f32 = torch.float32
    x = torch.arange(wp, dtype=f32, device=dev)[None, :]
    y = torch.arange(hp, dtype=f32, device=dev)[:, None]
    th_h = (x - ca[14]) * ca[12]
    th_v = (y - ca[15]) * ca[13]
    ch, sh = torch.cos(th_h), torch.sin(th_h)
    cv, sv = torch.cos(th_v), torch.sin(th_v)
    a1, a2 = ch * cv, ch * sv
    planes = {
        "dx": a1 * ca[3] + a2 * ca[9] + sh * ca[6],
        "dy": a1 * ca[4] + a2 * ca[10] + sh * ca[7],
        "dz": a1 * ca[5] + a2 * ca[11] + sh * ca[8]}
    zero = torch.zeros((hp, wp), dtype=f32, device=dev)
    planes.update(ox=zero + ca[0], oy=zero + ca[1], oz=zero + ca[2],
                  cr=zero + 1.0, cg=zero + 1.0, cb=zero + 1.0, path=zero)
    pad = (x >= ca[19]) | (y >= ca[20])
    planes["status"] = torch.where(pad, _MISS, _ALIVE).to(torch.int32)
    return planes


def _frame_groups(scene: Scene, cam: Camera, tab: Tensor, cnts: Tensor,
                  c_max: int, group: int):
    """The frame's bounce-0 state as exit groups -> (camera array, nby,
    nbx, state {name: [G, group]}, g_tile [G])."""
    _check_group(group, TILE_SUB * LANE)
    ca, nby, nbx = _frame_inputs(scene, cam, tab, cnts, c_max)
    planes = _frame_state(ca, nby, nbx)
    state = {k: to_groups(planes[k], nby, nbx, group)
             for k in STATE_NAMES[:11]}
    n_g = nby * nbx * TILE_SUB * LANE // group
    g_tile = torch.arange(n_g, device=ca.device) // (TILE_SUB * LANE
                                                     // group)
    return ca, nby, nbx, state, g_tile


def frame_bounce0_plain(scene: Scene, cam: Camera, tab: Tensor,
                        cnts: Tensor, c_max: int, work: bool = False,
                        group: int = GROUP):
    """Plain version of the frame kernel -> dict of [h_pad, w_pad] state
    planes (``STATE_NAMES``; 15, or 18 with normals), plus ``"chunks"``
    [groups, 3] (chunks scanned per exit group of ``group`` rays and class,
    in :func:`to_groups` order) when ``work``."""
    ca, nby, nbx, state, g_tile = _frame_groups(scene, cam, tab, cnts, c_max,
                                                group)
    out, chunks = bounce_tile_plain(
        tab, c_max, g_tile, cnts[g_tile], ca[21:24], ca[24:27], ca[16:19],
        state, **_flags(scene))
    res = {k: from_groups(v, nby, nbx, group) for k, v in out.items()}
    if work:
        res["chunks"] = chunks
    return res


def frame_need(scene: Scene, cam: Camera, tab: Tensor, cnts: Tensor,
               c_max: int, t: Tensor) -> Tensor:
    """The chunks of each segment each bounce-0 ray needs, given its final
    ``t`` plane [h_pad, w_pad] (:func:`need_plain`) -> [h_pad, w_pad, 3]
    i32."""
    ca, nby, nbx, state, g_tile = _frame_groups(scene, cam, tab, cnts, c_max,
                                                TILE_SUB * LANE)
    need = need_plain(tab, c_max, g_tile, cnts[g_tile], ca[21:24],
                      ca[24:27], state, to_groups(t, nby, nbx,
                                                  TILE_SUB * LANE))
    return torch.stack([from_groups(need[..., k], nby, nbx, TILE_SUB * LANE)
                        for k in range(3)], -1)


def launch_frame(tab: Tensor, cnts: Tensor, cam_arr: Tensor, c_max: int,
                 nby: int, nbx: int, *, want_uv: bool, sky_solid: bool,
                 has_trans: bool, want_normal: bool, work: bool = False):
    """Launch ``tiled_frame_kernel`` (B7) on the current stream -> dict of
    [h_pad, w_pad] planes (status and pid are int32 views), plus
    ``"chunks"`` (per warp, as :func:`frame_bounce0_plain` gives them for
    ``group=GROUP``) when ``work``. Does not synchronize."""
    dev = cam_arr.device
    if dev.type != "cuda":
        raise ValueError(f"the tiled frame kernel needs CUDA tensors, got "
                         f"{dev}")
    _need(tab, "candidate table", torch.float32,
          (nby * nbx * c_max, N_ATTR), dev)
    _need(cnts, "candidate counts", torch.float32, (nby * nbx, 8), dev)
    _need(cam_arr, "camera array", torch.float32, (TCAM_SLOTS,), dev)
    _aligned(tab)
    hp, wp = nby * TILE_SUB, nbx * LANE
    n_out = 18 if want_normal else 15
    out = torch.empty((n_out, hp, wp), dtype=torch.float32, device=dev)
    n_g = nby * nbx * GROUPS_PER_TILE
    chunks = (torch.zeros((n_g, 3), dtype=torch.int32, device=dev)
              if work else None)
    lib = _build.load()
    err = lib.rt_tiled_frame(
        _ptr(tab), c_max, _ptr(cnts), _ptr(cam_arr), nby, nbx, int(want_uv),
        int(sky_solid), int(has_trans), int(want_normal), _ptr(out),
        _ptr(chunks), dev.index, _build.stream(dev))
    _build.check(lib, err, "tiled_frame_kernel")
    LAUNCHES["frame"] += 1
    res = {}
    for i, name in enumerate(STATE_NAMES[:n_out]):
        res[name] = out[i].view(torch.int32) if name in _INT_PLANES else out[i]
    if work:
        res["chunks"] = chunks
    return res


def frame_bounce0(scene: Scene, cam: Camera, tab: Tensor, cnts: Tensor,
                  c_max: int, work: bool = False):
    """Bounce 0 over the whole frame -> dict of [h_pad, w_pad] state planes.

    ``tab``/``cnts``/``c_max`` from ``accel/candidates.frame_candidates``
    with sub=TILE_SUB, lane=LANE. Scenes with image textures get (u, v)
    filled and no in-kernel sky (the glue applies textures and sky). CUDA
    scenes launch the kernel; CPU scenes run :func:`frame_bounce0_plain`.
    """
    if _build.on_cpu(scene.device):
        return frame_bounce0_plain(scene, cam, tab, cnts, c_max, work=work)
    cam_arr, nby, nbx = _frame_inputs(scene, cam, tab, cnts, c_max)
    return launch_frame(tab, cnts, cam_arr, c_max, nby, nbx, work=work,
                        **_flags(scene))


# ---------------------------------------------------------------------------
# The wavefront entry
# ---------------------------------------------------------------------------

def group_rows(wave_sub: int) -> int:
    """Rows per exit group of the first design (256-thread blocks) for
    packets of ``wave_sub`` rows: GROUP_SUB when it divides the packet,
    else one (a group never spans packets)."""
    return GROUP_SUB if wave_sub % GROUP_SUB == 0 else 1


def _aligned(tab: Tensor) -> None:
    if tab.data_ptr() % 16:
        raise ValueError("the candidate table must start on a 16-byte "
                         "boundary (the kernels copy 8-byte pieces of its "
                         "rows)")


def _wave_inputs(scene: Scene, cols, tab: Tensor, cnts: Tensor, c_max: int,
                 wave_sub: int):
    """Check the wavefront's shapes -> (wave array [TCAM_SLOTS], rows)."""
    rows = cols[0].shape[0]
    dev = scene.device
    if len(cols) != 11 or rows % wave_sub:
        raise ValueError(f"a wavefront is 11 planes of a multiple of "
                         f"{wave_sub} rows, got {len(cols)} of {rows}")
    if c_max % CHUNK:
        raise ValueError(f"c_max {c_max} is not a multiple of {CHUNK}")
    n_pk = rows // wave_sub
    _need(tab, "candidate table", torch.float32, (n_pk * c_max, N_ATTR), dev)
    _need(cnts, "candidate counts", torch.float32, (n_pk, 8), dev)
    for c in cols:
        if tuple(c.shape) != (rows, LANE) or c.device != dev:
            raise ValueError(f"a state plane is {tuple(c.shape)} on "
                             f"{c.device}, expected {(rows, LANE)} on {dev}")
    sky_rgb = scene.textures.solid_rgb[scene.sky_tex]
    bb_lo, bb_hi = _scene_bbox(scene)
    f32 = torch.float32
    # the camera pose slots are unused here; sky and scene bounds are read
    arr = torch.cat([torch.zeros((16,), dtype=f32, device=dev),
                     sky_rgb.to(f32).reshape(3),
                     torch.zeros((2,), dtype=f32, device=dev),
                     bb_lo.to(f32).reshape(3), bb_hi.to(f32).reshape(3),
                     torch.zeros((TCAM_SLOTS - 27,), dtype=f32, device=dev)])
    return arr.contiguous(), rows


def _wave_groups(cols, rows: int, wave_sub: int, group: int, dev):
    """The wavefront's state as exit groups -> (state {name: [G,
    group]}, g_tile [G])."""
    _check_group(group, wave_sub * LANE)
    n_g = rows * LANE // group
    g_tile = torch.arange(n_g, device=dev) // (wave_sub * LANE // group)
    state = {k: c.reshape(n_g, group) for k, c in zip(STATE_NAMES[:11], cols)}
    return state, g_tile


def wave_bounce_plain(scene: Scene, cols, tab: Tensor, cnts: Tensor,
                      c_max: int, wave_sub: int = WAVE_SUB,
                      static_bases=None, work: bool = False,
                      group: int = GROUP):
    """Plain version of the wavefront kernel -> dict of [rows, LANE] planes
    (``STATE_NAMES``; 15, or 18 with normals), plus ``"chunks"`` [rays /
    group, 3] (chunks scanned per exit group of ``group`` consecutive rays
    and class) when ``work``. ``cols`` holds the 11 input planes (ox ..
    path, status), packet p = rows [p * wave_sub, (p + 1) * wave_sub) with
    table p and counts row p; ``group`` divides the packet's rays."""
    arr, rows = _wave_inputs(scene, cols, tab, cnts, c_max, wave_sub)
    state, g_tile = _wave_groups(cols, rows, wave_sub, group, arr.device)
    out, chunks = bounce_tile_plain(
        tab, c_max, g_tile, cnts[g_tile], arr[21:24], arr[24:27], arr[16:19],
        state, static_bases=static_bases, **_flags(scene))
    res = {k: v.reshape(rows, LANE) for k, v in out.items()}
    if work:
        res["chunks"] = chunks
    return res


def wave_need(scene: Scene, cols, tab: Tensor, cnts: Tensor, c_max: int,
              t: Tensor, wave_sub: int = WAVE_SUB,
              static_bases=None) -> Tensor:
    """The chunks of each segment each ray of a wavefront needs, given its
    final ``t`` plane [rows, LANE] (:func:`need_plain`; the counterpart of
    ``nearest_hit.listed_need``) -> [rows * LANE, 3] i32."""
    arr, rows = _wave_inputs(scene, cols, tab, cnts, c_max, wave_sub)
    packet = wave_sub * LANE
    state, g_tile = _wave_groups(cols, rows, wave_sub, packet, arr.device)
    need = need_plain(tab, c_max, g_tile, cnts[g_tile], arr[21:24],
                      arr[24:27], state, t.reshape(-1, packet),
                      static_bases)
    return need.reshape(-1, 3)


def launch_wave(scene: Scene, cols, tab: Tensor, cnts: Tensor, c_max: int,
                wave_sub: int = WAVE_SUB, static_bases=None,
                work: bool = False):
    """Launch ``tiled_wave_kernel`` (B7-wave) on the current stream -> the
    planes of :func:`wave_bounce_plain` (status and pid are int32 views;
    ``"chunks"`` per warp, as the plain version gives them for
    ``group=GROUP``). Does not synchronize."""
    dev = scene.device
    if dev.type != "cuda":
        raise ValueError(f"the tiled wavefront kernel needs CUDA tensors, "
                         f"got {dev}")
    arr, rows = _wave_inputs(scene, cols, tab, cnts, c_max, wave_sub)
    _aligned(tab)
    f32 = torch.float32
    state = torch.stack([c if c.dtype == f32 else c.to(torch.int32).view(f32)
                         for c in cols]).contiguous()
    flags = _flags(scene)
    n_out = 18 if flags["want_normal"] else 15
    out = torch.empty((n_out, rows, LANE), dtype=f32, device=dev)
    chunks = (torch.zeros((rows * LANE // GROUP, 3), dtype=torch.int32,
                          device=dev) if work else None)
    sb = (-1, -1) if static_bases is None else tuple(int(b)
                                                     for b in static_bases)
    lib = _build.load()
    err = lib.rt_tiled_wave(
        _ptr(tab), c_max, _ptr(cnts), _ptr(arr), _ptr(state), rows, wave_sub,
        sb[0], sb[1], int(flags["want_uv"]), int(flags["sky_solid"]),
        int(flags["has_trans"]), int(flags["want_normal"]), _ptr(out),
        _ptr(chunks), dev.index, _build.stream(dev))
    _build.check(lib, err, "tiled_wave_kernel")
    LAUNCHES["wave"] += 1
    res = {}
    for i, name in enumerate(STATE_NAMES[:n_out]):
        res[name] = out[i].view(torch.int32) if name in _INT_PLANES else out[i]
    if work:
        res["chunks"] = chunks
    return res


def wave_bounce(scene: Scene, cols, tab: Tensor, cnts: Tensor, c_max: int,
                wave_sub: int = WAVE_SUB, static_bases=None,
                work: bool = False):
    """One bounce of a packetized wavefront -> dict of [rows, LANE] planes.

    ``cols`` = the 11 planes (ox oy oz dx dy dz cr cg cb path status) of
    [rows, LANE]; ``tab``/``cnts`` the per-packet tables ([packets * c_max,
    N_ATTR], [packets, 8]) of ``accel/candidates.packet_candidates_grid``
    (with ``static_bases = grid.base[1:]``) or ``packet_candidates``.
    A finite t_safe leaves unresolved rays unchanged. CUDA scenes launch
    the kernel; CPU scenes run :func:`wave_bounce_plain`."""
    if _build.on_cpu(scene.device):
        return wave_bounce_plain(scene, cols, tab, cnts, c_max, wave_sub,
                                 static_bases, work)
    return launch_wave(scene, cols, tab, cnts, c_max, wave_sub, static_bases,
                       work)
