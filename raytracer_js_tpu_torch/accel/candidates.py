"""Candidate tables for the TILED kernels (B7-frame and B7-wave).

Port of ``raytracer_js_tpu.accel.candidates``. For every
ray tile of the frame (``sub`` x ``lane`` pixels) the host builds the
compact list of primitives any ray of the tile could hit: each primitive's
bounding sphere is tested against the tile's bounding cone (apex at the
camera), and the survivors are type-segregated ([spheres | boxes | tris])
and sorted by a conservative entry distance ``t_lo``, so the kernel can stop
scanning once every ray's best hit precedes every remaining candidate. The
cull is conservative, so it is exact: a rejected primitive cannot be hit by
any ray of the tile.

The host build runs in numpy (float64 geometry, float32 table), expression
for expression as the reference does, so the tables are equal bit for bit.

Packet tables (:func:`packet_candidates_grid`, the default, over the
host-built :class:`CellGrid`; :func:`packet_candidates`, a whole-scene
selection) are built on the scene's device per packet of divergent rays,
from each packet's bounding cone, and may be truncated: ``t_safe`` then
bounds the hit parameter of everything dropped.

Packed table layout (dense f32 ``[C, N_ATTR]`` per tile; column meaning
depends on the type segment):

====  =======================  =======================  ====================
col   sphere                   box                      triangle
====  =======================  =======================  ====================
0     t_lo (sorted asc.)       t_lo                     t_lo
1     global pid               global pid               global pid
2-4   center                   center                   v0
5     c.c - r^2                hx                       e1x
6     1/r                      hy                       e1y
7     --                       hz                       e1z
8-10  --                       --                       e2
11-13 --                       --                       unit geometric normal
14-17 rgb, mode (2=light, 1=mirror-continue, 3=transmission, 0=keep)
====  =======================  =======================  ====================

The pid rides column 1 as a float: exact below 2^24 primitives.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..config import ResponseType
from ..models import textures as tex_mod
from ..models.scene import Scene

Tensor = torch.Tensor

N_ATTR = 20

#: kernel scan-chunk size; every type segment in a packed table starts at a
#: SEG_ALIGN-multiple row (kernels/trace_tiled.CHUNK aliases this)
SEG_ALIGN = 16


def _pad_align(x: int) -> int:
    return -(-x // SEG_ALIGN) * SEG_ALIGN


def _np(t: Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def bounding_spheres_np(scene: Scene) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side bounding sphere per primitive (global prim order)."""
    parts_c, parts_r = [], []
    if scene.n_spheres:
        parts_c.append(_np(scene.sphere_center).astype(np.float64))
        parts_r.append(_np(scene.sphere_radius).astype(np.float64))
    if scene.n_boxes:
        parts_c.append(_np(scene.box_center).astype(np.float64))
        parts_r.append(np.linalg.norm(
            _np(scene.box_half).astype(np.float64), axis=-1))
    if scene.n_tris:
        v0 = _np(scene.tri_v0).astype(np.float64)
        v1 = _np(scene.tri_v1).astype(np.float64)
        v2 = _np(scene.tri_v2).astype(np.float64)
        c = (v0 + v1 + v2) / 3.0
        r = np.maximum(np.maximum(np.linalg.norm(v0 - c, axis=-1),
                                  np.linalg.norm(v1 - c, axis=-1)),
                       np.linalg.norm(v2 - c, axis=-1))
        parts_c.append(c)
        parts_r.append(r)
    if not parts_c:
        return np.zeros((0, 3)), np.zeros((0,))
    return np.concatenate(parts_c, 0), np.concatenate(parts_r, 0)


def cone_include_np(centers: np.ndarray, radii: np.ndarray, o0: np.ndarray,
                    ro: float, axis: np.ndarray, cos_t: float
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Conservative cone-vs-bounding-sphere test -> (include [P], t_lo [P]).

    Inflate the sphere by the origin-ball radius, then angular overlap
    ``cos(beta) >= cos(alpha + theta)``. cos_t < 0.25 keeps everything
    (cone too wide for the identity to be reliable).
    """
    v = centers - o0
    dist = np.linalg.norm(v, axis=-1)
    rr = radii + ro
    inside = dist <= rr * (1.0 + 1e-5) + 1e-7
    sin_a = np.clip(rr / np.maximum(dist, 1e-20), 0.0, 1.0)
    cos_a = np.sqrt(np.maximum(1.0 - sin_a * sin_a, 0.0))
    cos_b = v @ axis / np.maximum(dist, 1e-20)
    sin_t = np.sqrt(max(1.0 - cos_t * cos_t, 0.0))
    include = inside | (cos_b >= cos_a * cos_t - sin_a * sin_t - 1e-5)
    if cos_t < 0.25:
        include = np.ones_like(include, dtype=bool) | include
    t_lo = np.maximum(dist - rr, 0.0)
    return include, t_lo


def _shade_cols_np(scene: Scene, pid: np.ndarray) -> np.ndarray:
    """rgb + response-mode columns for prim ids -> [n, 4] f32.

    IMAGE-textured prims get rgb = 1 (identity): the kernel multiplies the
    packed rgb in place and the glue multiplies the sampled atlas color
    afterwards (render_tiled applies it to image-kind winners only).
    """
    safe = np.clip(pid, 0, max(scene.n_prims - 1, 0))
    tex_id = _np(scene.prim_texture)[safe]
    rgb = _np(scene.textures.solid_rgb)[tex_id]
    is_img = _np(tex_mod.is_image_kind(
        scene.textures.kind[torch.as_tensor(tex_id,
                                            device=scene.device).long()]))
    rgb = np.where(is_img[:, None], 1.0, rgb)
    mat_id = _np(scene.prim_material)[safe]
    mat = scene.materials
    light = _np(mat.light)[mat_id]
    cont = (_np(mat.mirror)[mat_id]
            & (_np(mat.response)[mat_id] == int(ResponseType.REFLECTION))
            & ~light)
    mode = 2.0 * light + 1.0 * cont
    if scene.has_transmission:
        # 3 = transmission continuation (the glue refracts; the kernel
        # leaves org/dir for it)
        trans = ((_np(mat.response)[mat_id]
                  == int(ResponseType.TRANSMISSION)) & ~light)
        mode = mode + 3.0 * trans
    return np.concatenate([rgb, mode[:, None]], axis=1).astype(np.float32)


def pack_candidate_attrs_np(scene: Scene, pid: np.ndarray, t_lo: np.ndarray
                            ) -> np.ndarray:
    """Attribute rows (see module docstring) -> [len(pid), N_ATTR] f32.

    ``pid`` -1 entries produce rows with t_lo=+inf and degenerate geometry
    (never tested: the per-segment count stops before padding; inf t_lo also
    trivially satisfies the early-exit check).
    """
    n = pid.shape[0]
    out = np.zeros((n, N_ATTR), np.float32)
    out[:, 0] = np.where(pid >= 0, t_lo, np.inf)
    out[:, 1] = np.maximum(pid, 0).astype(np.float32)
    out[:, 14:18] = _shade_cols_np(scene, pid)
    s_end = scene.n_spheres
    b_end = s_end + scene.n_boxes

    is_s = (pid >= 0) & (pid < s_end)
    if is_s.any():
        i = np.clip(pid, 0, max(s_end - 1, 0))
        c = _np(scene.sphere_center)[i]
        r = _np(scene.sphere_radius)[i]
        out[is_s, 2:5] = c[is_s]
        out[is_s, 5] = (np.sum(c * c, -1) - r * r)[is_s]
        out[is_s, 6] = (1.0 / np.maximum(r, 1e-20))[is_s]
    is_b = (pid >= s_end) & (pid < b_end)
    if is_b.any():
        i = np.clip(pid - s_end, 0, max(scene.n_boxes - 1, 0))
        out[is_b, 2:5] = _np(scene.box_center)[i][is_b]
        out[is_b, 5:8] = _np(scene.box_half)[i][is_b]
    is_t = pid >= b_end
    if is_t.any():
        i = np.clip(pid - b_end, 0, max(scene.n_tris - 1, 0))
        v0 = _np(scene.tri_v0)[i]
        e1 = _np(scene.tri_v1)[i] - v0
        e2 = _np(scene.tri_v2)[i] - v0
        gn = np.cross(e1, e2)
        gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
        out[is_t, 2:5] = v0[is_t]
        out[is_t, 5:8] = e1[is_t]
        out[is_t, 8:11] = e2[is_t]
        out[is_t, 11:14] = gn[is_t]
    return out


def _segment_sort_np(scene: Scene, ids: np.ndarray, t_lo: np.ndarray):
    """Type-segregate included prim ids, each segment sorted by t_lo and
    padded to a SEG_ALIGN multiple (pid -1 / t_lo inf padding rows) ->
    (ordered ids, ordered t_lo, (cnt_s, cnt_b, cnt_t) REAL counts)."""
    s_end = scene.n_spheres
    b_end = s_end + scene.n_boxes
    segs, tls, cnts = [], [], []
    for lo, hi in ((0, s_end), (s_end, b_end), (b_end, scene.n_prims)):
        m = (ids >= lo) & (ids < hi)
        sid = ids[m]
        stl = t_lo[sid] if sid.size else np.zeros((0,))
        order = np.argsort(stl, kind="stable")
        pad = _pad_align(len(sid)) - len(sid)
        segs.append(np.concatenate(
            [sid[order],
             np.full(pad, -1, sid.dtype if sid.size else np.int64)]))
        tls.append(np.concatenate([stl[order], np.full(pad, np.inf)]))
        cnts.append(len(sid))
    return (np.concatenate(segs), np.concatenate(tls),
            np.asarray(cnts, np.int32))


def frame_candidates(scene: Scene, cam, sub: int, lane: int,
                     c_max: int | None = None, raw: bool = False):
    """Host-side per-tile candidate tables for the frame entry.

    Tiles are (sub, lane) pixel blocks of the equiangular image (the tiled
    frame kernel's grid). Returns ``(tab [nby*nbx*C, N_ATTR] f32,
    cnts [nby*nbx, 8] f32, c_max)`` on the scene's device; ``cnts`` holds
    the real per-type counts, the resolution bound (+inf: untruncated) and
    the cone apex (the camera). ``c_max`` defaults to the exact per-scene
    maximum rounded up to a SEG_ALIGN multiple (no truncation — culling
    stays exact); passing a smaller value raises rather than silently
    dropping candidates. ``raw=True`` returns the numpy ``(pid [T, C] i32,
    t_lo [T, C] f32, cnts, c_max)`` lists instead of the packed table.
    """
    centers, radii = bounding_spheres_np(scene)
    nbx = -(-cam.w // lane)
    nby = -(-cam.h // sub)
    pos = _np(cam.pos).astype(np.float64)
    front = _np(cam.front).astype(np.float64)
    left = _np(cam.left).astype(np.float64)
    up = _np(cam.up).astype(np.float64)
    step_h = cam.fov_h / cam.w
    step_v = cam.fov_v / cam.h

    x_lo = np.arange(nbx) * lane
    x_hi = np.minimum(cam.w - 1, x_lo + lane - 1)
    y_lo = np.arange(nby) * sub
    y_hi = np.minimum(cam.h - 1, y_lo + sub - 1)
    thc_h = ((x_lo + x_hi) / 2 - (cam.w // 2)) * step_h          # [nbx]
    thc_v = ((y_lo + y_hi) / 2 - (cam.h // 2)) * step_v          # [nby]
    th_h = (x_hi - x_lo) / 2 * step_h
    th_v = (y_hi - y_lo) / 2 * step_v

    # vectorized over tiles: with the apex at the camera and ro = 0, every
    # per-prim factor of cone_include_np (dist, angular radius, t_lo) is
    # tile-independent; only cos_b = v_hat . axis varies per tile
    cv = np.cos(thc_v)[:, None]                                   # [nby,1]
    sv = np.sin(thc_v)[:, None]
    ch = np.cos(thc_h)[None, :]                                   # [1,nbx]
    sh = np.sin(thc_h)[None, :]
    axes = (ch[..., None] * cv[..., None] * front
            + ch[..., None] * sv[..., None] * up
            + sh[..., None] * np.ones((nby, 1, 1)) * left)        # [nby,nbx,3]
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    theta = (th_h[None, :] + th_v[:, None] + 1e-4).reshape(-1)    # [T]
    axes = axes.reshape(-1, 3)
    cos_t = np.cos(theta)
    sin_t = np.sqrt(np.maximum(1.0 - cos_t * cos_t, 0.0))

    v = centers - pos
    dist = np.linalg.norm(v, axis=-1)
    inside = dist <= radii * (1.0 + 1e-5) + 1e-7
    sin_a = np.clip(radii / np.maximum(dist, 1e-20), 0.0, 1.0)
    cos_a = np.sqrt(np.maximum(1.0 - sin_a * sin_a, 0.0))
    t_lo = np.maximum(dist - radii, 0.0)
    v_n = v / np.maximum(dist, 1e-20)[:, None]

    lists, tlos, cnts = [], [], []
    n_tiles = axes.shape[0]
    chunk = max(1, min(64, int(2e8 // max(len(centers), 1))))
    for c0 in range(0, n_tiles, chunk):
        ax_c = axes[c0:c0 + chunk]                               # [Tc, 3]
        cos_b = v_n @ ax_c.T                                     # [P, Tc]
        inc = (inside[:, None]
               | (cos_b >= cos_a[:, None] * cos_t[None, c0:c0 + chunk]
                  - sin_a[:, None] * sin_t[None, c0:c0 + chunk] - 1e-5)
               | (cos_t[None, c0:c0 + chunk] < 0.25))
        for j in range(ax_c.shape[0]):
            ids, tl, cnt = _segment_sort_np(scene,
                                            np.nonzero(inc[:, j])[0], t_lo)
            lists.append(ids)
            tlos.append(tl)
            cnts.append(cnt)

    maxlen = max((len(l) for l in lists), default=SEG_ALIGN)
    if c_max is None:
        c_max = max(SEG_ALIGN, _pad_align(maxlen))
    elif maxlen > c_max:
        raise ValueError(
            f"tile candidate overflow: {maxlen} > c_max {c_max}; "
            "culling would no longer be exact")
    t = len(lists)
    pid = np.full((t, c_max), -1, np.int64)
    tlo = np.full((t, c_max), np.inf, np.float32)
    for i, (l, tl) in enumerate(zip(lists, tlos)):
        pid[i, :len(l)] = l
        tlo[i, :len(l)] = tl
    cnt8 = np.zeros((t, 8), np.float32)
    cnt8[:, :3] = np.stack(cnts)           # exact below 2^24
    cnt8[:, 3] = np.inf                    # untruncated: always resolved
    cnt8[:, 4:7] = pos                     # centroid = camera (d_c = 0)
    if raw:
        return (pid.astype(np.int32), tlo, cnt8, c_max)
    tab = pack_candidate_attrs_np(scene, pid.reshape(-1), tlo.reshape(-1))
    dev = scene.device
    return torch.as_tensor(tab, device=dev), torch.as_tensor(cnt8,
                                                             device=dev), c_max


def bounding_spheres(scene: Scene) -> Tuple[Tensor, Tensor]:
    """Bounding sphere per primitive on the scene's device -> (center
    [P, 3], radius [P]), global prim order. Norms are written out as
    ``sqrt(x*x + y*y + z*z)``."""
    def norm(v):
        return torch.sqrt(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]
                          + v[:, 2] * v[:, 2])

    cs, rs = [], []
    if scene.n_spheres:
        cs.append(scene.sphere_center)
        rs.append(scene.sphere_radius)
    if scene.n_boxes:
        cs.append(scene.box_center)
        rs.append(norm(scene.box_half))
    if scene.n_tris:
        v0, v1, v2 = scene.tri_v0, scene.tri_v1, scene.tri_v2
        c = (v0 + v1 + v2) / 3.0
        rs.append(torch.maximum(torch.maximum(norm(v0 - c), norm(v1 - c)),
                                norm(v2 - c)))
        cs.append(c)
    if not cs:
        return (torch.zeros((0, 3), device=scene.device),
                torch.zeros((0,), device=scene.device))
    return torch.cat(cs, 0), torch.cat(rs, 0)


# ---------------------------------------------------------------------------
# Packet tables: candidate tables for packets of divergent rays
# ---------------------------------------------------------------------------

def _norm3(v: Tensor) -> Tensor:
    """|v| over the last axis, written out (never a matmul or a library
    norm: the cone test's 1e-5 slack is far below TF32 rounding)."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                      + v[..., 2] * v[..., 2])


def _dot3(v: Tensor, a: Tensor) -> Tensor:
    return (v[..., 0] * a[..., 0] + v[..., 1] * a[..., 1]
            + v[..., 2] * a[..., 2])


def packet_cones(org: Tensor, dir: Tensor, alive: Tensor, packet: int):
    """Bounding cone per packet of ``packet`` consecutive rays -> (o0
    [B, 3], ro [B], axis [B, 3], cos_t [B]).

    Dead rays are left out of the bound (their origin and direction are
    stale); a packet with no live ray gets cos_t = 2, an empty cone."""
    b = org.shape[0] // packet
    o = org.reshape(b, packet, 3)
    d = dir.reshape(b, packet, 3)
    m = alive.reshape(b, packet).to(org.dtype)[..., None]
    n_live = torch.clamp(m.sum(dim=1), min=1e-20)
    o0 = (o * m).sum(dim=1) / n_live
    ro = (_norm3(o - o0[:, None]) * m[..., 0]).max(dim=1).values
    axis = (d * m).sum(dim=1)
    axis = axis / torch.clamp(_norm3(axis)[:, None], min=1e-20)
    dots = _dot3(d, axis[:, None])
    cos_t = torch.where(m[..., 0] > 0, dots, 1.0).min(dim=1).values
    cos_t = torch.clamp(cos_t, -1.0, 1.0)
    any_live = m[..., 0].sum(dim=1) > 0
    return o0, ro, axis, torch.where(any_live, cos_t, 2.0)


def _cone_keep(centers: Tensor, radii: Tensor, o0: Tensor, ro: Tensor,
               axis: Tensor, cos_t: Tensor):
    """The ball-inflated cone test of every packet against every bounding
    sphere -> (keep [B, P], dist [B, P]); the identity of
    :func:`cone_include_np`, with a packet of no live ray keeping nothing."""
    v = centers[None] - o0[:, None]                              # [B, P, 3]
    dist = _norm3(v)
    rr = radii[None] + ro[:, None]
    inside = dist <= rr * (1.0 + 1e-5) + 1e-7
    sin_a = torch.clamp(rr / torch.clamp(dist, min=1e-20), 0.0, 1.0)
    cos_a = torch.sqrt(torch.clamp(1.0 - sin_a * sin_a, min=0.0))
    cos_b = _dot3(v, axis[:, None]) / torch.clamp(dist, min=1e-20)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    keep = inside | (cos_b >= cos_a * cos_t[:, None]
                     - sin_a * sin_t[:, None] - 1e-5)
    keep = keep | (cos_t[:, None] < 0.25)
    return keep & (cos_t[:, None] <= 1.0), dist


def _cleared_floor(org: Tensor, alive: Tensor, o0: Tensor, t_done: Tensor,
                   packet: int) -> Tensor:
    """Per packet, the distance from o0 that every live ray has proven
    clear: min over live rays of (t_done - |o - o0|), -inf if none."""
    b = org.shape[0] // packet
    d_c = _norm3(org.reshape(b, packet, 3) - o0[:, None])
    floor = torch.where(alive.reshape(b, packet),
                        t_done.reshape(b, packet) - d_c,
                        torch.inf).min(dim=1).values
    return torch.where(torch.isfinite(floor), floor, -torch.inf)


def packet_candidates(scene: Scene, org: Tensor, dir: Tensor, alive: Tensor,
                      packet: int, c_max: int, t_done: Tensor | None = None):
    """Per-packet candidate tables by a whole-scene selection -> (tab
    [B * c_max, N_ATTR] f32, cnts [B, 8] f32, t_safe [B] f32): the rowwise
    path, taken for tables without a cell grid.

    Every packet keeps the nearest ``c_max - 3 * SEG_ALIGN`` included prims
    by t_lo; ``t_safe`` is the smallest t_lo of those it dropped (+inf if
    none), below which a hit is final. ``t_done`` [N] is each ray's proven
    clear horizon: prims inside a packet's common cleared ball are skipped,
    so retry rounds progress. ``cnts`` rows: kept per class, t_safe, o0,
    ro."""
    centers, radii = bounding_spheres(scene)
    o0, ro, axis, cos_t = packet_cones(org, dir, alive, packet)
    include, dist = _cone_keep(centers, radii, o0, ro, axis, cos_t)
    # centroid-anchored entry bound: a ray d from o0 hits at t >= t_lo - d
    t_lo = torch.clamp(dist - radii[None], min=0.0)
    if t_done is not None:
        floor = _cleared_floor(org, alive, o0, t_done, packet)
        include = include & (dist + radii[None] > floor[:, None])
    c_sel = c_max - 3 * SEG_ALIGN
    assert c_sel > 0, c_max
    p = centers.shape[0]
    c_sel = min(c_sel, p)
    b = include.shape[0]
    s_end = scene.n_spheres
    b_end = s_end + scene.n_boxes
    big = 1e30
    # globally nearest first, so the dropped prims are the farthest
    key = torch.where(include, t_lo, big)
    order_full = torch.argsort(key, dim=1, stable=True)
    order = order_full[:, :c_sel]
    inc_sel = torch.gather(include, 1, order)
    tlo_sel = torch.gather(t_lo, 1, order)
    pid = torch.where(inc_sel, order, -1)
    if p > c_sel:
        t_safe = torch.gather(key, 1, order_full[:, c_sel:c_sel + 1])[:, 0]
        t_safe = torch.where(t_safe >= big, torch.inf, t_safe)
    else:
        t_safe = torch.full((b,), torch.inf, device=org.device)
    # class-major re-sort of the selected slice, nearest first in each
    seg_sel = torch.where(pid < 0, 3, torch.where(
        pid < s_end, 0, torch.where(pid < b_end, 1, 2)))
    pos = torch.arange(c_sel, device=org.device)[None]
    srt = torch.sort(seg_sel * (c_sel + 1) + pos, dim=1, stable=True).indices
    pid = torch.gather(pid, 1, srt)
    tlo_sel = torch.gather(tlo_sel, 1, srt)
    kept = torch.stack([(seg_sel == k).sum(dim=1) for k in range(3)], dim=1)
    cnts = torch.cat([kept.to(torch.float32), t_safe[:, None], o0,
                      ro[:, None]], dim=1)
    # class k starts at row a_k, a SEG_ALIGN multiple
    a1 = (kept[:, 0] + SEG_ALIGN - 1) // SEG_ALIGN * SEG_ALIGN
    a2 = a1 + (kept[:, 1] + SEG_ALIGN - 1) // SEG_ALIGN * SEG_ALIGN
    r = torch.arange(c_max, device=org.device)[None]
    seg_r = (r >= a1[:, None]).long() + (r >= a2[:, None]).long()
    a_seg = torch.where(seg_r == 0, 0, torch.where(seg_r == 1, a1[:, None],
                                                   a2[:, None]))
    s_seg = torch.where(seg_r == 0, 0, torch.where(
        seg_r == 1, kept[:, 0:1], (kept[:, 0] + kept[:, 1])[:, None]))
    k_seg = torch.gather(torch.cat([kept, kept.new_zeros((b, 1))], dim=1), 1,
                         torch.clamp(seg_r, max=3))
    off = r - a_seg
    valid = off < k_seg
    src = torch.clamp(s_seg + off, 0, c_sel - 1)
    pid_out = torch.where(valid, torch.gather(pid, 1, src), -1)
    tlo_out = torch.where(valid, torch.gather(tlo_sel, 1, src), torch.inf)
    tab = pack_candidate_attrs(scene, pid_out.reshape(-1),
                               tlo_out.reshape(-1))
    return tab, cnts, t_safe


def prim_attr_table(scene: Scene) -> Tensor:
    """Per-primitive packed rows [P, N_ATTR] f32 (columns 0 and 1, t_lo
    and pid, are filled per candidate), so packing a candidate list is one
    row gather."""
    mat = scene.materials
    mid = scene.prim_material.long()
    tex_id = scene.prim_texture.long()
    rgb = scene.textures.solid_rgb[tex_id]
    is_img = tex_mod.is_image_kind(scene.textures.kind[tex_id])
    rgb = torch.where(is_img[:, None], 1.0, rgb)      # the glue samples
    light = mat.light[mid]
    cont = (mat.mirror[mid]
            & (mat.response[mid] == int(ResponseType.REFLECTION)) & ~light)
    mode = 2.0 * light.to(torch.float32) + 1.0 * cont.to(torch.float32)
    if scene.has_transmission:
        trans = ((mat.response[mid] == int(ResponseType.TRANSMISSION))
                 & ~light)
        mode = mode + 3.0 * trans.to(torch.float32)
    dev = scene.device
    geos = []
    if scene.n_spheres:
        c, r = scene.sphere_center, scene.sphere_radius
        geos.append(torch.cat(
            [c, (c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1] + c[:, 2] * c[:, 2]
                 - r * r)[:, None],
             (1.0 / torch.clamp(r, min=1e-20))[:, None],
             torch.zeros((scene.n_spheres, 7), device=dev)], dim=1))
    if scene.n_boxes:
        geos.append(torch.cat([scene.box_center, scene.box_half,
                               torch.zeros((scene.n_boxes, 6), device=dev)],
                              dim=1))
    if scene.n_tris:
        v0 = scene.tri_v0
        e1 = scene.tri_v1 - v0
        e2 = scene.tri_v2 - v0
        gn = torch.linalg.cross(e1, e2)
        gn = gn / torch.clamp(_norm3(gn)[:, None], min=1e-20)
        geos.append(torch.cat([v0, e1, e2, gn], dim=1))
    if not geos:
        return torch.cat([torch.zeros((1, 14), device=dev),
                          torch.ones((1, 3), device=dev),
                          torch.zeros((1, N_ATTR - 17), device=dev)], dim=1)
    geo = torch.cat(geos, dim=0)
    n = geo.shape[0]
    return torch.cat([torch.zeros((n, 2), device=dev), geo, rgb,
                      mode[:, None], torch.zeros((n, N_ATTR - 18),
                                                 device=dev)], dim=1)


def pack_candidate_attrs(scene: Scene, pid: Tensor, t_lo: Tensor,
                         table: Tensor | None = None) -> Tensor:
    """Candidate rows [len(pid), N_ATTR] f32 by one gather from
    :func:`prim_attr_table`; pid -1 rows get t_lo = +inf."""
    if table is None:
        table = prim_attr_table(scene)
    safe = torch.clamp(pid.long(), 0, max(scene.n_prims - 1, 0))
    out = table[safe]
    out[:, 0] = torch.where(pid >= 0, t_lo, torch.inf)
    out[:, 1] = torch.clamp(pid, min=0).to(torch.float32)
    return out


# ---------------------------------------------------------------------------
# The cell grid: the sort-free packet path (the default)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CellGrid:
    """Uniform-cell lists over the small-prim extent, host-built, its
    tensors on the scene's device.

    ``order[c]`` lists all G = g^3 cells by center distance from cell c.
    Prims whose bounding box lies inside the grid's extent are listed (by
    global id, per class) in every cell their box overlaps; ``bound[c]``
    bounds the distance from cell c's center to any listed prim's surface.
    The other prims (a ground slab, a far emitter) go to the per-class
    ``glob`` lists, which every packet takes whole. ``off``/``ids`` are
    per-class CSR lists, ``cnt`` the per-cell counts as f32. ``budget``,
    ``base`` and ``c_max`` fix the packed layout: class k's rows start at
    ``base[k]``, its globals first."""

    g: int
    centers: Tensor       # [G, 3] f32
    bound: Tensor         # [G] f32
    order: Tensor         # [G, G] i32
    off_s: Tensor         # [G + 1] i32
    off_b: Tensor
    off_t: Tensor
    cnt_s: Tensor         # [G] f32
    cnt_b: Tensor
    cnt_t: Tensor
    ids_s: Tensor         # [K] i32
    ids_b: Tensor
    ids_t: Tensor
    glob_s: Tensor        # [n_glob] i32 (may be empty)
    glob_b: Tensor
    glob_t: Tensor
    lo: Tensor            # [3] f32
    inv_h: Tensor         # [3] f32
    budget: Tuple[int, int, int]
    base: Tuple[int, int, int]
    c_max: int


def build_cell_grid(scene: Scene, g: int = 16,
                    c_sel: int = 4096) -> CellGrid:
    """Host-side grid build (numpy, expression for expression as the
    reference's, so every field is equal bit for bit). ``c_sel`` sizes the
    per-class row budgets, split by list mass."""
    centers, radii = bounding_spheres_np(scene)
    p = centers.shape[0]
    if p == 0:
        raise ValueError("empty scene has no candidate grid")
    med = np.median(radii)
    small = radii <= 8.0 * med + 1e-12
    if not small.any():
        small = np.ones_like(small)
    lo = (centers - radii[:, None])[small].min(0) - 1e-3
    hi = (centers + radii[:, None])[small].max(0) + 1e-3
    h = np.maximum((hi - lo) / g, 1e-6)
    n_cells = g ** 3
    in_grid = (((centers - radii[:, None]) >= lo - 1e-6).all(1)
               & ((centers + radii[:, None]) <= hi + 1e-6).all(1))
    clo = np.clip(np.floor((centers - radii[:, None] - lo) / h), 0,
                  g - 1).astype(np.int64)
    chi = np.clip(np.floor((centers + radii[:, None] - lo) / h), 0,
                  g - 1).astype(np.int64)
    span = chi - clo + 1
    # prims spanning at most 2 cells an axis are covered by their 8 box
    # corner cells; the few larger ones by a loop
    fast = (span <= 2).all(axis=1) & in_grid
    cell_lists = []
    idx_fast = np.nonzero(fast)[0]
    if idx_fast.size:
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    cx = np.minimum(clo[idx_fast, 0] + dx, chi[idx_fast, 0])
                    cy = np.minimum(clo[idx_fast, 1] + dy, chi[idx_fast, 1])
                    cz = np.minimum(clo[idx_fast, 2] + dz, chi[idx_fast, 2])
                    cell_lists.append(((cx * g + cy) * g + cz, idx_fast))
    for i in np.nonzero(~fast & in_grid)[0]:
        xs = np.arange(clo[i, 0], chi[i, 0] + 1)
        ys = np.arange(clo[i, 1], chi[i, 1] + 1)
        zs = np.arange(clo[i, 2], chi[i, 2] + 1)
        cc = ((xs[:, None, None] * g + ys[None, :, None]) * g
              + zs[None, None, :]).ravel()
        cell_lists.append((cc, np.full(cc.shape, i, np.int64)))
    cell_lin = np.concatenate([c for c, _ in cell_lists])
    pid_lin = np.concatenate([pp for _, pp in cell_lists])
    key = np.unique(cell_lin * p + pid_lin)     # corner cells coincide
    cell_lin = key // p
    pid_lin = key % p

    s_end = scene.n_spheres
    b_end = s_end + scene.n_boxes
    halfdiag = float(np.linalg.norm(h) / 2.0)
    offs, cnts, idss, globs = [], [], [], []
    bound = np.full(n_cells, halfdiag, np.float64)
    for t_lo_, t_hi_ in ((0, s_end), (s_end, b_end), (b_end, p)):
        gm = ~in_grid & (np.arange(p) >= t_lo_) & (np.arange(p) < t_hi_)
        globs.append(np.nonzero(gm)[0].astype(np.int32))
        m = (pid_lin >= t_lo_) & (pid_lin < t_hi_)
        cl, pi = cell_lin[m], pid_lin[m]
        ordr = np.argsort(cl, kind="stable")
        cl, pi = cl[ordr], pi[ordr]
        cnt = np.bincount(cl, minlength=n_cells)
        off = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int64)
        offs.append(off)
        cnts.append(cnt.astype(np.float32))
        idss.append(pi.astype(np.int32) if pi.size
                    else np.zeros((1,), np.int32))
        if pi.size:
            # the exact reach of the listed prims' surfaces per cell
            cell_c = lo + (np.stack([cl // (g * g), (cl // g) % g, cl % g],
                                    axis=1) + 0.5) * h
            reach = np.linalg.norm(centers[pi] - cell_c, axis=1) + radii[pi]
            rmax = np.zeros(n_cells)
            np.maximum.at(rmax, cl, reach)
            bound = np.maximum(bound, rmax)

    gi = np.arange(g)
    ccenters = lo + (np.stack(np.meshgrid(gi, gi, gi, indexing="ij"),
                              axis=-1).reshape(-1, 3) + 0.5) * h
    d2 = ((ccenters[:, None, :] - ccenters[None, :, :]) ** 2).sum(-1)
    order = np.argsort(d2, axis=1, kind="stable").astype(np.int32)

    mass = np.array([max(int(c.sum()), 0) for c in cnts], np.float64)
    tot = max(mass.sum(), 1.0)
    budget, base = [], []
    a = 0
    for k in range(3):
        bk = 0
        if mass[k] > 0:
            bk = int(max(2 * SEG_ALIGN,
                         min(_pad_align(int(c_sel * mass[k] / tot)),
                             _pad_align(int(mass[k])))))
        base.append(a)
        budget.append(bk)
        # class capacity: globals then cell rows, SEG_ALIGN-aligned
        a += _pad_align(len(globs[k]) + bk) if (bk or len(globs[k])) else 0
    dev = scene.device

    def dev_t(x, dtype):
        return torch.as_tensor(np.asarray(x).astype(dtype), device=dev)

    i32, f32 = np.int32, np.float32
    return CellGrid(
        g=g, centers=dev_t(ccenters, f32), bound=dev_t(bound, f32),
        order=dev_t(order, i32), off_s=dev_t(offs[0], i32),
        off_b=dev_t(offs[1], i32), off_t=dev_t(offs[2], i32),
        cnt_s=dev_t(cnts[0], f32), cnt_b=dev_t(cnts[1], f32),
        cnt_t=dev_t(cnts[2], f32), ids_s=dev_t(idss[0], i32),
        ids_b=dev_t(idss[1], i32), ids_t=dev_t(idss[2], i32),
        glob_s=dev_t(globs[0], i32), glob_b=dev_t(globs[1], i32),
        glob_t=dev_t(globs[2], i32), lo=dev_t(lo, f32),
        inv_h=dev_t(1.0 / h, f32), budget=tuple(budget), base=tuple(base),
        c_max=max(a, SEG_ALIGN))


def packet_candidates_grid(scene: Scene, grid: CellGrid, org: Tensor,
                           dir: Tensor, alive: Tensor, packet: int,
                           t_done: Tensor | None = None,
                           table: Tensor | None = None):
    """Sort-free per-packet candidate tables from the cell grid -> (tab
    [B * grid.c_max, N_ATTR], cnts [B, 8], t_safe [B]), the contract of
    :func:`packet_candidates`; the classes sit at the fixed rows
    ``grid.base``.

    Per packet the kept cells are visited in the host-made distance order
    from the packet's own cell and cut by a cumulative count at each
    class's budget; ``t_safe`` is the exact smallest cell t_lo of the kept
    cells left out, and column 0 of the rows carries the per-class suffix
    minimum of t_lo, a true lower bound under the (only approximately
    sorted) visit order."""
    b = org.shape[0] // packet
    n_cells = grid.centers.shape[0]
    dev = org.device
    o0, ro, axis, cos_t = packet_cones(org, dir, alive, packet)
    keep, cdist = _cone_keep(grid.centers, grid.bound, o0, ro, axis, cos_t)
    t_lo_c = torch.clamp(cdist - grid.bound[None], min=0.0)
    if t_done is not None:
        floor = _cleared_floor(org, alive, o0, t_done, packet)
        keep = keep & (cdist + grid.bound[None] > floor[:, None])
    # the visit order anchored at the packet's own cell
    q = torch.clamp(((o0 - grid.lo[None]) * grid.inv_h[None]).to(
        torch.int32), 0, grid.g - 1)
    c0 = (q[:, 0] * grid.g + q[:, 1]) * grid.g + q[:, 2]
    order = grid.order[c0.long()].long()                      # [B, G]
    keep_o = torch.gather(keep, 1, order)
    tlo_o = torch.gather(t_lo_c, 1, order)

    centers_all, radii_all = bounding_spheres(scene)
    pid_rows, tlo_rows, counts, safes = [], [], [], []
    for cnt_c, off_c, ids_c, glob, budget in (
            (grid.cnt_s, grid.off_s, grid.ids_s, grid.glob_s,
             grid.budget[0]),
            (grid.cnt_b, grid.off_b, grid.ids_b, grid.glob_b,
             grid.budget[1]),
            (grid.cnt_t, grid.off_t, grid.ids_t, grid.glob_t,
             grid.budget[2])):
        n_g = int(glob.shape[0])
        if budget == 0 and n_g == 0:
            counts.append(torch.zeros((b,), device=dev))
            safes.append(torch.full((b,), torch.inf, device=dev))
            continue
        if budget:
            cnt_o = torch.where(keep_o, cnt_c[order], 0.0)
            cum = torch.cumsum(cnt_o, dim=1)                     # [B, G] f32
            sel = cum <= float(budget)                           # whole cells
            n_rows = torch.where(sel, cum, 0.0).max(dim=1).values
            t_safe_t = torch.where(keep_o & ~sel, tlo_o,
                                   torch.inf).min(dim=1).values
            jq = torch.arange(budget, dtype=torch.float32, device=dev)[None]
            rj = torch.searchsorted(cum, jq.expand(b, budget).contiguous(),
                                    right=True)
            rj = torch.clamp(rj, max=n_cells - 1)
            valid = jq < n_rows[:, None]
            cell_j = torch.gather(order, 1, rj)
            prev = torch.where(rj > 0, torch.gather(
                cum, 1, torch.clamp(rj - 1, min=0)), 0.0)
            local = (jq - prev).to(torch.int64)
            idx = torch.clamp(off_c.long()[cell_j] + local, 0,
                              ids_c.shape[0] - 1)
            pid = torch.where(valid, ids_c[idx], -1)
            tlo_row = torch.where(valid, torch.gather(tlo_o, 1, rj),
                                  torch.inf)
        else:
            n_rows = torch.zeros((b,), device=dev)
            t_safe_t = torch.full((b,), torch.inf, device=dev)
            pid = torch.full((b, 0), -1, dtype=torch.int32, device=dev)
            tlo_row = torch.full((b, 0), torch.inf, device=dev)
        if n_g:
            # the always-valid globals go first, so valid rows stay a prefix
            gl = glob.long()
            g_tlo = torch.clamp(_norm3(centers_all[gl][None] - o0[:, None])
                                - radii_all[gl][None], min=0.0)
            pid = torch.cat([glob[None].expand(b, n_g), pid], dim=1)
            tlo_row = torch.cat([g_tlo, tlo_row], dim=1)
            n_rows = n_rows + n_g
        # the per-class suffix minimum: a true lower bound of what follows
        tlo_row = torch.flip(torch.cummin(torch.flip(tlo_row, [1]), dim=1)
                             .values, [1])
        width = n_g + budget
        pad = _pad_align(width) - width
        if pad:
            pid = torch.nn.functional.pad(pid, (0, pad), value=-1)
            tlo_row = torch.nn.functional.pad(tlo_row, (0, pad),
                                              value=torch.inf)
        pid_rows.append(pid)
        tlo_rows.append(tlo_row)
        counts.append(n_rows)
        safes.append(t_safe_t)

    if pid_rows:
        pid_all = torch.cat(pid_rows, dim=1)
        tlo_all = torch.cat(tlo_rows, dim=1)
    else:
        pid_all = torch.full((b, SEG_ALIGN), -1, dtype=torch.int32,
                             device=dev)
        tlo_all = torch.full((b, SEG_ALIGN), torch.inf, device=dev)
    t_safe = torch.minimum(torch.minimum(safes[0], safes[1]), safes[2])
    cnts = torch.cat([torch.stack(counts, dim=1), t_safe[:, None], o0,
                      ro[:, None]], dim=1)
    tab = pack_candidate_attrs(scene, pid_all.reshape(-1),
                               tlo_all.reshape(-1), table=table)
    return tab, cnts, t_safe
