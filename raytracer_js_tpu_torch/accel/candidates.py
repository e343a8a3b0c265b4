"""Per-tile candidate tables for the TILED frame kernel (B7).

Port of the frame part of ``raytracer_js_tpu.accel.candidates``. For every
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
