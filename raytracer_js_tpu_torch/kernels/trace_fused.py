"""Fused whole-trace kernels (B1 frame, B2 wavefront) and their plain versions.

Port of ``raytracer_js_tpu.kernels.trace_fused``. The whole bounce loop of
``ops/trace.trace_rays`` for the fused scene class — solid textures, solid
sky, no ``ResponseType.BOTH`` — runs in one CUDA kernel launch
(``csrc/trace_fused.cu``); ray state never leaves registers.

Two entries share one core:

- :func:`trace_frame_fused` — the headline frame: camera rays are built in
  the kernel from the pose (the :func:`models.camera.pixel_rays` closed
  form). Camera directions are unit and mirror reflections keep them so,
  which drops the |d|^2 terms from every sphere test (``unit_d``); bounce
  0's shared origin folds the sphere constant c0 on the host (``has_c0``).
- :func:`trace_rays_fused` — an arbitrary ray wavefront with per-ray RNG
  ids, general |d|.

Each entry has a plain PyTorch version (``*_plain``, on
:func:`trace_core_plain`) that runs the same arithmetic in the same order
with [rays, prims] tensors. A wrapper takes the plain version only for CPU
tensors; for CUDA tensors it launches the kernel or raises. ``LAUNCHES``
counts kernel launches per entry.

Each warp of the kernels culls the spheres by the ball-cone of its live
rays (``csrc/cull.cuh``) before each bounce's search; :func:`cull_counts`
is its plain form (the spheres each warp tests at each bounce). A culled
sphere misses every live ray of its warp, so the kernels find the dense
search's hits, which :func:`trace_core_plain` runs. The CUDA wrappers keep
the
camera-independent tables on the scene (:func:`scene_tables`) and pass
the camera by pointer and value, so a frame waits on nothing and copies
nothing from the host.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from ..config import EPS_ADVANCE, JS_EPSILON, RayStatus, RenderConfig, ResponseType
from ..models.camera import Camera, angle_steps, pixel_rays
from ..models.scene import Scene, box_volumes, sphere_volumes
from ..ops import sampling
from ..ops.intersect import INF as _INF, MT_EPS as _MT_EPS
from ..ops.intersect import SLAB_DIR_EPS as _SLAB_EPS, safe_inv as _safe_inv
from ..ops.vecmath import cross, length
from ..utils.profiling import span
from . import _build
from . import nearest_hit as nh
from ._build import need as _need, on_cpu as _on_cpu, ptr as _ptr
from ._build import stream as _stream

Tensor = torch.Tensor

#: kernel launches per entry since the last reset (the plain versions do
#: not count)
LAUNCHES = {"frame": 0, "rays": 0}

#: rays a warp culls for (B1: a strip of 32 pixels of one row of its 32x8
#: block; B2: 32 consecutive rays)
WARP = 32

_ALIVE, _LIGHT, _KEEP, _MISS, _EXHAUST = (int(s) for s in RayStatus)

# Table rows (mirrored by the enums in csrc/trace_fused.cu).
(S_CX, S_CY, S_CZ, S_CCMR, S_INVR, S_R, S_G, S_B, S_MODE, S_C0, S_ROUGH,
 S_REFR, S_VOL) = range(13)
(B_CX, B_CY, B_CZ, B_HX, B_HY, B_HZ, B_R, B_G, B_B, B_MODE, B_ROUGH,
 B_REFR, B_VOL) = range(13)
(T_V0X, T_V0Y, T_V0Z, T_V1X, T_V1Y, T_V1Z, T_V2X, T_V2Y, T_V2Z, T_GX, T_GY,
 T_GZ, T_R, T_G, T_B, T_MODE, T_ROUGH) = range(17)


def supports(scene: Scene) -> bool:
    """Fused-class eligibility: solid textures, solid sky, no BOTH (the
    kernel's mode decode has no Fresnel-split branch)."""
    return (not scene.textures.has_images and scene.sky_box is None
            and not scene.has_both)


def supports_frame(scene: Scene) -> bool:
    """Frame-kernel eligibility. The reference also routes scenes of 4096
    spheres or more to its wavefront kernel, whose ray-block shortlist needs
    materialized rays; this port has no shortlist, so the frame kernel
    takes the whole fused class."""
    return supports(scene)


@dataclasses.dataclass(frozen=True)
class Tables:
    """Structure-of-arrays primitive tables, one [rows, count] f32 tensor
    per class, on the scene's device, and the spheres' radii, from which
    the kernels' arrays of structs are built on first use."""

    sph: Tensor     # [13, S]
    box: Tensor     # [13, B]
    tri: Tensor     # [17, T]
    sky: Tensor     # [3]
    has_rough: bool
    has_trans: bool
    radius: Tensor  # [S]

    @functools.cached_property
    def sph4(self) -> Tensor:
        """The sphere search rows as an array of structs [S, 4] f32: cx cy
        cz ccmr (the kernels' shared-memory window)."""
        return self.sph[S_CX:S_CCMR + 1].T.contiguous()

    @functools.cached_property
    def balls(self) -> Tensor:
        """The cull's balls [S, 4] f32: cx cy cz r, one row a sphere."""
        return torch.cat([self.sph[S_CX:S_CZ + 1].T,
                          self.radius.to(torch.float32)[:, None]],
                         1).contiguous()

    @property
    def n_sph(self) -> int:
        return self.sph.shape[1]

    @property
    def n_box(self) -> int:
        return self.box.shape[1]

    @property
    def n_tri(self) -> int:
        return self.tri.shape[1]


def pack_tables(scene: Scene, cam_pos: Optional[Tensor] = None) -> Tables:
    """Primitive tables for the fused core (the reference's ``_pack_prims``).

    Per prim: geometry, the shading color, the response mode (2 emissive,
    1 mirror REFLECTION continues, 3 TRANSMISSION continues, 0 keep — light
    wins), the roughness, and for transmission the substance's refractive
    index (-1 = undefined) and the enclosed volume. Spheres carry
    ``ccmr = c.c - r^2`` and ``1/r``; with ``cam_pos`` also the bounce-0
    constant ``c0 = o.o - 2 o.c + ccmr``. Triangles carry the unit geometric
    normal.
    """
    f32 = torch.float32
    mat_id = scene.prim_material.long()
    m = scene.materials
    rgb = scene.textures.solid_rgb.index_select(0, scene.prim_texture.long())
    light = m.light.index_select(0, mat_id)
    response = m.response.index_select(0, mat_id)
    cont = (m.mirror.index_select(0, mat_id)
            & (response == int(ResponseType.REFLECTION)) & ~light)
    mode = 2.0 * light.to(f32) + cont.to(f32)
    if scene.has_transmission:
        trans = (response == int(ResponseType.TRANSMISSION)) & ~light
        mode = mode + 3.0 * trans.to(f32)
    rough = m.roughness.index_select(0, mat_id)
    sub_id = scene.prim_substance.long()
    sub_refr = torch.where(
        sub_id >= 0,
        scene.sub_refr.index_select(
            0, torch.clamp(sub_id, 0, scene.sub_refr.shape[0] - 1)),
        -1.0)
    s_end = scene.n_spheres
    b_end = s_end + scene.n_boxes

    def attrs(lo, hi):
        return [rgb[lo:hi, 0], rgb[lo:hi, 1], rgb[lo:hi, 2], mode[lo:hi]]

    c = scene.sphere_center
    r = scene.sphere_radius
    cx, cy, cz = c[:, 0], c[:, 1], c[:, 2]
    ccmr = (cx * cx + cy * cy + cz * cz) - r * r
    if cam_pos is None:
        c0 = torch.zeros_like(r)
    else:
        o0, o1, o2 = cam_pos[0], cam_pos[1], cam_pos[2]
        o_dot_o = o0 * o0 + o1 * o1 + o2 * o2
        c0 = o_dot_o - 2.0 * (cx * o0 + cy * o1 + cz * o2) + ccmr
    sph = [cx, cy, cz, ccmr, 1.0 / torch.clamp(r, min=1e-20),
           *attrs(0, s_end), c0, rough[0:s_end], sub_refr[0:s_end],
           sphere_volumes(r)]
    bc, bh = scene.box_center, scene.box_half
    box = [bc[:, 0], bc[:, 1], bc[:, 2], bh[:, 0], bh[:, 1], bh[:, 2],
           *attrs(s_end, b_end), rough[s_end:b_end], sub_refr[s_end:b_end],
           box_volumes(bh)]
    v0, v1, v2 = scene.tri_v0, scene.tri_v1, scene.tri_v2
    gn = cross(v1 - v0, v2 - v0)
    gn = gn / torch.clamp(length(gn), min=1e-20)[:, None]
    tri = [v0[:, 0], v0[:, 1], v0[:, 2], v1[:, 0], v1[:, 1], v1[:, 2],
           v2[:, 0], v2[:, 1], v2[:, 2], gn[:, 0], gn[:, 1], gn[:, 2],
           *attrs(b_end, scene.n_prims), rough[b_end:]]
    def table(rows):
        return torch.stack([x.to(f32) for x in rows], dim=0).contiguous()

    return Tables(sph=table(sph), box=table(box), tri=table(tri),
                  sky=scene.textures.solid_rgb[scene.sky_tex].contiguous(),
                  has_rough=bool(scene.has_rough),
                  has_trans=bool(scene.has_transmission), radius=r)


def _table_key(scene: Scene) -> tuple:
    """Identity and version counter of every tensor :func:`pack_tables`
    reads (an in-place edit moves the counter), and the static fields."""
    m, x = scene.materials, scene.textures
    tensors = (scene.sphere_center, scene.sphere_radius, scene.box_center,
               scene.box_half, scene.tri_v0, scene.tri_v1, scene.tri_v2,
               scene.prim_material, scene.prim_texture,
               scene.prim_substance, scene.sub_refr, m.response, m.light,
               m.mirror, m.roughness, x.solid_rgb)
    return (tuple((id(t), t._version) for t in tensors)
            + (scene.sky_tex, scene.has_rough, scene.has_transmission))


def scene_tables(scene: Scene) -> Tables:
    """The camera-independent :func:`pack_tables` of ``scene`` (c0 zero),
    kept on the scene object and built again when a tensor it reads was
    edited in place or the key otherwise changed: the CUDA wrappers' tables,
    so that a frame of an unchanged scene launches its kernel and nothing
    else. An edit that bypasses PyTorch's version counter (through
    ``.data`` or a shared numpy array) is not seen."""
    key = _table_key(scene)
    kept = scene.__dict__.get("_fused_tables")
    if kept is None or kept[0] != key:
        kept = (key, pack_tables(scene))
        object.__setattr__(scene, "_fused_tables", kept)
    return kept[1]


# ---------------------------------------------------------------------------
# The plain core
# ---------------------------------------------------------------------------

def sphere_t(tabs: Tables, ox, oy, oz, dx, dy, dz, use_c0: bool,
             unit_d: bool) -> Tensor:
    """The kernels' sphere test for every ray and sphere -> t [N, S], +inf
    where it finds no forward hit."""
    col = (lambda v: v[:, None])
    s = tabs.sph
    cx, cy, cz = s[S_CX], s[S_CY], s[S_CZ]
    o_dot_d = ox * dx + oy * dy + oz * dz
    b_half = col(o_dot_d) - (col(dx) * cx + col(dy) * cy + col(dz) * cz)
    if use_c0:
        c = s[S_C0].expand_as(b_half)
    else:
        o_dot_o = ox * ox + oy * oy + oz * oz
        c = (col(o_dot_o) - 2.0 * (col(ox) * cx + col(oy) * cy
                                   + col(oz) * cz) + s[S_CCMR])
    if unit_d:
        disc = b_half * b_half - c
    else:
        a = dx * dx + dy * dy + dz * dz
        disc = b_half * b_half - col(a) * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    if unit_d:
        t_near = -b_half - sq
        t_far = sq - b_half
    else:
        inv_a = col(1.0 / a)
        t_near = (-b_half - sq) * inv_a
        t_far = (-b_half + sq) * inv_a
    t = torch.where(t_near >= 0.0, t_near, t_far)
    return torch.where((disc >= 0.0) & (t >= 0.0), t, _INF)


def _hit_search(tabs: Tables, ox, oy, oz, dx, dy, dz, use_c0: bool,
                unit_d: bool) -> Tuple[Tensor, Tensor]:
    """Nearest forward hit over every prim -> (t_best [N], pid [N]).

    Each class is tested as an [N, P] matrix with the kernel's expressions;
    invalid candidates become +inf and ``min`` returns the first index, so
    a tie goes to the lowest pid as with the kernel's strict ``<``.
    """
    col = (lambda v: v[:, None])
    x_o, y_o, z_o = col(ox), col(oy), col(oz)
    x_d, y_d, z_d = col(dx), col(dy), col(dz)
    parts = []
    if tabs.n_sph:
        parts.append(sphere_t(tabs, ox, oy, oz, dx, dy, dz, use_c0, unit_d))
    if tabs.n_box:
        b = tabs.box
        ix, iy, iz = col(_safe_inv(dx)), col(_safe_inv(dy)), col(_safe_inv(dz))
        tax = ((b[B_CX] - b[B_HX]) - x_o) * ix
        tbx = ((b[B_CX] + b[B_HX]) - x_o) * ix
        tay = ((b[B_CY] - b[B_HY]) - y_o) * iy
        tby = ((b[B_CY] + b[B_HY]) - y_o) * iy
        taz = ((b[B_CZ] - b[B_HZ]) - z_o) * iz
        tbz = ((b[B_CZ] + b[B_HZ]) - z_o) * iz
        t_enter = torch.maximum(torch.maximum(torch.minimum(tax, tbx),
                                              torch.minimum(tay, tby)),
                                torch.minimum(taz, tbz))
        t_exit = torch.minimum(torch.minimum(torch.maximum(tax, tbx),
                                             torch.maximum(tay, tby)),
                               torch.maximum(taz, tbz))
        t = torch.where(t_enter >= 0.0, t_enter, t_exit)
        parts.append(torch.where((t_enter <= t_exit) & (t >= 0.0), t, _INF))
    if tabs.n_tri:
        r = tabs.tri
        v0x, v0y, v0z = r[T_V0X], r[T_V0Y], r[T_V0Z]
        e1x, e1y, e1z = r[T_V1X] - v0x, r[T_V1Y] - v0y, r[T_V1Z] - v0z
        e2x, e2y, e2z = r[T_V2X] - v0x, r[T_V2Y] - v0y, r[T_V2Z] - v0z
        px = y_d * e2z - z_d * e2y
        py = z_d * e2x - x_d * e2z
        pz = x_d * e2y - y_d * e2x
        det = e1x * px + e1y * py + e1z * pz
        inv_det = 1.0 / torch.where(det.abs() < _MT_EPS, _MT_EPS, det)
        sx, sy, sz = x_o - v0x, y_o - v0y, z_o - v0z
        u = (sx * px + sy * py + sz * pz) * inv_det
        qx = sy * e1z - sz * e1y
        qy = sz * e1x - sx * e1z
        qz = sx * e1y - sy * e1x
        v = (x_d * qx + y_d * qy + z_d * qz) * inv_det
        t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        ok = ((det.abs() >= _MT_EPS) & (u >= 0.0) & (v >= 0.0)
              & (u + v <= 1.0) & (t >= 0.0))
        parts.append(torch.where(ok, t, _INF))
    n = dx.shape[0]
    if not parts:
        return (torch.full((n,), _INF, device=dx.device),
                torch.full((n,), -1, dtype=torch.long, device=dx.device))
    t_best, pid = torch.cat(parts, dim=1).min(dim=1)
    return t_best, torch.where(t_best < _INF, pid, -1)


def _winner(tabs: Tables, pid: Tensor, ox, oy, oz, dx, dy, dz, hx, hy, hz):
    """Winner color, mode, roughness and unit normal (flipped against the
    ray) -> (rgb [3][N], mode, rough, (nx, ny, nz)). Miss lanes carry
    values that the caller masks."""
    ns, nb = tabs.n_sph, tabs.n_box
    zero = torch.zeros_like(dx)
    wr = wg = wb = mode = rough = nx = ny = nz = zero
    is_sph = (pid >= 0) & (pid < ns)
    is_box = (pid >= ns) & (pid < ns + nb)
    is_tri = pid >= ns + nb

    def pick(tab, rows, ids, mask, olds):
        cols = tab[list(rows)].index_select(1, ids)
        return [torch.where(mask, cols[i], old) for i, old in enumerate(olds)]

    if ns:
        ids = torch.clamp(pid, 0, ns - 1)
        wr, wg, wb, mode, rough, cx, cy, cz, ir = pick(
            tabs.sph, (S_R, S_G, S_B, S_MODE, S_ROUGH, S_CX, S_CY, S_CZ,
                       S_INVR), ids, is_sph, [wr, wg, wb, mode, rough] + [zero] * 4)
        nx, ny, nz = (hx - cx) * ir, (hy - cy) * ir, (hz - cz) * ir
    if nb:
        ids = torch.clamp(pid - ns, 0, nb - 1)
        wr, wg, wb, mode, rough, cx, cy, cz, bhx, bhy, bhz = pick(
            tabs.box, (B_R, B_G, B_B, B_MODE, B_ROUGH, B_CX, B_CY, B_CZ,
                       B_HX, B_HY, B_HZ), ids, is_box,
            [wr, wg, wb, mode, rough] + [zero] * 6)
        ix, iy, iz = _safe_inv(dx), _safe_inv(dy), _safe_inv(dz)
        tax, tbx = (cx - bhx - ox) * ix, (cx + bhx - ox) * ix
        tay, tby = (cy - bhy - oy) * iy, (cy + bhy - oy) * iy
        taz, tbz = (cz - bhz - oz) * iz, (cz + bhz - oz) * iz
        t0x, t1x = torch.minimum(tax, tbx), torch.maximum(tax, tbx)
        t0y, t1y = torch.minimum(tay, tby), torch.maximum(tay, tby)
        t0z, t1z = torch.minimum(taz, tbz), torch.maximum(taz, tbz)
        t_enter = torch.maximum(torch.maximum(t0x, t0y), t0z)
        t_exit = torch.minimum(torch.minimum(t1x, t1y), t1z)
        # winning slab axis, tie order x > y > z; the face normal already
        # faces against the ray
        entering = t_enter >= 0.0
        wx = torch.where(entering, t0x == t_enter, t1x == t_exit)
        wy = torch.where(entering, t0y == t_enter, t1y == t_exit) & ~wx
        wz = ~wx & ~wy

        def face(w, d):
            return torch.where(w, torch.where(d < 0.0, 1.0, -1.0), 0.0)

        nx = torch.where(is_box, face(wx, dx), nx)
        ny = torch.where(is_box, face(wy, dy), ny)
        nz = torch.where(is_box, face(wz, dz), nz)
    if tabs.n_tri:
        ids = torch.clamp(pid - ns - nb, 0, tabs.n_tri - 1)
        wr, wg, wb, mode, rough, nx, ny, nz = pick(
            tabs.tri, (T_R, T_G, T_B, T_MODE, T_ROUGH, T_GX, T_GY, T_GZ),
            ids, is_tri, [wr, wg, wb, mode, rough, nx, ny, nz])
    flip = (is_sph | is_tri) & (dx * nx + dy * ny + dz * nz > 0.0)
    nx, ny, nz = (torch.where(flip, -nx, nx), torch.where(flip, -ny, ny),
                  torch.where(flip, -nz, nz))
    n_inv = 1.0 / torch.sqrt(torch.clamp(nx * nx + ny * ny + nz * nz,
                                         min=1e-20))
    return (wr, wg, wb), mode, rough, (nx * n_inv, ny * n_inv, nz * n_inv)


def _substance(tabs: Tables, ax, ay, az, refr, refr_def):
    """Innermost-containment substance scan at the advanced points ->
    (target index, do_refract)."""
    col = (lambda v: v[:, None])
    inside, vol, rf = [], [], []
    if tabs.n_sph:
        s = tabs.sph
        a_dot_a = ax * ax + ay * ay + az * az
        q = (col(a_dot_a) - 2.0 * (col(ax) * s[S_CX] + col(ay) * s[S_CY]
                                   + col(az) * s[S_CZ])) + s[S_CCMR]
        inside.append(q <= 0.0)
        vol.append(s[S_VOL])
        rf.append(s[S_REFR])
    if tabs.n_box:
        b = tabs.box
        inside.append(((col(ax) - b[B_CX]).abs() <= b[B_HX])
                      & ((col(ay) - b[B_CY]).abs() <= b[B_HY])
                      & ((col(az) - b[B_CZ]).abs() <= b[B_HZ]))
        vol.append(b[B_VOL])
        rf.append(b[B_REFR])
    if not inside:
        return refr_def.expand_as(ax), torch.ones_like(ax, dtype=torch.bool)
    inside = torch.cat(inside, dim=1)
    # strict < on volume in the kernel: the first prim wins a tie
    j = torch.where(inside, torch.cat(vol), _INF).argmin(dim=1)
    any_in = inside.any(dim=1)
    refr_sel = torch.where(any_in, torch.cat(rf).index_select(0, j), 0.0)
    defined = refr_sel >= 0.0
    target = torch.where(any_in, torch.where(defined, refr_sel, refr),
                         refr_def)
    return target, ~any_in | defined


def trace_core_plain(org: Tensor, dir: Tensor, tabs: Tables, *, refmax: int,
                     atten: float, unit_d: bool, has_c0: bool,
                     rid: Optional[Tensor] = None,
                     seed: int = sampling.DEFAULT_SEED,
                     refr0: Optional[Tensor] = None,
                     refr_def: Optional[Tensor] = None,
                     record: bool = False):
    """The fused bounce loop in plain PyTorch -> (color [N,3], status [N],
    rec).

    Same contract and expression order as ``trace_core`` in
    ``csrc/trace_fused.cu``. ``rid`` keys the counter RNG (rough scenes);
    ``refr0``/``refr_def`` are the start and empty-space refractive indices
    (transmission scenes). ``record=True`` returns in ``rec`` the winner
    pid per bounce (-1 on a miss or a dead ray) with the ray it was found
    for and whether it was alive: ``{"pid": [refmax, N], "org": [refmax,
    N, 3], "dir": ..., "alive": [refmax, N]}``.
    """
    n = org.shape[0]
    ox, oy, oz = org[:, 0], org[:, 1], org[:, 2]
    dx, dy, dz = dir[:, 0], dir[:, 1], dir[:, 2]
    ones = torch.ones_like(dx)
    cr, cg, cb = ones, ones, ones
    path = torch.zeros_like(dx)
    status = torch.full((n,), _ALIVE, dtype=torch.int32, device=dx.device)
    refr = refr0 * ones if tabs.has_trans else None
    rec = ({"pid": [], "org": [], "dir": [], "alive": []} if record
           else None)

    with torch.no_grad():
        for bounce in range(refmax):
            alive = status == _ALIVE
            t_best, pid = _hit_search(tabs, ox, oy, oz, dx, dy, dz,
                                      has_c0 and bounce == 0, unit_d)
            if record:
                rec["pid"].append(torch.where(alive, pid, -1).to(torch.int32))
                rec["org"].append(torch.stack([ox, oy, oz], dim=1))
                rec["dir"].append(torch.stack([dx, dy, dz], dim=1))
                rec["alive"].append(alive)
            hit = alive & (pid >= 0)
            miss = alive & (pid < 0)
            t_fin = torch.where(t_best < _INF, t_best, 0.0)
            hx, hy, hz = ox + t_fin * dx, oy + t_fin * dy, oz + t_fin * dz
            (wr, wg, wb), mode, rough, (nx, ny, nz) = _winner(
                tabs, pid, ox, oy, oz, dx, dy, dz, hx, hy, hz)

            cr = torch.where(hit, cr * wr, torch.where(miss, cr * tabs.sky[0], cr))
            cg = torch.where(hit, cg * wg, torch.where(miss, cg * tabs.sky[1], cg))
            cb = torch.where(hit, cb * wb, torch.where(miss, cb * tabs.sky[2], cb))
            path = torch.where(hit, path + t_best, path)
            lit = hit & (mode > 1.5) & (mode < 2.5)
            cont_m = hit & (mode > 0.5) & (mode < 1.5)
            cont_t = (hit & (mode > 2.5) if tabs.has_trans
                      else torch.zeros_like(hit))
            keep = hit & ~lit & ~cont_m & ~cont_t
            status = torch.where(lit, _LIGHT, torch.where(
                keep, _KEEP, torch.where(miss, _MISS, status))).to(torch.int32)

            # mirror: reflect, scatter, eps-advance along the NEW direction;
            # TIR below reflects the unscattered direction
            d_dot_n = dx * nx + dy * ny + dz * nz
            rdx = dx - 2.0 * d_dot_n * nx
            rdy = dy - 2.0 * d_dot_n * ny
            rdz = dz - 2.0 * d_dot_n * nz
            if tabs.has_rough:
                sdx, sdy, sdz = sampling.scatter_direction_xyz(
                    seed, rid, bounce, rdx, rdy, rdz, nx, ny, nz, rough)
            else:
                sdx, sdy, sdz = rdx, rdy, rdz
            new_o = [torch.where(cont_m, h + EPS_ADVANCE * s, o)
                     for h, s, o in ((hx, sdx, ox), (hy, sdy, oy),
                                     (hz, sdz, oz))]
            new_d = [torch.where(cont_m, s, d)
                     for s, d in ((sdx, dx), (sdy, dy), (sdz, dz))]
            if tabs.has_trans:
                # eps-advance along the OLD direction, then refract into the
                # innermost containing substance (Snell + TIR)
                ax, ay, az = (hx + EPS_ADVANCE * dx, hy + EPS_ADVANCE * dy,
                              hz + EPS_ADVANCE * dz)
                target, do_refract = _substance(tabs, ax, ay, az, refr,
                                                refr_def)
                eta = refr / torch.clamp(target, min=1e-6)
                c1 = -(dx * nx + dy * ny + dz * nz)
                s2 = eta * eta * (1.0 - c1 * c1)
                inside = torch.clamp(1.0 - s2, min=0.0)
                pos = inside > 0.0
                c2 = torch.where(pos, torch.sqrt(torch.where(pos, inside, 1.0)),
                                 0.0)
                k = eta * c1 - c2
                tir = s2 > 1.0
                tdir = [torch.where(do_refract,
                                    torch.where(tir, r, eta * d + k * nn), d)
                        for r, d, nn in ((rdx, dx, nx), (rdy, dy, ny),
                                         (rdz, dz, nz))]
                new_o = [torch.where(cont_t, a, o)
                         for a, o in zip((ax, ay, az), new_o)]
                new_d = [torch.where(cont_t, t, d)
                         for t, d in zip(tdir, new_d)]
                refr = torch.where(cont_t & do_refract, target, refr)
            ox, oy, oz = new_o
            dx, dy, dz = new_d

    # bounce budget spent -> black; inverse-square law for light hits
    exhausted = status == _ALIVE
    status = torch.where(exhausted, _EXHAUST, status).to(torch.int32)
    pa = path * atten
    isl = 1.0 / (JS_EPSILON + pa * pa)
    lit = status == _LIGHT
    color = torch.stack([torch.where(exhausted, 0.0,
                                     torch.where(lit, c * isl, c))
                         for c in (cr, cg, cb)], dim=1)
    if record:
        rec = {k: torch.stack(v) for k, v in rec.items()}
    return color, status, rec


# ---------------------------------------------------------------------------
# The plain form of the kernels' per-warp sphere cull
# ---------------------------------------------------------------------------

def frame_lanes(w: int, h: int, device=None) -> Tensor:
    """The frame kernel's warps -> [h * ceil(w / 32) * 32] i64: lane l of
    warp k (pixels x = 32 (k mod ceil(w / 32)) + l of row k div ceil(w /
    32)) holds its pixel's ray index y * w + x, or -1 past the image's
    right edge."""
    wp = -(-w // WARP) * WARP
    x = torch.arange(wp, device=device)
    y = torch.arange(h, device=device)
    return torch.where(x[None, :] < w, y[:, None] * w + x[None, :],
                       -1).reshape(-1)


def ray_lanes(n: int, device=None) -> Tensor:
    """The wavefront kernel's warps (32 consecutive rays) -> [ceil(n / 32)
    * 32] i64: each lane's ray index, or -1 past the last ray."""
    i = torch.arange(-(-n // WARP) * WARP, device=device)
    return torch.where(i < n, i, -1)


def fused_cull(tabs: Tables, org: Tensor, dir: Tensor, alive: Tensor,
               lanes: Tensor, group: int = WARP) -> Tensor:
    """The spheres each group of lanes keeps -> include [G, S] bool, G =
    lanes / group: the ball-cone (:func:`nearest_hit.cone_include`) of the
    group's live rays (``alive`` [N] at a lane holding a ray) against each
    sphere's ball (``tabs.balls``). With the kernels' lanes and ``group``
    32, the spheres each warp tests; with ``lanes`` = every ray and
    ``group`` 1, those each ray alone can reach (the need). A sphere left
    out misses every live ray of its group."""
    idx = lanes.clamp(min=0)
    live = alive[idx] & (lanes >= 0)
    return nh.cone_include(org[idx], dir[idx], live, tabs.balls,
                           group)[:lanes.shape[0] // group]


def cull_counts(tabs: Tables, rec: dict, lanes: Tensor,
                group: int = WARP) -> Tensor:
    """The spheres each group tests at each bounce of a recorded trace
    (``rec`` from ``trace_core_plain(record=True)``) -> [refmax, G] i32: its
    :func:`fused_cull` count, or 0 for a group with no live ray (the
    kernels' warp skips the bounce). With the kernels' lanes, their
    ``work``."""
    out = []
    for b in range(rec["pid"].shape[0]):
        alive = rec["alive"][b]
        inc = fused_cull(tabs, rec["org"][b], rec["dir"][b], alive, lanes,
                         group)
        live = (alive[lanes.clamp(min=0)] & (lanes >= 0)).reshape(
            -1, group).any(dim=1)
        out.append(torch.where(live, inc.sum(dim=1), 0))
    return torch.stack(out).to(torch.int32)


# ---------------------------------------------------------------------------
# Entries: plain versions, CUDA launches, and the dispatching wrappers
# ---------------------------------------------------------------------------

def _refr_args(scene: Scene, start_refr) -> Tuple[Tensor, Tensor]:
    """(start substance index, the scene's default) as f32 scalars on the
    scene's device; a Python number becomes a fill on the device, not a
    copy from the host."""
    f32 = torch.float32
    if start_refr is None:
        refr0 = scene.default_refr
    elif isinstance(start_refr, torch.Tensor):
        refr0 = start_refr.to(device=scene.device, dtype=f32)
    else:
        refr0 = torch.full((), float(start_refr), dtype=f32,
                           device=scene.device)
    return refr0.reshape(()), scene.default_refr.reshape(())


def _frame_rid(cam: Camera, spp: int, sample: int) -> Tensor:
    return (torch.arange(cam.h * cam.w, dtype=torch.int32, device=cam.device)
            * spp + sample)


def trace_frame_fused_plain(scene: Scene, cfg: RenderConfig, cam: Camera,
                            seed: Optional[int] = None, sample: int = 0,
                            start_refr=None, record: bool = False,
                            work: bool = False):
    """Plain version of the frame kernel -> (image [h, w, 3], status [h, w],
    rec) (+ the spheres each warp tests at each bounce, :func:`cull_counts`
    [refmax, h * ceil(w / 32)], when ``work``): :func:`pixel_rays` plus the
    core with ``unit_d`` and ``has_c0``."""
    org, dir = pixel_rays(cam)
    refr0, refr_def = _refr_args(scene, start_refr)
    tabs = pack_tables(scene, cam_pos=cam.pos)
    color, status, rec = trace_core_plain(
        org, dir, tabs, refmax=int(cfg.refmax),
        atten=float(cfg.distance_attenuation_factor), unit_d=True,
        has_c0=True, rid=_frame_rid(cam, cfg.spp, sample),
        seed=sampling.DEFAULT_SEED if seed is None else seed, refr0=refr0,
        refr_def=refr_def, record=record or work)
    out = (color.reshape(cam.h, cam.w, 3), status.reshape(cam.h, cam.w),
           rec if record else None)
    if work:
        out += (cull_counts(tabs, rec, frame_lanes(cam.w, cam.h,
                                                   org.device)),)
    return out


def trace_rays_fused_plain(scene: Scene, cfg: RenderConfig, org: Tensor,
                           dir: Tensor, seed: Optional[int] = None,
                           ray_id: Optional[Tensor] = None, start_refr=None,
                           record: bool = False, work: bool = False):
    """Plain version of the wavefront kernel -> (color [N, 3], status [N],
    rec) (+ the spheres each warp tests at each bounce [refmax, ceil(N /
    32)], when ``work``): the core with general |d|."""
    if ray_id is None:
        ray_id = torch.arange(org.shape[0], dtype=torch.int32,
                              device=org.device)
    refr0, refr_def = _refr_args(scene, start_refr)
    tabs = pack_tables(scene)
    color, status, rec = trace_core_plain(
        org, dir, tabs, refmax=int(cfg.refmax),
        atten=float(cfg.distance_attenuation_factor), unit_d=False,
        has_c0=False, rid=ray_id,
        seed=sampling.DEFAULT_SEED if seed is None else seed, refr0=refr0,
        refr_def=refr_def, record=record or work)
    out = (color, status, rec if record else None)
    if work:
        out += (cull_counts(tabs, rec, ray_lanes(org.shape[0], org.device)),)
    return out


def _table_args(tabs: Tables, dev) -> list:
    f32 = torch.float32
    _need(tabs.sph, "sphere table", f32, (13, tabs.n_sph), dev)
    _need(tabs.box, "box table", f32, (13, tabs.n_box), dev)
    _need(tabs.tri, "triangle table", f32, (17, tabs.n_tri), dev)
    _need(tabs.sky, "sky", f32, (3,), dev)
    _need(tabs.sph4, "sphere search rows", f32, (tabs.n_sph, 4), dev)
    _need(tabs.balls, "sphere balls", f32, (tabs.n_sph, 4), dev)
    return [_ptr(tabs.sph), tabs.n_sph, _ptr(tabs.box), tabs.n_box,
            _ptr(tabs.tri), tabs.n_tri, _ptr(tabs.sky), _ptr(tabs.sph4),
            _ptr(tabs.balls)]


def _outputs(n: int, refmax: int, n_warps: int, record: bool, work: bool,
             dev):
    i32 = torch.int32
    return (torch.empty((n, 3), dtype=torch.float32, device=dev),
            torch.empty((n,), dtype=i32, device=dev),
            torch.empty((refmax, n), dtype=i32, device=dev) if record
            else None,
            torch.empty((refmax, n_warps), dtype=i32, device=dev) if work
            else None)


def _results(color, status, rec_pid, work_t, work: bool):
    out = (color, status, {"pid": rec_pid} if rec_pid is not None else None)
    return out + (work_t,) if work else out


def camera_args(cam: Camera) -> list:
    """The frame kernel's camera arguments: the pose tensors pos, front,
    left, up ([3] f32 on the camera's device, passed by pointer), then
    ``angle_steps`` (step_h, step_v as f32 values, off_h, off_v), all host
    values: no copy and no wait."""
    pose = [t.to(torch.float32).contiguous()
            for t in (cam.pos, cam.front, cam.left, cam.up)]
    for name, t in zip(("pos", "front", "left", "up"), pose):
        _need(t, f"camera {name}", torch.float32, (3,), cam.device)
    return [*pose, *angle_steps(cam)]


def launch_frame(tabs: Tables, cam: Camera, refr0: Tensor, refr_def: Tensor,
                 *, refmax: int, atten: float, seed: int, spp: int,
                 sample: int, record: bool = False, work: bool = False):
    """Launch the frame kernel (B1) on the current stream -> (image
    [h, w, 3], status [h, w], rec) with ``rec = {"pid": [refmax, h*w]}``
    when ``record`` (+ ``work`` [refmax, h * ceil(w / 32)] i32, the spheres
    each warp tested at each bounce, when ``work``). ``refr0`` and
    ``refr_def`` are f32 scalars on the card. Does not synchronize: the
    inputs were allocated on this stream, so the caching allocator reuses
    their memory only for work ordered after the kernel."""
    dev = cam.device
    if dev.type != "cuda":
        raise ValueError(f"the frame kernel needs CUDA tensors, got {dev}")
    lib = _build.load()
    args = _table_args(tabs, dev)
    _need(refr0, "start substance index", torch.float32, (), dev)
    _need(refr_def, "default substance index", torch.float32, (), dev)
    pose_steps = camera_args(cam)
    w, h = cam.w, cam.h
    n_warps = h * -(-w // WARP)
    color, status, rec_pid, work_t = _outputs(w * h, refmax, n_warps,
                                              record, work, dev)
    err = lib.rt_trace_frame(
        *args, _ptr(refr0), _ptr(refr_def),
        *(_ptr(t) for t in pose_steps[:4]), *pose_steps[4:], w, h, refmax,
        atten, int(tabs.has_rough), int(tabs.has_trans), seed & 0xFFFFFFFF,
        spp, sample, _ptr(color), _ptr(status), _ptr(rec_pid), _ptr(work_t),
        dev.index, _stream(dev))
    _build.check(lib, err, "trace_frame_kernel")
    LAUNCHES["frame"] += 1
    return _results(color.reshape(h, w, 3), status.reshape(h, w), rec_pid,
                    work_t, work)


def launch_rays(tabs: Tables, refr0: Tensor, refr_def: Tensor, org: Tensor,
                dir: Tensor, rid: Tensor, *, refmax: int, atten: float,
                seed: int, record: bool = False, work: bool = False):
    """Launch the wavefront kernel (B2) on the current stream -> (color
    [N, 3], status [N], rec) (+ ``work`` [refmax, ceil(N / 32)] i32 when
    ``work``). Does not synchronize."""
    dev = org.device
    if dev.type != "cuda":
        raise ValueError(f"the wavefront kernel needs CUDA tensors, got {dev}")
    lib = _build.load()
    args = _table_args(tabs, dev)
    n = org.shape[0]
    _need(refr0, "start substance index", torch.float32, (), dev)
    _need(refr_def, "default substance index", torch.float32, (), dev)
    _need(org, "org", torch.float32, (n, 3), dev)
    _need(dir, "dir", torch.float32, (n, 3), dev)
    _need(rid, "ray ids", torch.int32, (n,), dev)
    color, status, rec_pid, work_t = _outputs(n, refmax, -(-n // WARP),
                                              record, work, dev)
    err = lib.rt_trace_rays(
        *args, _ptr(refr0), _ptr(refr_def), _ptr(org), _ptr(dir), _ptr(rid),
        n, refmax, atten, int(tabs.has_rough), int(tabs.has_trans),
        seed & 0xFFFFFFFF, _ptr(color), _ptr(status), _ptr(rec_pid),
        _ptr(work_t), dev.index, _stream(dev))
    _build.check(lib, err, "trace_rays_kernel")
    LAUNCHES["rays"] += 1
    return _results(color, status, rec_pid, work_t, work)


def trace_frame_fused_cuda(scene: Scene, cfg: RenderConfig, cam: Camera,
                           seed: Optional[int] = None, sample: int = 0,
                           start_refr=None, record: bool = False,
                           work: bool = False):
    """The frame kernel on the scene's CUDA device -> (image, status, rec)
    (+ work): :func:`scene_tables`, the camera by pointer and value, one
    launch."""
    if cam.device != scene.device:
        raise ValueError(f"camera on {cam.device}, scene on {scene.device}")
    return launch_frame(
        scene_tables(scene), cam, *_refr_args(scene, start_refr),
        refmax=int(cfg.refmax), atten=float(cfg.distance_attenuation_factor),
        seed=sampling.DEFAULT_SEED if seed is None else seed,
        spp=int(cfg.spp), sample=int(sample), record=record, work=work)


def trace_rays_fused_cuda(scene: Scene, cfg: RenderConfig, org: Tensor,
                          dir: Tensor, seed: Optional[int] = None,
                          ray_id: Optional[Tensor] = None, start_refr=None,
                          record: bool = False, work: bool = False):
    """The wavefront kernel on the scene's CUDA device -> (color, status,
    rec) (+ work)."""
    if ray_id is None:
        ray_id = torch.arange(org.shape[0], dtype=torch.int32,
                              device=org.device)
    return launch_rays(
        scene_tables(scene), *_refr_args(scene, start_refr), org, dir,
        ray_id.to(torch.int32), refmax=int(cfg.refmax),
        atten=float(cfg.distance_attenuation_factor),
        seed=sampling.DEFAULT_SEED if seed is None else seed, record=record,
        work=work)


def trace_frame_fused(scene: Scene, cfg: RenderConfig, cam: Camera,
                      seed: Optional[int] = None, sample: int = 0,
                      start_refr=None) -> Tensor:
    """Whole-frame fused trace with in-kernel ray generation -> [h, w, 3].

    Caller must check :func:`supports_frame`. CUDA scenes launch the frame
    kernel; CPU scenes run :func:`trace_frame_fused_plain`.
    """
    run = (trace_frame_fused_plain if _on_cpu(scene.device)
           else trace_frame_fused_cuda)
    with span("rt.fused.frame"):
        return run(scene, cfg, cam, seed=seed, sample=sample,
                   start_refr=start_refr)[0]


def trace_rays_fused(scene: Scene, cfg: RenderConfig, org: Tensor,
                     dir: Tensor, seed: Optional[int] = None,
                     ray_id: Optional[Tensor] = None,
                     start_refr=None) -> Tuple[Tensor, Tensor]:
    """Fused trace of a ray wavefront -> (color [N, 3], status [N]).

    Caller must check :func:`supports`. CUDA tensors launch the wavefront
    kernel; CPU tensors run :func:`trace_rays_fused_plain`.
    """
    run = (trace_rays_fused_plain if _on_cpu(org.device)
           else trace_rays_fused_cuda)
    color, status, _ = run(scene, cfg, org, dir, seed=seed, ray_id=ray_id,
                           start_refr=start_refr)
    return color, status
