"""Path-replay forward and backward kernels (B5) and their plain versions.

Port of ``raytracer_js_tpu.kernels.replay_grad``. The inverse-rendering
step differentiates the search-free replay (``ops/trace.trace_rays`` with
``pid_seq``): per bounce one row lookup, the analytic surface recompute and
the color products, whose cotangent is closed-form. :func:`replay_colors`
is a ``torch.autograd.Function`` over two CUDA kernels
(``csrc/replay_grad.cu``):

- ``replay_fwd_kernel`` — one thread per ray replays the bounce chain from
  the supplied winners, reading the sphere and box rows by index;
- ``replay_bwd_kernel`` — re-runs the forward in registers, then walks the
  hand-derived reverse of each bounce backwards (the reference's
  ``_reverse_bounce``): per-ray cotangents of origin and direction (the
  camera-pose gradient) and per-primitive cotangents (center, radius or
  half size, rgb) plus the sky's.

The class is the reference's: solid textures and sky, REFLECTION only, no
roughness, transmission or triangles, ``spp == 1``, ``refmax <= 4``
(:func:`supports`: at most 192 prims; :func:`supports_listed`: up to 16384
spheres). One kernel serves both classes, since a thread indexes its prim
directly; the reference's per-tile id lists (``build_tile_lists``) only
shortened its pid-match scans and are not ported. So the port's fit takes
it on a wider class of its own, :func:`supports_fit`: the listed class
with no cap on the sphere count (BASELINE config 5's 1M spheres).

Each kernel has a plain PyTorch version (:func:`replay_fwd_plain`,
:func:`replay_bwd_plain`) with the kernel's expressions in the kernel's
order: the colors and the per-ray cotangents match the kernels bit for
bit. The per-primitive sums are reductions in another order; the plain
version accumulates them in float64. A wrapper takes the plain version
only for CPU tensors; for CUDA tensors it launches the kernel or raises.
``LAUNCHES`` counts launches.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..config import EPS_ADVANCE, JS_EPSILON, RayStatus, RenderConfig, ResponseType
from ..models.scene import Scene
from ..ops.intersect import SLAB_DIR_EPS as _SLAB_EPS, safe_inv as _safe_inv
from . import _build

Tensor = torch.Tensor

#: kernel launches since the last reset (the plain versions do not count)
LAUNCHES = {"fwd": 0, "bwd": 0}

#: prim-count ceiling of :func:`supports` (the reference's pick/scatter
#: scans); here the backward keeps every prim's cotangent sums in shared
#: memory up to this count
SCAN_MAX_PRIMS = 192
#: sphere-count ceiling of :func:`supports_listed`
LISTED_MAX_SPHERES = 16384
#: cotangent slots per primitive: center (3), radius or half size (3; a
#: sphere uses the first), rgb (3)
N_SLOT = 9
#: the slots a sphere reports: center, radius, rgb
SPHERE_SLOTS = (0, 1, 2, 3, 6, 7, 8)
#: threads per block of the backward kernel (kBlock in csrc/replay_grad.cu):
#: its resident blocks (:func:`bwd_grid`) loop over ray groups of this
#: many, each writes one partial row of per-prim sums
BWD_BLOCK = 128

_ALIVE = int(RayStatus.ALIVE)
_LIGHT = int(RayStatus.LIGHT)
_KEEP = int(RayStatus.KEEP)
_MISS = int(RayStatus.MISS)


def supports(scene: Scene, cfg: RenderConfig) -> bool:
    """The reference's eligibility: the fused class minus the search
    (solid textures and sky, REFLECTION only), spheres and boxes, at most
    ``SCAN_MAX_PRIMS`` prims, ``refmax <= 4``, one sample."""
    return (not scene.textures.has_images and scene.sky_box is None
            and not scene.has_rough and not scene.has_transmission
            and scene.n_tris == 0 and 0 < scene.n_prims <= SCAN_MAX_PRIMS
            and cfg.refmax <= 4 and cfg.spp == 1)


def supports_listed(scene: Scene, cfg: RenderConfig) -> bool:
    """The reference's listed class: the same, with up to
    ``LISTED_MAX_SPHERES`` spheres and ``SCAN_MAX_PRIMS`` boxes."""
    return (not scene.textures.has_images and scene.sky_box is None
            and not scene.has_rough and not scene.has_transmission
            and scene.n_tris == 0 and 0 < scene.n_prims
            and scene.n_spheres <= LISTED_MAX_SPHERES
            and scene.n_boxes <= SCAN_MAX_PRIMS
            and cfg.refmax <= 4 and cfg.spp == 1)


def supports_fit(scene: Scene, cfg: RenderConfig) -> bool:
    """The port's class for the fit's replay: :func:`supports_listed`
    without its cap on spheres (above ``SCAN_MAX_PRIMS`` prims the
    backward sums sphere cotangents with global atomics whatever their
    count); at most ``SCAN_MAX_PRIMS`` boxes."""
    return (not scene.textures.has_images and scene.sky_box is None
            and not scene.has_rough and not scene.has_transmission
            and scene.n_tris == 0 and 0 < scene.n_prims
            and scene.n_boxes <= SCAN_MAX_PRIMS
            and cfg.refmax <= 4 and cfg.spp == 1)


@dataclasses.dataclass(frozen=True)
class ReplayTables:
    """Row-major prim tables, f32, at least one row each (a kernel never
    gets a null pointer): spheres ``cx cy cz r tr tg tb mode`` [S, 8],
    boxes ``cx cy cz hx hy hz tr tg tb mode`` [B, 10], sky rgb [3]. ``mode``
    is 2 * light + continues (a non-emissive mirror REFLECTION)."""

    sph: Tensor
    box: Tensor
    sky: Tensor
    n_sph: int
    n_box: int

    @property
    def n_prims(self) -> int:
        return self.n_sph + self.n_box


def prim_modes(scene: Scene) -> Tensor:
    """[P] f32 mode per prim: 2 for an emitter, 1 for a mirror REFLECTION
    that continues, 0 for a surface that keeps its color."""
    mat = scene.materials
    pm = scene.prim_material.long()
    light = mat.light.index_select(0, pm)
    cont = (mat.mirror.index_select(0, pm)
            & (mat.response.index_select(0, pm)
               == int(ResponseType.REFLECTION)) & ~light)
    return 2.0 * light.to(torch.float32) + cont.to(torch.float32)


def _inputs(scene: Scene):
    """The replay's table inputs: sphere center, radius, rgb; box center,
    half size, rgb; sky rgb; mode per prim. The colors are gathered from
    ``textures.solid_rgb`` by autograd's index gather."""
    s = scene.n_spheres
    rgb = scene.textures.solid_rgb
    prim_rgb = rgb.index_select(0, scene.prim_texture.long())
    return (scene.sphere_center, scene.sphere_radius, prim_rgb[:s],
            scene.box_center, scene.box_half, prim_rgb[s:],
            rgb[scene.sky_tex], prim_modes(scene))


def scene_tables(scene: Scene) -> ReplayTables:
    """The scene's replay tables, detached from any graph."""
    with torch.no_grad():
        return pack_tables(*_inputs(scene))


def pack_tables(sph_c, sph_r, sph_rgb, box_c, box_h, box_rgb, sky_rgb,
                mode) -> ReplayTables:
    n_s, n_b = sph_c.shape[0], box_c.shape[0]

    def table(cols, n, width):
        if n == 0:
            return torch.zeros((1, width), dtype=torch.float32,
                               device=sky_rgb.device)
        return torch.cat(cols, dim=1).to(torch.float32).contiguous()

    return ReplayTables(
        sph=table([sph_c, sph_r[:, None], sph_rgb, mode[:n_s, None]], n_s,
                  8),
        box=table([box_c, box_h, box_rgb, mode[n_s:, None]], n_b, 10),
        sky=sky_rgb.to(torch.float32).contiguous(), n_sph=n_s, n_box=n_b)


# ---------------------------------------------------------------------------
# The plain versions
# ---------------------------------------------------------------------------

def _mask(b: Tensor) -> Tensor:
    return torch.where(b, 1.0, 0.0)


def _sphere_fwd(ox, oy, oz, dx, dy, dz, cx, cy, cz, r) -> dict:
    """The reference kernel's sphere surface (plane form, ``inv_a = 1/a``),
    with every intermediate the reverse reuses."""
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    bh = ocx * dx + ocy * dy + ocz * dz
    a = dx * dx + dy * dy + dz * dz
    c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = bh * bh - a * c
    pos = disc > 0.0
    sq_inner = torch.sqrt(torch.where(pos, disc, 1.0))
    sq = sq_inner * _mask(pos)
    inv_a = 1.0 / a
    t_near = (-bh - sq) * inv_a
    t_far = (-bh + sq) * inv_a
    near_fwd = t_near >= 0.0
    t = torch.where(near_fwd, t_near, t_far)
    px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz
    r_guard = r.abs() < 1e-12
    inv_rs = 1.0 / torch.where(r_guard, 1e-12, r)
    n0x, n0y, n0z = (px - cx) * inv_rs, (py - cy) * inv_rs, (pz - cz) * inv_rs
    fs = torch.where(dx * n0x + dy * n0y + dz * n0z > 0.0, -1.0, 1.0)
    return dict(ocx=ocx, ocy=ocy, ocz=ocz, bh=bh, a=a, c=c, posf=_mask(pos),
                sq_inner=sq_inner, inv_a=inv_a, t_near=t_near, t_far=t_far,
                nf=_mask(near_fwd), t=t, r_okf=_mask(~r_guard),
                inv_rs=inv_rs, fs=fs, nx=n0x * fs, ny=n0y * fs, nz=n0z * fs)


def _box_fwd(ox, oy, oz, dx, dy, dz, cx, cy, cz, hx, hy, hz) -> dict:
    """The slab test with its selection masks: the lo slab wins a tie in
    t, the winning axis a tie in x > y > z order; the normal is the winning
    axis signed against the ray (a zero component counts as positive)."""
    ivx, ivy, ivz = _safe_inv(dx), _safe_inv(dy), _safe_inv(dz)
    tax, tbx = (cx - hx - ox) * ivx, (cx + hx - ox) * ivx
    tay, tby = (cy - hy - oy) * ivy, (cy + hy - oy) * ivy
    taz, tbz = (cz - hz - oz) * ivz, (cz + hz - oz) * ivz
    lo_x, lo_y, lo_z = tax <= tbx, tay <= tby, taz <= tbz
    t0x = torch.where(lo_x, tax, tbx)
    t0y = torch.where(lo_y, tay, tby)
    t0z = torch.where(lo_z, taz, tbz)
    t1x = torch.where(lo_x, tbx, tax)
    t1y = torch.where(lo_y, tby, tay)
    t1z = torch.where(lo_z, tbz, taz)
    t_enter = torch.maximum(torch.maximum(t0x, t0y), t0z)
    t_exit = torch.minimum(torch.minimum(t1x, t1y), t1z)
    entering = t_enter >= 0.0
    t = torch.where(entering, t_enter, t_exit)
    ne = ~entering
    wex = t0x == t_enter
    wey = (t0y == t_enter) & ~wex
    wxx = t1x == t_exit
    wxy = (t1y == t_exit) & ~wxx
    wx = (entering & wex) | (ne & wxx)
    wy = (entering & wey) | (ne & wxy)
    wz = ~wx & ~wy
    wxf, wyf, wzf = _mask(wx), _mask(wy), _mask(wz)

    def sgn(lo):   # -1 where the winning value came from the lo slab
        return torch.where((entering & lo) | (ne & ~lo), -1.0, 1.0)

    return dict(ivx=ivx, ivy=ivy, ivz=ivz, t=t, wxf=wxf, wyf=wyf, wzf=wzf,
                sgn_x=sgn(lo_x), sgn_y=sgn(lo_y), sgn_z=sgn(lo_z),
                dokf_x=_mask(dx.abs() >= _SLAB_EPS),
                dokf_y=_mask(dy.abs() >= _SLAB_EPS),
                dokf_z=_mask(dz.abs() >= _SLAB_EPS),
                nx=wxf * torch.where(dx < 0.0, 1.0, -1.0),
                ny=wyf * torch.where(dy < 0.0, 1.0, -1.0),
                nz=wzf * torch.where(dz < 0.0, 1.0, -1.0))


def _rows(tabs: ReplayTables, pid: Tensor):
    """Per-ray prim attributes by direct index -> (is_s, pidc, sphere row
    [N, 8], box row [N, 10])."""
    pidc = torch.clamp(pid.long(), 0, tabs.n_prims - 1)
    is_s = pidc < tabs.n_sph
    srow = tabs.sph.index_select(
        0, torch.clamp(pidc, 0, tabs.sph.shape[0] - 1))
    brow = tabs.box.index_select(
        0, torch.clamp(pidc - tabs.n_sph, 0, tabs.box.shape[0] - 1))
    return is_s, pidc, srow, brow


def _bounce_fwd(tabs: ReplayTables, st: dict, pid: Tensor) -> dict:
    """One replayed bounce from state ``st`` (o, d, col, path, status);
    returns the next state and the bounce's intermediates."""
    ox, oy, oz = st["o"]
    dx, dy, dz = st["d"]
    col_r, col_g, col_b = st["col"]
    alive = st["status"] == _ALIVE
    hit = alive & (pid >= 0)
    miss = alive & (pid < 0)
    is_s, pidc, srow, brow = _rows(tabs, pid)
    sf = _sphere_fwd(ox, oy, oz, dx, dy, dz, srow[:, 0], srow[:, 1],
                     srow[:, 2], srow[:, 3])
    bf = _box_fwd(ox, oy, oz, dx, dy, dz, *(brow[:, k] for k in range(6)))
    tr = torch.where(is_s, srow[:, 4], brow[:, 6])
    tg = torch.where(is_s, srow[:, 5], brow[:, 7])
    tb = torch.where(is_s, srow[:, 6], brow[:, 8])
    mode = torch.where(is_s, srow[:, 7], brow[:, 9])
    t = torch.where(is_s, sf["t"], bf["t"])
    nx = torch.where(is_s, sf["nx"], bf["nx"])
    ny = torch.where(is_s, sf["ny"], bf["ny"])
    nz = torch.where(is_s, sf["nz"], bf["nz"])
    px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz
    lit = hit & (mode > 1.5)
    cont = hit & (mode > 0.5) & (mode < 1.5)
    keep = hit & ~lit & ~cont

    sky = tabs.sky
    mcol_r = torch.where(hit, col_r * tr, col_r)
    mcol_g = torch.where(hit, col_g * tg, col_g)
    mcol_b = torch.where(hit, col_b * tb, col_b)
    ncol = (torch.where(miss, mcol_r * sky[0], mcol_r),
            torch.where(miss, mcol_g * sky[1], mcol_g),
            torch.where(miss, mcol_b * sky[2], mcol_b))
    status = torch.where(lit, _LIGHT, torch.where(
        keep, _KEEP, torch.where(miss, _MISS, st["status"])))

    d_dot_n = dx * nx + dy * ny + dz * nz
    rdx = dx - 2.0 * d_dot_n * nx
    rdy = dy - 2.0 * d_dot_n * ny
    rdz = dz - 2.0 * d_dot_n * nz
    nxt = dict(
        o=(torch.where(cont, px + EPS_ADVANCE * rdx, ox),
           torch.where(cont, py + EPS_ADVANCE * rdy, oy),
           torch.where(cont, pz + EPS_ADVANCE * rdz, oz)),
        d=(torch.where(cont, rdx, dx), torch.where(cont, rdy, dy),
           torch.where(cont, rdz, dz)),
        col=ncol, path=torch.where(hit, st["path"] + t, st["path"]),
        status=status)
    saves = dict(d=st["d"], col=st["col"], hit=hit,
                 miss=miss, cont=cont, is_s=is_s, pidc=pidc, t=t,
                 p=(px, py, pz), n=(nx, ny, nz), d_dot_n=d_dot_n,
                 c=(srow[:, 0], srow[:, 1], srow[:, 2]), r=srow[:, 3],
                 rgb=(tr, tg, tb), sf=sf, bf=bf)
    return nxt, saves


def _forward(tabs: ReplayTables, org: Tensor, dir: Tensor, pid_seq: Tensor,
             refmax: int, atten: float):
    n = org.shape[0]
    ones = torch.ones((n,), dtype=torch.float32, device=org.device)
    st = dict(o=(org[:, 0], org[:, 1], org[:, 2]),
              d=(dir[:, 0], dir[:, 1], dir[:, 2]), col=(ones, ones, ones),
              path=torch.zeros_like(ones),
              status=torch.full((n,), _ALIVE, dtype=torch.int32,
                                device=org.device))
    saves = []
    for b in range(refmax):
        st, sv = _bounce_fwd(tabs, st, pid_seq[:, b])
        saves.append(sv)
    exhausted = st["status"] == _ALIVE
    pre = tuple(torch.where(exhausted, 0.0, c) for c in st["col"])
    pa = st["path"] * atten
    isl = 1.0 / (JS_EPSILON + pa * pa)
    lit_fin = st["status"] == _LIGHT
    out = torch.stack([torch.where(lit_fin, c * isl, c) for c in pre], dim=1)
    fin = dict(exhausted=exhausted, lit_fin=lit_fin, isl=isl,
               path=st["path"], pre=pre)
    return out, saves, fin


def replay_fwd_plain(tabs: ReplayTables, org: Tensor, dir: Tensor,
                     pid_seq: Tensor, refmax: int, atten: float) -> Tensor:
    """Plain version of ``replay_fwd_kernel`` -> color [N, 3]."""
    return _forward(tabs, org, dir, pid_seq, refmax, atten)[0]


def _reverse_sphere(s: dict, g_o, g_d, g_t, g_n):
    """The sphere surface's reverse on every lane -> (g_o, g_d, row)."""
    sf = s["sf"]
    dxb, dyb, dzb = s["d"]
    t = s["t"]
    fs, inv_rs = sf["fs"], sf["inv_rs"]
    g_n0x, g_n0y, g_n0z = fs * g_n[0], fs * g_n[1], fs * g_n[2]
    g_psx, g_psy, g_psz = g_n0x * inv_rs, g_n0y * inv_rs, g_n0z * inv_rs
    g_scx, g_scy, g_scz = -g_psx, -g_psy, -g_psz
    px, py, pz = s["p"]
    ax, ay, az = s["c"]
    pmcx, pmcy, pmcz = px - ax, py - ay, pz - az
    g_sr = (-sf["r_okf"] * (g_n0x * pmcx + g_n0y * pmcy + g_n0z * pmcz)
            * inv_rs * inv_rs)
    g_ox, g_oy, g_oz = g_o[0] + g_psx, g_o[1] + g_psy, g_o[2] + g_psz
    g_dx, g_dy, g_dz = (g_d[0] + t * g_psx, g_d[1] + t * g_psy,
                        g_d[2] + t * g_psz)
    g_ts = g_t + g_psx * dxb + g_psy * dyb + g_psz * dzb
    nf = sf["nf"]
    g_tn = nf * g_ts
    g_tf = (1.0 - nf) * g_ts
    inv_a = sf["inv_a"]
    g_bh = -(g_tn + g_tf) * inv_a
    g_sq = (g_tf - g_tn) * inv_a
    g_a = -(sf["t_near"] * g_tn + sf["t_far"] * g_tf) * inv_a
    g_disc = sf["posf"] * g_sq * 0.5 / sf["sq_inner"]
    g_bh = g_bh + 2.0 * sf["bh"] * g_disc
    g_a = g_a - sf["c"] * g_disc
    g_cq = -sf["a"] * g_disc
    g_ocx = 2.0 * g_cq * sf["ocx"]
    g_ocy = 2.0 * g_cq * sf["ocy"]
    g_ocz = 2.0 * g_cq * sf["ocz"]
    g_sr = g_sr - 2.0 * s["r"] * g_cq
    g_dx = g_dx + 2.0 * g_a * dxb
    g_dy = g_dy + 2.0 * g_a * dyb
    g_dz = g_dz + 2.0 * g_a * dzb
    g_ocx = g_ocx + g_bh * dxb
    g_ocy = g_ocy + g_bh * dyb
    g_ocz = g_ocz + g_bh * dzb
    g_dx = g_dx + g_bh * sf["ocx"]
    g_dy = g_dy + g_bh * sf["ocy"]
    g_dz = g_dz + g_bh * sf["ocz"]
    g_ox, g_oy, g_oz = g_ox + g_ocx, g_oy + g_ocy, g_oz + g_ocz
    g_scx, g_scy, g_scz = g_scx - g_ocx, g_scy - g_ocy, g_scz - g_ocz
    zero = torch.zeros_like(g_sr)
    return ((g_ox, g_oy, g_oz), (g_dx, g_dy, g_dz),
            (g_scx, g_scy, g_scz, g_sr, zero, zero))


def _reverse_box(s: dict, g_o, g_d, g_t):
    """The slab test's reverse on every lane (the face normal is piecewise
    constant) -> (g_o, g_d, row)."""
    bf = s["bf"]
    gw = (g_t * bf["wxf"], g_t * bf["wyf"], g_t * bf["wzf"])
    iv = (bf["ivx"], bf["ivy"], bf["ivz"])
    sgn = (bf["sgn_x"], bf["sgn_y"], bf["sgn_z"])
    dok = (bf["dokf_x"], bf["dokf_y"], bf["dokf_z"])
    t = bf["t"]
    g_bc = tuple(w * i for w, i in zip(gw, iv))
    g_bh = tuple(w * i * sg for w, i, sg in zip(gw, iv, sgn))
    g_o = tuple(go - w * i for go, w, i in zip(g_o, gw, iv))
    g_d = tuple(gd - ok * w * i * t for gd, ok, w, i in zip(g_d, dok, gw, iv))
    return g_o, g_d, g_bc + g_bh


def _reverse_bounce(s: dict, sky: Tensor, g_o, g_d, g_c, g_path):
    """The reverse of one replayed bounce -> (g_o, g_d, g_c, row [N, 9],
    g_sky [N, 3]); a lane that was not alive is passed through, a miss
    only feeds the sky."""
    hit, miss, cont = s["hit"], s["miss"], s["cont"]
    col_r, col_g, col_b = s["col"]
    tr, tg, tb = s["rgb"]
    # miss: color_out = col * sky
    g_sky = torch.stack([torch.where(miss, g_c[0] * col_r, 0.0),
                         torch.where(miss, g_c[1] * col_g, 0.0),
                         torch.where(miss, g_c[2] * col_b, 0.0)], dim=1)
    # hit: color_out = col * rgb
    g_rgb = (g_c[0] * col_r, g_c[1] * col_g, g_c[2] * col_b)
    g_c_hit = (g_c[0] * tr, g_c[1] * tg, g_c[2] * tb)
    g_c_miss = (g_c[0] * sky[0], g_c[1] * sky[1], g_c[2] * sky[2])
    g_t = g_path
    # continuation: org' = point + EPS * refl, dir' = refl
    g_px = tuple(torch.where(cont, go, 0.0) for go in g_o)
    g_rd = tuple(torch.where(cont, EPS_ADVANCE * go + gd, 0.0)
                 for go, gd in zip(g_o, g_d))
    g_oh = tuple(torch.where(cont, 0.0, go) for go in g_o)
    g_dh = tuple(torch.where(cont, 0.0, gd) for gd in g_d)
    # refl = d - 2 (d.n) n
    dxb, dyb, dzb = s["d"]
    nx, ny, nz = s["n"]
    n_dot_gr = nx * g_rd[0] + ny * g_rd[1] + nz * g_rd[2]
    g_dh = (g_dh[0] + g_rd[0] - 2.0 * nx * n_dot_gr,
            g_dh[1] + g_rd[1] - 2.0 * ny * n_dot_gr,
            g_dh[2] + g_rd[2] - 2.0 * nz * n_dot_gr)
    ddn = s["d_dot_n"]
    g_n = (-2.0 * (ddn * g_rd[0] + n_dot_gr * dxb),
           -2.0 * (ddn * g_rd[1] + n_dot_gr * dyb),
           -2.0 * (ddn * g_rd[2] + n_dot_gr * dzb))
    # point = o + t d
    t = s["t"]
    g_oh = tuple(go + gp for go, gp in zip(g_oh, g_px))
    g_dh = tuple(gd + t * gp for gd, gp in zip(g_dh, g_px))
    g_t = g_t + g_px[0] * dxb + g_px[1] * dyb + g_px[2] * dzb
    so, sd, srow = _reverse_sphere(s, g_oh, g_dh, g_t, g_n)
    bo, bd, brow = _reverse_box(s, g_oh, g_dh, g_t)
    is_s = s["is_s"]

    def pick(hit_s, hit_b, missv, old):
        v = torch.where(is_s, hit_s, hit_b)
        return torch.where(hit, v, torch.where(miss, missv, old))

    new_o = tuple(pick(a, b, g, g) for a, b, g in zip(so, bo, g_o))
    new_d = tuple(pick(a, b, g, g) for a, b, g in zip(sd, bd, g_d))
    new_c = tuple(pick(h, h, m, g)
                  for h, m, g in zip(g_c_hit, g_c_miss, g_c))
    row = torch.stack([torch.where(is_s, a, b) for a, b in zip(srow, brow)]
                      + list(g_rgb), dim=1)
    row = torch.where(hit[:, None], row, 0.0)
    return new_o, new_d, new_c, row, g_sky


def replay_bwd_terms(tabs: ReplayTables, org: Tensor, dir: Tensor,
                     pid_seq: Tensor, g_color: Tensor, refmax: int,
                     atten: float):
    """The backward up to the per-primitive sums -> (g_org [N, 3], g_dir
    [N, 3], pidc [refmax, N], rows [refmax, N, 9], sky rows
    [refmax, N, 3]); rows of lanes that hit nothing are zero."""
    _, saves, fin = _forward(tabs, org, dir, pid_seq, refmax, atten)
    isl, lit_fin = fin["isl"], fin["lit_fin"]
    g_out = (g_color[:, 0], g_color[:, 1], g_color[:, 2])
    g_pre = tuple(torch.where(lit_fin, g * isl, g) for g in g_out)
    pre_r, pre_g, pre_b = fin["pre"]
    pre_dot_g = pre_r * g_out[0] + pre_g * g_out[1] + pre_b * g_out[2]
    path = fin["path"]
    disl = -2.0 * path * (atten * atten) * isl * isl
    g_path = torch.where(lit_fin, pre_dot_g * disl, 0.0)
    zero = torch.zeros_like(g_path)
    g_o = g_d = (zero, zero, zero)
    g_c = tuple(torch.where(fin["exhausted"], 0.0, g) for g in g_pre)
    keys, rows, skies = [], [], []
    for b in range(refmax - 1, -1, -1):
        g_o, g_d, g_c, row, g_sky = _reverse_bounce(
            saves[b], tabs.sky, g_o, g_d, g_c, g_path)
        keys.append(saves[b]["pidc"])
        rows.append(row)
        skies.append(g_sky)
    return (torch.stack(g_o, dim=1), torch.stack(g_d, dim=1),
            torch.stack(keys[::-1]), torch.stack(rows[::-1]),
            torch.stack(skies[::-1]))


def reduce_terms(tabs: ReplayTables, keys: Tensor, rows: Tensor,
                 skies: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Sum per-ray rows onto their prims, in float64 -> (g_sph [S, 7],
    g_box [B, 9], g_sky [3]) in float32."""
    acc = torch.zeros((tabs.n_prims, N_SLOT), dtype=torch.float64,
                      device=rows.device)
    acc.index_add_(0, keys.reshape(-1), rows.reshape(-1, N_SLOT).double())
    acc = acc.to(torch.float32)
    g_sky = skies.reshape(-1, 3).double().sum(dim=0).to(torch.float32)
    return (acc[:tabs.n_sph][:, list(SPHERE_SLOTS)], acc[tabs.n_sph:],
            g_sky)


def replay_bwd_plain(tabs: ReplayTables, org: Tensor, dir: Tensor,
                     pid_seq: Tensor, g_color: Tensor, refmax: int,
                     atten: float):
    """Plain version of ``replay_bwd_kernel`` -> (g_org [N, 3], g_dir
    [N, 3], g_sph [S, 7] (center, radius, rgb), g_box [B, 9] (center, half
    size, rgb), g_sky [3])."""
    g_org, g_dir, keys, rows, skies = replay_bwd_terms(
        tabs, org, dir, pid_seq, g_color, refmax, atten)
    return (g_org, g_dir, *reduce_terms(tabs, keys, rows, skies))


def _lane_tree(x: Tensor) -> Tensor:
    """Sum over dim 1 (32 lanes) in the xor-butterfly tree the kernel's
    warp sums take (partners 16, 8, 4, 2, 1): its value on every lane."""
    off = 16
    while off:
        x = x[:, :off] + x[:, off:2 * off]
        off //= 2
    return x[:, 0]


def bwd_sums_model(tabs: ReplayTables, keys: Tensor, rows: Tensor,
                   skies: Tensor, hits: Tensor, grid: int):
    """``replay_bwd_kernel``'s float32 summation of the per-prim and sky
    terms, in its order, for ``grid`` blocks and tables of at most
    ``SCAN_MAX_PRIMS`` prims -> (g_sph [S, 7], g_box [B, 9], g_sky [3]).

    ``keys``/``rows``/``skies`` are :func:`replay_bwd_terms`' [R, N],
    [R, N, 9], [R, N, 3]; ``hits`` [R, N] the rays that hit at each bounce
    (their key is the prim's, else none). Rays are taken 128 at a time,
    group g by block ``g % grid`` (a grid-stride loop), 32 to a warp.
    For each group, bounce R-1 down to 0, each warp sums the rows of each
    winner over its lanes in the xor-butterfly tree, and adds the sum to
    its own slot row, one add per slot (the sky's 3 sums likewise); a
    block's partial row is its 4 warps' rows left to right; column c of
    the result sums the partial rows in the fixed order of a 32-lane pass
    (lane y adds rows y, y + 32, ... in turn from 0) and a shuffle-down
    tree over the 32 lanes. Adding a zero, for a prim a warp did not hit,
    changes no bit: no sum starts from -0."""
    if tabs.n_prims > SCAN_MAX_PRIMS:
        raise ValueError("the model covers the shared-memory slots only "
                         f"(at most {SCAN_MAX_PRIMS} prims)")
    n_r, n = keys.shape
    p_all = tabs.n_prims
    dev = rows.device
    groups = -(-n // BWD_BLOCK)
    pad = groups * BWD_BLOCK - n
    key = torch.where(hits, keys.long(), -1)
    key = torch.cat([key, key.new_full((n_r, pad), -1)], 1)
    row = torch.cat([rows, rows.new_zeros((n_r, pad, N_SLOT))], 1)
    sky = torch.cat([skies, skies.new_zeros((n_r, pad, 3))], 1)
    warps = BWD_BLOCK // 32
    acc = torch.zeros((grid, warps, p_all * N_SLOT + 3), dtype=torch.float32,
                      device=dev)
    prims = torch.arange(p_all, device=dev)
    for it in range(-(-groups // grid)):
        g0, g1 = it * grid, min((it + 1) * grid, groups)
        sel = slice(g0 * BWD_BLOCK, g1 * BWD_BLOCK)
        nb = g1 - g0
        for b in range(n_r - 1, -1, -1):
            k = key[b, sel].reshape(nb * warps, 32)
            r = row[b, sel].reshape(nb * warps, 32, N_SLOT)
            s = sky[b, sel].reshape(nb * warps, 32, 3)
            own = (k[:, :, None] == prims)[..., None]          # [W, 32, P, 1]
            g = _lane_tree(torch.where(own, r[:, :, None, :], 0.0))
            add = torch.cat([g.reshape(nb * warps, -1), _lane_tree(s)], 1)
            acc[:nb] += add.reshape(nb, warps, -1)
    part = acc[:, 0]
    for w in range(1, warps):
        part = part + acc[:, w]
    lanes = -(-grid // 32) * 32
    part = torch.cat([part, part.new_zeros((lanes - grid, part.shape[1]))])
    v = torch.zeros((32, part.shape[1]), dtype=torch.float32, device=dev)
    for k0 in range(0, lanes, 32):
        v = v + part[k0:k0 + 32]
    out = _lane_tree(v[None])[0]
    slots = out[:p_all * N_SLOT].reshape(p_all, N_SLOT)
    return (slots[:tabs.n_sph][:, list(SPHERE_SLOTS)], slots[tabs.n_sph:],
            out[p_all * N_SLOT:])


def bwd_grid(n: int, blocks_per_sm: int, sms: int) -> int:
    """The backward's grid for ``n`` rays: one block per 128 rays, at most
    as many as the card holds at once (``blocks_per_sm`` x ``sms``, the
    kernel's occupancy), so every block is resident and the last of them
    can wait for the rest; 0 for no rays."""
    if n < 0 or blocks_per_sm < 1 or sms < 1:
        raise ValueError(f"bad grid inputs: n={n}, blocks_per_sm="
                         f"{blocks_per_sm}, sms={sms}")
    return min(-(-n // BWD_BLOCK), blocks_per_sm * sms)


# ---------------------------------------------------------------------------
# CUDA launches and the dispatching wrappers
# ---------------------------------------------------------------------------

def _launch_args(tabs: ReplayTables, org: Tensor, dir: Tensor,
                 pid_seq: Tensor, refmax: int):
    dev = org.device
    if dev.type != "cuda":
        raise ValueError(f"the replay kernels need CUDA tensors, got {dev}")
    if not 1 <= refmax <= 4:
        raise ValueError(f"the replay kernels take refmax 1..4, got {refmax}")
    if tabs.n_prims == 0:
        raise ValueError("the replay kernels need at least one prim")
    n = org.shape[0]
    f32 = torch.float32
    _build.need(tabs.sph, "sphere table", f32, (max(tabs.n_sph, 1), 8), dev)
    _build.need(tabs.box, "box table", f32, (max(tabs.n_box, 1), 10), dev)
    _build.need(tabs.sky, "sky", f32, (3,), dev)
    _build.need(org, "org", f32, (n, 3), dev)
    _build.need(dir, "dir", f32, (n, 3), dev)
    _build.need(pid_seq, "pid_seq", torch.int32, (n, refmax), dev)
    return [_build.ptr(tabs.sph), tabs.n_sph, _build.ptr(tabs.box),
            tabs.n_box, _build.ptr(tabs.sky), _build.ptr(org),
            _build.ptr(dir), _build.ptr(pid_seq), n, refmax]


def launch_fwd(tabs: ReplayTables, org: Tensor, dir: Tensor,
               pid_seq: Tensor, refmax: int, atten: float) -> Tensor:
    """Launch ``replay_fwd_kernel`` on the current stream -> color [N, 3].
    Does not synchronize."""
    args = _launch_args(tabs, org, dir, pid_seq, refmax)
    dev = org.device
    color = torch.empty((org.shape[0], 3), dtype=torch.float32, device=dev)
    if org.shape[0] == 0:
        return color
    lib = _build.load()
    err = lib.rt_replay_fwd(*args, float(atten), _build.ptr(color), dev.index,
                            _build.stream(dev))
    _build.check(lib, err, "replay_fwd_kernel")
    LAUNCHES["fwd"] += 1
    return color


def bwd_layout(tabs: ReplayTables) -> Tuple[int, int]:
    """(n_glob, cols) of the backward: spheres above the shared-memory
    ceiling (the listed class) sum with global atomics, the other prims in
    9 shared-memory columns each, then the sky's 3."""
    n_glob = tabs.n_sph if tabs.n_prims > SCAN_MAX_PRIMS else 0
    return n_glob, (tabs.n_prims - n_glob) * N_SLOT + 3


_BLOCKS_PER_SM = {}


def launch_grid(tabs: ReplayTables, n: int, refmax: int,
                dev: torch.device) -> int:
    """The grid :func:`launch_bwd` takes for these tables and ``n`` rays
    (:func:`bwd_grid` at the kernel's occupancy on ``dev``)."""
    cols = bwd_layout(tabs)[1]
    key = (dev.index, refmax, cols)
    if key not in _BLOCKS_PER_SM:
        per_sm = _build.load().rt_replay_bwd_blocks_per_sm(refmax, cols,
                                                           dev.index)
        if per_sm < 1:
            raise RuntimeError(f"replay_bwd_kernel fits no block on an SM "
                               f"({per_sm})")
        _BLOCKS_PER_SM[key] = per_sm
    return bwd_grid(n, _BLOCKS_PER_SM[key],
                    torch.cuda.get_device_properties(dev).multi_processor_count)


def launch_bwd(tabs: ReplayTables, org: Tensor, dir: Tensor,
               pid_seq: Tensor, g_color: Tensor, refmax: int, atten: float):
    """Launch ``replay_bwd_kernel`` (one cooperative launch, its
    fixed-order reduction included) on the current stream -> the five
    outputs of :func:`replay_bwd_plain`, the last three views of one
    buffer the kernel fills. Does not synchronize."""
    args = _launch_args(tabs, org, dir, pid_seq, refmax)
    dev = org.device
    n = org.shape[0]
    _build.need(g_color, "g_color", torch.float32, (n, 3), dev)
    f32 = torch.float32
    n_s, n_b = tabs.n_sph, tabs.n_box
    n_glob, cols = bwd_layout(tabs)
    g_org = torch.empty((n, 3), dtype=f32, device=dev)
    g_dir = torch.empty((n, 3), dtype=f32, device=dev)
    out = torch.empty((n_s * 7 + n_b * N_SLOT + 3,), dtype=f32, device=dev)
    if n == 0:
        out.zero_()
    else:
        if n_glob:
            out[:n_glob * 7].zero_()
        blocks = launch_grid(tabs, n, refmax, dev)
        partial = torch.empty((blocks, cols), dtype=f32, device=dev)
        lib = _build.load()
        err = lib.rt_replay_bwd(*args, float(atten), float(atten) ** 2,
                                _build.ptr(g_color), n_glob, _build.ptr(g_org),
                                _build.ptr(g_dir), _build.ptr(out),
                                _build.ptr(partial), blocks, dev.index,
                                _build.stream(dev))
        _build.check(lib, err, "replay_bwd_kernel")
        LAUNCHES["bwd"] += 1
    return (g_org, g_dir, out[:n_s * 7].view(n_s, 7),
            out[n_s * 7:n_s * 7 + n_b * N_SLOT].view(n_b, N_SLOT),
            out[n_s * 7 + n_b * N_SLOT:])


def replay_fwd(tabs: ReplayTables, org: Tensor, dir: Tensor,
               pid_seq: Tensor, refmax: int, atten: float) -> Tensor:
    """B5 forward: CUDA tensors launch the kernel; CPU tensors run the
    plain version."""
    if _build.on_cpu(org.device):
        return replay_fwd_plain(tabs, org, dir, pid_seq, refmax, atten)
    return launch_fwd(tabs, org, dir, pid_seq, refmax, atten)


def replay_bwd(tabs: ReplayTables, org: Tensor, dir: Tensor,
               pid_seq: Tensor, g_color: Tensor, refmax: int, atten: float):
    """B5 backward: CUDA tensors launch the kernel; CPU tensors run the
    plain version."""
    if _build.on_cpu(org.device):
        return replay_bwd_plain(tabs, org, dir, pid_seq, g_color, refmax,
                                atten)
    return launch_bwd(tabs, org, dir, pid_seq, g_color, refmax, atten)


class _ReplayColors(torch.autograd.Function):
    """Replay colors with the B5 backward as their VJP."""

    @staticmethod
    def forward(ctx, sph_c, sph_r, sph_rgb, box_c, box_h, box_rgb, sky_rgb,
                mode, org, dir, pid_seq, refmax, atten):
        tabs = pack_tables(sph_c, sph_r, sph_rgb, box_c, box_h, box_rgb,
                           sky_rgb, mode)
        org, dir = org.contiguous(), dir.contiguous()
        ctx.tabs, ctx.refmax, ctx.atten = tabs, refmax, atten
        ctx.save_for_backward(org, dir, pid_seq)
        return replay_fwd(tabs, org, dir, pid_seq, refmax, atten)

    @staticmethod
    def backward(ctx, g_color):
        org, dir, pid_seq = ctx.saved_tensors
        g_org, g_dir, g_sph, g_box, g_sky = replay_bwd(
            ctx.tabs, org, dir, pid_seq, g_color.contiguous(), ctx.refmax,
            ctx.atten)
        return (g_sph[:, 0:3], g_sph[:, 3], g_sph[:, 4:7], g_box[:, 0:3],
                g_box[:, 3:6], g_box[:, 6:9], g_sky, None, g_org, g_dir,
                None, None, None)


def replay_colors(scene: Scene, cfg: RenderConfig, org: Tensor, dir: Tensor,
                  pid_seq: Tensor) -> Tensor:
    """Differentiable replay colors [N, 3] through kernel B5.

    The drop-in for ``trace_rays(..., pid_seq=pid_seq).color`` on the
    :func:`supports_fit` class (the caller checks it); gradients reach
    every scene float leaf the colors depend on and ``org``/``dir`` (the
    camera pose). The prim and sky colors are gathered from
    ``textures.solid_rgb`` outside the Function, so autograd carries their
    cotangents back to the texture table.
    """
    return _ReplayColors.apply(
        *_inputs(scene), org, dir, pid_seq.to(torch.int32).contiguous(),
        int(cfg.refmax), float(cfg.distance_attenuation_factor))
