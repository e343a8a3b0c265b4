"""Nearest-hit kernels B3 (scalar) and B4 (dense) and their plain versions.

Port of ``raytracer_js_tpu.kernels.nearest_hit``: the search behind
``HitBackend.PALLAS``. Both return, per ray, the nearest forward hit
``(t [N] f32, pid [N] i32)`` over the global [spheres | boxes | triangles]
order, with ``pid = -1`` and ``t = +inf`` on a miss and a tie in t going
to the lowest pid — the contract of ``ops/trace.nearest_hit_brute``.

- :func:`nearest_hit_pallas_scalar` (B3, ``nh_scalar_kernel``) — the
  reference's prim-at-a-time kernel for scenes of at most 384 prims.
- :func:`nearest_hit_pallas` (B4, ``nh_dense_kernel``) — the dense tiled
  kernel, with the sphere test in its factored form and ``n_live``: rows at
  or past ``n_live`` report a miss.

- :func:`nearest_hit_pallas` with ``tile_ids``/``tri_tile_ids`` (B6,
  ``nh_listed_kernel``) — the listed search of the TILED sweep rounds: each
  128-ray block has its own list of 128-prim (super)tiles in ascending
  entry bound; each warp of 32 rays streams it and stops early on its own
  (:func:`nearest_hit_listed_plain`).
- :func:`nearest_hit_pallas` with ``tile_bounds`` (B8,
  ``nh_culled_kernel``) — B4 with an in-kernel cone cull: each warp of 32
  rays bounds its live rays by a cone and skips every 128-sphere tile the
  cone cannot reach (:func:`nearest_hit_culled_plain`).

The plain versions of B6 and B8 take the exit group's size as ``group``:
32, the kernels', by default; 128 gives the block-wide exit of the first
design, with the same t and pid, so the two can be held against each
other.

The kernels live in ``csrc/nearest_hit.cu``. Each has a plain PyTorch
version (``*_plain``) with the kernel's expressions in the kernel's order,
written out elementwise (never a matmul: TF32 or another summation order
would move near-miss discriminants, the phantom-hit class). The plain
versions chunk over rays so their ``[rays, prims]`` temporaries stay
bounded; a ray's result depends only on that ray, so chunking changes no
bit. A wrapper takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises. ``LAUNCHES`` counts launches.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple, Union

import torch

from ..models.scene import Scene, prim_aabbs
from ..ops.intersect import INF as _INF, MT_EPS as _MT_EPS
from ..ops.intersect import SLAB_DIR_EPS as _SLAB_EPS, safe_inv as _safe_inv
from . import _build

Tensor = torch.Tensor

#: kernel launches per kernel since the last reset (the plain versions and
#: the empty cases answered on the host do not count)
LAUNCHES = {"scalar": 0, "dense": 0, "listed": 0, "culled": 0}

#: the reference sends scenes of 1..SCALAR_MAX_PRIMS prims to B3
SCALAR_MAX_PRIMS = 384
#: elements of one [rays, prims] temporary in a plain version
PLAIN_CHUNK_ELEMS = 1 << 25
#: B4 splits each 128-ray block's scan over about this many sphere and
#: triangle tiles a block (a rescue round's few live rays then keep the
#: card busy), with at most DENSE_PART_ELEMS partial results [splits, N]
DENSE_SPLIT_TILES = 32
DENSE_PART_ELEMS = 1 << 22
#: B6: rays per list row (one CUDA block of four warps), prims per listed
#: tile, and list slots streamed between early-exit checks
BLOCK_R = 128
BLOCK_K = 128
CHUNK_T = 16


@dataclasses.dataclass(frozen=True)
class HitTables:
    """Structure-of-arrays prim tables, row-major ``[rows, max(count, 1)]``
    f32 on the scene's device (at least one column, so a kernel never gets
    a null pointer): spheres cx cy cz ccmr (``c.c - r^2``), boxes
    cx cy cz hx hy hz, triangles v0 v1 v2 (xyz each); and the scene's
    sphere radii ``radius`` [S], from which :attr:`bounds` is built."""

    sph: Tensor     # [4, S]
    box: Tensor     # [6, B]
    tri: Tensor     # [9, T]
    n_sph: int
    n_box: int
    n_tri: int
    radius: Tensor  # [S]

    @property
    def n_prims(self) -> int:
        return self.n_sph + self.n_box + self.n_tri

    @functools.cached_property
    def bounds(self) -> Tensor:
        """B3's sphere bounds [max(S, 1), 4] f32 (cx cy cz r, one row a
        sphere), the balls its cone cull tests. Built on first use, so the
        other searches pay nothing for it."""
        if self.n_sph == 0:
            return torch.zeros((1, 4), dtype=torch.float32,
                               device=self.sph.device)
        return torch.cat([self.sph[:3, :self.n_sph].T,
                          self.radius.to(torch.float32)[:, None]],
                         1).contiguous()


def pack_tables(scene: Scene) -> HitTables:
    c, r = scene.sphere_center, scene.sphere_radius
    cx, cy, cz = c[:, 0], c[:, 1], c[:, 2]
    bc, bh = scene.box_center, scene.box_half
    v0, v1, v2 = scene.tri_v0, scene.tri_v1, scene.tri_v2

    def table(rows, n):
        if n == 0:
            return torch.zeros((len(rows), 1), dtype=torch.float32,
                               device=scene.device)
        return torch.stack([x.to(torch.float32) for x in rows]).contiguous()

    return HitTables(
        sph=table([cx, cy, cz, (cx * cx + cy * cy + cz * cz) - r * r],
                  scene.n_spheres),
        box=table([bc[:, 0], bc[:, 1], bc[:, 2], bh[:, 0], bh[:, 1],
                   bh[:, 2]], scene.n_boxes),
        tri=table([v[:, k] for v in (v0, v1, v2) for k in range(3)],
                  scene.n_tris),
        n_sph=scene.n_spheres, n_box=scene.n_boxes, n_tri=scene.n_tris,
        radius=r)


# ---------------------------------------------------------------------------
# The plain versions
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Rays:
    """Per-ray terms as [c, 1] columns (one chunk of rays)."""

    ox: Tensor
    oy: Tensor
    oz: Tensor
    dx: Tensor
    dy: Tensor
    dz: Tensor
    a: Tensor
    inv_a: Tensor
    ix: Tensor
    iy: Tensor
    iz: Tensor
    o_dot_o: Tensor
    o_dot_d: Tensor


def _rays(org: Tensor, dir: Tensor) -> _Rays:
    ox, oy, oz = (org[:, k:k + 1] for k in range(3))
    dx, dy, dz = (dir[:, k:k + 1] for k in range(3))
    a = dx * dx + dy * dy + dz * dz
    return _Rays(ox, oy, oz, dx, dy, dz, a, 1.0 / a, _safe_inv(dx),
                 _safe_inv(dy), _safe_inv(dz), ox * ox + oy * oy + oz * oz,
                 ox * dx + oy * dy + oz * dz)


def _sphere_scalar(r: _Rays, s: Tensor) -> Tensor:
    """B3's sphere test: clamped discriminant and a disc >= 0 mask."""
    cx, cy, cz, ccmr = s[0], s[1], s[2], s[3]
    b_half = r.o_dot_d - (r.dx * cx + r.dy * cy + r.dz * cz)
    c = r.o_dot_o - 2.0 * (r.ox * cx + r.oy * cy + r.oz * cz) + ccmr
    disc = b_half * b_half - r.a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_near = (-b_half - sq) * r.inv_a
    t_far = (-b_half + sq) * r.inv_a
    t = torch.where(t_near >= 0.0, t_near,
                    torch.where(t_far >= 0.0, t_far, _INF))
    return torch.where(disc >= 0.0, t, _INF)


def _sphere_dense(r: _Rays, s: Tensor) -> Tensor:
    """B4's sphere test: the factored form; a negative discriminant makes
    ``sq`` NaN, every compare on it false, and t = +inf."""
    cx, cy, cz, ccmr = s[0], s[1], s[2], s[3]
    d_dot_c = r.dx * cx + r.dy * cy + r.dz * cz
    o_dot_c = r.ox * cx + r.oy * cy + r.oz * cz
    b_half = r.o_dot_d - d_dot_c
    c = r.o_dot_o - 2.0 * o_dot_c + ccmr
    disc = b_half * b_half - r.a * c
    sq = torch.sqrt(disc)
    u = (d_dot_c - r.o_dot_d) * r.inv_a
    s_ = sq * r.inv_a
    t_sel = torch.where(u - s_ >= 0.0, u - s_, u + s_)
    return torch.where(u + s_ >= 0.0, t_sel, _INF)


def _box(r: _Rays, b: Tensor) -> Tensor:
    cx, cy, cz, hx, hy, hz = (b[k] for k in range(6))
    tax = (cx - hx - r.ox) * r.ix
    tbx = (cx + hx - r.ox) * r.ix
    tay = (cy - hy - r.oy) * r.iy
    tby = (cy + hy - r.oy) * r.iy
    taz = (cz - hz - r.oz) * r.iz
    tbz = (cz + hz - r.oz) * r.iz
    t_enter = torch.maximum(torch.maximum(torch.minimum(tax, tbx),
                                          torch.minimum(tay, tby)),
                            torch.minimum(taz, tbz))
    t_exit = torch.minimum(torch.minimum(torch.maximum(tax, tbx),
                                         torch.maximum(tay, tby)),
                           torch.maximum(taz, tbz))
    t = torch.where(t_enter >= 0.0, t_enter,
                    torch.where(t_exit >= 0.0, t_exit, _INF))
    return torch.where(t_enter <= t_exit, t, _INF)


def _tri(r: _Rays, tr: Tensor) -> Tensor:
    """Moeller-Trumbore with the 1e-9 determinant floor, from the vertex
    rows v0 v1 v2."""
    v0x, v0y, v0z = tr[0], tr[1], tr[2]
    return _tri_edges(r, (v0x, v0y, v0z, tr[3] - v0x, tr[4] - v0y,
                          tr[5] - v0z, tr[6] - v0x, tr[7] - v0y,
                          tr[8] - v0z))


def _tri_head(r: _Rays, te):
    """The test's terms up to u's numerator: (p, det, s, u_num)."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (te[k] for k in range(9))
    px = r.dy * e2z - r.dz * e2y
    py = r.dz * e2x - r.dx * e2z
    pz = r.dx * e2y - r.dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    sx, sy, sz = r.ox - v0x, r.oy - v0y, r.oz - v0z
    return (px, py, pz), det, (sx, sy, sz), sx * px + sy * py + sz * pz


def _tri_edges(r: _Rays, te) -> Tensor:
    """The same test from the edge rows v0, e1 = v1 - v0, e2 = v2 - v0 (the
    kernels' triangle table, :func:`edge_table`)."""
    e1x, e1y, e1z, e2x, e2y, e2z = (te[k] for k in range(3, 9))
    _p, det, (sx, sy, sz), u_num = _tri_head(r, te)
    inv_det = 1.0 / torch.where(det.abs() < _MT_EPS, _MT_EPS, det)
    u = u_num * inv_det
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = ((det.abs() >= _MT_EPS) & (u >= 0.0) & (v >= 0.0)
          & (u + v <= 1.0) & (t >= 0.0))
    return torch.where(ok, t, _INF)


def tri_certain_miss(r: _Rays, te) -> Tensor:
    """The streaming kernels' predicate that a triangle test certainly
    fails (``csrc/nearest_hit.cu`` ``tri_certain_miss``, whose note proves
    it): |det| < 1e-9 (or NaN), or u = u_num / det certainly below 0 or
    above 1. A warp whose every lane certainly fails skips 1 / det and the
    rest of the test. -> bool, the shape of :func:`_tri_edges`' result."""
    _p, det, _s, u_num = _tri_head(r, te)
    ad, au = det.abs(), u_num.abs()
    opposite = (u_num < 0.0) != (det < 0.0)
    return ~(ad >= _MT_EPS) | torch.where(opposite, au >= ad * 2.0 ** -64,
                                          au >= ad * (1.0 + 2.0 ** -20))


def _search_plain(tabs: HitTables, org: Tensor, dir: Tensor,
                  sphere: Callable,
                  sph_mask: Optional[Callable] = None) -> Tuple[Tensor,
                                                                Tensor]:
    """Nearest forward hit, class by class in pid order, folding each
    class's first minimum with a strict ``<`` (the kernels' running min),
    in chunks of rays. ``sph_mask(lo, hi)`` -> [hi - lo, n_sph] bool drops
    the spheres it is False for (B8's culled tiles)."""
    n = org.shape[0]
    t_out = torch.full((n,), _INF, dtype=torch.float32, device=org.device)
    pid_out = torch.full((n,), -1, dtype=torch.int32, device=org.device)
    classes = [(tabs.n_sph, tabs.sph, sphere, 0),
               (tabs.n_box, tabs.box, _box, tabs.n_sph),
               (tabs.n_tri, tabs.tri, _tri, tabs.n_sph + tabs.n_box)]
    step = max(1, PLAIN_CHUNK_ELEMS // max(tabs.n_prims, 1))
    for lo in range(0, n if tabs.n_prims else 0, step):
        r = _rays(org[lo:lo + step], dir[lo:lo + step])
        t_best = torch.full_like(r.ox[:, 0], _INF)
        pid = torch.full(t_best.shape, -1, dtype=torch.int64,
                         device=org.device)
        for count, tab, test, base in classes:
            if count == 0:
                continue
            t = test(r, tab[:, :count])
            if base == 0 and sph_mask is not None:
                t = torch.where(sph_mask(lo, lo + t.shape[0]), t, _INF)
            t, idx = t.min(dim=1)
            upd = t < t_best
            t_best = torch.where(upd, t, t_best)
            pid = torch.where(upd, idx + base, pid)
        t_out[lo:lo + step] = t_best
        pid_out[lo:lo + step] = torch.where(t_best < _INF, pid, -1).to(
            torch.int32)
    return t_out, pid_out


def nearest_hit_pallas_scalar_plain(scene: Scene, org: Tensor,
                                    dir: Tensor) -> Tuple[Tensor, Tensor]:
    """Plain version of B3 -> (t [N], pid [N])."""
    return _search_plain(pack_tables(scene), org, dir, _sphere_scalar)


def nearest_hit_pallas_plain(scene: Scene, org: Tensor, dir: Tensor,
                             n_live=None) -> Tuple[Tensor, Tensor]:
    """Plain version of B4 -> (t [N], pid [N]); rows at or past ``n_live``
    report (+inf, -1)."""
    t, pid = _search_plain(pack_tables(scene), org, dir, _sphere_dense)
    if n_live is None:
        return t, pid
    live = (torch.arange(org.shape[0], device=org.device)
            < torch.as_tensor(n_live, device=org.device))
    return torch.where(live, t, _INF), torch.where(live, pid, -1)


def _check_group(group: int) -> None:
    if group < 1 or group & (group - 1) or BLOCK_R % group:
        raise ValueError(f"group must be a power of two dividing {BLOCK_R}, "
                         f"got {group}")


def _group_sum(x: Tensor, group: int) -> Tensor:
    """Sum of each group of rows [G, group] in the kernels' order: a
    shuffle-down tree over each warp of (at most) 32 rows, then the warp
    sums left to right (the first design's block of 128: four warps)."""
    lanes = min(group, 32)
    x = x.reshape(x.shape[0], group // lanes, lanes)
    off = lanes // 2
    while off:
        x = x[..., :off] + x[..., off:2 * off]
        off //= 2
    w = x[..., 0]
    s = w[:, 0]
    for k in range(1, w.shape[1]):
        s = s + w[:, k]
    return s


def culled_tiles(org: Tensor, dir: Tensor, live: int,
                 tile_bounds: Tensor, n_sph: int,
                 group: int = 32) -> Tensor:
    """B8's cull -> include [G, T] bool over the ``ceil(n_sph / 128)``
    sphere tiles (bounds ``tile_bounds[k]`` = center, radius):
    :func:`cone_include`."""
    return cone_include(org, dir, live, tile_bounds[:-(-n_sph // BLOCK_K)],
                        group)


def scalar_cull(tabs: HitTables, org: Tensor, dir: Tensor,
                group: int = 32) -> Tensor:
    """B3's cull -> include [ceil(N / group), S] bool: :func:`cone_include`
    over every ray and each sphere's own ball (``tabs.bounds``). With
    ``group=32``, the spheres each warp of B3 tests (the kernel's
    ``work``, summed); ``group=1``, the spheres each ray alone can reach
    (the need). A sphere left out misses every ray of its group."""
    n = org.shape[0]
    return cone_include(org, dir, n, tabs.bounds[:tabs.n_sph],
                        group)[:-(-n // group)]


def cone_include(org: Tensor, dir: Tensor, live, bounds: Tensor,
                 group: int = 32) -> Tensor:
    """The per-warp ball-cone cull of B3, B8 and B1/B2 (``csrc/cull.cuh``)
    -> include [G, K] bool, one row per group of ``group`` rays (the rays
    padded to whole 128-ray blocks), one column per ball ``bounds[k]`` =
    center, radius (B8: a 128-sphere tile's, B3 and B1/B2: a sphere's):
    group g's live rays (``live``: the rows below it, as the kernel's
    prologue takes the rows below min(n_live, N), or a bool mask [N]) are
    bounded by an apex ball (o0 = their mean origin, ro = the largest
    distance from it) and a cone (axis = their mean direction, cos_t = the
    worst alignment); ball k is kept iff the ball-cone can reach it or ``cos_t <
    0.25``, the predicate of ``accel/candidates.cone_include_np``. The
    kernels' expressions, in their order. ``group=1`` bounds each ray by
    itself (apex 0, angle 0): the balls that ray alone can reach."""
    _check_group(group)
    n = org.shape[0]
    nb = -(-n // BLOCK_R) * (BLOCK_R // group)
    pad = nb * group - n
    o = torch.cat([org, org.new_zeros((pad, 3))]) if pad else org
    d = torch.cat([dir, dir.new_ones((pad, 3))]) if pad else dir
    if isinstance(live, torch.Tensor):
        lv = torch.cat([live, live.new_zeros((pad,))]) if pad else live
        lv = lv.reshape(nb, group)
    else:
        lv = (torch.arange(nb * group, device=org.device) < live).reshape(
            nb, group)
    ox, oy, oz = (o[:, k].reshape(nb, group) for k in range(3))
    dx, dy, dz = (d[:, k].reshape(nb, group) for k in range(3))
    zero = torch.zeros_like(ox)

    def gsum(x):
        return _group_sum(x, group)

    r_inv = 1.0 / torch.clamp(gsum(lv.to(torch.float32)), min=1.0)
    o0x = gsum(torch.where(lv, ox, zero)) * r_inv
    o0y = gsum(torch.where(lv, oy, zero)) * r_inv
    o0z = gsum(torch.where(lv, oz, zero)) * r_inv
    ex, ey, ez = ox - o0x[:, None], oy - o0y[:, None], oz - o0z[:, None]
    ro = torch.sqrt(torch.where(lv, ex * ex + ey * ey + ez * ez,
                                zero).max(dim=1).values)
    axm = gsum(torch.where(lv, dx, zero)) * r_inv
    aym = gsum(torch.where(lv, dy, zero)) * r_inv
    azm = gsum(torch.where(lv, dz, zero)) * r_inv
    a_n = 1.0 / torch.sqrt(torch.clamp(axm * axm + aym * aym + azm * azm,
                                       min=1e-20))
    axm, aym, azm = axm * a_n, aym * a_n, azm * a_n
    d_inv = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz)
    cos_t = torch.where(lv, (dx * axm[:, None] + dy * aym[:, None]
                             + dz * azm[:, None]) * d_inv,
                        1.0).min(dim=1).values
    use_cone = cos_t >= 0.25
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    tb = bounds
    vx = tb[None, :, 0] - o0x[:, None]
    vy = tb[None, :, 1] - o0y[:, None]
    vz = tb[None, :, 2] - o0z[:, None]
    dist = torch.sqrt(vx * vx + vy * vy + vz * vz)
    rr = tb[None, :, 3] + ro[:, None]
    inside = dist <= rr * (1.0 + 1e-5) + 1e-7
    sin_a = torch.clamp(rr / torch.clamp(dist, min=1e-20), max=1.0)
    cos_a = torch.sqrt(torch.clamp(1.0 - sin_a * sin_a, min=0.0))
    cos_b = ((vx * axm[:, None] + vy * aym[:, None] + vz * azm[:, None])
             / torch.clamp(dist, min=1e-20))
    return (inside | (cos_b >= cos_a * cos_t[:, None]
                      - sin_a * sin_t[:, None] - 1e-5)
            | ~use_cone[:, None])


def nearest_hit_culled_plain(scene: Scene, org: Tensor, dir: Tensor,
                             tile_bounds: Tensor, n_live=None,
                             work: bool = False, group: int = 32):
    """Plain version of B8 -> (t [N], pid [N]) (+ ``tiles`` [B, 128 /
    group] i32, the sphere tiles each group of ``group`` rays streamed, per
    128-ray block, when ``work``).

    B4's search (boxes and triangles dense), each group skipping the
    sphere tiles :func:`culled_tiles` excludes; the spheres must be in the
    tile order of ``tile_bounds`` [T >= ceil(S / 128), 4]. Rows at or past
    ``n_live`` report (+inf, -1), and groups wholly past it stream
    nothing. The cull is conservative, so the result is B4's whatever the
    group."""
    return culled_plain(pack_tables(scene), org, dir, tile_bounds, n_live,
                        work, group)


def culled_plain(tabs: HitTables, org: Tensor, dir: Tensor,
                 tile_bounds: Tensor, n_live=None, work: bool = False,
                 group: int = 32):
    """:func:`nearest_hit_culled_plain` on packed tables."""
    n = org.shape[0]
    live = n if n_live is None else min(int(n_live), n)
    if tile_bounds.shape[0] * BLOCK_K < tabs.n_sph:
        raise ValueError(f"{tile_bounds.shape[0]} tile bounds cover fewer "
                         f"than {tabs.n_sph} spheres")
    include = culled_tiles(org, dir, live, tile_bounds, tabs.n_sph, group)
    tile_of = torch.arange(tabs.n_sph, device=org.device) // BLOCK_K

    def mask(lo, hi):
        grp = torch.arange(lo, hi, device=org.device) // group
        return include[grp][:, tile_of]

    t, pid = _search_plain(tabs, org, dir, _sphere_dense, sph_mask=mask)
    rows = torch.arange(n, device=org.device) < live
    t, pid = torch.where(rows, t, _INF), torch.where(rows, pid, -1)
    if not work:
        return t, pid
    starts = torch.arange(include.shape[0], device=org.device) * group
    tiles = torch.where(starts < live, include.sum(dim=1), 0).to(
        torch.int32).reshape(-1, BLOCK_R // group)
    return t, pid, tiles


# ---------------------------------------------------------------------------
# CUDA launches and the dispatching wrappers
# ---------------------------------------------------------------------------

def launch_scalar(tabs: HitTables, org: Tensor, dir: Tensor,
                  work: bool = False):
    """Launch B3 on the current stream -> (t [N], pid [N]) (+ ``tested``
    [ceil(N / 32)] i32, the spheres each warp tested, when ``work``). No
    rays or no prims is answered here without a launch. Does not
    synchronize."""
    dev = org.device
    if dev.type != "cuda":
        raise ValueError(f"the nearest-hit kernels need CUDA tensors, got "
                         f"{dev}")
    n = org.shape[0]
    f32, i32 = torch.float32, torch.int32
    if n == 0 or tabs.n_prims == 0:
        t = torch.full((n,), _INF, dtype=f32, device=dev)
        pid = torch.full((n,), -1, dtype=i32, device=dev)
        tested = torch.zeros((-(-n // 32),), dtype=i32, device=dev)
        return (t, pid, tested) if work else (t, pid)
    args = []
    for name, tab, rows, count in (("sphere table", tabs.sph, 4, tabs.n_sph),
                                   ("box table", tabs.box, 6, tabs.n_box),
                                   ("triangle table", tabs.tri, 9,
                                    tabs.n_tri)):
        _build.need(tab, name, f32, (rows, max(count, 1)), dev)
        args += [_build.ptr(tab), count, tab.shape[1]]
    _build.need(tabs.bounds, "sphere bounds", f32, (max(tabs.n_sph, 1), 4),
                dev)
    _build.need(org, "org", f32, (n, 3), dev)
    _build.need(dir, "dir", f32, (n, 3), dev)
    t = torch.empty((n,), dtype=f32, device=dev)
    pid = torch.empty((n,), dtype=i32, device=dev)
    tested = torch.empty((-(-n // 32),), dtype=i32, device=dev) if work \
        else None
    lib = _build.load()
    err = lib.rt_nearest_hit_scalar(
        *args, _build.ptr(tabs.bounds), _build.ptr(org), _build.ptr(dir), n,
        _build.ptr(t), _build.ptr(pid), _build.ptr(tested),
        dev.index, _build.stream(dev))
    _build.check(lib, err, "nh_scalar_kernel")
    LAUNCHES["scalar"] += 1
    return (t, pid, tested) if work else (t, pid)


def dense_splits(st: StreamTables, n: int) -> int:
    """How many blocks share each 128-ray block's dense scan (B4): about
    ``DENSE_SPLIT_TILES`` sphere and triangle tiles each, so that a scan of
    few live rays over many prims still fills the card, but at most
    ``DENSE_PART_ELEMS / n``. The splits' results merge to the unsplit
    scan's t and pid bit for bit (the kernel's note)."""
    tiles = -(-st.n_sph // BLOCK_K) + -(-st.n_tri // BLOCK_K)
    return max(1, min(-(-tiles // DENSE_SPLIT_TILES),
                      DENSE_PART_ELEMS // max(n, 1), 65535))


def launch_dense(st: StreamTables, org: Tensor, dir: Tensor,
                 n_live: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Launch B4 on the current stream -> (t [N], pid [N]); ``st`` from
    :func:`stream_tables`, ``n_live`` a [1] int32 device tensor (None:
    every row), so the count never syncs to the host. The scan is split
    over :func:`dense_splits` blocks per 128 rays. No rays or no prims is
    answered here without a launch. Does not synchronize."""
    dev = org.device
    if dev.type != "cuda":
        raise ValueError(f"the nearest-hit kernels need CUDA tensors, got "
                         f"{dev}")
    n = org.shape[0]
    f32, i32 = torch.float32, torch.int32
    _build.need(org, "org", f32, (n, 3), dev)
    _build.need(dir, "dir", f32, (n, 3), dev)
    t = torch.full((n,), _INF, dtype=f32, device=dev)
    pid = torch.full((n,), -1, dtype=i32, device=dev)
    if n == 0 or st.n_prims == 0:
        return t, pid
    args = _stream_table_args(st, dev)
    if n_live is None:
        n_live = torch.full((1,), n, dtype=i32, device=dev)
    _build.need(n_live, "n_live", i32, (1,), dev)
    splits = dense_splits(st, n)
    t_part = pid_part = None
    if splits > 1:
        t_part = torch.empty((splits, n), dtype=f32, device=dev)
        pid_part = torch.empty((splits, n), dtype=i32, device=dev)
    lib = _build.load()
    err = lib.rt_nearest_hit_dense(*args, _build.ptr(org), _build.ptr(dir), n,
                                   _build.ptr(n_live), splits,
                                   _build.ptr(t_part), _build.ptr(pid_part),
                                   _build.ptr(t), _build.ptr(pid), dev.index,
                                   _build.stream(dev))
    _build.check(lib, err, "nh_dense_kernel")
    LAUNCHES["dense"] += 1
    return t, pid


def nearest_hit_pallas_scalar(scene: Scene, org: Tensor,
                              dir: Tensor) -> Tuple[Tensor, Tensor]:
    """B3: prim-at-a-time nearest hit -> (t [N], pid [N]). CUDA tensors
    launch the kernel; CPU tensors run the plain version."""
    if _build.on_cpu(org.device):
        return nearest_hit_pallas_scalar_plain(scene, org, dir)
    return launch_scalar(pack_tables(scene), org, dir)


# ---------------------------------------------------------------------------
# B6: the listed search, and the tables B6 and B8 stream
# ---------------------------------------------------------------------------

def _pad_tiles(tab: Tensor, count: int, fan: int = 1,
               poison_row: Optional[int] = None) -> Tensor:
    """A [rows, >= count] table padded with zero columns to whole
    (super)tiles of ``BLOCK_K * fan`` prims; ``poison_row`` set to +inf in
    the padding (the sphere table's ccmr row: a padded sphere is never
    hit)."""
    width = -(-max(count, 1) // (BLOCK_K * fan)) * (BLOCK_K * fan)
    out = torch.zeros((tab.shape[0], width), dtype=torch.float32,
                      device=tab.device)
    out[:, :count] = tab[:, :count]
    if poison_row is not None:
        out[poison_row, count:] = _INF
    return out


def edge_table(tri: Tensor) -> Tensor:
    """A [9, T] vertex table (v0 v1 v2) -> the edge table (v0, e1 = v1 -
    v0, e2 = v2 - v0), subtracted in float32 on the table's device, each
    element rounded once as the vertex-form test rounds it. All-zero
    (padded) triangles stay all-zero."""
    v0 = tri[0:3]
    return torch.cat([v0, tri[3:6] - v0, tri[6:9] - v0]).contiguous()


@dataclasses.dataclass(frozen=True)
class StreamTables:
    """What B4, B6 and B8 stream: the array-of-structs sphere table
    ``sph4`` [S', 4] (cx cy cz ccmr) and the triangle edge table ``tri``
    [9, T'] (:func:`edge_table`), both padded to whole (super)tiles of
    ``BLOCK_K`` prims (padded spheres poisoned with ``ccmr = +inf``,
    padded triangles all-zero: neither can be hit) on fresh, 16-byte
    aligned allocations; the box table as :class:`HitTables` has it."""

    sph4: Tensor
    box: Tensor
    tri: Tensor
    n_sph: int
    n_box: int
    n_tri: int

    @property
    def n_prims(self) -> int:
        return self.n_sph + self.n_box + self.n_tri


def stream_tables(tabs: HitTables, sph_fan: int = 1,
                  tri_fan: int = 1) -> StreamTables:
    """The kernels' copies of :func:`pack_tables`' tables, padded to
    supertiles of ``fan`` 128-prim tiles."""
    sph = _pad_tiles(tabs.sph, tabs.n_sph, sph_fan, poison_row=3)
    return StreamTables(
        sph4=sph.T.contiguous(), box=tabs.box,
        tri=edge_table(_pad_tiles(tabs.tri, tabs.n_tri, tri_fan)),
        n_sph=tabs.n_sph, n_box=tabs.n_box, n_tri=tabs.n_tri)


@dataclasses.dataclass(frozen=True)
class ListedInputs:
    """What B6 and its plain version read: the plain version's tables,
    spheres and triangles padded to whole (super)tiles (padded spheres
    poisoned with ``ccmr = +inf``, padded triangles all-zero: neither can
    be hit), the kernel's copies of them (``stream``), the lists ([rows,
    cols] ids i32 / t_lo f32, rows >= ceil(N / BLOCK_R), cols a CHUNK_T
    multiple; None scans that class dense) and the scene-bbox row [8] (lo
    xyz, hi xyz, 0, 0)."""

    tabs: HitTables
    stream: StreamTables
    sph_list: Optional[Tuple[Tensor, Tensor]]
    tri_list: Optional[Tuple[Tensor, Tensor]]
    sph_fan: int
    tri_fan: int
    bbox: Tensor


def _prep_list(pair, n: int) -> Tuple[Tensor, Tensor]:
    """The reference's list padding: rows to a multiple of 8, columns to a
    CHUNK_T multiple (id 0, t_lo +inf)."""
    ids, tlo = pair
    if ids.shape[0] * BLOCK_R < n:
        raise ValueError(f"{ids.shape[0]} list rows cover fewer than {n} "
                         f"rays")
    ids = ids.to(torch.int32)
    tlo = tlo.to(torch.float32)
    rpad = -(-ids.shape[0] // 8) * 8 - ids.shape[0]
    cpad = -(-ids.shape[1] // CHUNK_T) * CHUNK_T - ids.shape[1]
    ids = torch.nn.functional.pad(ids, (0, cpad, 0, rpad))
    tlo = torch.nn.functional.pad(tlo, (0, cpad, 0, rpad), value=_INF)
    return ids.contiguous(), tlo.contiguous()


def listed_inputs(scene: Scene, n: int, tile_ids=None, tri_tile_ids=None,
                  sph_fan: int = 1, tri_fan: int = 1) -> ListedInputs:
    tabs = pack_tables(scene)
    stream = stream_tables(tabs, sph_fan, tri_fan)
    tabs = dataclasses.replace(
        tabs, sph=_pad_tiles(tabs.sph, tabs.n_sph, sph_fan, 3),
        tri=_pad_tiles(tabs.tri, tabs.n_tri, tri_fan))
    lo, hi = prim_aabbs(scene)
    bbox = torch.cat([lo.min(dim=0).values, hi.max(dim=0).values,
                      torch.zeros(2, device=lo.device)]).contiguous()
    return ListedInputs(
        tabs=tabs, stream=stream,
        sph_list=None if tile_ids is None else _prep_list(tile_ids, n),
        tri_list=None if tri_tile_ids is None else _prep_list(tri_tile_ids,
                                                              n),
        sph_fan=int(sph_fan), tri_fan=int(tri_fan), bbox=bbox)


def _group_rays(r: _Rays, group: int) -> _Rays:
    """[k * group, 1] ray columns -> [k, group, 1]."""
    return _Rays(*(getattr(r, f.name).reshape(-1, group, 1)
                   for f in dataclasses.fields(_Rays)))


def _t_cap(r: _Rays, bbox: Tensor) -> Tensor:
    """Each ray's early-exit cap, the scene-bbox exit (every hit point lies
    in the union of the prim AABBs), with the kernel's slack."""
    lo_x, lo_y, lo_z, hi_x, hi_y, hi_z = (bbox[k] for k in range(6))
    ex = [torch.maximum((lo - oc[..., 0]) * ic[..., 0],
                        (hi - oc[..., 0]) * ic[..., 0])
          for lo, hi, oc, ic in ((lo_x, hi_x, r.ox, r.ix),
                                 (lo_y, hi_y, r.oy, r.iy),
                                 (lo_z, hi_z, r.oz, r.iz))]
    t_exit = torch.minimum(torch.minimum(ex[0], ex[1]), ex[2])
    return torch.clamp(t_exit, min=0.0) * (1.0 + 1e-4) + 1e-3


def _fold(t: Tensor, pids: Tensor, active: Tensor, t_best: Tensor,
          pid: Tensor):
    """Fold a [..., L] block of tests, in stream order, into the running
    minimum: the first minimum of the block, then the kernel's strict <."""
    t_c, k_c = t.min(dim=-1)
    upd = active & (t_c < t_best)
    return (torch.where(upd, t_c, t_best),
            torch.where(upd, pids.expand(t.shape).gather(
                -1, k_c[..., None])[..., 0], pid))


def _dense_plain(r: _Rays, tab: Tensor, count: int, pid0: int, test,
                 active, t_best, pid):
    """B4's scan of one class, prims [0, count), in chunks of prims."""
    step = max(1, PLAIN_CHUNK_ELEMS // max(active.numel(), 1))
    for k0 in range(0, count, step):
        k1 = min(count, k0 + step)
        pids = torch.arange(pid0 + k0, pid0 + k1, device=tab.device)
        t_best, pid = _fold(test(r, tab[:, k0:k1]), pids, active, t_best,
                            pid)
    return t_best, pid


def _listed_plain(r: _Rays, ids: Tensor, tlo: Tensor, fan: int, tab: Tensor,
                  pid0: int, test, active, t_cap, t_best, pid, slots):
    """Stream each exit group's list row (the kernel's ``ListCursor``):
    rows [G, group] of rays, ``ids``/``tlo`` [G, cols] the row each group
    streams; ``slots`` [G] counts the list slots each group streamed."""
    g, cols = ids.shape
    dev = ids.device
    lane = torch.arange(BLOCK_K, device=dev)
    spread = torch.arange(fan, device=dev)

    def horizon(bi):
        return torch.where(active[bi], torch.minimum(t_best[bi], t_cap[bi]),
                           -_INF).max(dim=1).values

    every = torch.arange(g, device=dev)
    open_ = (cols > 0) & (tlo[:, 0] <= horizon(every))
    j = 0
    while bool(open_.any()):
        bi = torch.nonzero(open_).flatten()
        tiles = (ids[bi, j:j + CHUNK_T, None] * fan + spread).reshape(
            bi.shape[0], -1)
        prims = (tiles[:, :, None] * BLOCK_K + lane).reshape(
            bi.shape[0], 1, -1)                              # [b, 1, L]
        rb = _Rays(*(getattr(r, f.name)[bi] for f in dataclasses.fields(_Rays)))
        t = test(rb, tab[:, prims])                          # [b, R, L]
        t_best[bi], pid[bi] = _fold(t, pid0 + prims, active[bi], t_best[bi],
                                    pid[bi])
        slots[bi] += CHUNK_T
        j += CHUNK_T
        open_[bi] = ((j < cols) & (tlo[bi, min(j, cols - 1)]
                                   <= horizon(bi)))
    return t_best, pid


def _list_rows(li: ListedInputs, n: int) -> int:
    rows = max(-(-n // BLOCK_R), 1)
    for lst in (li.sph_list, li.tri_list):
        if lst is not None:
            rows = lst[0].shape[0]
    return rows


def nearest_hit_listed_plain(scene: Scene, org: Tensor, dir: Tensor,
                             n_live=None, tile_ids=None, tri_tile_ids=None,
                             sph_fan: int = 1, tri_fan: int = 1,
                             work: bool = False, inputs=None,
                             group: int = 32):
    """Plain version of B6 -> (t [N], pid [N]) (+ ``slots`` [rows, 128 /
    group, 2], the list slots each exit group streamed per listed class,
    when ``work``).

    Block b = rays [128 b, 128 b + 128) has list row b. Each exit group of
    ``group`` rays in it (32, the kernel's warp, by default; 128, the
    whole block, is the first design) streams spheres (listed or dense),
    boxes (dense), triangles (listed or dense), each prim folded with a
    strict ``<`` in stream order, so a t tie goes to the prim streamed
    first. A listed class stops once the next chunk's t_lo exceeds the
    group's horizon, the largest over its rays of min(t_best, bbox-exit
    cap). The row is conservative for the block, hence for any group in
    it, so t and pid do not depend on ``group``; the slots streamed do.
    Rows at or past ``n_live`` report (+inf, -1) and take no part in a
    horizon (the reference computes them and lets its caller mask them).
    ``inputs`` is a prebuilt :func:`listed_inputs`.
    """
    _check_group(group)
    n = org.shape[0]
    dev = org.device
    li = inputs or listed_inputs(scene, n, tile_ids, tri_tile_ids, sph_fan,
                                 tri_fan)
    tabs = li.tabs
    live = n if n_live is None else min(int(n_live), n)
    sub = BLOCK_R // group
    slots = torch.zeros((_list_rows(li, n), sub, 2), dtype=torch.int32,
                        device=dev)
    t_out = torch.full((n,), _INF, dtype=torch.float32, device=dev)
    pid_out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    live_blk = -(-live // BLOCK_R)
    widest = max(BLOCK_K * CHUNK_T * max(li.sph_fan, li.tri_fan),
                 tabs.n_box, 1)
    per = max(1, PLAIN_CHUNK_ELEMS // (BLOCK_R * widest))
    for b0 in range(0, live_blk, per):
        b1 = min(live_blk, b0 + per)
        g = b1 - b0
        r0, r1 = b0 * BLOCK_R, min(b1 * BLOCK_R, n)
        o = torch.zeros((g * BLOCK_R, 3), dtype=torch.float32, device=dev)
        d = torch.ones((g * BLOCK_R, 3), dtype=torch.float32, device=dev)
        o[:r1 - r0] = org[r0:r1]
        d[:r1 - r0] = dir[r0:r1]
        r = _group_rays(_rays(o, d), group)
        row = torch.arange(r0, r0 + g * BLOCK_R, device=dev).reshape(
            -1, group)
        active = row < live
        t_cap = _t_cap(r, li.bbox)
        t_best = torch.full(row.shape, _INF, dtype=torch.float32, device=dev)
        pid = torch.full(row.shape, -1, dtype=torch.int64, device=dev)
        s = torch.zeros((g * sub, 2), dtype=torch.int32, device=dev)
        classes = ((li.sph_list, li.sph_fan, tabs.sph, tabs.n_sph, 0,
                    _sphere_dense),
                   (None, 1, tabs.box, tabs.n_box, tabs.n_sph, _box),
                   (li.tri_list, li.tri_fan, tabs.tri, tabs.n_tri,
                    tabs.n_sph + tabs.n_box, _tri))
        for k, (lst, fan, tab, count, pid0, test) in enumerate(classes):
            if lst is None:
                t_best, pid = _dense_plain(r, tab, count, pid0, test, active,
                                           t_best, pid)
            else:
                ids, tlo = (x[b0:b1].repeat_interleave(sub, dim=0)
                            for x in lst)
                t_best, pid = _listed_plain(
                    r, ids.long(), tlo, fan, tab, pid0, test, active, t_cap,
                    t_best, pid, s[:, k // 2])
        slots[b0:b1] = s.reshape(g, sub, 2)
        t_best = torch.where(active, t_best, _INF).reshape(-1)[:r1 - r0]
        t_out[r0:r1] = t_best
        pid_out[r0:r1] = torch.where(t_best < _INF, pid.reshape(-1)[:r1 - r0],
                                     -1).to(torch.int32)
    return (t_out, pid_out, slots) if work else (t_out, pid_out)


def listed_need(li: ListedInputs, org: Tensor, dir: Tensor, t: Tensor,
                n_live=None) -> Tensor:
    """The list slots each ray needs, given its final nearest hit ``t``
    [N] -> [N, 2] i32 (spheres, triangles): the slots of its block's row
    whose t_lo is at most its own min(t, bbox-exit cap), rounded up to
    whole CHUNK_T chunks (the least any exit rule streams for that ray);
    0 for a class streamed dense and for rows at or past ``n_live``."""
    n = org.shape[0]
    live = n if n_live is None else min(int(n_live), n)
    need = torch.zeros((n, 2), dtype=torch.int32, device=org.device)
    nb = -(-live // BLOCK_R)
    if nb == 0:
        return need
    pad = nb * BLOCK_R - live
    r = _group_rays(_rays(torch.cat([org[:live], org.new_zeros((pad, 3))]),
                          torch.cat([dir[:live], dir.new_ones((pad, 3))])),
                    BLOCK_R)
    reach = torch.minimum(torch.cat([t[:live], t.new_full((pad,), -_INF)])
                          .reshape(nb, BLOCK_R), _t_cap(r, li.bbox))
    for k, lst in enumerate((li.sph_list, li.tri_list)):
        if lst is None:
            continue
        count = torch.searchsorted(lst[1][:nb], reach, right=True)
        need[:live, k] = (-(-count // CHUNK_T) * CHUNK_T).reshape(-1)[
            :live].to(torch.int32)
    return need


def launch_listed(li: ListedInputs, org: Tensor, dir: Tensor,
                  n_live: Optional[Tensor] = None, work: bool = False):
    """Launch B6 on the current stream -> (t [N], pid [N]) (+ ``slots``
    [rows, 4, 2], the list slots each warp streamed, when ``work``);
    ``n_live`` is a [1] int32 device tensor (None: every row), so the count
    never syncs to the host. Does not synchronize."""
    dev = org.device
    if dev.type != "cuda":
        raise ValueError(f"the nearest-hit kernels need CUDA tensors, got "
                         f"{dev}")
    n = org.shape[0]
    f32, i32 = torch.float32, torch.int32
    args = _stream_table_args(li.stream, dev)
    _build.need(org, "org", f32, (n, 3), dev)
    _build.need(dir, "dir", f32, (n, 3), dev)
    _build.need(li.bbox, "bbox", f32, (8,), dev)
    n_blk = -(-n // BLOCK_R)
    list_args = []
    for name, lst, fan in (("sphere list", li.sph_list, li.sph_fan),
                           ("triangle list", li.tri_list, li.tri_fan)):
        if lst is None:
            list_args += [None, None, 0, 1]
            continue
        ids, tlo = lst
        if ids.shape[0] < n_blk or ids.shape[1] % CHUNK_T:
            raise ValueError(f"{name} has shape {tuple(ids.shape)}")
        _build.need(ids, f"{name} ids", i32, tuple(ids.shape), dev)
        _build.need(tlo, f"{name} t_lo", f32, tuple(ids.shape), dev)
        list_args += [_build.ptr(ids), _build.ptr(tlo), ids.shape[1], fan]
    t = torch.full((n,), _INF, dtype=f32, device=dev)
    pid = torch.full((n,), -1, dtype=i32, device=dev)
    slots = (torch.zeros((_list_rows(li, n), BLOCK_R // 32, 2), dtype=i32,
                         device=dev) if work else None)
    if n == 0:
        return (t, pid, slots) if work else (t, pid)
    if n_live is None:
        n_live = torch.full((1,), n, dtype=i32, device=dev)
    _build.need(n_live, "n_live", i32, (1,), dev)
    lib = _build.load()
    err = lib.rt_nearest_hit_listed(
        *args, _build.ptr(org), _build.ptr(dir), n, _build.ptr(n_live),
        _build.ptr(li.bbox), *list_args, _build.ptr(t), _build.ptr(pid),
        _build.ptr(slots), dev.index, _build.stream(dev))
    _build.check(lib, err, "nh_listed_kernel")
    LAUNCHES["listed"] += 1
    return (t, pid, slots) if work else (t, pid)


def _stream_table_args(st: StreamTables, dev) -> list:
    """B4's, B6's and B8's table arguments, checked: the kernels copy the
    sphere and triangle tables in 16-byte pieces of whole tiles."""
    f32 = torch.float32
    _build.need(st.sph4, "sphere table", f32, (st.sph4.shape[0], 4), dev)
    _build.need(st.box, "box table", f32, (6, max(st.n_box, 1)), dev)
    _build.need(st.tri, "triangle table", f32, (9, st.tri.shape[1]), dev)
    for name, tab, width, count in (("sphere table", st.sph4,
                                     st.sph4.shape[0], st.n_sph),
                                    ("triangle table", st.tri,
                                     st.tri.shape[1], st.n_tri)):
        if width % BLOCK_K or width < count:
            raise ValueError(f"{name} is not padded to whole tiles: "
                             f"{width} for {count} prims")
        if tab.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    return [_build.ptr(st.sph4), st.n_sph, st.sph4.shape[0],
            _build.ptr(st.box), st.n_box, st.box.shape[1],
            _build.ptr(st.tri), st.n_tri, st.tri.shape[1]]


def launch_culled(st: StreamTables, org: Tensor, dir: Tensor,
                  tile_bounds: Tensor, n_live: Optional[Tensor] = None,
                  work: bool = False):
    """Launch B8 on the current stream -> (t [N], pid [N]) (+ ``tiles``
    [B, 4] i32, the sphere tiles each warp streamed, when ``work``);
    ``st`` and ``n_live`` as for :func:`launch_dense`. Does not
    synchronize."""
    dev = org.device
    if dev.type != "cuda":
        raise ValueError(f"the nearest-hit kernels need CUDA tensors, got "
                         f"{dev}")
    n = org.shape[0]
    _build.need(org, "org", torch.float32, (n, 3), dev)
    _build.need(dir, "dir", torch.float32, (n, 3), dev)
    n_t = -(-st.n_sph // BLOCK_K)
    if tile_bounds.shape[0] < n_t:
        raise ValueError(f"{tile_bounds.shape[0]} tile bounds cover fewer "
                         f"than {st.n_sph} spheres")
    tb = _build.need(tile_bounds[:max(n_t, 1)].contiguous(), "tile bounds",
                     torch.float32, (max(n_t, 1), 4), dev)
    t = torch.full((n,), _INF, dtype=torch.float32, device=dev)
    pid = torch.full((n,), -1, dtype=torch.int32, device=dev)
    tiles = (torch.zeros((-(-n // BLOCK_R), BLOCK_R // 32), dtype=torch.int32,
                         device=dev) if work else None)
    if n == 0 or st.n_prims == 0:
        return (t, pid, tiles) if work else (t, pid)
    args = _stream_table_args(st, dev)
    if n_live is None:
        n_live = torch.full((1,), n, dtype=torch.int32, device=dev)
    _build.need(n_live, "n_live", torch.int32, (1,), dev)
    lib = _build.load()
    err = lib.rt_nearest_hit_culled(*args, _build.ptr(org), _build.ptr(dir),
                                    n, _build.ptr(n_live), _build.ptr(tb),
                                    _build.ptr(t), _build.ptr(pid),
                                    _build.ptr(tiles), dev.index,
                                    _build.stream(dev))
    _build.check(lib, err, "nh_culled_kernel")
    LAUNCHES["culled"] += 1
    return (t, pid, tiles) if work else (t, pid)


def nearest_hit_pallas(scene: Scene, org: Tensor, dir: Tensor,
                       n_live: Union[int, Tensor, None] = None,
                       tile_bounds: Optional[Tensor] = None,
                       tile_ids=None, tri_tile_ids=None, sph_fan: int = 1,
                       tri_fan: int = 1) -> Tuple[Tensor, Tensor]:
    """Nearest hit -> (t [N], pid [N]), the drop-in for
    ``ops/trace.nearest_hit_brute``: B4 (dense), or B6 (listed) when
    ``tile_ids = (ids [B, T] i32, tlo [B, T] f32)`` or ``tri_tile_ids``
    is given (see :func:`nearest_hit_listed_plain`; the spheres or
    triangles must be in the tile order the ids index, ``B >= ceil(N /
    128)``, and each list row sorted by a conservative t_lo; ``sph_fan``/
    ``tri_fan`` make the ids supertiles of ``fan`` consecutive 128-prim
    tiles), or B8 (culled) when ``tile_bounds`` [T, 4] is given (see
    :func:`nearest_hit_culled_plain`). ``n_live`` (an int or a scalar
    tensor) declares that only the first ``n_live`` rays matter: rows at or
    past it report (+inf, -1). CUDA tensors launch the kernel; CPU tensors
    run the plain version.
    """
    on_cpu = _build.on_cpu(org.device)
    nl = None
    if n_live is not None and not on_cpu:
        nl = torch.as_tensor(n_live, device=org.device).reshape(1).to(
            torch.int32)
    if tile_ids is not None or tri_tile_ids is not None:
        if on_cpu:
            return nearest_hit_listed_plain(scene, org, dir, n_live, tile_ids,
                                            tri_tile_ids, sph_fan, tri_fan)
        li = listed_inputs(scene, org.shape[0], tile_ids, tri_tile_ids,
                           sph_fan, tri_fan)
        return launch_listed(li, org, dir, n_live=nl)
    if tile_bounds is not None:
        if on_cpu:
            return nearest_hit_culled_plain(scene, org, dir, tile_bounds,
                                            n_live)
        return launch_culled(stream_tables(pack_tables(scene)), org, dir,
                             tile_bounds, n_live=nl)
    if on_cpu:
        return nearest_hit_pallas_plain(scene, org, dir, n_live=n_live)
    return launch_dense(stream_tables(pack_tables(scene)), org, dir,
                        n_live=nl)
