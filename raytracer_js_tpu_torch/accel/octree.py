"""Flat Morton-coded octree acceleration structure (the OCTREE backend).

Port of ``raytracer_js_tpu.accel.octree``. The build quantizes every
primitive AABB to its *covering node*, the deepest axis-aligned cube cell
that fully contains it (``octree_entity.ts:60-79``), and splits the
primitives at ``l_cut``:

* **coarse set**: the few large, out-of-root or many-cell entities every
  ray tests by brute force (the ground box, the emitter);
* **fine grid**: every other entity scattered into a CSR ``cell -> entity
  ids`` table over the ``2^max_depth``-per-axis finest grid, covering every
  finest cell its AABB overlaps, with a chessboard-distance skip field.

Where each array is made: the prims' float32 AABBs are read to the host
(one ``rt.sync``), and host NumPy makes every float64 decision, the same
for every scene: ``root_lo`` and ``root_size`` (the median-based cube of
:func:`_small_inside`), the fine mask (:func:`grid_inputs`), the
``coarse_ids`` list, ``max_depth`` and ``l_cut``. The fine grid follows the
scene's device. A CPU scene takes the native scene kit's CSR scatter
(``native.grid_csr``) for ``cell_offsets``, ``cell_ids`` and
``max_per_cell``, and scipy's distance transform for ``skip_dist``. A scene
on the card makes those on the card (``kernels/octree_build``: the count,
a scan, one read of the pair total and the largest count, the fill and
sort, the three skip passes), from the AABBs already there, the uploaded
fine mask and the float32 root; the host path is its plain version. Either
way the arrays equal the reference package's bit for bit. The queries run
on that device: :func:`nearest_hit_octree` (a coarse brute pass, then a
grid DDA with the empty-space skip; on the card one kernel launch,
``kernels/octree_dda``, on the CPU its plain version
:func:`nearest_hit_octree_plain`, a Python loop over the still-live rays)
and :func:`point_query_candidates` (the substance query's candidate
superset, plain PyTorch). The structure is discrete: callers search under
``torch.no_grad`` on detached inputs, and an optimization loop rebuilds it
as geometry moves (``optim/fit``'s ``accel_every``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import native
from ..config import OctreeConfig
from ..kernels import _build, octree_build, octree_dda
from ..models.scene import Scene, prim_aabbs
from ..ops import intersect as I
from ..ops.vecmath import cross, dot
from ..utils.profiling import span

Tensor = torch.Tensor

_TENSORS = ("root_lo", "root_size", "coarse_ids", "cell_offsets", "cell_ids",
            "skip_dist")


@dataclasses.dataclass(frozen=True)
class OctreeAccel:
    #: root cube (covers every fine primitive's AABB)
    root_lo: Tensor         # [3] f32
    root_size: Tensor       # [] f32
    #: coarse: global prim ids tested by every ray, padded with -1
    coarse_ids: Tensor      # [Nc] i32
    #: fine grid CSR at resolution R = 2^max_depth
    cell_offsets: Tensor    # [R^3 + 1] i32
    cell_ids: Tensor        # [K] i32
    #: chessboard distance from each cell to the nearest occupied cell (0
    #: for occupied), capped at 255: the DDA jumps through proven-empty
    #: space instead of marching cell by cell. 0 exactly where the cell's
    #: CSR count is > 0: the search kernel reads a cell's offsets only
    #: where its skip is 0
    skip_dist: Tensor       # [R^3] u8
    max_depth: int = 4
    l_cut: int = 1
    max_per_cell: int = 8

    @property
    def res(self) -> int:
        return 1 << self.max_depth

    def to(self, device) -> "OctreeAccel":
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(device) for k in _TENSORS})


# ---------------------------------------------------------------------------
# Build (host NumPy; the fine grid on the scene's device)
# ---------------------------------------------------------------------------

def _morton3(ix: np.ndarray, iy: np.ndarray, iz: np.ndarray,
             bits: int) -> np.ndarray:
    """Interleave three ``bits``-bit coordinates into a Morton code (the
    reference's ``(z<<2)|(y<<1)|x`` octant code, octree_space.ts:45-49,
    applied across all levels at once)."""
    out = np.zeros_like(ix, dtype=np.int64)
    for b in range(bits):
        out |= ((ix >> b) & 1).astype(np.int64) << (3 * b)
        out |= ((iy >> b) & 1).astype(np.int64) << (3 * b + 1)
        out |= ((iz >> b) & 1).astype(np.int64) << (3 * b + 2)
    return out


def covering_levels(lo: np.ndarray, hi: np.ndarray, root_lo: np.ndarray,
                    root_size: float, max_depth: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-AABB covering node -> (level [P], cell [P,3] at that level): the
    deepest level whose aligned cell fully contains the AABB
    (``get_covering_node_for_entity``, octree_entity.ts:60-79), evaluated
    for all levels at once."""
    P = lo.shape[0]
    levels = np.arange(max_depth + 1)
    cell_sz = root_size / (1 << levels)                       # [L+1]
    rel_lo = (lo - root_lo)[:, None, :]                       # [P, 1, 3]
    rel_hi = (hi - root_lo)[:, None, :]
    cell = np.floor(rel_lo / cell_sz[None, :, None]).astype(np.int64)
    cell = np.clip(cell, 0, (1 << levels)[None, :, None] - 1)
    fits = np.all(rel_hi <= (cell + 1) * cell_sz[None, :, None] + 1e-7
                  * root_size, axis=-1)                       # [P, L+1]
    fits[:, 0] = True                                         # root always fits
    level = np.max(np.where(fits, levels[None, :], -1), axis=1)
    chosen = cell[np.arange(P), level]                        # [P, 3]
    return level.astype(np.int64), chosen


def _aabbs_f64(scene: Scene):
    """The float32 prim AABBs -> (lo, hi [P, 3] f32 on the scene's device,
    the same read as float64 on the host: an ``rt.sync`` span)."""
    lo, hi = (a.detach() for a in prim_aabbs(scene))
    with span("rt.sync"):
        lo_h, hi_h = lo.cpu(), hi.cpu()
    return (lo, hi, lo_h.numpy().astype(np.float64),
            hi_h.numpy().astype(np.float64))


def _small_inside(lo: np.ndarray, hi: np.ndarray):
    """The robust root: cubic, over the *small-entity population* (extent
    <= 8x the median), with a small margin -> (root_lo [3] f64, size,
    small [P], inside [P]). Oversized or out-of-root entities go to the
    coarse list, where huge straddlers belong anyway."""
    extent = (hi - lo).max(axis=1)
    med = np.median(extent)
    small = extent <= 8.0 * med + 1e-12
    if not small.any():
        small = np.ones_like(small)
    scene_lo = lo[small].min(axis=0)
    scene_hi = hi[small].max(axis=0)
    size = float((scene_hi - scene_lo).max()) * (1.0 + 1e-4) + 1e-6
    root_lo = scene_lo - 0.5 * (size - (scene_hi - scene_lo))
    inside = np.all(lo >= root_lo - 1e-6 * size, axis=1) & np.all(
        hi <= root_lo + size * (1 + 1e-6), axis=1)
    return root_lo, size, small, inside


def grid_inputs(lo: np.ndarray, hi: np.ndarray, max_depth: int):
    """What the CSR scatter takes for AABBs ``lo``/``hi`` [P, 3] (f64) ->
    ``(lo32, hi32, fine_mask [P], root_lo [3] f64, size)``. The scatter is
    overlap-based, so a small entity that straddles a high-level split
    plane still lives in the grid; coarse (``~fine_mask``) is for the
    entities that would bloat the CSR: huge, outside the root, or
    overlapping more than ``cell_cap`` finest cells."""
    R = 1 << max_depth
    root_lo, size, small, inside = _small_inside(lo, hi)
    cell_sz = size / R
    c_lo = np.clip(np.floor((lo - root_lo) / cell_sz), 0, R - 1).astype(int)
    c_hi = np.clip(np.floor((hi - root_lo) / cell_sz - 1e-9), 0,
                   R - 1).astype(int)
    n_cells = np.prod(c_hi - c_lo + 1, axis=1)
    cell_cap = 64
    fine_mask = small & inside & (n_cells <= cell_cap)
    return (lo.astype(np.float32), hi.astype(np.float32), fine_mask,
            root_lo, size)


def build_octree(scene: Scene, cfg: Optional[OctreeConfig] = None,
                 l_cut: Optional[int] = None,
                 like: Optional[OctreeAccel] = None) -> OctreeAccel:
    """Build the flat octree over a scene's primitive AABBs, on the scene's
    device: the fine grid on the card for a scene there, on the host for a
    CPU scene (the module docstring says which array is made where; the
    two give the same arrays).

    ``like`` pins the output to a previous accel's shapes (CSR id capacity,
    coarse capacity, per-cell bound), so a fit can rebuild it as geometry
    moves (``FitConfig.accel_every``); raises if the new build exceeds the
    pinned capacity (rebuild without ``like`` to grow). Raises "octree cell
    overflow" when a cell would list more entities than the scene has.
    """
    cfg = cfg or OctreeConfig()
    dev = scene.device
    lo_d, hi_d, lo, hi = _aabbs_f64(scene)
    P = lo.shape[0]
    L = int(cfg.max_depth)
    R = 1 << L
    if l_cut is None:
        l_cut = max(0, min(1, L - 1))

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    if P == 0:
        return OctreeAccel(
            root_lo=put(np.zeros(3), torch.float32),
            root_size=put(np.float32(1.0), torch.float32),
            coarse_ids=put(np.full((1,), -1), torch.int32),
            cell_offsets=put(np.zeros((R ** 3 + 1,)), torch.int32),
            cell_ids=put(np.zeros((0,)), torch.int32),
            skip_dist=put(np.full((R ** 3,), 255), torch.uint8),
            max_depth=L, l_cut=l_cut, max_per_cell=1)

    lo32, hi32, fine_mask, root_lo, size = grid_inputs(lo, hi, L)
    coarse = np.where(~fine_mask)[0].astype(np.int32)
    if coarse.size == 0:
        coarse = np.full((1,), -1, np.int32)
    rl32 = np.asarray(root_lo, np.float32)

    host = _build.on_cpu(dev)
    if host:
        offsets, cell_ids, max_per_cell = native.grid_csr(
            lo32, hi32, fine_mask, rl32, size, L)
        n_ids = cell_ids.size
    else:
        grid = (lo_d, hi_d, put(fine_mask, torch.uint8), rl32, size, L)
        offsets, n_ids, max_per_cell = octree_build.count(*grid)
    max_per_cell = max(1, max_per_cell)
    if max_per_cell > scene.n_prims:
        raise ValueError("octree cell overflow")

    capacity = n_ids
    if like is not None:
        if (n_ids > like.cell_ids.shape[0]
                or coarse.size > like.coarse_ids.shape[0]
                or max_per_cell > like.max_per_cell
                or L != like.max_depth):
            raise ValueError(
                "octree rebuild exceeds pinned capacity "
                f"(ids {n_ids}>{like.cell_ids.shape[0]} or coarse "
                f"{coarse.size}>{like.coarse_ids.shape[0]} or per-cell "
                f"{max_per_cell}>{like.max_per_cell}); rebuild without "
                "like=")
        capacity = like.cell_ids.shape[0]      # the padding is never indexed
        coarse = np.concatenate(
            [coarse, np.full(like.coarse_ids.shape[0] - coarse.size, -1,
                             coarse.dtype)])
        max_per_cell = like.max_per_cell

    if host:
        cell_ids = put(np.concatenate(
            [cell_ids, np.zeros(capacity - n_ids, cell_ids.dtype)]),
            torch.int32)
        skip = put(_skip_field_host(offsets, R), torch.uint8)
        offsets = put(offsets, torch.int32)
    else:
        cell_ids = octree_build.fill(*grid, offsets, capacity)
        skip = octree_build.skip_field(offsets, L)

    return OctreeAccel(
        root_lo=put(rl32, torch.float32),
        root_size=put(np.float32(size), torch.float32),
        coarse_ids=put(coarse, torch.int32),
        cell_offsets=offsets, cell_ids=cell_ids, skip_dist=skip,
        max_depth=L, l_cut=l_cut, max_per_cell=max_per_cell)


def _skip_field_host(offsets: np.ndarray, R: int) -> np.ndarray:
    """The empty-space skip field of a host CSR -> [R^3] u8: the chessboard
    distance to the nearest occupied cell, capped at u8; the NumPy
    fallback's lower cap only weakens the skip (a smaller distance promises
    less), never correctness."""
    occ = (np.diff(offsets) > 0).reshape(R, R, R)
    if not occ.any():
        return np.full((R ** 3,), 255, np.uint8)
    try:
        from scipy import ndimage

        dist = ndimage.distance_transform_cdt(~occ, metric="chessboard")
    except ImportError:
        dist = _chebyshev_dist_np(occ, cap=15)
    return np.minimum(dist, 255).astype(np.uint8).reshape(-1)


def _chebyshev_dist_np(occ: np.ndarray, cap: int = 15) -> np.ndarray:
    """Chessboard distance to the nearest occupied cell, NumPy only: one
    radius-1 box dilation per iteration; cells not reached after ``cap``
    steps report ``cap`` (an underestimate, conservative for the skip)."""
    cur = occ.copy()
    dist = np.where(occ, 0, cap).astype(np.int16)
    for d in range(1, cap):
        for ax in range(3):
            fwd = np.roll(cur, 1, axis=ax)
            bwd = np.roll(cur, -1, axis=ax)
            # zero the wrapped slab (roll is circular; the grid edge is not)
            sl = [slice(None)] * 3
            sl[ax] = 0
            fwd[tuple(sl)] = False
            sl[ax] = -1
            bwd[tuple(sl)] = False
            cur = cur | fwd | bwd
        newly = cur & (dist == cap)
        if not newly.any():
            break
        dist[newly] = d
    return dist.astype(np.int64)


def build_node_directory(scene: Scene, cfg: Optional[OctreeConfig] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Sorted (level, Morton) covering-node directory -> (levels, mortons):
    host-side, for inspection and :func:`walk_nodes`; traversal never
    reads it."""
    cfg = cfg or OctreeConfig()
    lo, hi = _aabbs_f64(scene)[2:]
    if lo.shape[0] == 0:
        return np.zeros((0,), np.int32), np.zeros((0,), np.int32)
    L = int(cfg.max_depth)
    accel = build_octree(scene, cfg)
    root_lo = accel.root_lo.cpu().numpy().astype(np.float64)
    size = float(accel.root_size)
    level, cell = covering_levels(lo, hi, root_lo, size, L)
    _, _, small, _ = _small_inside(lo, hi)
    inside = np.all(lo >= root_lo - 1e-6 * size, axis=1) & np.all(
        hi <= root_lo + size * (1 + 1e-6), axis=1)
    level = np.where(small & inside, level, 0)
    key = (level << (3 * L)) | _morton3(cell[:, 0], cell[:, 1], cell[:, 2], L)
    node_key = np.unique(key)
    return ((node_key >> (3 * L)).astype(np.int32),
            (node_key & ((1 << (3 * L)) - 1)).astype(np.int32))


# ---------------------------------------------------------------------------
# Per-(ray, candidate) primitive tests
# ---------------------------------------------------------------------------

def prim_hit_t(scene: Scene, org: Tensor, dir: Tensor, pid: Tensor) -> Tensor:
    """First forward hit parameter of primitive ``pid`` per lane; inf for
    pid < 0. Branchless type dispatch over the global [spheres | boxes |
    tris] order. Shapes: org/dir [..., 3] (broadcast against pid), pid
    [...] -> t [...]."""
    t = torch.full(pid.shape, float("inf"), dtype=org.dtype,
                   device=org.device)
    s_end = scene.n_spheres
    b_end = s_end + scene.n_boxes
    pid_c = torch.clamp(pid.long(), 0, max(scene.n_prims - 1, 0))
    if scene.n_spheres:
        i = torch.clamp(pid_c, 0, s_end - 1)
        c, r = scene.sphere_center[i], scene.sphere_radius[i]
        oc = org - c
        b_half = dot(oc, dir)
        a = dot(dir, dir)
        cc = dot(oc, oc) - r * r
        disc = b_half * b_half - a * cc
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        tn, tf = (-b_half - sq) / a, (-b_half + sq) / a
        ts = torch.where(tn >= 0, tn, torch.where(tf >= 0, tf, float("inf")))
        ts = torch.where(disc >= 0, ts, float("inf"))
        t = torch.where(pid_c < s_end, ts, t)
    if scene.n_boxes:
        i = torch.clamp(pid_c - s_end, 0, scene.n_boxes - 1)
        c, h = scene.box_center[i], scene.box_half[i]
        te, tx, _, _ = I._slab(org, dir, c - h, c + h)
        tb = torch.where(te >= 0, te, torch.where(tx >= 0, tx, float("inf")))
        tb = torch.where(te <= tx, tb, float("inf"))
        t = torch.where((pid_c >= s_end) & (pid_c < b_end), tb, t)
    if scene.n_tris:
        i = torch.clamp(pid_c - b_end, 0, scene.n_tris - 1)
        v0, v1, v2 = scene.tri_v0[i], scene.tri_v1[i], scene.tri_v2[i]
        e1, e2 = v1 - v0, v2 - v0
        pv = cross(dir, e2)
        det = dot(e1, pv)
        inv = 1.0 / torch.where(det.abs() < I.MT_EPS, I.MT_EPS, det)
        sv = org - v0
        u = dot(sv, pv) * inv
        qv = cross(sv, e1)
        v = dot(dir, qv) * inv
        tt = dot(e2, qv) * inv
        ok = ((det.abs() >= I.MT_EPS) & (u >= 0) & (v >= 0) & (u + v <= 1)
              & (tt >= 0))
        t = torch.where(pid_c >= b_end, torch.where(ok, tt, float("inf")), t)
    return torch.where(pid >= 0, t, float("inf"))


def prim_contains(scene: Scene, point: Tensor, pid: Tensor) -> Tensor:
    """Does primitive ``pid`` contain ``point``? (the ``is_within`` virtual,
    entity.ts:73-75; triangles have no interior; pid < 0 -> False). The
    same arithmetic as ``ops/trace.substance_refr_at``'s dense test.
    Shapes: point [..., 3], pid [...] -> bool [...]."""
    inside = torch.zeros(pid.shape, dtype=torch.bool, device=point.device)
    s_end = scene.n_spheres
    b_end = s_end + scene.n_boxes
    pid_c = torch.clamp(pid.long(), 0, max(scene.n_prims - 1, 0))
    if scene.n_spheres:
        i = torch.clamp(pid_c, 0, s_end - 1)
        diff = point - scene.sphere_center[i]
        d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] \
            + diff[..., 2] * diff[..., 2]
        r = scene.sphere_radius[i]
        inside = torch.where(pid_c < s_end, d2 <= r * r, inside)
    if scene.n_boxes:
        i = torch.clamp(pid_c - s_end, 0, scene.n_boxes - 1)
        rel = (point - scene.box_center[i]).abs()
        inside = torch.where((pid_c >= s_end) & (pid_c < b_end),
                             (rel <= scene.box_half[i]).all(dim=-1), inside)
    return inside & (pid >= 0)


def point_query_candidates(accel: OctreeAccel, point: Tensor) -> Tensor:
    """Candidate prim ids whose AABB may contain ``point`` -> [N, K + Nc]:
    the point's finest cell's CSR span (a fine entity containing p
    overlaps p's cell) then the coarse list, -1 for padding: a superset of
    the containing entities (``entity_at_pos``, octree_entity.ts:191-202)."""
    n = point.shape[0]
    R = accel.res
    cell_sz = accel.root_size / R
    rel = (point - accel.root_lo) / cell_sz
    in_root = ((rel >= 0.0) & (rel < R)).all(dim=-1)
    cell = torch.clamp(rel.to(torch.int32), 0, R - 1)          # truncating
    lin = ((cell[:, 0] * R + cell[:, 1]) * R + cell[:, 2]).long()
    base = accel.cell_offsets[lin]                             # [N]
    cnt = accel.cell_offsets[lin + 1] - base
    k = torch.arange(max(accel.max_per_cell, 1), dtype=torch.int32,
                     device=point.device)[None, :]
    nk = accel.cell_ids.shape[0]
    if nk:
        idx = torch.clamp(base[:, None] + k, 0, nk - 1).long()
        fine = torch.where((k < cnt[:, None]) & in_root[:, None],
                           accel.cell_ids[idx], -1)            # [N, K]
    else:
        fine = torch.full((n, 1), -1, dtype=torch.int32, device=point.device)
    coarse = accel.coarse_ids[None, :].expand(n, -1)
    return torch.cat([fine, coarse], dim=1)


# ---------------------------------------------------------------------------
# Traversal: the grid DDA (the OctreeWalker re-expression)
# ---------------------------------------------------------------------------

def _argmin_pid(t: Tensor, pid: Tensor) -> Tuple[Tensor, Tensor]:
    """Row minimum of ``t`` [n, k] and the pid at its first position."""
    t_min, j = t.min(dim=1)
    return t_min, pid.gather(1, j[:, None])[:, 0]


@torch.no_grad()
def nearest_hit_octree(scene: Scene, accel: OctreeAccel, org: Tensor,
                       dir: Tensor, stats: Optional[dict] = None,
                       per_ray: Optional[dict] = None,
                       live: Optional[Tensor] = None
                       ) -> Tuple[Tensor, Tensor]:
    """Nearest forward hit via the coarse brute pass and the fine-grid DDA
    -> (t [N], pid [N] i32, -1 on a miss).

    CPU tensors take :func:`nearest_hit_octree_plain`; CUDA tensors launch
    the search kernel (``kernels/octree_dda``: one launch for the whole
    search, one thread a ray, no sync), which equals the plain loop bit
    for bit in t, pid and each ray's steps; any other device raises.
    ``live`` ([N] bool, None for every ray) marks the rays whose
    answer the caller reads: the others take no walk and get t = +inf, pid
    -1 and 0 steps and tests. ``stats`` (a dict) receives ``steps`` (the
    most steps of a ray), ``ray_steps`` (the steps summed over the rays)
    and ``tests`` (the candidate tests summed over the rays: each ray's
    coarse ids >= 0 and each step's cell count); ``per_ray`` (a dict)
    receives them per ray, ``steps`` and ``tests`` [N] i32. Only a call
    with ``stats`` reads the counts back to the host.
    """
    if _build.on_cpu(org.device):
        return nearest_hit_octree_plain(scene, accel, org, dir, stats,
                                        per_ray, live)
    t, pid, steps, tests = octree_dda.launch(scene, accel, org.contiguous(),
                                             dir.contiguous(), live)
    if stats is not None:
        stats.update(steps=int(steps.max()) if steps.numel() else 0,
                     ray_steps=int(steps.sum()), tests=int(tests.sum()))
    if per_ray is not None:
        per_ray.update(steps=steps, tests=tests)
    return t, pid


@torch.no_grad()
def nearest_hit_octree_plain(scene: Scene, accel: OctreeAccel, org: Tensor,
                             dir: Tensor, stats: Optional[dict] = None,
                             per_ray: Optional[dict] = None,
                             live: Optional[Tensor] = None
                             ) -> Tuple[Tensor, Tensor]:
    """The plain version of :func:`nearest_hit_octree` (same arguments and
    results): a Python loop over the still-live rays. A ray that ``live``
    marks dead keeps the coarse pass's initial miss and never walks.

    The DDA enumerates the finest cells a ray pierces near to far (the
    reference walker's order, test/octree-space-walker.test.ts:22-71) and
    stops a ray once its best hit precedes its current position: one
    batched [live rays, max_per_cell] candidate test per step, at most
    ``3R + 2`` steps. Each step works on the rays still live, gathered to
    the front (a ``torch.nonzero``, which waits for the device); every
    ray's arithmetic is that of the reference's full-width masked loop, so
    (t, pid) are the same bit for bit.
    """
    n = org.shape[0]
    dev = org.device
    R = accel.res
    cell_sz = accel.root_size / R
    counting = stats is not None or per_ray is not None
    if counting:
        # each ray's steps and candidate tests: the coarse ids >= 0, then
        # each step's cell count
        n_steps = torch.zeros((n,), dtype=torch.int32, device=dev)
        n_tests = torch.full((n,), int((accel.coarse_ids >= 0).sum()),
                             dtype=torch.int32, device=dev)
        if live is not None:
            n_tests = torch.where(live, n_tests, 0)

    def count(steps, ray_steps):
        if stats is not None:
            stats.update(steps=steps, ray_steps=ray_steps,
                         tests=int(n_tests.sum()))
        if per_ray is not None:
            per_ray.update(steps=n_steps, tests=n_tests)

    # --- coarse brute pass ------------------------------------------------
    t_best = torch.full((n,), float("inf"), dtype=org.dtype, device=dev)
    pid_best = torch.full((n,), -1, dtype=torch.int32, device=dev)
    nc = accel.coarse_ids.shape[0]
    if nc:
        ids = accel.coarse_ids[None, :].expand(n, nc)
        t0, p0 = _argmin_pid(prim_hit_t(scene, org[:, None, :],
                                        dir[:, None, :], ids), ids)
        upd = t0 < t_best
        if live is not None:
            upd = upd & live
        t_best = torch.where(upd, t0, t_best)
        pid_best = torch.where(upd & torch.isfinite(t0), p0, pid_best)
    if accel.cell_ids.shape[0] == 0:
        if counting:
            count(0, 0)
        return t_best, pid_best

    # --- fine-grid DDA with empty-space skipping --------------------------
    inv = 1.0 / torch.where(dir.abs() < 1e-12,
                            torch.where(dir < 0, -1e-12, 1e-12), dir)
    lo = accel.root_lo
    hi = accel.root_lo + accel.root_size
    ta = (lo - org) * inv
    tb = (hi - org) * inv
    t_enter = torch.minimum(ta, tb).max(dim=-1).values
    t_exit = torch.maximum(ta, tb).min(dim=-1).values
    t_cur = torch.clamp(t_enter, min=0.0)
    step_pos = (dir >= 0).to(org.dtype)                          # [N, 3]
    #: time to cross one chessboard ring of cells (max-axis speed)
    dt_cheb = cell_sz / dir.abs().max(dim=-1).values             # [N]
    eps_t = 1e-4 * dt_cheb
    nk = accel.cell_ids.shape[0]
    j = torch.arange(accel.max_per_cell, dtype=torch.int32, device=dev)

    walk = t_cur <= t_exit
    if live is not None:
        walk = walk & live
    rows = torch.nonzero(walk).flatten()
    # the walking rays' state, gathered to the front
    o, d, iv, sp = org[rows], dir[rows], inv[rows], step_pos[rows]
    tc, tx, dtc, et = t_cur[rows], t_exit[rows], dt_cheb[rows], eps_t[rows]
    tbl, pbl = t_best[rows], pid_best[rows]
    steps = ray_steps = 0
    for _ in range(3 * R + 2):
        if rows.numel() == 0:
            break
        steps += 1
        ray_steps += rows.numel()
        # position-based stepping: re-derive the cell from the current
        # param (jumps make incremental per-axis bookkeeping moot)
        p = o + (tc + et)[:, None] * d
        cell = torch.clamp(torch.floor((p - lo) / cell_sz).to(torch.int32),
                           0, R - 1)                             # [n, 3]
        lin = ((cell[:, 0] * R + cell[:, 1]) * R + cell[:, 2]).long()
        base = accel.cell_offsets[lin]
        cnt = accel.cell_offsets[lin + 1] - base
        if counting:
            n_steps[rows] += 1
            n_tests[rows] += torch.clamp(cnt, max=accel.max_per_cell)
        idx = torch.clamp(base[:, None] + j[None, :], 0, nk - 1).long()
        pid = torch.where(j[None, :] < cnt[:, None], accel.cell_ids[idx],
                          -1)                                    # [n, K]
        t_min, pid_min = _argmin_pid(
            prim_hit_t(scene, o[:, None, :], d[:, None, :], pid), pid)
        upd = t_min < tbl
        tbl = torch.where(upd, t_min, tbl)
        pbl = torch.where(upd, pid_min, pbl)
        # advance at least to the current cell's exit; through empty
        # space jump k - 2 rings: the skip field proves no occupied cell
        # within k - 1 rings, and a ray crosses at most floor(tau /
        # dt_cheb) + 1 rings in time tau
        nb = lo + (cell.to(o.dtype) + sp) * cell_sz
        t_exit_cell = ((nb - o) * iv).min(dim=-1).values
        k = accel.skip_dist[lin].to(o.dtype)
        t_jump = tc + torch.clamp(k - 2.0, min=0.0) * dtc
        t_new = torch.maximum(torch.maximum(t_exit_cell, t_jump), tc + et)
        done = (~torch.isinf(tbl) & (tbl <= t_new)) | (t_new > tx)
        t_best[rows] = tbl
        pid_best[rows] = pbl
        keep = torch.nonzero(~done).flatten()
        rows = rows[keep]
        o, d, iv, sp = o[keep], d[keep], iv[keep], sp[keep]
        tc, tx, dtc, et = t_new[keep], tx[keep], dtc[keep], et[keep]
        tbl, pbl = tbl[keep], pbl[keep]
    if counting:
        count(steps, ray_steps)
    pid_best = torch.where(torch.isfinite(t_best), pid_best, -1)
    return t_best, pid_best


# ---------------------------------------------------------------------------
# Host walkers (tests)
# ---------------------------------------------------------------------------

def walk_nodes(accel: OctreeAccel, directory, org, dir,
               max_steps: Optional[int] = None):
    """Occupied-node itinerary of one ray, near -> far (host-side, tests):
    ``(level, (cx, cy, cz))`` stops in the reference walker's order
    (test/octree-space-walker.test.ts:38-71): ancestors before
    descendants, near before far, each node once. ``directory`` is
    :func:`build_node_directory`'s (levels, mortons)."""
    L = accel.max_depth
    levels, mortons = directory
    keys = {(int(l), int(m)) for l, m in zip(levels, mortons)}
    seen = set()
    out = []
    for cell in walk_cells(accel, org, dir, max_steps):
        for lvl in range(0, L + 1):
            shift = L - lvl
            c = tuple(int(x) >> shift for x in cell)
            m = int(_morton3(np.array([c[0]]), np.array([c[1]]),
                             np.array([c[2]]), L)[0])
            k = (lvl, m)
            if k in keys and k not in seen:
                seen.add(k)
                out.append((lvl, c))
    return out


def octant_code(cell) -> int:
    """Reference octant bit code ``(z << 2) | (y << 1) | x``
    (octree_space.ts:45-49) of a depth-1 cell."""
    x, y, z = cell
    return (int(z) << 2) | (int(y) << 1) | int(x)


def walk_cells(accel: OctreeAccel, org, dir, max_steps: Optional[int] = None):
    """Finest-cell itinerary of one ray, near -> far (host-side, tests):
    the cells the ray pierces in order (test/octree-space-walker.test.ts)."""
    org = np.asarray(org, np.float64)
    dir = np.asarray(dir, np.float64)
    R = accel.res
    lo = accel.root_lo.cpu().numpy().astype(np.float64)
    size = float(accel.root_size)
    cell_sz = size / R
    inv = 1.0 / np.where(np.abs(dir) < 1e-12,
                         np.where(dir < 0, -1e-12, 1e-12), dir)
    ta = (lo - org) * inv
    tb = (lo + size - org) * inv
    t_enter = np.max(np.minimum(ta, tb))
    t_exit = np.min(np.maximum(ta, tb))
    t = max(t_enter, 0.0) + 1e-9
    if t > t_exit:
        return []
    cell = np.clip(((org + t * dir - lo) / cell_sz).astype(int), 0, R - 1)
    step = np.where(dir >= 0, 1, -1).astype(int)
    nb = lo + (cell + (step > 0)) * cell_sz
    t_next = (nb - org) * inv
    out = []
    for _ in range(max_steps or (3 * R + 2)):
        out.append(tuple(cell))
        ax = int(np.argmin(t_next))
        if t_next[ax] > t_exit:
            break
        cell = cell.copy()
        cell[ax] += step[ax]
        if cell[ax] < 0 or cell[ax] >= R:
            break
        t_next = t_next.copy()
        t_next[ax] += cell_sz * abs(inv[ax])
    return out
