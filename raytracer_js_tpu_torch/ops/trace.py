"""Fixed-depth iterative wavefront trace loop — the BRUTE and PALLAS backends.

Port of ``raytracer_js_tpu.ops.trace``: ``refmax`` masked passes over
structure-of-arrays ray state — traverse, intersect, shade, respawn — with
an explicit per-ray status word (raytracer.ts:166-277). The nearest-hit
search is dense PyTorch (BRUTE), kernels B3/B4 (PALLAS,
``kernels/nearest_hit``) or the octree's grid DDA (OCTREE with an
``accel``, ``accel/octree``). It is also the semantic reference for the fused
kernel's plain versions (``kernels/trace_fused``).

Behavioral contract (reference source in parentheses):

* a hit modulates the ray color by the texture color at the hit's uv
  (material_solid.ts:30-36) and adds the hit distance to the path
  (raytracer.ts:210);
* emissive hit -> LIGHT; at the end the color is scaled by
  ``1/(eps + (path * A)^2)`` (raytracer.ts:215-218, 273-275);
* mirror REFLECTION -> reflect, roughness scatter, eps-advance along the NEW
  direction (raytracer.ts:231-236); non-mirror REFLECTION -> KEEP;
* TRANSMISSION -> eps-advance along the OLD direction, refract into the
  innermost containing entity's substance, TIR reflects; an undefined
  substance means no refraction (raytracer.ts:239-248);
* BOTH -> KEEP, or with ``RenderConfig.fresnel_both`` a Schlick split drawn
  from the counter RNG;
* miss -> color times sky (equirect or cube map), MISS; alive after
  ``refmax`` bounces -> black.

The frontends above this loop take two helpers from here: the substance
at the camera (:func:`start_substance`) and the refusal of inputs that
require grad by the backends without a backward (:func:`refuse_grad`).

On CUDA tensors a scene of the shade kernel's class (``kernels/shade``:
solid textures and sky, no transmission) shades each bounce in one launch
of that kernel, the last bounce with the epilogue, when autograd would
record nothing; ``_shade`` below is its plain twin, which every other case
takes.

Autograd: the hit search is discrete and runs under ``torch.no_grad()`` on
detached inputs; gradients flow only through the surface recompute
(``ops/intersect`` ``*_surface``), the color products, the inverse-square
law and the sky and texture lookups. Path replay: :func:`record_paths`
records the winner per bounce (``pid_seq [N, refmax]``) and
``trace_rays(..., pid_seq=...)`` replays it without any search — the same
values and gradients as the search path, since the search result carries
no gradient there either.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..accel import octree
from ..config import (EPS_ADVANCE, JS_EPSILON, HitBackend, RayStatus,
                      RenderConfig, ResponseType)
from ..kernels import nearest_hit as nh
from ..kernels import shade as shade_kernel
from ..models import textures as tex_mod
from ..models.scene import Scene, prim_volumes, records_grad
from ..utils.profiling import span
from . import intersect, sampling
from .vecmath import reflect, refract, uv_map_sphere

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class RayState:
    """Structure-of-arrays wavefront state (raytracer.ts:55-99)."""

    org: Tensor      # [N, 3] current origin
    dir: Tensor      # [N, 3] direction
    color: Tensor    # [N, 3] accumulated modulation (starts white)
    path: Tensor     # [N] path distance for the inverse-square law
    refr: Tensor     # [N] current substance refractive index
    status: Tensor   # [N] i32 RayStatus


# ---------------------------------------------------------------------------
# Nearest hit
# ---------------------------------------------------------------------------

@torch.no_grad()
def nearest_hit_brute(scene: Scene, org: Tensor,
                      dir: Tensor) -> Tuple[Tensor, Tensor]:
    """Dense nearest forward hit: [N] rays x all prims -> (t [N], pid [N]).

    ``pid`` indexes the global [spheres|boxes|tris] order, -1 on a miss; on
    a tie in t the lowest pid wins (``min`` returns the first index).
    """
    n = org.shape[0]
    if scene.n_prims == 0:
        return (torch.full((n,), float("inf"), device=org.device),
                torch.full((n,), -1, dtype=torch.int32, device=org.device))
    t_all = torch.cat([
        intersect.sphere_hit_t(org, dir, scene.sphere_center,
                               scene.sphere_radius),
        intersect.box_hit_t(org, dir, scene.box_center, scene.box_half),
        intersect.tri_hit_t(org, dir, scene.tri_v0, scene.tri_v1,
                            scene.tri_v2)], dim=1)                 # [N, P]
    t, pid = t_all.min(dim=1)
    pid = torch.where(torch.isfinite(t), pid, -1).to(torch.int32)
    return t, pid


def nearest_hit(scene: Scene, cfg: RenderConfig, org: Tensor,
                dir: Tensor, accel=None,
                live: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Backend dispatch for the nearest-hit search; ``accel`` is the
    OCTREE backend's ``accel/octree.OctreeAccel``. ``live`` ([N] bool) marks
    the rays whose answer the caller reads: the OCTREE search walks only
    those (the others get a miss); the other searches answer every ray."""
    if cfg.backend == HitBackend.OCTREE and accel is not None:
        # discrete, as PALLAS: detached inputs, no graph
        with torch.no_grad():
            return octree.nearest_hit_octree(scene, accel, org.detach(),
                                             dir.detach(), live=live)
    if cfg.backend == HitBackend.PALLAS:
        # the search is discrete: detached inputs, no graph. Kernel B3
        # streams prims one at a time (1..384 prims); B4 tiles them
        # (larger scenes, and the empty one)
        org, dir = org.detach(), dir.detach()
        with torch.no_grad():
            if 0 < scene.n_prims <= nh.SCALAR_MAX_PRIMS:
                return nh.nearest_hit_pallas_scalar(scene, org, dir)
            return nh.nearest_hit_pallas(scene, org, dir)
    if cfg.backend not in (HitBackend.BRUTE, HitBackend.OCTREE,
                           HitBackend.FUSED):
        raise ValueError(f"unknown backend {cfg.backend}")
    # BRUTE, OCTREE without an accel (the reference's dense fallback) and
    # FUSED reaching this loop for off-class scenes (BOTH) all take the
    # dense search
    return nearest_hit_brute(scene, org, dir)


# ---------------------------------------------------------------------------
# Per-primitive attributes and the surface recompute
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PrimRows:
    """Shading attributes per primitive, in global prim order."""

    #: [P, 3] solid texture color, pre-joined only when the scene has no
    #: image textures (image scenes sample per hit at the hit's uv)
    rgb: Optional[Tensor]
    light: Tensor      # [P] bool
    mirror: Tensor     # [P] bool
    response: Tensor   # [P] i32 ResponseType
    roughness: Tensor  # [P] f32


def prim_rows(scene: Scene) -> Optional[PrimRows]:
    """Join the material and texture tables onto the primitives (None for
    an empty scene)."""
    if scene.n_prims == 0:
        return None
    mat_id = scene.prim_material.long()
    m = scene.materials
    return PrimRows(
        rgb=(None if scene.textures.has_images else
             scene.textures.solid_rgb[scene.prim_texture.long()]),
        light=m.light.index_select(0, mat_id),
        mirror=m.mirror.index_select(0, mat_id),
        response=m.response.index_select(0, mat_id),
        roughness=m.roughness.index_select(0, mat_id))


def surface_at(scene: Scene, org: Tensor, dir: Tensor, pid: Tensor):
    """(point, normal, u, v, t) of primitive ``pid`` per ray.

    Every present class recomputes on every ray from its class row of the
    clamped pid; the winner is picked by the pid range masks. Miss lanes
    (pid < 0) carry values that callers mask.
    """
    pid_c = torch.clamp(pid.long(), 0, max(scene.n_prims - 1, 0))
    s_end = scene.n_spheres
    b_end = s_end + scene.n_boxes
    point = torch.zeros_like(org)
    normal = torch.zeros_like(org)
    uu = torch.zeros_like(org[:, 0])
    vv = torch.zeros_like(uu)
    tt = torch.zeros_like(uu)

    def put(m, res):
        nonlocal point, normal, uu, vv, tt
        t, p, nrm, (u, v) = res
        point = torch.where(m[:, None], p, point)
        normal = torch.where(m[:, None], nrm, normal)
        uu = torch.where(m, u, uu)
        vv = torch.where(m, v, vv)
        tt = torch.where(m, t, tt)

    if scene.n_spheres:
        idx = torch.clamp(pid_c, 0, s_end - 1)
        put(pid_c < s_end, intersect.sphere_surface(
            org, dir, scene.sphere_center.index_select(0, idx),
            scene.sphere_radius.index_select(0, idx)))
    if scene.n_boxes:
        idx = torch.clamp(pid_c - s_end, 0, scene.n_boxes - 1)
        put((pid_c >= s_end) & (pid_c < b_end), intersect.box_surface(
            org, dir, scene.box_center.index_select(0, idx),
            scene.box_half.index_select(0, idx)))
    if scene.n_tris:
        idx = torch.clamp(pid_c - b_end, 0, scene.n_tris - 1)
        put(pid_c >= b_end, intersect.tri_surface(
            org, dir, scene.tri_v0.index_select(0, idx),
            scene.tri_v1.index_select(0, idx),
            scene.tri_v2.index_select(0, idx)))
    return point, normal, uu, vv, tt


# ---------------------------------------------------------------------------
# Substance point query (TRANSMISSION refraction target)
# ---------------------------------------------------------------------------

def substance_refr_at(scene: Scene, point: Tensor, cur_refr: Tensor,
                      accel=None):
    """Refraction target at ``point`` (octree_entity.ts:191-202 used at
    raytracer.ts:240-248) -> ``(target_refr [N], do_refract [N])``:

    * innermost containing entity (smallest volume, first on a tie) with a
      defined substance -> its index, refract;
    * innermost containing entity with an undefined substance -> keep the
      current index, no refraction;
    * no containing entity -> the scene default, refract.

    With ``accel`` the containment test runs over the grid-cell candidate
    superset (``accel/octree.point_query_candidates``) instead of the dense
    [N, P] matrices: mandatory for transmission at large prim counts (the
    dense bool alone is 209 GB at 1920x1088 rays against 100k prims).
    """
    n = point.shape[0]
    default = scene.default_refr.expand(n)
    if scene.n_prims == 0:
        return default, torch.ones((n,), dtype=torch.bool,
                                   device=point.device)
    if accel is not None:
        pid = octree.point_query_candidates(accel, point)          # [N, C]
        inside = octree.prim_contains(scene, point[:, None, :], pid)
        pid_c = torch.clamp(pid.long(), 0, scene.n_prims - 1)
        score = torch.where(inside, prim_volumes(scene)[pid_c],
                            float("inf"))
        ent = pid_c.gather(1, score.argmin(dim=1)[:, None])[:, 0]  # innermost
        return _substance_of(scene, ent, inside.any(dim=1), cur_refr,
                             default)
    diff = point[:, None, :] - scene.sphere_center[None, :, :]
    d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] \
        + diff[..., 2] * diff[..., 2]
    r2 = scene.sphere_radius * scene.sphere_radius
    rel = (point[:, None, :] - scene.box_center[None, :, :]).abs()
    inside = torch.cat([
        d2 <= r2[None, :],
        (rel <= scene.box_half[None, :, :]).all(dim=-1),
        torch.zeros((n, scene.n_tris), dtype=torch.bool,
                    device=point.device)], dim=1)                  # [N, P]
    score = torch.where(inside, prim_volumes(scene)[None, :], float("inf"))
    ent = score.argmin(dim=1)                                      # innermost
    return _substance_of(scene, ent, inside.any(dim=1), cur_refr, default)


def _substance_of(scene: Scene, ent: Tensor, any_inside: Tensor,
                  cur_refr: Tensor, default: Tensor):
    """The substance rule of :func:`substance_refr_at` for the innermost
    containing entity ``ent`` [N] (meaningless where not ``any_inside``)."""
    sub_id = scene.prim_substance.index_select(0, ent)
    defined = sub_id >= 0
    sub_refr = scene.sub_refr.index_select(
        0, torch.clamp(sub_id.long(), 0, scene.sub_refr.shape[0] - 1))
    target = torch.where(any_inside, torch.where(defined, sub_refr, cur_refr),
                         default)
    do_refract = torch.where(any_inside, defined, True)
    return target, do_refract


def start_substance(scene: Scene, pos: Tensor) -> Tensor:
    """Substance index at the camera position (raytracer.ts:312-313):
    innermost containing entity's substance, or the scene default."""
    refr, _ = substance_refr_at(scene, pos[None, :], scene.default_refr[None])
    return refr[0]


def refuse_grad(scene: Scene, *tensors: Tensor, backend: str = "FUSED"
                ) -> None:
    """Raise if autograd would record through a backend without a backward
    (FUSED, TILED): its kernels (and their plain versions) return detached
    values, so a loss through them would get zero or partial gradients
    without a word."""
    with span("rt.render.refuse_grad"):
        if records_grad(scene, *tensors):
            raise RuntimeError(
                f"the {backend} backend has no backward: an input requires "
                f"grad; render with HitBackend.PALLAS or HitBackend.BRUTE to "
                f"differentiate")


def sky_color(scene: Scene, dir: Tensor) -> Tensor:
    """Environment color for a direction.

    Sky sphere: equirect lookup (sky/sky_sphere.ts:22-27). With
    ``scene.sky_box`` set: cube-map lookup in the GL face convention mapped
    to this scene's axes (the reference's SkyBox is a stub,
    sky/sky_box.ts:17): faces (+x, -x, +y, -y, +z, -z) by the dominant
    |component| of ``dir``, with

        +x: (u,v) <- (-z/ax, -y/ax)   -x: (+z/ax, -y/ax)
        +y: (u,v) <- (+x/ay, +z/ay)   -y: (+x/ay, -z/ay)
        +z: (u,v) <- (+x/az, -y/az)   -z: (-x/az, -y/az)

    remapped from [-1, 1] to [0, 1).
    """
    if scene.sky_box is None:
        u, v = uv_map_sphere(dir)
        tex_id = torch.full(u.shape, scene.sky_tex, dtype=torch.int32,
                            device=dir.device)
        return tex_mod.sample(scene.textures, tex_id, u, v)
    x, y, z = dir[..., 0], dir[..., 1], dir[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    inv = 1.0 / torch.maximum(torch.maximum(ax, ay),
                              torch.clamp(az, min=1e-20))
    x_major = (ax >= ay) & (ax >= az)
    y_major = ~x_major & (ay >= az)

    def pick(px, nx, py, ny, pz, nz):
        return torch.where(x_major, torch.where(x >= 0, px, nx),
                           torch.where(y_major, torch.where(y >= 0, py, ny),
                                       torch.where(z >= 0, pz, nz)))

    face = pick(0, 1, 2, 3, 4, 5)
    sc = pick(-z, z, x, x, x, -x)
    tc = pick(-y, -y, z, -z, -y, -y)
    top = 1.0 - 2.0 ** -23
    u = torch.clamp(0.5 * (sc * inv + 1.0), 0.0, top)
    v = torch.clamp(0.5 * (tc * inv + 1.0), 0.0, top)
    face_tex = torch.tensor(scene.sky_box, dtype=torch.int32,
                            device=dir.device)
    return tex_mod.sample(scene.textures, face_tex[face], u, v)


# ---------------------------------------------------------------------------
# The bounce loop
# ---------------------------------------------------------------------------

def _winners(scene: Scene, cfg: RenderConfig, state: RayState,
             live: Optional[Tensor], pid_override: Optional[Tensor],
             accel) -> Tensor:
    """A bounce's winner per ray: ``pid_override``, else the nearest-hit
    search. A dead ray's answer is never read (every use of pid in the
    shade is masked by alive or by hit), so ``live`` goes to the search."""
    if pid_override is not None:
        return pid_override
    with span("rt.trace.search"):
        _t_hit, pid = nearest_hit(scene, cfg, state.org, state.dir, accel,
                                  live=live)
    return pid


def _bounce(scene: Scene, cfg: RenderConfig, state: RayState, rng,
            bounce, prows: Optional[PrimRows],
            pid_override: Optional[Tensor] = None, accel=None,
            live: Optional[Tensor] = None) -> RayState:
    """One wavefront pass: traverse -> intersect -> shade -> respawn.

    ``bounce`` is the RNG stream's bounce index: an int, or a per-ray [N]
    tensor (the TILED sweep rounds mix rays of several bounces).
    ``pid_override`` [N] supplies the winner per ray (-1 = miss) in place of
    the nearest-hit search: the path-replay mode. ``accel`` (the octree)
    serves the OCTREE search and the transmission substance query.
    ``live`` is the state's ALIVE mask where the caller has it."""
    alive = state.status == int(RayStatus.ALIVE) if live is None else live
    pid = _winners(scene, cfg, state, alive, pid_override, accel)
    with span("rt.trace.shade"):
        shade_kernel.count_plain(state.org.device)
        return _shade(scene, cfg, state, rng, bounce, prows, alive, pid,
                      accel)


def _bounce_kernel(scene: Scene, cfg: RenderConfig, state: RayState, rng,
                   bounce, live: Optional[Tensor] = None,
                   pid_override: Optional[Tensor] = None, last: bool = False,
                   accel=None) -> Tuple[RayState, Tensor]:
    """:func:`_bounce` with the shade kernel (``kernels/shade``), for a
    wavefront that :func:`shade_kernel.engages` admits -> (state, the next
    bounce's ALIVE mask). ``live`` is this bounce's ALIVE mask for the
    search (None: every ray, as at a trace's first bounce); ``last``
    applies :func:`trace_rays`'s epilogue in the same launch."""
    pid = _winners(scene, cfg, state, live, pid_override, accel)
    with span("rt.trace.shade"):
        org, dir, color, path, status, alive = shade_kernel.launch(
            scene, state.org, state.dir, state.color, state.path,
            state.status, pid, bounce, rng, last=last,
            atten=cfg.distance_attenuation_factor)
    return RayState(org=org, dir=dir, color=color, path=path,
                    refr=state.refr, status=status), alive


def _shader(scene: Scene, *tensors: Tensor, remat: bool = False):
    """How each bounce of a wavefront of these state ``tensors`` shades,
    chosen once: :func:`_bounce_kernel` where ``kernels/shade.engages``
    (never under ``remat``), else the plain :func:`_bounce` with the
    scene's prim rows built here (each bounce checkpointed under
    ``remat``). Either is called as ``shader(cfg, state, rng, bounce,
    live=None, pid_override=None, last=False, accel=None)`` -> (state, the
    next bounce's ALIVE mask, which the plain bounce leaves None where
    ``last``); ``live`` is this bounce's ALIVE mask, None where every ray
    is ALIVE or the plain bounce is to compute it; ``last`` applies
    :func:`_epilogue`."""
    if not remat and shade_kernel.engages(scene, *tensors):
        return functools.partial(_bounce_kernel, scene)
    prows = prim_rows(scene)

    def plain(cfg, state, rng, bounce, live=None, pid_override=None,
              last=False, accel=None):
        if remat:
            state = checkpoint(_bounce, scene, cfg, state, rng, bounce,
                               prows, pid_override, accel, live,
                               use_reentrant=False)
        else:
            state = _bounce(scene, cfg, state, rng, bounce, prows,
                            pid_override=pid_override, accel=accel,
                            live=live)
        if last:
            return _epilogue(cfg, state), None
        return state, state.status == int(RayStatus.ALIVE)

    return plain


def _shade(scene: Scene, cfg: RenderConfig, state: RayState, rng, bounce,
           prows: Optional[PrimRows], alive: Tensor, pid: Tensor,
           accel) -> RayState:
    """The rest of a :func:`_bounce` given the winners ``pid`` (-1 = miss)
    of the ``alive`` rays: the surface recompute, the gathers, shading and
    respawn."""
    hit = alive & (pid >= 0)

    if scene.n_prims == 0:
        sky = sky_color(scene, state.dir)
        color = torch.where(alive[:, None], state.color * sky, state.color)
        status = torch.where(alive, int(RayStatus.MISS), state.status)
        return dataclasses.replace(state, color=color, status=status)

    pid_cc = torch.clamp(pid.long(), 0, scene.n_prims - 1)
    point, normal, u, v, t_surf = surface_at(scene, state.org, state.dir,
                                             pid_cc)
    # alter_ray: color *= texture(uv) (material_solid.ts:30-36)
    if prows.rgb is None:
        tex_rgb = tex_mod.sample(scene.textures,
                                 scene.prim_texture.index_select(0, pid_cc),
                                 u, v)
    else:
        tex_rgb = prows.rgb.index_select(0, pid_cc)
    color = torch.where(hit[:, None], state.color * tex_rgb, state.color)
    path = torch.where(hit, state.path + t_surf, state.path)

    is_light = prows.light.index_select(0, pid_cc) & hit
    is_mirror = prows.mirror.index_select(0, pid_cc)
    response = prows.response.index_select(0, pid_cc)
    roughness = prows.roughness.index_select(0, pid_cc)
    is_refl = response == int(ResponseType.REFLECTION)
    is_trans = response == int(ResponseType.TRANSMISSION)

    # --- REFLECTION (mirror) ----------------------------------------------
    refl_dir = reflect(state.dir, normal)
    if scene.has_rough:
        seed, rid = rng
        refl_dir = sampling.scatter_direction(seed, rid, bounce, refl_dir,
                                              normal, roughness)
    # --- TRANSMISSION -------------------------------------------------------
    adv_point = point + EPS_ADVANCE * state.dir        # eps-advance, OLD dir
    if scene.has_transmission:
        target_refr, do_refract = substance_refr_at(scene, adv_point,
                                                    state.refr, accel=accel)
        eta = state.refr / torch.clamp(target_refr, min=1e-6)
        refr_dir, tir = refract(state.dir, normal, eta)
        trans_dir = torch.where(do_refract[:, None], refr_dir, state.dir)
        new_refr = torch.where(do_refract, target_refr, state.refr)
    else:
        trans_dir, new_refr = state.dir, state.refr

    # --- select continuation -------------------------------------------------
    cont_mirror = hit & ~is_light & is_refl & is_mirror
    cont_trans = hit & ~is_light & is_trans & scene.has_transmission
    if scene.has_both and cfg.fresnel_both:
        # Schlick split: continue reflected with probability
        # R = r0 + (1-r0)(1-cos)^5 drawn from the counter RNG; TIR reflects
        seed_b, rid_b = rng
        is_both = response == int(ResponseType.BOTH)
        cos_i = torch.clamp(
            (state.dir * normal).sum(dim=-1).abs(), 0.0, 1.0)
        n2 = torch.clamp(target_refr, min=1e-6)
        r0 = (state.refr - n2) / (state.refr + n2)
        r0 = r0 * r0
        k = 1.0 - cos_i
        k2 = k * k
        fres = r0 + (1.0 - r0) * (k * (k2 * k2))     # (1 - cos)^5
        fres = torch.where(do_refract, torch.where(tir, 1.0, fres), 0.0)
        u_f = sampling.ray_uniform(seed_b, rid_b, bounce,
                                   sampling.SALT_FRESNEL)
        cont_both = hit & ~is_light & is_both
        cont_mirror = cont_mirror | (cont_both & (u_f < fres))
        cont_trans = cont_trans | (cont_both & ~(u_f < fres))
    cont = cont_mirror | cont_trans

    new_dir = torch.where(cont_trans[:, None], trans_dir,
                          torch.where(cont_mirror[:, None], refl_dir,
                                      state.dir))
    new_org = torch.where(
        cont_trans[:, None], adv_point,
        torch.where(cont_mirror[:, None], point + EPS_ADVANCE * refl_dir,
                    state.org))
    refr_out = torch.where(cont_trans, new_refr, state.refr)

    # --- terminations ---------------------------------------------------------
    miss = alive & (pid < 0)
    color = torch.where(miss[:, None], color * sky_color(scene, state.dir),
                        color)
    keep = hit & ~is_light & ~cont
    status = state.status
    status = torch.where(is_light, int(RayStatus.LIGHT), status)
    status = torch.where(keep, int(RayStatus.KEEP), status)
    status = torch.where(miss, int(RayStatus.MISS), status)
    return RayState(org=new_org, dir=new_dir, color=color, path=path,
                    refr=refr_out, status=status)


def _start(scene: Scene, cfg: RenderConfig, org: Tensor, dir: Tensor,
           seed: int, ray_id: Optional[Tensor],
           start_refr: Optional[Tensor]):
    """Fresh wavefront state (white color, ALIVE) and the RNG coordinates,
    which only rough mirrors and the Fresnel-BOTH split draw from."""
    n = org.shape[0]
    if ray_id is None:
        ray_id = torch.arange(n, dtype=torch.int32, device=org.device)
    zeros = torch.zeros_like(org[:, 0])
    if start_refr is None:
        start_refr = scene.default_refr
    state = RayState(org=org, dir=dir, color=torch.ones_like(org),
                     path=zeros, refr=start_refr + zeros,
                     status=torch.zeros((n,), dtype=torch.int32,
                                        device=org.device))
    rng = ((seed, ray_id)
           if scene.has_rough or (scene.has_both and cfg.fresnel_both)
           else None)
    return state, rng


@torch.no_grad()
def record_paths(scene: Scene, cfg: RenderConfig, org: Tensor, dir: Tensor,
                 seed: int = sampling.DEFAULT_SEED,
                 ray_id: Optional[Tensor] = None,
                 start_refr: Optional[Tensor] = None, accel=None) -> Tensor:
    """Run the search path and record the winner per bounce ->
    ``pid_seq [N, refmax]`` int32 (-1 = a miss or a dead ray).

    Feed it to :func:`trace_rays`'s ``pid_seq`` for the path-replay
    backward. The recording is discrete bookkeeping: no graph is built.
    ``accel`` as in :func:`trace_rays`.
    """
    state, rng = _start(scene, cfg, org, dir, seed, ray_id, start_refr)
    shader = _shader(scene, state.org)
    rec = []
    alive = state.status == int(RayStatus.ALIVE)
    for b in range(cfg.refmax):
        _t, pid = nearest_hit(scene, cfg, state.org, state.dir, accel,
                              live=alive)
        pid = torch.where(alive, pid, -1).to(torch.int32)
        rec.append(pid)
        state, alive = shader(cfg, state, rng, b, live=alive,
                              pid_override=pid, accel=accel)
    return torch.stack(rec, dim=1)


def trace_rays(scene: Scene, cfg: RenderConfig, org: Tensor, dir: Tensor,
               seed: int = sampling.DEFAULT_SEED,
               ray_id: Optional[Tensor] = None,
               start_refr: Optional[Tensor] = None,
               pid_seq: Optional[Tensor] = None, accel=None) -> RayState:
    """Trace a wavefront of N rays to termination.

    ``ray_id`` is the global ray id the counter RNG is keyed by (default
    ``arange(N)``); ``start_refr`` is the substance at the camera (default
    the scene default). ``pid_seq`` [N, refmax] switches to path replay:
    the winners come from :func:`record_paths` and no search runs.
    ``accel`` (an ``accel/octree.OctreeAccel``) serves the OCTREE search
    and the transmission substance query.
    Returns the final RayState: LIGHT rays carry the inverse-square
    attenuation, EXHAUST rays are black. Under ``cfg.remat`` each bounce
    is recomputed in the backward instead of keeping its residuals; the
    counter RNG makes the recompute exact. Whether the shade kernel shades
    (:func:`_shader`) is decided once, here: under ``remat`` never.
    """
    state, rng = _start(scene, cfg, org, dir, seed, ray_id, start_refr)
    if cfg.refmax == 0:
        return _epilogue(cfg, state)
    shader = _shader(scene, state.org, state.dir, state.refr,
                     remat=cfg.remat and torch.is_grad_enabled())
    # every ray of _start is ALIVE: the first bounce takes live=None
    alive = None
    for b in range(cfg.refmax):
        state, alive = shader(
            cfg, state, rng, b, live=alive,
            pid_override=None if pid_seq is None else pid_seq[:, b],
            last=b == cfg.refmax - 1, accel=accel)
    return state


def _epilogue(cfg: RenderConfig, state: RayState) -> RayState:
    """The end of a trace: ALIVE rays turn EXHAUST and black, LIGHT rays
    take the inverse-square law."""
    # alive after refmax bounces -> black (raytracer.ts:256-263)
    exhausted = state.status == int(RayStatus.ALIVE)
    color = torch.where(exhausted[:, None], 0.0, state.color)
    status = torch.where(exhausted, int(RayStatus.EXHAUST), state.status)
    # inverse-square law for light hits (raytracer.ts:273-275)
    pa = state.path * cfg.distance_attenuation_factor
    isl = 1.0 / (JS_EPSILON + pa * pa)
    lit = status == int(RayStatus.LIGHT)
    color = torch.where(lit[:, None], color * isl[:, None], color)
    return dataclasses.replace(state, color=color,
                               status=status.to(torch.int32))
