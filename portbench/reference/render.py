"""Cameras, the dense nearest-hit search and the wavefront bounce loop.

A frozen copy of the program's plain BRUTE path, operation for operation
where the scene class allows: the closed-form pixel rays, the factored
sphere quadratic (``rays @ centers.T``, in full float32: TF32 is refused),
the slab test, the surface recompute, mirror reflection with the
``1e-3`` advance, the sky on a miss and the inverse-square law on an
emitter. ``dtype`` runs all of it in another precision (the control).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .scene import RefScene

Tensor = torch.Tensor

ALIVE, LIGHT, KEEP, MISS, EXHAUST = 0, 1, 2, 3, 4
EPS_ADVANCE = 1e-3
JS_EPSILON = 2.0 ** -52
INF = math.inf
SLAB_DIR_EPS = 1e-12
#: elements of one [rays, prims] block of the dense search (256 MB each in
#: float32): the search runs in blocks of rays so that it fits
BLOCK_ELEMS = 1 << 26


def fp32_matmuls() -> None:
    """The sphere test's dot products must not round to TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def dot(a: Tensor, b: Tensor) -> Tensor:
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def cross(a: Tensor, b: Tensor) -> Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


# ---------------------------------------------------------------------------
# Camera
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RefCamera:
    pos: Tensor
    front: Tensor
    left: Tensor
    up: Tensor
    fov_h: float
    fov_v: float
    w: int
    h: int


def make_camera(pos, w: int, h: int, fov_h: float, fov_v: float,
                rot_h: float = 0.0, device="cpu") -> RefCamera:
    """Identity triad, then a yaw of ``rot_h`` radians (the raytracer.js
    camera's horizontal rotation: the XY projections of front and left
    turned, up = front x left)."""
    def vec(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    pos_t = torch.as_tensor(pos, dtype=torch.float32, device=device
                            ).reshape(3)
    front, left, up = vec([1.0, 0.0, 0.0]), vec([0.0, 1.0, 0.0]), \
        vec([0.0, 0.0, 1.0])
    if rot_h:
        a = torch.as_tensor(rot_h, dtype=torch.float32, device=device)
        c = torch.cos(a)[..., None]
        s = torch.sin(a)[..., None]

        def turn(v):
            x = v[:2]
            y = torch.stack([-x[..., 1], x[..., 0]], dim=-1)
            return torch.cat([c * x + s * y, v[2:]])

        front, left = turn(front), turn(left)
        up = cross(front, left)
    return RefCamera(pos_t, front, left, up, float(fov_h), float(fov_v),
                     int(w), int(h))


def pixel_rays(cam: RefCamera, dtype=torch.float32):
    """Per-pixel unit directions, row-major over (y, x) -> (org, dir)
    [h*w, 3]: ``dir = cos th_h cos th_v front + cos th_h sin th_v up +
    sin th_h left``, ``th = (i - size//2) * step`` with the step
    ``fov / size`` rounded once to float32."""
    step_h = float(torch.tensor(cam.fov_h / cam.w, dtype=torch.float32))
    step_v = float(torch.tensor(cam.fov_v / cam.h, dtype=torch.float32))
    f32, dev = torch.float32, cam.pos.device
    x = torch.arange(cam.w, dtype=f32, device=dev)
    y = torch.arange(cam.h, dtype=f32, device=dev)
    th_h = (x - cam.w // 2) * step_h
    th_v = (y - cam.h // 2) * step_v
    ch, sh = torch.cos(th_h)[None, :], torch.sin(th_h)[None, :]
    cv, sv = torch.cos(th_v)[:, None], torch.sin(th_v)[:, None]
    a1 = (ch * cv)[..., None]
    a2 = (ch * sv)[..., None]
    d = a1 * cam.front + a2 * cam.up + sh[..., None] * cam.left
    d = d.reshape(-1, 3)
    org = cam.pos.expand_as(d).contiguous()
    return org.to(dtype), d.to(dtype)


# ---------------------------------------------------------------------------
# Dense search
# ---------------------------------------------------------------------------

def _first_forward(t_near, t_far, valid):
    t = torch.where(t_near >= 0.0, t_near,
                    torch.where(t_far >= 0.0, t_far, INF))
    return torch.where(valid, t, INF)


def _dots(v: Tensor, c: Tensor) -> Tensor:
    if (v.is_cuda and v.dtype == torch.float32
            and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError("the sphere test needs float32 matmuls: call "
                           "fp32_matmuls() first")
    return v @ c.T


def sphere_winner(org, dir, center, radius):
    """[N] rays against [S] spheres -> (t [N], sphere id [N], -1: none).

    The factored quadratic over every pair; the roots only where the
    discriminant is >= 0, each with the same operations as over the whole
    [N, S] matrix; the least t a ray, the lowest id on a tie."""
    n, s = org.shape[0], center.shape[0]
    d_dot_c = _dots(dir, center)
    o_dot_c = _dots(org, center)
    o_dot_d = dot(org, dir)[:, None]
    o_dot_o = dot(org, org)[:, None]
    a = dot(dir, dir)[:, None]
    c_dot_c = dot(center, center)[None, :]
    r2 = (radius * radius)[None, :]
    b_half = o_dot_d - d_dot_c
    c = o_dot_o - 2.0 * o_dot_c + c_dot_c - r2
    disc = b_half * b_half - a * c
    row, col = torch.nonzero(disc >= 0.0, as_tuple=True)
    b, aa = b_half[row, col], a[row, 0]
    sq = torch.sqrt(disc[row, col])
    t_near = (-b - sq) / aa
    t_far = (-b + sq) / aa
    t = _first_forward(t_near, t_far, torch.ones_like(row, dtype=torch.bool))
    t_min = torch.full((n,), INF, dtype=org.dtype, device=org.device
                       ).scatter_reduce(0, row, t, "amin")
    win = (t == t_min[row]) & torch.isfinite(t)
    sid = torch.full((n,), s, dtype=torch.int64, device=org.device
                     ).scatter_reduce(0, row[win], col[win], "amin")
    return t_min, torch.where(sid < s, sid, -1)


def _slab(org, dir, lo, hi):
    d_safe = torch.where(dir.abs() < SLAB_DIR_EPS,
                         torch.where(dir < 0, -SLAB_DIR_EPS,
                                     SLAB_DIR_EPS).to(dir.dtype),
                         dir)
    inv = 1.0 / d_safe
    ta = (lo - org) * inv
    tb = (hi - org) * inv
    t0 = torch.minimum(ta, tb)
    t1 = torch.maximum(ta, tb)
    t_enter, enter_axis = t0.max(dim=-1)
    t_exit, exit_axis = t1.min(dim=-1)
    return t_enter, t_exit, enter_axis, exit_axis


def box_hit_t(org, dir, center, half):
    lo = (center - half)[None, :, :]
    hi = (center + half)[None, :, :]
    t_enter, t_exit, _, _ = _slab(org[:, None, :], dir[:, None, :], lo, hi)
    return _first_forward(t_enter, t_exit, t_enter <= t_exit)


@torch.no_grad()
def nearest_hit(scene: RefScene, org: Tensor, dir: Tensor):
    """Every ray against every prim -> (t [N], pid [N], -1 on a miss);
    on a tie in t the lowest pid wins (spheres before boxes)."""
    n, p = org.shape[0], scene.n_prims
    t_out = torch.full((n,), INF, dtype=org.dtype, device=org.device)
    pid_out = torch.full((n,), -1, dtype=torch.int64, device=org.device)
    if p == 0 or n == 0:
        return t_out, pid_out
    step = max(1, BLOCK_ELEMS // p)
    sc, sr = scene.sphere_center.detach(), scene.sphere_radius.detach()
    bc, bh = scene.box_center.detach(), scene.box_half.detach()
    for lo in range(0, n, step):
        o, d = org[lo:lo + step], dir[lo:lo + step]
        t = torch.full((o.shape[0],), INF, dtype=o.dtype, device=o.device)
        pid = torch.full((o.shape[0],), -1, dtype=torch.int64,
                         device=o.device)
        if scene.n_spheres:
            t, pid = sphere_winner(o, d, sc, sr)
        if scene.n_boxes:
            t_b, b = box_hit_t(o, d, bc, bh).min(dim=1)
            box = t_b < t
            t = torch.where(box, t_b, t)
            pid = torch.where(box, scene.n_spheres + b, pid)
        t_out[lo:lo + step] = t
        pid_out[lo:lo + step] = pid
    return t_out, pid_out


# ---------------------------------------------------------------------------
# Surface recompute and the bounce loop
# ---------------------------------------------------------------------------

def sphere_surface(org, dir, center, radius):
    oc = org - center
    b_half = dot(oc, dir)
    a = dot(dir, dir)
    c = dot(oc, oc) - radius * radius
    disc = b_half * b_half - a * c
    pos = disc > 0.0
    sq = torch.where(pos, torch.sqrt(torch.where(pos, disc, 1.0)), 0.0)
    t_near = (-b_half - sq) / a
    t_far = (-b_half + sq) / a
    t = torch.where(t_near >= 0.0, t_near, t_far)
    point = org + t[..., None] * dir
    r_safe = torch.where(radius.abs() < 1e-12, 1e-12, radius)
    normal = (point - center) / r_safe[..., None]
    normal = torch.where(dot(dir, normal)[..., None] > 0.0, -normal, normal)
    return t, point, normal


def box_surface(org, dir, center, half):
    lo = center - half
    hi = center + half
    t_enter, t_exit, enter_axis, exit_axis = _slab(org, dir, lo, hi)
    entering = t_enter >= 0.0
    t = torch.where(entering, t_enter, t_exit)
    axis = torch.where(entering, enter_axis, exit_axis)
    point = org + t[..., None] * dir
    ax_onehot = torch.stack([axis == 0, axis == 1, axis == 2],
                            dim=-1).to(org.dtype)
    d_axis = dot(dir, ax_onehot)
    sign = torch.where(d_axis < 0.0, -1.0, 1.0).to(org.dtype)
    normal = -sign[..., None] * ax_onehot
    return t, point, normal


def surface_at(scene: RefScene, org, dir, pid_c):
    """(point, normal, t) of prim ``pid_c`` (clamped, >= 0) per ray."""
    s_end = scene.n_spheres
    point = torch.zeros_like(org)
    normal = torch.zeros_like(org)
    tt = torch.zeros_like(org[:, 0])

    def put(m, res):
        nonlocal point, normal, tt
        t, p, nrm = res
        point = torch.where(m[:, None], p, point)
        normal = torch.where(m[:, None], nrm, normal)
        tt = torch.where(m, t, tt)

    if scene.n_spheres:
        idx = torch.clamp(pid_c, 0, s_end - 1)
        put(pid_c < s_end, sphere_surface(
            org, dir, scene.sphere_center.index_select(0, idx),
            scene.sphere_radius.index_select(0, idx)))
    if scene.n_boxes:
        idx = torch.clamp(pid_c - s_end, 0, scene.n_boxes - 1)
        put(pid_c >= s_end, box_surface(
            org, dir, scene.box_center.index_select(0, idx),
            scene.box_half.index_select(0, idx)))
    return point, normal, tt


@dataclasses.dataclass
class Trace:
    color: Tensor            # [N, 3] HDR
    status: Tensor           # [N] final status


def trace(scene: RefScene, org: Tensor, dir: Tensor, refmax: int) -> Trace:
    """Trace a wavefront to termination, each bounce searching densely
    over its live rays."""
    n = org.shape[0]
    color = torch.ones_like(org)
    path = torch.zeros_like(org[:, 0])
    status = torch.zeros((n,), dtype=torch.int64, device=org.device)
    rgb = scene.tex_rgb.index_select(0, scene.prim_tex)
    sky = scene.tex_rgb[scene.sky_tex]
    for _ in range(refmax):
        alive = status == ALIVE
        idx = torch.nonzero(alive)[:, 0]
        pid = torch.full((n,), -1, dtype=torch.int64, device=org.device)
        if idx.numel():
            pid[idx] = nearest_hit(scene, org[idx], dir[idx])[1]
        hit = alive & (pid >= 0)
        pid_c = torch.clamp(pid, 0, max(scene.n_prims - 1, 0))
        point, normal, t_surf = surface_at(scene, org, dir, pid_c)
        color = torch.where(hit[:, None], color * rgb.index_select(0, pid_c),
                            color)
        path = torch.where(hit, path + t_surf, path)
        is_light = scene.prim_light.index_select(0, pid_c) & hit
        cont = hit & ~is_light & scene.prim_mirror.index_select(0, pid_c)
        refl = dir - 2.0 * dot(dir, normal)[..., None] * normal
        new_dir = torch.where(cont[:, None], refl, dir)
        new_org = torch.where(cont[:, None], point + EPS_ADVANCE * refl, org)
        miss = alive & (pid < 0)
        color = torch.where(miss[:, None], color * sky, color)
        keep = hit & ~is_light & ~cont
        status = torch.where(is_light, LIGHT, status)
        status = torch.where(keep, KEEP, status)
        status = torch.where(miss, MISS, status)
        org, dir = new_org, new_dir
    exhausted = status == ALIVE
    color = torch.where(exhausted[:, None], 0.0, color)
    status = torch.where(exhausted, EXHAUST, status)
    isl = 1.0 / (JS_EPSILON + path * path)
    color = torch.where((status == LIGHT)[:, None], color * isl[:, None],
                        color)
    return Trace(color=color, status=status)


def render_frame(scene: RefScene, cam: RefCamera, refmax: int) -> Trace:
    """One frame of ``cam`` -> its trace; ``color`` is [h*w, 3] in the
    scene's dtype."""
    org, dir = pixel_rays(cam, scene.sphere_center.dtype)
    return trace(scene, org, dir, refmax)
