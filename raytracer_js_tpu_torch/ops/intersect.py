"""Batched analytic ray-primitive intersection.

Port of ``raytracer_js_tpu.ops.intersect``:

* ``*_hit_t`` — [rays, prims] nearest-forward-hit parameter matrices
  (misses are +inf), the BRUTE search;
* ``*_surface`` — per-ray recompute of (t, point, normal, uv) for one chosen
  primitive per ray.

Forward-hit semantics: the first parameter ``t >= 0`` of the (near, far)
pair (intersection.ts:207-216). The sphere test keeps the reference's
factoring into ``rays @ centers.T`` matmuls, which must run in full fp32:
TF32-rounded sphere dots turn near misses into phantom hits, so on a GPU
the test raises while ``torch.backends.cuda.matmul.allow_tf32`` is on.
"""
from __future__ import annotations

import math

import torch

from .vecmath import cross, dot, normalize, uv_map_sphere

Tensor = torch.Tensor

INF = math.inf
#: determinant cutoff for Moeller-Trumbore parallel rays
MT_EPS = 1e-9
#: |dir| floor for the slab test
SLAB_DIR_EPS = 1e-12


def safe_inv(d: Tensor) -> Tensor:
    """``1 / d`` with ``|d|`` raised to ``SLAB_DIR_EPS``, its sign kept: the
    slab test's inverse direction, here and in every kernel's plain
    version."""
    tiny = d.abs() < SLAB_DIR_EPS
    return 1.0 / torch.where(
        tiny, torch.where(d < 0, -SLAB_DIR_EPS, SLAB_DIR_EPS), d)


def _first_forward(t_near: Tensor, t_far: Tensor, valid: Tensor) -> Tensor:
    """First parameter >= 0 of an ordered (near, far) pair, else +inf."""
    t = torch.where(t_near >= 0.0, t_near,
                    torch.where(t_far >= 0.0, t_far, INF))
    return torch.where(valid, t, INF)


def _empty(org: Tensor) -> Tensor:
    return torch.full((org.shape[0], 0), INF, dtype=org.dtype,
                      device=org.device)


def _dots(v: Tensor, c: Tensor) -> Tensor:
    """[N, 3] x [S, 3] -> [N, S] dot products, refusing TF32."""
    if v.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the sphere test needs fp32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    return v @ c.T


def sphere_hit_t(org: Tensor, dir: Tensor, center: Tensor,
                 radius: Tensor) -> Tensor:
    """Nearest forward hit params for [N] rays x [S] spheres -> [N, S]."""
    if center.shape[0] == 0:
        return _empty(org)
    d_dot_c = _dots(dir, center)                    # [N, S]
    o_dot_c = _dots(org, center)                    # [N, S]
    o_dot_d = dot(org, dir)[:, None]
    o_dot_o = dot(org, org)[:, None]
    a = dot(dir, dir)[:, None]
    c_dot_c = dot(center, center)[None, :]
    r2 = (radius * radius)[None, :]

    b_half = o_dot_d - d_dot_c
    c = o_dot_o - 2.0 * o_dot_c + c_dot_c - r2
    disc = b_half * b_half - a * c
    valid = disc >= 0.0
    sq = torch.sqrt(torch.where(valid, disc, 0.0))
    t_near = (-b_half - sq) / a
    t_far = (-b_half + sq) / a
    return _first_forward(t_near, t_far, valid)


def sphere_surface(org: Tensor, dir: Tensor, center: Tensor, radius: Tensor):
    """(t, point, normal, uv) for one chosen sphere per ray ([N,3]/[N])."""
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
    u, v = uv_map_sphere(point - center)
    return t, point, normal, (u, v)


def _slab(org: Tensor, dir: Tensor, lo: Tensor, hi: Tensor):
    """Slab intervals -> (t_enter, t_exit, enter_axis, exit_axis). A ray
    parallel to a slab divides by the clamped ``SLAB_DIR_EPS``."""
    inv = safe_inv(dir)
    ta = (lo - org) * inv
    tb = (hi - org) * inv
    t0 = torch.minimum(ta, tb)
    t1 = torch.maximum(ta, tb)
    t_enter, enter_axis = t0.max(dim=-1)
    t_exit, exit_axis = t1.min(dim=-1)
    return t_enter, t_exit, enter_axis, exit_axis


def box_hit_t(org: Tensor, dir: Tensor, center: Tensor,
              half: Tensor) -> Tensor:
    """Nearest forward hit params for [N] rays x [B] boxes -> [N, B]."""
    if center.shape[0] == 0:
        return _empty(org)
    lo = (center - half)[None, :, :]
    hi = (center + half)[None, :, :]
    t_enter, t_exit, _, _ = _slab(org[:, None, :], dir[:, None, :], lo, hi)
    return _first_forward(t_enter, t_exit, t_enter <= t_exit)


def box_surface(org: Tensor, dir: Tensor, center: Tensor, half: Tensor):
    """(t, point, normal, uv) for one chosen box per ray.

    The face normal comes from the winning slab axis, tie order x > y > z
    (``max``/``min`` return the first index), flipped against the ray. The
    uv layout puts face f in u in [f/6, (f+1)/6).
    """
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
    sign = torch.where(d_axis < 0.0, -1.0, 1.0)
    normal = -sign[..., None] * ax_onehot
    outward_sign = torch.where(entering, -sign, sign)
    a0, a1, a2 = ax_onehot[..., 0], ax_onehot[..., 1], ax_onehot[..., 2]
    face = (a1 + 2.0 * a2) * 2.0 + torch.where(outward_sign > 0.0, 1.0, 0.0)
    rel = torch.clamp((point - lo) / torch.clamp(2.0 * half, min=1e-12),
                      0.0, 1.0 - 2.0 ** -23)
    u_local = rel[..., 0] * (a1 + a2) + rel[..., 1] * a0
    v_local = rel[..., 1] * a2 + rel[..., 2] * (a0 + a1)
    u = (face + u_local) / 6.0
    return t, point, normal, (u, v_local)


def tri_hit_t(org: Tensor, dir: Tensor, v0: Tensor, v1: Tensor,
              v2: Tensor) -> Tensor:
    """Moeller-Trumbore for [N] rays x [T] triangles -> [N, T]."""
    if v0.shape[0] == 0:
        return _empty(org)
    e1 = (v1 - v0)[None, :, :]
    e2 = (v2 - v0)[None, :, :]
    d = dir[:, None, :]
    o = org[:, None, :]
    p = cross(d, e2)
    det = dot(e1, p)
    inv_det = 1.0 / torch.where(det.abs() < MT_EPS, MT_EPS, det)
    s = o - v0[None, :, :]
    u = dot(s, p) * inv_det
    q = cross(s, e1)
    v = dot(d, q) * inv_det
    t = dot(e2, q) * inv_det
    valid = ((det.abs() >= MT_EPS) & (u >= 0.0) & (v >= 0.0)
             & (u + v <= 1.0) & (t >= 0.0))
    return torch.where(valid, t, INF)


def tri_surface(org: Tensor, dir: Tensor, v0: Tensor, v1: Tensor,
                v2: Tensor):
    """(t, point, normal, uv) for one chosen triangle per ray: geometric
    normal flipped against the ray, barycentric (u, v)."""
    e1 = v1 - v0
    e2 = v2 - v0
    p = cross(dir, e2)
    det = dot(e1, p)
    inv_det = 1.0 / torch.where(det.abs() < MT_EPS, MT_EPS, det)
    s = org - v0
    u = dot(s, p) * inv_det
    q = cross(s, e1)
    v = dot(dir, q) * inv_det
    t = dot(e2, q) * inv_det
    point = org + t[..., None] * dir
    normal = normalize(cross(e1, e2), eps=1e-20)
    normal = torch.where(dot(dir, normal)[..., None] > 0.0, -normal, normal)
    return t, point, normal, (u, v)
