"""Batched 3-vector algebra on ``[..., 3]`` tensors.

Port of ``raytracer_js_tpu.ops.vecmath`` (reference math/vector.ts). Every
sum is written out left to right, so one expression rounds the same way on
every device.
"""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def dot(a: Tensor, b: Tensor) -> Tensor:
    """Batched dot product over the trailing axis (vector.ts:78-86)."""
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def cross(a: Tensor, b: Tensor) -> Tensor:
    """Batched 3D cross product (vector.ts:88-101)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by,
                        az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def length(a: Tensor) -> Tensor:
    return torch.sqrt(dot(a, a))


def normalize(a: Tensor, eps: float = 0.0) -> Tensor:
    """Unit vector; ``eps`` guards a zero vector (``|a|^2 + eps^2``)."""
    if eps:
        return a * torch.rsqrt(dot(a, a) + eps * eps)[..., None]
    return a / length(a)[..., None]


def reflect(v: Tensor, normal: Tensor) -> Tensor:
    """Mirror reflection about a unit normal: ``v - 2*dot(v,n)*n``."""
    return v - 2.0 * dot(v, normal)[..., None] * normal


def rotate_vectors(base_x: Tensor, base_y: Tensor, cos_a, sin_a):
    """Givens rotation of an orthogonal pair (vector.ts:318-323):
    ``x' = cos*x + sin*y``, ``y' = -sin*x + cos*y``."""
    c = torch.as_tensor(cos_a)[..., None]
    s = torch.as_tensor(sin_a)[..., None]
    return c * base_x + s * base_y, -s * base_x + c * base_y


def ortho2(v: Tensor) -> Tensor:
    """2D perpendicular: (x, y) -> (-y, x)."""
    return torch.stack([-v[..., 1], v[..., 0]], dim=-1)


def refract(dir: Tensor, normal: Tensor, eta: Tensor):
    """Snell refraction with total-internal-reflection fallback.

    ``dir``/``normal`` unit, ``normal`` against ``dir``; ``eta = n_from /
    n_to``. Standard form ``t = eta*d + (eta*c1 - c2)*n`` with
    ``c1 = -dot(d, n)`` and ``c2 = sqrt(1 - eta^2*(1 - c1^2))``; TIR reflects.
    Returns ``(new_dir, tir_mask)``.
    """
    eta = torch.as_tensor(eta, dtype=dir.dtype, device=dir.device)
    c1 = -dot(dir, normal)
    s2 = (eta * eta) * (1.0 - c1 * c1)
    tir = s2 > 1.0
    inside = torch.clamp(1.0 - s2, min=0.0)
    pos = inside > 0.0
    c2 = torch.where(pos, torch.sqrt(torch.where(pos, inside, 1.0)), 0.0)
    refr = eta[..., None] * dir + (eta * c1 - c2)[..., None] * normal
    refl = reflect(dir, normal)
    return torch.where(tir[..., None], refl, refr), tir


def uv_map_sphere(d: Tensor):
    """Direction -> equirectangular (u, v) in [0, 1) (uv_mapping.ts:19-25)."""
    eps = 2.0 ** -52
    u = torch.atan2(d[..., 1], d[..., 0]) / (2.0 * math.pi) + 0.5 - eps
    xy = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
    v = torch.atan2(d[..., 2], xy) / math.pi + 0.5 - eps
    return u, v
