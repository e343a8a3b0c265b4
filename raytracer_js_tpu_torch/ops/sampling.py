"""Counter-based random sampling for scatter.

Port of ``raytracer_js_tpu.ops.sampling``: every draw is a pure function of
``(seed, global ray id, bounce, salt)`` through a chained 32-bit avalanche
hash (lowbias32), so a ray's stream never depends on which device or thread
traces it, and the CUDA kernel (``csrc/trace_fused.cu``) draws the same bits.

PyTorch has little uint32 arithmetic, so the hash runs in int64 holding
values in ``[0, 2^32)``. Each 32-bit multiply is split into two 16-bit
halves of the constant, which keeps every intermediate below 2^49: no int64
product overflows. The results are bit-identical to the uint32 originals.

The seed is an explicit uint32 integer where the reference package takes a
``jax.random`` key; :data:`DEFAULT_SEED` is the seed the reference derives
from its default key, so default renders draw the same streams.
"""
from __future__ import annotations

import math

import torch

from .vecmath import dot

Tensor = torch.Tensor

_TWO_PI = float(2.0 * math.pi)
_MASK = 0xFFFFFFFF
#: salts decorrelating the per-(ray, bounce) draws
SALT_Z, SALT_PHI, SALT_R = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35
#: Fresnel reflect-vs-refract choice for ResponseType.BOTH
SALT_FRESNEL = 0x27D4EB2F
#: ``seed_from_key(jax.random.key(0))`` of the reference package — the
#: stream seed of a render that passes no seed
DEFAULT_SEED = 4070199207


def _u32(x) -> Tensor:
    """Any integer tensor (or Python int) -> int64 holding its uint32 bits."""
    return torch.as_tensor(x).to(torch.int64) & _MASK


def _mul32(x: Tensor, c: int) -> Tensor:
    """``x * c mod 2^32`` for ``x`` in [0, 2^32) and a constant ``c``."""
    lo = c & 0xFFFF
    hi = c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK


def lowbias32(x) -> Tensor:
    """Wellons' lowbias32 avalanche hash on uint32 values (int64 holder)."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def step_seed(seed: int, step: int) -> int:
    """The counter-RNG seed of fit step (or exposure frame) ``step``:
    ``lowbias32(seed ^ lowbias32(step))``. The port's counterpart of
    ``jax.random.fold_in(key, step)``; the two give different streams."""
    return int(lowbias32(seed ^ int(lowbias32(step))))


def hash_u32(seed, rid, bounce, salt: int) -> Tensor:
    """Chained hash of the draw coordinates -> uint32 bits (int64 holder)."""
    h = lowbias32(_u32(rid) ^ _u32(seed))
    h = lowbias32((h + _mul32(_u32(bounce), 0x68BC21EB)) & _MASK)
    return lowbias32(h ^ salt)


def uniform01(bits: Tensor) -> Tensor:
    """uint32 bits -> f32 uniform in [0, 1): the high 24 bits through int32."""
    return ((bits >> 8).to(torch.int32).to(torch.float32)
            * (1.0 / (1 << 24)))


def ray_uniform(seed, rid, bounce, salt: int) -> Tensor:
    return uniform01(hash_u32(seed, rid, bounce, salt))


def ball_sample_xyz(seed, rid, bounce):
    """Uniform-in-ball sample as elementwise (x, y, z) tensors: direction
    from (z, phi) uniform on the sphere, radius = cbrt(uniform)."""
    z = 1.0 - 2.0 * ray_uniform(seed, rid, bounce, SALT_Z)
    phi = _TWO_PI * ray_uniform(seed, rid, bounce, SALT_PHI)
    u_r = ray_uniform(seed, rid, bounce, SALT_R)
    s = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    # cbrt via exp/log; u_r floored away from 0
    r = torch.exp(torch.log(torch.clamp(u_r, min=2.0 ** -25)) * (1.0 / 3.0))
    rs = r * s
    return rs * torch.cos(phi), rs * torch.sin(phi), r * z


def scatter_direction_xyz(seed, rid, bounce, rx, ry, rz, nx, ny, nz, rho):
    """Roughness-lerped scatter (raytracer.ts:121-133), elementwise:
    ``normalize((1 - rho) * reflected + rho * ball_sample_in_hemisphere)``;
    roughness 0 returns exactly ``reflected``."""
    bx, by, bz = ball_sample_xyz(seed, rid, bounce)
    flip = torch.where(bx * nx + by * ny + bz * nz < 0.0, -1.0, 1.0)
    bx, by, bz = bx * flip, by * flip, bz * flip
    k = 1.0 - rho
    mx = k * rx + rho * bx
    my = k * ry + rho * by
    mz = k * rz + rho * bz
    inv = 1.0 / torch.sqrt(torch.clamp(mx * mx + my * my + mz * mz,
                                       min=1e-20))
    rough = rho > 0.0
    return (torch.where(rough, mx * inv, rx),
            torch.where(rough, my * inv, ry),
            torch.where(rough, mz * inv, rz))


def ball_sample(seed, rid, bounce=0) -> Tensor:
    """Uniform samples in the unit ball -> [N, 3] (the draws of
    :func:`ball_sample_xyz`, stacked)."""
    return torch.stack(ball_sample_xyz(seed, rid, bounce), dim=-1)


def hemisphere_ball_sample(seed, rid, normal: Tensor, bounce=0) -> Tensor:
    """Unit-ball sample flipped into the hemisphere of ``normal``
    (the scatter setup of raytracer.ts:121-127)."""
    v = ball_sample(seed, rid, bounce)
    flip = dot(v, normal) < 0.0
    return torch.where(flip[..., None], -v, v)


def scatter_direction(seed, rid, bounce, reflected: Tensor, normal: Tensor,
                      roughness: Tensor) -> Tensor:
    """[N, 3] wrapper over :func:`scatter_direction_xyz`."""
    x, y, z = scatter_direction_xyz(
        seed, rid, bounce,
        reflected[..., 0], reflected[..., 1], reflected[..., 2],
        normal[..., 0], normal[..., 1], normal[..., 2], roughness)
    return torch.stack([x, y, z], dim=-1)
