"""RGBA color operations.

Port of ``raytracer_js_tpu.ops.color`` (reference color.ts): the per-pixel
RGBA record functions become broadcasting ops over ``[..., 4]`` (RGBA) and
``[..., 3]`` (RGB) tensors. The trace path carries plain RGB; RGBA overlay
serves the screen and compositing layer.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

#: BT.601 luma weights (exposure_buffer.ts:161-173)
LUMA_W = (0.299, 0.587, 0.114)


def color(r, g, b, a=1.0) -> Tensor:
    """RGBA constructor (color.ts:21-27)."""
    parts = torch.broadcast_tensors(
        *(torch.as_tensor(x, dtype=torch.float32) for x in (r, g, b, a)))
    return torch.stack(parts, dim=-1)


def mul_color(a: Tensor, b: Tensor) -> Tensor:
    """Component-wise product (color.ts:50-52), the alter_ray modulation."""
    return a * b


def scale_color(c: Tensor, factor, scale_alpha: bool = False) -> Tensor:
    """Scale RGB, optionally alpha (color.ts:38-47)."""
    f = torch.as_tensor(factor, dtype=c.dtype, device=c.device)[..., None]
    if scale_alpha or c.shape[-1] == 3:
        return c * f
    return torch.cat([c[..., :3] * f, c[..., 3:]], dim=-1)


def clamp_color(c: Tensor, lo: float = 0.0, hi: float = 1.0) -> Tensor:
    """Clamp components (color.ts:28-36)."""
    return torch.clamp(c, lo, hi)


def overlay_color(top: Tensor, bottom: Tensor) -> Tensor:
    """Alpha-composite ``top`` over ``bottom`` (color.ts:59-65, exactly):
    ``rgb = clamp(top_rgb * a_top + bottom_rgb * (1 - a_top))``; alpha
    saturates additively, ``a = clamp(a_bottom + a_top)`` (not Porter-Duff
    "over"). RGBA [..., 4] tensors."""
    a_t = top[..., 3:]
    rgb = torch.clamp(top[..., :3] * a_t + bottom[..., :3] * (1.0 - a_t),
                      0.0, 1.0)
    return torch.cat([rgb, torch.clamp(bottom[..., 3:] + a_t, 0.0, 1.0)],
                     dim=-1)


def luma(c: Tensor) -> Tensor:
    """BT.601 luminance of RGB(A), a plain f32 weighted sum."""
    return c[..., 0] * LUMA_W[0] + c[..., 1] * LUMA_W[1] + c[..., 2] * LUMA_W[2]
