"""Progressive HDR exposure accumulation + luma statistics.

Port of ``raytracer_js_tpu.view.exposure`` (reference exposure_buffer.ts):
a per-pixel running mean with the reference's weight ``w = 1/(1+n)``, n the
post-increment frame count, and the luma statistics the tone mappers read.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import resolve_device

Tensor = torch.Tensor

# BT.601 luma weights (exposure_buffer.ts:161-173).
LUMA_W = (0.299, 0.587, 0.114)


@dataclasses.dataclass(frozen=True)
class ExposureBuffer:
    pixels: Tensor       # [h, w, 3] f32 running-mean HDR
    frame_count: Tensor  # [] i32 — number of accumulated exposure frames
    max_frames: int = -1

    @property
    def shape(self):
        return self.pixels.shape


def new_exposure_buffer(h: int, w: int, max_frames: int = -1,
                        device=None) -> ExposureBuffer:
    """An empty buffer, on the card unless ``device`` says otherwise."""
    device = resolve_device(device)
    return ExposureBuffer(
        pixels=torch.zeros((h, w, 3), dtype=torch.float32, device=device),
        frame_count=torch.zeros((), dtype=torch.int32, device=device),
        max_frames=max_frames)


def reset(buf: ExposureBuffer) -> ExposureBuffer:
    """Restart accumulation (camera moved, exposure_buffer.ts:63-66)."""
    return dataclasses.replace(buf, pixels=torch.zeros_like(buf.pixels),
                               frame_count=torch.zeros_like(buf.frame_count))


def accumulate(buf: ExposureBuffer, frame: Tensor) -> ExposureBuffer:
    """Blend one frame into the running mean with weight ``1/(1+n)``, n the
    post-increment frame count: the first frame enters at weight 1/2 against
    a zero buffer, the reference's behavior (exposure_buffer.ts:53-60).
    Past ``max_frames`` the buffer is returned unchanged."""
    n = buf.frame_count + 1
    w = 1.0 / (1.0 + n.to(frame.dtype))
    blended = frame * w + buf.pixels * (1.0 - w)
    if buf.max_frames >= 0:
        full = buf.frame_count >= buf.max_frames
        blended = torch.where(full, buf.pixels, blended)
        n = torch.where(full, buf.frame_count, n)
    return dataclasses.replace(buf, pixels=blended, frame_count=n)


def luma(pixels: Tensor) -> Tensor:
    """BT.601 Y' per pixel, a plain f32 weighted sum."""
    return (pixels[..., 0] * LUMA_W[0] + pixels[..., 1] * LUMA_W[1]
            + pixels[..., 2] * LUMA_W[2])


def luma_mean(buf: ExposureBuffer) -> Tensor:
    return luma(buf.pixels).mean()


def luma_variance(buf: ExposureBuffer, mean: Tensor) -> Tensor:
    d = luma(buf.pixels) - mean
    return (d * d).mean()


def luma_absdev(buf: ExposureBuffer, mean: Tensor) -> Tensor:
    return (luma(buf.pixels) - mean).abs().mean()


def discretize(pixels: Tensor, drange_low: Tensor,
               drange_high: Tensor) -> Tensor:
    """HDR -> [0,1] display window (exposure_buffer.ts:145-158): window
    remap in brightness space, RGB scaled by the compressed/raw ratio."""
    y = luma(pixels)
    compressed = (y - drange_low) / (drange_high - drange_low)
    scale = compressed / (y + 2.0 ** -52)
    return torch.clamp(pixels * scale[..., None], 0.0, 1.0)
