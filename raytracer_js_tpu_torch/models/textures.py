"""Texture tables, solid kinds only (port of
``raytracer_js_tpu.models.textures``).

A solid texture is one flat color (texture_solid.ts:21-44), so sampling is a
row gather. Image textures and their atlas come with ROADMAP item A8.
"""
from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor

_A8 = "image textures are not ported yet (ROADMAP A8)"


@dataclasses.dataclass(frozen=True)
class TextureTable:
    kind: Tensor        # [X] i32: TextureKind (SOLID only so far)
    ref: Tensor         # [X] i32: atlas row of an image texture (0 for solid)
    solid_rgb: Tensor   # [X, 3] f32: the solid color
    #: always False until ROADMAP A8 brings image textures
    has_images: bool = False

    def to(self, device) -> "TextureTable":
        return dataclasses.replace(self, kind=self.kind.to(device),
                                   ref=self.ref.to(device),
                                   solid_rgb=self.solid_rgb.to(device))


def sample(tex: TextureTable, tex_id: Tensor, u: Tensor, v: Tensor) -> Tensor:
    """Color of texture ``tex_id`` at (u, v) -> [N, 3]."""
    if tex.has_images:
        raise NotImplementedError(_A8)
    tex_id = torch.clamp(tex_id.long(), 0, tex.kind.shape[0] - 1)
    return tex.solid_rgb.index_select(0, tex_id.reshape(-1)).reshape(
        tex_id.shape + (3,))
