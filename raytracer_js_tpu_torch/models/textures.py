"""Texture tables and branchless sampling (port of
``raytracer_js_tpu.models.textures``).

Two tables replace the reference's texture classes (texture.ts:26-35):

* ``solid_rgb [X, 3]`` — every texture's flat color: a solid texture's color
  (texture_solid.ts:21-44) or an image texture's fallback color;
* ``atlas [I, H, W, 3]`` — every image, stored top-left in an atlas padded
  to the largest image, with each image's native size in ``img_h``/``img_w``.

Sampling is a gather and a select on ``kind``. Image texels are read with a
plain index gather ``atlas[img_row, row, col]``; the reference's two-level
one-hot MXU gather (``_atlas_gather``) is a TPU workaround and is not ported.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import TextureKind

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TextureTable:
    kind: Tensor        # [X] i32: TextureKind
    ref: Tensor         # [X] i32: atlas row of an image texture (0 for solid)
    solid_rgb: Tensor   # [X, 3] f32: solid color / image fallback
    atlas: Tensor       # [I, H, W, 3] f32 (I >= 1; row 0 is a dummy if unused)
    img_h: Tensor       # [I] i32: each image's native height in the atlas
    img_w: Tensor       # [I] i32: each image's native width
    #: any IMAGE-kind entry? When False sampling is a row gather of
    #: ``solid_rgb``.
    has_images: bool = False
    #: any IMAGE_BILINEAR entry? Gates the 4-tap filtered path.
    has_bilinear: bool = False

    def to(self, device) -> "TextureTable":
        return dataclasses.replace(
            self, kind=self.kind.to(device), ref=self.ref.to(device),
            solid_rgb=self.solid_rgb.to(device), atlas=self.atlas.to(device),
            img_h=self.img_h.to(device), img_w=self.img_w.to(device))


def is_image_kind(kind: Tensor) -> Tensor:
    """Bool mask: does this TextureKind sample the atlas (nearest or
    bilinear)?"""
    return ((kind == int(TextureKind.IMAGE))
            | (kind == int(TextureKind.IMAGE_BILINEAR)))


def _texel(atlas: Tensor, img_row: Tensor, row: Tensor, col: Tensor):
    return atlas[img_row.long(), row.long(), col.long()]


def sample(tex: TextureTable, tex_id: Tensor, u: Tensor, v: Tensor) -> Tensor:
    """Color of texture ``tex_id`` at (u, v); all args [N] -> [N, 3].

    Texel ``(floor(u*W), floor(v*H))``, edge-clamped, with row 0 at the
    *bottom* of the image: the reference flips rows at decode time
    (texture_image.ts:112-127); images are stored top-down here and flipped
    at sample time. Bilinear taps sit on texel centers (x = u*W - 0.5).
    """
    tex_id = torch.clamp(tex_id.long(), 0, tex.kind.shape[0] - 1)
    solid = tex.solid_rgb[tex_id]
    if not tex.has_images:
        return solid
    kind = tex.kind[tex_id]
    img_row = tex.ref[tex_id].long()
    hi = tex.img_h[img_row]
    wi = tex.img_w[img_row]
    h = hi.to(torch.float32)
    w = wi.to(torch.float32)
    h_top = hi - 1
    w_hi = wi - 1

    def clip(i, hi_):
        return torch.minimum(torch.clamp(i, min=0), hi_)

    ix = clip((u * w).to(torch.int32), w_hi)
    iy = clip((v * h).to(torch.int32), h_top)
    img = _texel(tex.atlas, img_row, h_top - iy, ix)
    if tex.has_bilinear:
        x = u * w - 0.5
        y = v * h - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = (x - x0)[..., None]
        fy = (y - y0)[..., None]
        x0i = clip(x0.to(torch.int32), w_hi)
        x1i = clip(x0.to(torch.int32) + 1, w_hi)
        y0i = clip(y0.to(torch.int32), h_top)
        y1i = clip(y0.to(torch.int32) + 1, h_top)
        r0 = h_top - y0i
        r1 = h_top - y1i
        c00 = _texel(tex.atlas, img_row, r0, x0i)
        c10 = _texel(tex.atlas, img_row, r0, x1i)
        c01 = _texel(tex.atlas, img_row, r1, x0i)
        c11 = _texel(tex.atlas, img_row, r1, x1i)
        # the reference's operation order, so both round alike
        blin = ((1 - fx) * (1 - fy) * c00 + fx * (1 - fy) * c10
                + (1 - fx) * fy * c01 + fx * fy * c11)
        img = torch.where(
            (kind == int(TextureKind.IMAGE_BILINEAR))[..., None], blin, img)
    return torch.where(is_image_kind(kind)[..., None], img, solid)
