"""Image I/O for textures.

Port of ``raytracer_js_tpu.utils.image`` (reference ImageTexture loader,
texture_image.ts:76-136): PIL decode and numpy flips. The reference's
async-with-fallback contract (the fallback color until the image loads,
main.ts:383-388) maps to :func:`load_texture_image`'s ``fallback`` on
failure. PIL is optional and imported at call time: without it,
:func:`load_image` raises :class:`TextureError` naming PIL, and images can
still be given as numpy arrays (``SceneBuilder.add_image_texture``).
"""
from __future__ import annotations

import pathlib
from typing import Optional, Tuple, Union

import numpy as np

PathLike = Union[str, pathlib.Path]


class TextureError(Exception):
    """Image decode failure (reference texture.ts TextureError)."""


def load_image(path: PathLike, hflip: bool = False,
               vflip: bool = False) -> np.ndarray:
    """Decode an image file -> [H, W, 3] float32 in [0, 1]; ``hflip`` and
    ``vflip`` mirror it (texture_image.ts:76-136). Raises
    :class:`TextureError` on failure, or without PIL."""
    try:
        from PIL import Image
    except ImportError as e:
        raise TextureError(f"PIL unavailable, cannot decode {path}: {e}"
                           ) from e
    try:
        with Image.open(path) as im:
            arr = np.asarray(im.convert("RGB"), np.float32) / 255.0
    except Exception as e:
        raise TextureError(f"failed to decode {path}: {e}") from e
    if hflip:
        arr = arr[:, ::-1]
    if vflip:
        arr = arr[::-1]
    return np.ascontiguousarray(arr)


def load_texture_image(path: PathLike,
                       fallback: Tuple[float, float, float] = (0.0, 0.0, 0.0),
                       hflip: bool = False, vflip: bool = False,
                       size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Load an image for ``SceneBuilder.add_image_texture``; on failure a
    1x1 image of the fallback color (the reference's graceful degradation,
    main.ts:383-388). ``size`` (h, w) resamples by nearest texel."""
    try:
        img = load_image(path, hflip=hflip, vflip=vflip)
    except TextureError:
        return np.full((1, 1, 3), np.asarray(fallback, np.float32))
    if size is not None:
        h, w = size
        yi = np.arange(h) * img.shape[0] // h
        xi = np.arange(w) * img.shape[1] // w
        img = img[yi][:, xi]
    return img
