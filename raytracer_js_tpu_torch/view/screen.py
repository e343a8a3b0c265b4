"""Output sinks (port of ``raytracer_js_tpu.view.screen``, numpy only).

u8 quantization as the reference canvas sink does it (screen_canvas.ts:92-94,
8-bit ``dynamic_range()``, :96-98), plus PNG and ``.npy`` writers. Tensors on
any device are copied to the host first.
"""
from __future__ import annotations

import pathlib
from typing import Union

import numpy as np

PathLike = Union[str, pathlib.Path]

#: display bit depth (screen_canvas.ts:96-98)
DYNAMIC_RANGE_BITS = 8


def _host(img) -> np.ndarray:
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    return np.asarray(img, np.float32)


def quantize_u8(img) -> np.ndarray:
    """[0,1] float -> u8 (screen_canvas.ts:92-94: round(c * 0xff))."""
    return np.clip(np.rint(_host(img) * 255.0), 0, 255).astype(np.uint8)


def to_rgba(img) -> np.ndarray:
    """[h, w, 3] RGB -> [h, w, 4] RGBA with opaque alpha
    (screen_canvas.ts:45-56)."""
    arr = _host(img)
    if arr.shape[-1] == 4:
        return arr
    a = np.ones(arr.shape[:-1] + (1,), np.float32)
    return np.concatenate([arr, a], axis=-1)


def write_png(path: PathLike, img) -> pathlib.Path:
    """Write a [h, w, 3] RGB or [h, w, 4] RGBA image in [0, 1] as PNG (a
    ``.npy`` of the u8 image when PIL is unavailable). Returns the path
    written."""
    path = pathlib.Path(path)
    u8 = quantize_u8(img)
    try:
        from PIL import Image
    except ImportError:
        path = path.with_suffix(".npy")
        np.save(path, u8)
        return path
    mode = "RGBA" if u8.shape[-1] == 4 else "RGB"
    Image.fromarray(u8, mode=mode).save(path)
    return path


def write_npy(path: PathLike, img) -> pathlib.Path:
    """Raw HDR dump for exact golden comparisons."""
    path = pathlib.Path(path).with_suffix(".npy")
    np.save(path, _host(img))
    return path
