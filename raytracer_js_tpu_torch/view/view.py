"""View glue — tone-map window -> display image (port of
``raytracer_js_tpu.view.view``; reference view/view.ts:23-41)."""
from __future__ import annotations

import torch

from ..config import ToneMapConfig
from . import exposure as ex
from .tonemap import tonemap


def draw(buf: ex.ExposureBuffer, cfg: ToneMapConfig) -> torch.Tensor:
    """ExposureBuffer -> display-ready [0,1] image (view.ts:34-38)."""
    return tonemap(buf, cfg)
