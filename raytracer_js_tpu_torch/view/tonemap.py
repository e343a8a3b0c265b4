"""Tone mapping — dynamic-range window selection (port of
``raytracer_js_tpu.view.tonemap``, reference tone_mapping.ts:21-79)."""
from __future__ import annotations

from typing import Tuple

import torch

from ..config import ToneMapConfig, ToneMapperKind
from . import exposure as ex

Tensor = torch.Tensor


def dynamic_range(buf: ex.ExposureBuffer,
                  cfg: ToneMapConfig) -> Tuple[Tensor, Tensor]:
    """(drange_low, drange_high) for the display window.

    * IDENTITY — fixed [0, 1];
    * DR_LIMITED — fixed [min_dynamic, min_dynamic * 2^k];
    * STDDEV_AROUND_MEAN — hi = min(mean + std, max_dynamic), lo = hi/2^k,
      floored at min_dynamic with hi re-derived;
    * ABSDEV_AROUND_MEAN — the same with the mean absolute deviation.
    """
    dev = buf.pixels.device
    if cfg.kind == ToneMapperKind.IDENTITY:
        z = torch.zeros((), dtype=torch.float32, device=dev)
        return z, z + 1.0
    coef = float(1 << cfg.dynamic_range)
    if cfg.kind == ToneMapperKind.DR_LIMITED:
        lo = torch.tensor(cfg.min_dynamic, dtype=torch.float32, device=dev)
        return lo, lo * coef
    mean = ex.luma_mean(buf)
    if cfg.kind == ToneMapperKind.STDDEV_AROUND_MEAN:
        dev_ = torch.sqrt(ex.luma_variance(buf, mean))
    elif cfg.kind == ToneMapperKind.ABSDEV_AROUND_MEAN:
        dev_ = ex.luma_absdev(buf, mean)
    else:
        raise ValueError(f"unknown tone mapper {cfg.kind}")
    hi = torch.clamp(mean + dev_, max=cfg.max_dynamic)
    lo = hi / coef
    under = lo < cfg.min_dynamic
    lo = torch.where(under, cfg.min_dynamic, lo)
    hi = torch.where(under, lo * coef, hi)
    return lo, hi


def tonemap(buf: ex.ExposureBuffer, cfg: ToneMapConfig) -> Tensor:
    """Apply the window -> [h, w, 3] in [0, 1] (view/view.ts:34-38)."""
    lo, hi = dynamic_range(buf, cfg)
    return ex.discretize(buf.pixels, lo, hi)
