"""View glue — tone-map window -> display image (port of
``raytracer_js_tpu.view.view``; reference view/view.ts:23-41), and the
progressive loop of main.ts:210: ``progressive_render`` drives render ->
accumulate -> tone map across exposure frames."""
from __future__ import annotations

from typing import Sequence

import torch

from ..config import RenderConfig, ToneMapConfig
from ..models.camera import Camera
from ..models.scene import Scene
from ..ops.color import overlay_color
from ..ops.sampling import DEFAULT_SEED, step_seed
from ..render import render_hdr
from . import exposure as ex
from .tonemap import tonemap


def draw(buf: ex.ExposureBuffer, cfg: ToneMapConfig) -> torch.Tensor:
    """ExposureBuffer -> display-ready [0,1] image (view.ts:34-38)."""
    return tonemap(buf, cfg)


def draw_rgba(buf: ex.ExposureBuffer, cfg: ToneMapConfig,
              overlays: Sequence = ()) -> torch.Tensor:
    """RGBA display path: tone-map, make it opaque RGBA (the canvas sink
    writes alpha 0xff, screen_canvas.ts:45-56), then alpha-composite each
    of ``overlays`` ([h, w, 4] RGBA, e.g. a HUD) on top with
    ``ops/color.overlay_color`` (color.ts:59-65) -> [h, w, 4]."""
    rgb = tonemap(buf, cfg)
    img = torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)
    for layer in overlays:
        img = overlay_color(torch.as_tensor(layer, dtype=rgb.dtype,
                                            device=rgb.device), img)
    return img


def progressive_render(scene: Scene, camera: Camera, cfg: RenderConfig,
                       tone: ToneMapConfig, frames: int,
                       seed: int = DEFAULT_SEED) -> torch.Tensor:
    """Render ``frames`` exposure frames, accumulate their running mean
    (exposure_buffer.ts:53-91), then tone-map. Frame f draws from the seed
    ``ops/sampling.step_seed(seed, f)``, the port's counterpart of the
    reference's ``fold_in(key, f)``: the per-frame streams differ from the
    reference's, frame 0's included."""
    buf = ex.new_exposure_buffer(camera.h, camera.w, device=camera.device)
    for f in range(frames):
        frame = render_hdr(scene, camera, cfg, seed=step_seed(seed, f))
        buf = ex.accumulate(buf, frame)
    return draw(buf, tone)
