"""Render frontend — ``render_hdr(scene, camera, cfg) -> image``.

Port of ``raytracer_js_tpu.render``: one wavefront of ``h*w`` rays per frame
(raytracer.ts:281-339), the camera substance looked up once per frame
(raytracer.ts:312-313), and ``spp`` samples averaged per call. The FUSED
backend runs the headline frame through the frame kernel; arbitrary
wavefronts go through the wavefront kernel; scenes outside the fused class
(BOTH materials, image textures, a cube-map sky) take the BRUTE loop. The
PALLAS backend runs the wavefront loop with kernels B3/B4 as its search.
TILED renders through ``render_tiled`` (kernels B7 and B6); TILED requests
on scenes of at most ``TILED_MIN_PRIMS`` prims without cached tables, and
on BOTH scenes, go to PALLAS. OCTREE searches the octree's grid with the
octree kernel (``kernels/octree_dda``) when given an ``accel``
(``accel/octree.build_octree``), else densely, as BRUTE does. On the card
the wavefront loop (``ops/trace``) shades each bounce of a scene in the
shade kernel's class in one launch (``kernels/shade``). This is the
reference's dispatch. FUSED and TILED have no backward: a call refuses
inputs that require grad once (``ops/trace.refuse_grad``), before any
sample.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import render_tiled as rtl
from .config import HitBackend, RenderConfig
from .kernels import trace_fused
from .models.camera import Camera, pixel_rays
from .models.scene import Scene
from .ops import sampling
from .ops import trace as trace_mod
from .ops.trace import refuse_grad, start_substance
from .utils.profiling import span

Tensor = torch.Tensor

#: TILED requests on scenes of at most this many prims without cached
#: tables (and on BOTH scenes) render on the PALLAS wavefront path, as in
#: the reference
TILED_MIN_PRIMS = 2048


def _stochastic(scene: Scene, cfg: RenderConfig) -> bool:
    """spp averaging only helps when some draw varies per sample: rough
    scatter, or the Fresnel-BOTH split."""
    return scene.has_rough or (scene.has_both and cfg.fresnel_both)


def _average(one, spp: int, stochastic: bool) -> Tensor:
    if spp == 1 or not stochastic:
        return one(0)
    acc = one(0)
    for s in range(1, spp):
        acc = acc + one(s)
    return acc / spp


def render_rays(scene: Scene, cfg: RenderConfig, org: Tensor, dir: Tensor,
                seed: int = sampling.DEFAULT_SEED,
                ray_id: Optional[Tensor] = None, accel=None) -> Tensor:
    """Trace a flat wavefront, averaging ``cfg.spp`` samples -> [N, 3] HDR.

    Sample s of ray i draws from the stream (seed, ray_id[i]*spp + s).
    ``accel`` (the octree) serves the OCTREE search and the transmission
    substance query of the wavefront loop.
    """
    if ray_id is None:
        ray_id = torch.arange(org.shape[0], dtype=torch.int32,
                              device=org.device)
    if cfg.backend == HitBackend.TILED:
        # the tiled path is frame-shaped; arbitrary wavefronts use the
        # dense search, as in the reference
        cfg = dataclasses.replace(cfg, backend=HitBackend.BRUTE)
    if cfg.backend == HitBackend.FUSED:
        if trace_fused.supports(scene):
            refuse_grad(scene, org, dir)
            refr0 = (start_substance(scene, org[0])
                     if scene.has_transmission else None)

            def one_fused(s):
                color, _status = trace_fused.trace_rays_fused(
                    scene, cfg, org, dir, seed=seed,
                    ray_id=ray_id * cfg.spp + s, start_refr=refr0)
                return color

            return _average(one_fused, cfg.spp, _stochastic(scene, cfg))
        cfg = dataclasses.replace(cfg, backend=HitBackend.BRUTE)

    # the camera's substance matters only where a ray can refract, and
    # sample 0 of one draws from the ray's own id
    refr0 = (start_substance(scene, org[0]).expand(org.shape[0])
             if scene.has_transmission else None)

    def one_sample(s):
        rid = ray_id if cfg.spp == 1 else ray_id * cfg.spp + s
        return trace_mod.trace_rays(scene, cfg, org, dir, seed, rid,
                                    start_refr=refr0, accel=accel).color

    return _average(one_sample, cfg.spp, True)


def render_hdr(scene: Scene, camera: Camera, cfg: RenderConfig,
               seed: Optional[int] = None, accel=None,
               tables=None) -> Tensor:
    """Full-frame HDR render -> [h, w, 3] float32 (linear, pre-tone-map),
    on the scene's device.

    ``tables`` — cached TILED candidate tables
    (``render_tiled.frame_tables(scene, camera)``); without them TILED
    builds them on the host per call. ``accel`` — an
    ``accel/octree.OctreeAccel`` of this scene: OCTREE searches with its
    grid DDA (without it, densely, the reference's path), and the
    transmission substance query of the wavefront loop and of TILED uses
    its grid. FUSED and TILED raise on inputs that require grad.
    """
    with span("rt.render"):
        if cfg.backend == HitBackend.TILED and (
                (scene.n_prims <= TILED_MIN_PRIMS and tables is None)
                or scene.has_both):
            # small scenes render faster on the whole-table wavefront path,
            # and the tiled kernels have no BOTH branch
            cfg = dataclasses.replace(cfg, backend=HitBackend.PALLAS)
        if seed is None:
            seed = sampling.DEFAULT_SEED
        if cfg.backend == HitBackend.TILED:
            # before the host builds tables for a frame that would raise;
            # the frames below are the unchecked bodies of the public ones
            refuse_grad(scene, camera.pos, camera.front, camera.left,
                        camera.up, backend="TILED")
            if tables is None:
                tables = rtl.frame_tables(scene, camera)
            # image scenes: a solid-search record pass + one flat replay
            # shading
            frame = (rtl._replay_shaded_frame
                     if scene.textures.has_images or scene.sky_box is not None
                     else rtl._tiled_frame)

            def one_tiled(s):
                return frame(scene, cfg, camera, tables=tables, seed=seed,
                             sample=s, accel=accel)

            return _average(one_tiled, cfg.spp, _stochastic(scene, cfg))
        if (cfg.backend == HitBackend.FUSED
                and trace_fused.supports_frame(scene)):
            # headline path: rays are generated inside the kernel
            refuse_grad(scene, camera.pos, camera.front, camera.left,
                        camera.up)
            refr0 = (start_substance(scene, camera.pos)
                     if scene.has_transmission else None)

            def one_frame(s):
                return trace_fused.trace_frame_fused(scene, cfg, camera,
                                                     seed=seed, sample=s,
                                                     start_refr=refr0)

            return _average(one_frame, cfg.spp, _stochastic(scene, cfg))
        org, dir = pixel_rays(camera)
        colors = render_rays(scene, cfg, org, dir, seed, accel=accel)
        return colors.reshape(camera.h, camera.w, 3)


# Convenience alias matching the package-level API.
render = render_hdr
