"""Config-driven demo app — the batch-rendering analogue of the reference's
browser demo (main.ts), ported from ``raytracer_js_tpu.demo``.

What main.ts does interactively (a random aligned scene of 16 spheres and
boxes with weighted random materials, REFMAX=4, fov pi/2, a 128x128
canvas, progressive exposure ticks, an FPS HUD; main.ts:341-433), this
module does as a CLI: generate the same kind of scene from a seed, render
``--frames`` progressive exposure frames, tone-map, write a PNG (a ``.npy``
of the 8-bit image without PIL), and print the throughput the HUD showed.

Run: ``python -m raytracer_js_tpu_torch.demo --seed 42 --size 128 --out
demo.png`` (on the card; ``--device cpu`` for the plain PyTorch versions).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from .config import (RenderConfig, ResponseType, ToneMapConfig,
                     ToneMapperKind, resolve_device)
from .models import camera as cam_mod
from .models.camera import make_camera
from .models.scene import REFR_GLASS, REFR_WATER, Scene, SceneBuilder
from .ops.sampling import step_seed
from .render import render_hdr
from .utils.profiling import RayMeter, block
from .view import exposure as ex
from .view.screen import write_png
from .view.view import draw

#: the reference demo's constants (main.ts:48-49)
REFMAX = 4
RANDOM_SEED = 42


def weighted_choice(rng: np.random.Generator, pairs):
    """Weighted random choice over (weight, value) pairs: the correct
    cumulative-weight sampler (the reference's comparator takes one
    argument, main.ts:84, so its sort is the identity; a documented
    divergence)."""
    weights = np.asarray([p[0] for p in pairs], np.float64)
    i = rng.choice(len(pairs), p=weights / weights.sum())
    return pairs[i][1]


def generate_aligned_entities(b: SceneBuilder, rng: np.random.Generator,
                              count: int, materials, substances, textures,
                              min_depth: int = 1, max_depth: int = 7):
    """Random entities placed on the octree grid (main.ts:97-147): each
    picks a depth d in [min, max], a size of 2^-d, and a position snapped
    to the 2^-d grid, so every entity fills one octree cell."""
    for _ in range(count):
        depth = int(rng.integers(min_depth, max_depth + 1))
        size = 2.0 ** -depth
        cells = 1 << depth
        pos = (rng.integers(0, cells, 3) + 0.5) * size
        mat, sub = weighted_choice(rng, materials)
        tex = weighted_choice(rng, textures)
        if rng.random() < 0.5:
            b.add_sphere(pos, size / 2.0, mat, tex, sub)
        else:
            b.add_box(pos, size, mat, tex, sub)


def build_demo_scene(seed: int = RANDOM_SEED, entities: int = 16,
                     device=None) -> Scene:
    """The demo scene: a unit-box world, ``entities`` aligned random
    entities, a sky; on the card unless ``device`` says otherwise."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0.30, 0.42, 0.65)))

    smooth = b.add_material(ResponseType.REFLECTION, mirror=True)
    light = b.add_material(ResponseType.REFLECTION, light=True)
    diffuse = b.add_material(ResponseType.REFLECTION)
    transparent = b.add_material(ResponseType.TRANSMISSION)
    water = b.add_substance(REFR_WATER)
    glass = b.add_substance(REFR_GLASS)

    textures = [(1.0, b.add_solid_texture(rng.uniform(0.25, 1.0, 3)))
                for _ in range(8)]
    # the weighted material mix of main.ts:116-126
    materials = [
        (4.0, (diffuse, -1)),
        (2.0, (smooth, -1)),
        (1.5, (transparent, glass)),
        (1.0, (transparent, water)),
        (1.0, (light, -1)),
    ]
    generate_aligned_entities(b, rng, entities, materials, None, textures)
    # the unit-cube world shell the camera sits inside (main.ts:393-396)
    b.add_box((0.5, 0.5, 0.5), 1.0, diffuse,
              b.add_solid_texture((0.55, 0.55, 0.55)))
    return b.build(device=device)


def run_orbit(args, scene, cam, cfg, tone, meter) -> int:
    """Camera-path mode, the batch analogue of the interactive loop
    (main.ts:254-339): per pose, move and rotate the camera (camera.ts),
    reset the exposure buffer (any motion restarts accumulation,
    exposure_buffer.ts:63-66), re-accumulate ``--frames`` frames and write
    the pose's tone-mapped image."""
    base, ext = (args.out.rsplit(".", 1) + ["png"])[:2]
    buf = ex.new_exposure_buffer(args.size, args.size, device=cam.device)
    step_h = 2.0 * np.pi / args.orbit
    outs = []
    for pose in range(args.orbit):
        if pose:
            # strafe and yaw so the camera circles its view center: each
            # motion is a WASD/mouse update of the PlayerInterface
            cam = cam_mod.move_xy_forward(cam, 0.15 * np.sin(step_h))
            cam = cam_mod.rotate_h(cam, step_h * 0.1)
            cam = cam_mod.rotate_v(cam, 0.02 * np.cos(pose), lock=True)
            buf = ex.reset(buf)         # motion -> restart accumulation
        assert int(buf.frame_count) == 0
        for f in range(args.frames):
            with meter.frame(args.size * args.size):
                frame = block(render_hdr(scene, cam, cfg, seed=step_seed(
                    args.seed, pose * args.frames + f)))
            buf = ex.accumulate(buf, frame)
        assert int(buf.frame_count) == args.frames
        outs.append(write_png(f"{base}_{pose:03d}.{ext}", draw(buf, tone)))
    print(f"wrote {len(outs)} poses ({outs[0]} .. {outs[-1]})  "
          f"{args.size}x{args.size}  frames/pose={args.frames}  "
          f"{meter.rays_per_s / 1e6:.2f} M rays/s on {cam.device}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=RANDOM_SEED,
                    help="scene and frame seed (the ?seed= URL param, "
                    "main.ts:149-152)")
    ap.add_argument("--size", type=int, default=128,
                    help="square frame size (dist/test.html:9)")
    ap.add_argument("--entities", type=int, default=16)
    ap.add_argument("--frames", type=int, default=4,
                    help="progressive exposure frames")
    ap.add_argument("--refmax", type=int, default=REFMAX)
    ap.add_argument("--out", default="demo.png")
    ap.add_argument("--tonemap", default="identity",
                    choices=["identity", "stddev", "absdev"])
    ap.add_argument("--orbit", type=int, default=0, metavar="N",
                    help="camera-path mode: N poses orbiting the scene; "
                    "each motion resets the exposure buffer and each pose "
                    "re-accumulates --frames frames (main.ts:254-330 as a "
                    "batch path)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    scene = build_demo_scene(args.seed, args.entities, device=dev)
    cam = make_camera((0.5, 0.5, 0.5), args.size, args.size,
                      np.pi / 2, np.pi / 2, device=dev)
    cfg = RenderConfig(refmax=args.refmax)
    tone = ToneMapConfig(kind={
        "identity": ToneMapperKind.IDENTITY,
        "stddev": ToneMapperKind.STDDEV_AROUND_MEAN,
        "absdev": ToneMapperKind.ABSDEV_AROUND_MEAN,
    }[args.tonemap])
    meter = RayMeter()
    if args.orbit:
        return run_orbit(args, scene, cam, cfg, tone, meter)

    buf = ex.new_exposure_buffer(args.size, args.size, device=dev)
    for f in range(args.frames):
        with meter.frame(args.size * args.size):
            frame = block(render_hdr(scene, cam, cfg,
                                     seed=step_seed(args.seed, f)))
        buf = ex.accumulate(buf, frame)
    path = write_png(args.out, draw(buf, tone))

    m = float(ex.luma_mean(buf))
    v = float(ex.luma_variance(buf, m))
    print(f"wrote {path}  {args.size}x{args.size}  "
          f"frames={int(buf.frame_count)}  luma mean={m:.4f} "
          f"sigma={v ** 0.5:.4f}  {meter.rays_per_s / 1e6:.2f} M rays/s "
          f"(fps SMA {meter.fps.value:.1f}) on {dev}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
