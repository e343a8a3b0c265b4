#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``raytracer_js_tpu_torch``) on one
NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, one JSON line each:
  0. device   — needs CUDA (exit 1 without it); prints the card's name and
                ``nvidia-smi`` name/power limit; TF32 off.
  1. build    — nvcc builds the kernels from ``raytracer_js_tpu_torch/csrc``.
  2. B1       — the frame kernel against its plain PyTorch version, image,
                status and recorded pid bit for bit, and the spheres each
                warp tested at each bounce equal to the plain form of its
                cull (``tf.cull_counts``): (a) the headline scene at
                1920x1088, refmax 2 (and its bounce-0 and bounce-1 cull);
                (b) config 1 with glass and a triangle, 256x256, refmax 3;
                (c) a rough + glass scene, spp 4; (d) a 600-sphere near-miss
                field at 512x512 (three shared-memory windows); (e) a 40x24
                rotated camera (partial edge warps, dead lanes at bounce 1);
                (g) the field at 45x21, refmax 3 (windows, partial warps
                and a partial block row).
  3. B2       — the wavefront kernel against its plain version as B1, on
                (b), (c) and (d), and ``render_rays`` with FUSED; (f) a ray
                on a mirror box's edge (the x > y > z face tie; one partial
                warp).
  4. B3       — the scalar nearest-hit kernel against its plain version,
                t and pid bit for bit and the spheres each warp tested equal
                to the plain form of its cone cull (``nh.scalar_cull``):
                (a) the headline scene's 1920x1088 bounce-0 and bounce-1
                rays (as ``record_paths`` searches them); (b) config 1 with
                glass and a triangle, camera and random rays; (c) a
                384-sphere near-miss field at 512x512.
  5. B4       — the dense nearest-hit kernel against its plain version, t
                and pid bit for bit: (a) BASELINE config 3's 512x512
                bounce-0 rays (5124 prims); (b) the 600-sphere near-miss
                field; (c) config 3 with n_live < N; (d) the empty scene;
                (e) a ray on a box edge; (f) rays through shared triangle
                edges and vertices; (i) ties in t across the boundary of
                two splits of the scan; (g, h) config 4's first and last
                packet-mode rescue rounds (from 9c: 100k spheres, their
                n_live, the scan split).
  6. B5       — the replay forward and backward kernels against their plain
                versions: (a) a headline 1920x1088 view, winners recorded
                by B3, a random target; (e) its all-ground pixels packed,
                so that every warp has one winner; (b) the 9-sphere replay
                scene at refmax 3 and 4; (c) a 600-sphere listed-class
                field at 512x512, recorded by B4; (d) all-miss rays and
                rays exhausted at refmax. Up to 192 prims the backward's
                sums equal the float32 model of its order
                (``rg.bwd_sums_model``) bit for bit. Then B5's gradients
                against autograd through the search path on view (a); then
                (f) BASELINE config 5's size: the 1M-prim config-4 field
                (the fit's class, global-atomic sphere sums), view 0 of
                config 5 recorded through the octree, and both kernels
                timed alone (``python3 chip_smoke.py --replay-1m`` runs
                (f) by itself).
 6b. B7       — the tiled frame kernel against its plain version, every
                plane bit for bit (and the chunks each warp scanned), and
                every plane bit for bit against the plain version with the
                first design's 256-ray exit groups (never fewer chunks):
                (a) one 128x32 tile; (b) partial edge tiles (151x37, the
                600-sphere field); (c) config 3's image scene (uv planes);
                (d) the rough + glass scene (normal planes, transmission).
 6c. B6       — the listed nearest-hit kernel against its plain version (t
                and pid bit for bit, the same list slots streamed by each
                warp), against the plain version with the first design's
                128-ray exit groups (t and pid bit for bit, never fewer
                slots) and against B4 on the same rays and Morton-permuted
                scene: (a) the 600-sphere field listed per 128-ray block;
                (b) config 3's mesh, triangles listed; (c) a supertile fan
                of 4; (d) n_live < N.
 6d. B7-wave  — the tiled wavefront kernel against its plain version, every
                plane bit for bit (and the chunks each warp scanned), and
                against the plain version with the first design's exit
                groups as B7, on packetized wavefronts with their packet
                tables: (a)
                config 4's first packet round (from 9c); (b) rowwise tables
                on the 600-sphere field; (c) truncated cell-grid tables
                (finite t_safe: unresolved rays pass through unchanged);
                (d) the rough + glass scene (normal planes); (e) config 3's
                image scene (uv planes); (f) one-row packets (wave_sub 1).
 6e. B8       — the cone-culled nearest-hit kernel against its plain version
                (t, pid and the sphere tiles each warp streamed, bit for
                bit) and against B4 on the same rays and Morton-permuted
                scene (t and pid bit for bit, 0 flips): (a) the 600-sphere
                field; (b) config 4's first sweep round with n_live < N
                (from 9d); (c) incoherent warps (cos_t < 0.25 keeps every
                tile).
  7. main     — ``render_hdr`` FUSED on the headline scene -> exposure ->
                STDDEV tone map -> PNG, plus ``render_rays`` FUSED over the
                same camera's rays, with the launch counters reset first;
                a profiler trace of one frame: no stream synchronization
                and no copy from pageable host memory.
  8. main-PALLAS — ``render_hdr`` PALLAS on config 3 (B4 at every bounce)
                -> exposure -> STDDEV tone map -> PNG, held against the same
                path with the plain versions on the CPU at a small size;
                then ``render_rays`` PALLAS over the headline camera's rays
                (B3), held against the FUSED frame. Counters reset first.
  9. main-fit — ``optim.fit`` over config 5's 8-view batch of the headline
                scene at 1920x1088 (refmax 2, PALLAS, 4 Adam steps, a
                recording every 2: B3 records, B5 differentiates), from
                perturbed sphere colors and centers; counters reset after
                the targets are rendered. Then one ``fit_cameras`` step at
                256x256, and a small fit held against the same fit on the
                CPU plain versions.
 9b. main-TILED — ``render_hdr`` TILED on BASELINE config 4 (1920x1088,
                100k prims, refmax 2; tables built on the host) -> exposure
                -> tone map -> PNG, counters reset first: B7 once, B6 each
                sweep round, no B3/B4, ``unresolved`` 0. Then B7 (e) on the
                full frame and B6 (e) on the first sweep round's compacted
                slice and lists, against their plain versions; and the frame
                against ``render_hdr`` PALLAS under the parity rule, at most
                ``C4_MAX_ROUNDING_FRAC`` of its pixels proven as rounding.
 9c. main-packet — ``render_hdr`` TILED in packet mode, counters reset
                first: B7 once, B7-wave once per live segment per packet
                round, B4 in rescue rounds only, ``unresolved`` 0. (a)
                config 4 with ``render_tiled.SWEEP_MAX_PRIMS = 0``, held
                against the 9b sweep frame at the reference's packet
                tolerance (rtol 1e-4, atol 1e-5, < 0.2% of pixels), every
                differing winner a proven flip or grazing hit; (b) the
                1.1M-sphere slab (packet mode by the default threshold),
                held against PALLAS on 65,536 sampled pixels.
 9d. main-cull — config 4 with ``SWEEP_LISTED = False`` and ``SWEEP_CULL =
                True``: B8 once per sweep round, the frame equal to 9b's
                but for proven flips.
 9e. work     — on config 4's first sweep round (B6) and its cull round
                (B8), summed over the live rays: the slots (tiles) the
                first design's 128-ray blocks stream, the slots the
                kernel's warps stream, and the slots each ray needs (B6:
                those whose t_lo lies within its own final hit or bbox
                exit, in whole chunks; B8: the tiles its own apex-0,
                angle-0 cone reaches); need <= warp <= block. The same for
                B7-wave on config 4's first packet round (the need: each
                ray's chunks up to its own exit, ``wave_need``).
 9f. main-OCTREE — the octree accel (``accel/octree``) and its search
                kernel (``octree_dda_kernel``, one launch a search, one
                thread a ray, dead rays masked; it replaces the
                reference's ``lax.while_loop``, no TPU kernel): (a) the
                native scene kit (``native``) built by g++ from
                ``csrc/scenekit.cpp``, its CSR scatter and covering levels
                equal to their NumPy specifications on config 2 (depth 4)
                and a 2,000-prim config 4 (depth 8); the kernel against its
                plain version, the live-ray loop, t bit for bit, pid, each
                ray's steps and tests and the stats, each case without and
                with a live mask (dead rays: t +inf, pid -1, no steps or
                tests), on the near-miss field (``octree_field``, depths 3
                and 4: rays tangent to spheres, along box faces, on cell
                faces, axis-parallel, walks ended by the 3R + 2 cap; a
                random half dead); (b) BASELINE config 2 (256x256, 50
                spheres, refmax 2, a depth-4 octree) through ``render_hdr``
                OCTREE equal to PALLAS in every pixel, the frame and the
                recording equal with every ray walking (no mask), the
                kernel against the loop on both bounces (the live rays; all
                rays with the frame's status and with a random half dead);
                (c) config 4 (1920x1088, 100k prims, refmax 2, depth 8, as
                ``bench.py --c4-backend octree``) against 9b's PALLAS
                frame, at most ``C4_MAX_ROUNDING_FRAC`` proven as rounding;
                the kernel against the loop on bounce 0 (2,088,960 rays;
                also a random half dead), bounce 1 as the frame sends it
                (every ray, the frame's status as the mask; also unmasked)
                and bounce 1's live rays alone, each search's steps, tests,
                ms (events around the wrapper, alone by the profiler, the
                loop's) and bound; the build's host seconds, the frame's ms,
                its device time by kernel name and its idle share
                (``frame_breakdown``) and peak device memory; the frame and
                the recording equal with every ray walking; every search
                the octree's, none dense, the kernel launched once a bounce
                and nothing else; (d) config 4's
                glass variant (``config4_glass_scene``) through TILED with
                ``accel=``: B7 once, B6 each sweep round, ``unresolved`` 0,
                no dense substance query, the grid query equal to the dense
                one on 4,096 of the frame's transmission points; (e) an
                OCTREE fit (4 views of the headline at 128x128, 4 SGD
                steps, ``accel_every=2``) against the same fit on the CPU:
                losses to rtol 1e-4, one rebuild each, one kernel launch
                for each octree search on the card; with PyTorch's
                deterministic algorithms, the fit with the live mask equal
                bit for bit to the fit with every ray walking (losses and
                every leaf).
 9g. main-sharded, one rank — a one-rank NCCL group (``parallel.distributed.
                init_distributed``, ``file://`` rendezvous), counters reset
                before each path: ``render_hdr_sharded`` on the headline
                (FUSED: B2 on the rank's slice) equal to ``render_rays``
                FUSED bit for bit and held to ``render_hdr`` FUSED (B1) by
                the frame-vs-wavefront ULP rule; config 3 sharded (B4) equal
                to the unsharded frame; ``sharded_fit_step`` on a headline
                view (B3) equal to the unsharded ``value_and_grad`` within
                float32 sum order; ``fit(mesh=...)`` on config 5's cut (8
                headline views at 1920x1088, PALLAS, ``replay_every=1``, 2
                SGD steps: B3 records, B5 replays) with the unsharded fit's
                losses to 1e-6; ``dryrun_multichip``.
 9h. main-sharded, two ranks — two processes (``torch.multiprocessing``
                spawn) in a gloo group on the one card (NCCL refuses two
                ranks on one device), CUDA tensors: the headline frame
                sharded equal to one process bit for bit, the 8-view fit's
                losses those of one process to rtol 1e-5, the ranks' params
                equal; B2, B3 and B5 launched on each rank. A rank that
                fails or outlives ``GLOO_JOIN_S`` fails the phase.
 9i. main-A9  — ``view.progressive_render`` on the headline at 1920x1088,
                FUSED, 4 frames: B1 4 times, equal to the port's own loop of
                ``render_hdr`` with ``step_seed(seed, f)`` and
                ``accumulate``; ``demo.main`` at 128x128 (4 frames, then
                ``--orbit 2``) on the card (BRUTE, the reference's
                ``refmax=4`` config): the images written.
 9j. main-shade — the wavefront shade kernel (``kernels/shade``,
                ``shade_bounce_kernel``, one launch a bounce; it replaces
                the plain ``ops/trace._shade``, no TPU kernel): (a) the
                kernel against ``_shade`` (and the epilogue on the last
                bounce), every column of the state and the next ALIVE mask
                bit for bit, at both bounces of refmax 2 on config 4's
                frame rays (the octree search), the 600-sphere near-miss
                field, the rough scene with its glass as diffuse (the RNG
                live) and ``tri_edge_field``, and on states with every
                status (TILED's capped one too) and a per-ray bounce; (b)
                config 4's OCTREE and TILED frames equal to the plain
                path's bit for bit (``plain_shade``), the launches counted
                (OCTREE: 2 and 0 plain; TILED: one a sweep round), each
                frame's ms, device operations and idle share; (c)
                ``config4_glass_scene`` (OCTREE at 480x272) and a cube-sky
                scene on the plain ``_shade``; (d) the kernel alone at
                config 4's bounce 0 and bounce 1 against its bound (bytes)
                and the plain ``_shade``, and ``engages``'s host time
                (config 4, grad on). ``python3 chip_smoke.py --shade``
                runs the build and this phase alone.
 9k. main-octree-build — the octree's fine grid on the card
                (``kernels/octree_build``: the count, fill, sort and skip
                passes; no TPU kernel, the reference builds on the host):
                (a) config 4's field (100k prims) and config 5's (1M),
                depth 8, built on the card and on the host (a CPU copy of
                the scene), every array of the accel equal, and again with
                ``like=`` an accel of more room and the prims moved; the
                passes' launches (1, 1, 1, 3); each pass alone (profiler
                median), the whole build on the card and on the host (host
                clock), the AABB read and ``grid_inputs`` alone; (b) a
                depth-9 grid with one occupied corner (distances to 511):
                the CSR and the skip field against ``native.grid_csr`` and
                scipy's, most cells capped at 255; (c) a 16-step OCTREE fit
                of the headline (2 views at 480x272, ``accel_every`` =
                ``replay_every`` = 8) with the card build and with the host
                build: losses and leaves equal bit for bit (deterministic
                algorithms on). ``python3 chip_smoke.py --octree-build``
                runs the build and this phase alone.
     times (sharded) — the sharded headline frame at one rank against
                ``render_rays`` FUSED, the all-reduce of a config-5 fit
                step's gradients at one rank (NCCL) and at two (gloo), and
                the 8-view fit step sharded and unsharded (host clock).
 10. times    — CUDA-event medians of each kernel and its plain version at
                the main paths' shapes; each kernel also alone, by the
                profiler (``kernel_ms``; B1, B2, B3 and B5 with their
                spread and the device work one call issues, B1 and B2 at
                refmax 2 and 1);
                ``render_hdr`` end to end, and the
                gradient path: a replay step for one view, an 8-view fit
                step and an 8-view recording; config 4's TILED frame, B7,
                B6 per sweep round, and its PALLAS frame; the packet frames
                (config 4, 1.1M) with B7-wave summed over their rounds, B4
                per rescue round and the glue (the frame less B7, B7-wave
                and B4), the cull frame and B8 per round, the host tables.
                Then each kernel's bound: the larger of its tests'
                operations over 67 TFLOP/s (float32) and its bytes in and
                out over 3.35 TB/s, counted from this run's inputs
                (``OPS``); B1's, B2's, B3's, B6's, B7's, B7-wave's and
                B8's from the work the rays need (9e, ``frame_need``; B1,
                B2 and B3: each ray's own cone), printed beside the bound of
                what the warps streamed and the time of one streamed test;
                B7-wave's chunks per warp and time per launch.
Parity rule: allclose(rtol=1e-5, atol=1e-6) and equal status per pixel (or
pid per ray), except proven winner flips (``utils/parity``), at most 0.1%.
B5: colors and per-ray cotangents bit-exact; per-prim and sky cotangents
within 1e-5 of the sum of the terms' magnitudes (the kernel sums in another
order), and bit-reproducible where the kernel's reduction is deterministic.
Any failure raises, so the script exits non-zero and never prints the last
line, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import multiprocessing.connection
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as torch_mp

import raytracer_js_tpu_torch as rt
from raytracer_js_tpu_torch import (HitBackend, RenderConfig, ResponseType,
                                    SceneBuilder, ToneMapConfig,
                                    ToneMapperKind, make_camera)
from raytracer_js_tpu_torch import demo, native
from raytracer_js_tpu_torch.accel import candidates as cand
from raytracer_js_tpu_torch.accel import octree
from raytracer_js_tpu_torch.kernels import _build
from raytracer_js_tpu_torch.kernels import nearest_hit as nh
from raytracer_js_tpu_torch.kernels import octree_build as ob
from raytracer_js_tpu_torch.kernels import octree_dda as od
from raytracer_js_tpu_torch.kernels import replay_grad as rg
from raytracer_js_tpu_torch.kernels import shade
from raytracer_js_tpu_torch.kernels import trace_fused as tf
from raytracer_js_tpu_torch.kernels import trace_tiled as tt
from raytracer_js_tpu_torch.models.camera import move, pixel_rays, rotate_h
from raytracer_js_tpu_torch.models.scene import (float_leaf_names,
                                                 float_partition, prim_aabbs)
from raytracer_js_tpu_torch.ops import trace as trace_mod
from raytracer_js_tpu_torch.ops.sampling import DEFAULT_SEED, step_seed
from raytracer_js_tpu_torch.ops.trace import (record_paths, start_substance,
                                              trace_rays)
from raytracer_js_tpu_torch.optim import FitConfig, fit
from raytracer_js_tpu_torch.optim.fit import record_views, replay_loss
from raytracer_js_tpu_torch.parallel import distributed as pdist
from raytracer_js_tpu_torch.parallel.dryrun import dryrun_multichip
from raytracer_js_tpu_torch.parallel.sharding import (all_reduce_sum,
                                                       make_mesh,
                                                       render_hdr_sharded,
                                                       sharded_fit_step)
from raytracer_js_tpu_torch import render_tiled as rtl
from raytracer_js_tpu_torch.render import render_rays
from raytracer_js_tpu_torch.utils import parity
from raytracer_js_tpu_torch.utils.mesh import icosphere
from raytracer_js_tpu_torch.view import exposure, screen, view

HEADLINE_W, HEADLINE_H = 1920, 1088
C3_W, C3_H = 512, 512
C4_W, C4_H = 1920, 1088
#: share of config 4's pixels that TILED and PALLAS may differ in by
#: rounding (a first hit on a sphere whose t float32 leaves undetermined
#: beyond rtol): the factored quadratic of TILED's bounce 0 leaves t of the
#: small far spheres undetermined by about 1e-3; 0.31% of the frame on an
#: H100 80GB HBM3 (700 W)
C4_MAX_ROUNDING_FRAC = 0.005
#: case (b) of the packet phase: config 4's slab with 1,099,998 spheres, past
#: the sweep threshold, held against PALLAS on this many sampled pixels
C4B_PRIMS = 1_100_000
C4B_SAMPLES = 65536
#: its cap on the rounding-proven share: the share grows with the sphere
#: silhouettes a pixel sees, and the slab holds 11 times config 4's spheres
C4B_MAX_ROUNDING_FRAC = 0.03
SWEEP_MAX_PRIMS = rtl.SWEEP_MAX_PRIMS
WARMUP, TIMED = 3, 20
#: a profiler trace of ``kernel_report`` runs TRACE_PAD calls before the
#: ``TIMED`` it keeps, and is taken up to TRACE_TRIES times
TRACE_PAD, TRACE_TRIES = 10, 3
#: how every kernel's ``ms`` is taken (``cuda_median_ms``), and B7-wave's
#: ``kernel_ms`` beside it (``device_ms_per_call``)
MS_TIMING = "median of CUDA events around the wrapper's call"
KERNEL_MS_TIMING = "mean kernel time in a torch.profiler trace of the card"
KERNEL_SOURCE = "raytracer_js_tpu_torch/csrc/trace_fused.cu"
NH_SOURCE = "raytracer_js_tpu_torch/csrc/nearest_hit.cu"
REPLAY_SOURCE = "raytracer_js_tpu_torch/csrc/replay_grad.cu"
TILED_SOURCE = "raytracer_js_tpu_torch/csrc/trace_tiled.cu"
OCTREE_SOURCE = "raytracer_js_tpu_torch/csrc/octree_dda.cu"
SHADE_SOURCE = "raytracer_js_tpu_torch/csrc/shade.cu"
BUILD_SOURCE = "raytracer_js_tpu_torch/csrc/octree_build.cu"
FIT_VIEWS = 8
#: phase 9f: BASELINE config 2's frame, the octree depths of configs 2 and
#: 4 (``BASELINE.md``; ``bench.py --c4-backend octree``), the substance
#: points held against the dense query, and the OCTREE fit's views
C2_W, C2_H = 256, 256
C2_DEPTH, C4_DEPTH = 4, 8
SUBSTANCE_SAMPLES = 4096
OCT_FIT_VIEWS, OCT_FIT_W = 4, 128


# ---------------------------------------------------------------------------
# Scenes (numpy-seeded recipes on the port's builder)
# ---------------------------------------------------------------------------

def headline_scene(n_spheres: int = 50, seed: int = 42, device=None):
    """The benchmark scene of the reference package (``bench.build_scene``):
    a ground box, ``n_spheres`` random diffuse/mirror spheres and one
    emissive sphere."""
    b = SceneBuilder()
    sky = b.add_solid_texture((0.35, 0.45, 0.65))
    b.set_sky(sky)
    grey = b.add_solid_texture((0.6, 0.6, 0.6))
    white = b.add_solid_texture((1.0, 1.0, 1.0))
    diffuse = b.add_material(ResponseType.REFLECTION)
    mirror = b.add_material(ResponseType.REFLECTION, mirror=True)
    light = b.add_material(ResponseType.REFLECTION, light=True)
    b.add_box((0.0, 0.0, -51.0), 100.0, diffuse, grey)
    rng = np.random.default_rng(seed)
    centers = rng.uniform([2.0, -6.0, -0.5], [14.0, 6.0, 5.0], (n_spheres, 3))
    radii = rng.uniform(0.15, 0.6, n_spheres)
    palette = [b.add_solid_texture(rng.uniform(0.2, 1.0, 3)) for _ in range(8)]
    for i in range(n_spheres):
        b.add_sphere(centers[i], float(radii[i]),
                     mirror if i % 3 == 0 else diffuse, palette[i % 8])
    b.add_sphere((8.0, 0.5, 6.0), 1.0, light, white)
    return b.build(device)


def headline_camera(device=None):
    return make_camera((0.0, 0.0, 0.5), HEADLINE_W, HEADLINE_H, np.pi / 2,
                       np.pi / 2 * HEADLINE_H / HEADLINE_W, device=device)


def config3_scene(subdiv: int = 4, device=None):
    """BASELINE config 3 (``bench.build_config3_scene``): a ground box, a
    mirror icosphere of 20 * 4^subdiv triangles (5120 at 4), a mirror
    sphere, a checker-textured sphere, an emitter, and a 64x64 gradient
    image sky, all on a 64x64 atlas."""
    b = SceneBuilder(atlas_hw=(64, 64))
    yy = np.linspace(0.0, 1.0, 64)[:, None] * np.ones((1, 64))
    sky_img = np.stack([0.35 + 0.25 * yy, 0.45 + 0.25 * yy,
                        0.65 + 0.2 * yy], -1).astype(np.float32)
    b.set_sky(b.add_image_texture(sky_img))
    check = (np.indices((64, 64)).sum(0) % 2).astype(np.float32)[..., None]
    checker = (check * [0.55, 0.1, 0.1] + [0.25, 0.3, 0.35]).astype(np.float32)
    tex_check = b.add_image_texture(checker)
    grey = b.add_solid_texture((0.55, 0.55, 0.6))
    white = b.add_solid_texture((1.0, 1.0, 1.0))
    gold = b.add_solid_texture((0.9, 0.75, 0.3))
    diffuse = b.add_material(ResponseType.REFLECTION)
    mirror = b.add_material(ResponseType.REFLECTION, mirror=True)
    light = b.add_material(ResponseType.REFLECTION, light=True)
    b.add_box((0.0, 0.0, -51.0), 100.0, diffuse, grey)
    v, f = icosphere(subdiv, radius=1.2, center=(6.0, 0.0, 1.0))
    b.add_mesh(v, f, mirror, gold)
    b.add_sphere((4.0, -2.0, 0.6), 0.8, mirror, white)
    b.add_sphere((4.0, 2.2, 0.7), 0.9, diffuse, tex_check)
    b.add_sphere((6.0, 1.0, 5.0), 1.2, light, white)
    return b.build(device)


def config3_camera(device=None):
    return make_camera((0.0, 0.0, 0.5), C3_W, C3_H, np.pi / 2, np.pi / 2,
                       device=device)


def config4_scene(n_prims: int = 100_000, seed: int = 7, device=None):
    """BASELINE config 4 (``bench.build_config4_scene``): a uniform field
    of ``n_prims - 2`` small spheres over a slab ahead of the camera (every
    third a mirror), a ground box and an emitter."""
    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0.35, 0.45, 0.65)))
    grey = b.add_solid_texture((0.6, 0.6, 0.6))
    white = b.add_solid_texture((1.0, 1.0, 1.0))
    diffuse = b.add_material(ResponseType.REFLECTION)
    mirror = b.add_material(ResponseType.REFLECTION, mirror=True)
    light = b.add_material(ResponseType.REFLECTION, light=True)
    b.add_box((20.0, 0.0, -52.0), 100.0, diffuse, grey)
    rng = np.random.default_rng(seed)
    n_s = n_prims - 2
    centers = rng.uniform([4.0, -20.0, -1.0], [44.0, 20.0, 7.0], (n_s, 3))
    radii = rng.uniform(0.05, 0.18, n_s)
    palette = [b.add_solid_texture(rng.uniform(0.2, 1.0, 3))
               for _ in range(16)]
    for i in range(n_s):
        b.add_sphere(centers[i], float(radii[i]),
                     mirror if i % 3 == 0 else diffuse, palette[i % 16])
    b.add_sphere((24.0, 0.0, 14.0), 3.0, light, white)
    return b.build(device)


def config4_camera(device=None):
    """Config 4's camera (``bench.py``): 1920x1088, fov pi/2 x pi/2 * h/w."""
    return make_camera((0.0, 0.0, 0.5), C4_W, C4_H, np.pi / 2,
                       np.pi / 2 * C4_H / C4_W, device=device)


def config4_glass_scene(n_prims: int = 100_000, seed: int = 7,
                        device=None):
    """Config 4's layout with glass: every third small sphere is
    TRANSMISSION with a 1.5 substance in place of the mirror, every 30th
    TRANSMISSION of undefined substance (no refraction), the rest
    diffuse; the ground box and the emitter as config 4."""
    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0.35, 0.45, 0.65)))
    grey = b.add_solid_texture((0.6, 0.6, 0.6))
    white = b.add_solid_texture((1.0, 1.0, 1.0))
    diffuse = b.add_material(ResponseType.REFLECTION)
    glass = b.add_material(ResponseType.TRANSMISSION)
    light = b.add_material(ResponseType.REFLECTION, light=True)
    glass_sub = b.add_substance(1.5)
    b.add_box((20.0, 0.0, -52.0), 100.0, diffuse, grey)
    rng = np.random.default_rng(seed)
    n_s = n_prims - 2
    centers = rng.uniform([4.0, -20.0, -1.0], [44.0, 20.0, 7.0], (n_s, 3))
    radii = rng.uniform(0.05, 0.18, n_s)
    palette = [b.add_solid_texture(rng.uniform(0.2, 1.0, 3))
               for _ in range(16)]
    for i in range(n_s):
        if i % 3 == 0:
            b.add_sphere(centers[i], float(radii[i]), glass, white,
                         substance=glass_sub)
        elif i % 30 == 1:
            b.add_sphere(centers[i], float(radii[i]), glass, palette[i % 16])
        else:
            b.add_sphere(centers[i], float(radii[i]), diffuse,
                         palette[i % 16])
    b.add_sphere((24.0, 0.0, 14.0), 3.0, light, white)
    return b.build(device)


def config2_scene(n: int = 50, seed: int = 7, device=None):
    """BASELINE config 2 (``tests/test_configs.config2_scene``): a ground
    box, ``n`` random spheres (every third a mirror) and an emitter."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0.4, 0.5, 0.7)))
    diffuse = b.add_material(ResponseType.REFLECTION)
    mirror = b.add_material(ResponseType.REFLECTION, mirror=True)
    light = b.add_material(ResponseType.REFLECTION, light=True)
    b.add_box((0, 0, -52.0), 100.0, diffuse,
              b.add_solid_texture((0.6, 0.6, 0.6)))
    for i in range(n):
        c = rng.uniform([2, -6, -1.5], [14, 6, 5])
        r = float(rng.uniform(0.15, 0.7))
        tex = b.add_solid_texture(rng.uniform(0.2, 1.0, 3))
        b.add_sphere(c, r, mirror if i % 3 == 0 else diffuse, tex)
    b.add_sphere((8.0, 0.0, 6.0), 1.0, light, b.add_solid_texture((1, 1, 1)))
    return b.build(device)


def config2_camera(device=None):
    return make_camera((0, 0, 0.5), C2_W, C2_H, np.pi / 2, np.pi / 2,
                       device=device)


def config1_scene(with_glass: bool = False, with_tri: bool = False,
                  device=None):
    """Config 1 of the reference tests: 3 spheres, ground box, emitter,
    optional glass sphere and triangle."""
    b = SceneBuilder()
    sky = b.add_solid_texture((0.35, 0.45, 0.65))
    b.set_sky(sky)
    red = b.add_solid_texture((0.9, 0.2, 0.15))
    green = b.add_solid_texture((0.2, 0.8, 0.3))
    grey = b.add_solid_texture((0.6, 0.6, 0.6))
    white = b.add_solid_texture((1.0, 1.0, 1.0))
    diffuse = b.add_material(ResponseType.REFLECTION, mirror=False)
    mirror = b.add_material(ResponseType.REFLECTION, mirror=True)
    light = b.add_material(ResponseType.REFLECTION, light=True)
    glass_mat = b.add_material(ResponseType.TRANSMISSION)
    glass_sub = b.add_substance(1.5)
    b.add_box((0.0, 0.0, -51.0), 100.0, diffuse, grey)
    b.add_sphere((4.0, 0.0, 0.3), 0.9, diffuse, red)
    b.add_sphere((4.5, 1.8, 0.2), 0.8, mirror, white)
    b.add_sphere((3.5, -1.7, 0.1), 0.7, diffuse, green)
    b.add_sphere((5.0, 0.5, 2.6), 0.8, light, white)
    if with_glass:
        b.add_sphere((2.6, 0.7, 0.4), 0.5, glass_mat, white, glass_sub)
    if with_tri:
        b.add_triangle((3.0, -0.8, -0.4), (3.6, 0.4, 1.3), (4.2, -1.6, 1.0),
                       diffuse, green)
    return b.build(device)


def rough_scene(roughness: float = 0.4, device=None):
    """Rough mirror, glass spheres (defined, undefined and nested
    substances), ground box and emitter."""
    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0.35, 0.45, 0.65)))
    diffuse = b.add_material(ResponseType.REFLECTION)
    mirror = b.add_material(ResponseType.REFLECTION, mirror=True,
                            roughness=roughness)
    light = b.add_material(ResponseType.REFLECTION, light=True)
    glass = b.add_material(ResponseType.TRANSMISSION)
    b.add_box((0, 0, -51.0), 100.0, diffuse, b.add_solid_texture((.6,) * 3))
    b.add_sphere((4, 0, 0.5), 1.0, mirror, b.add_solid_texture((.9, .2, .1)))
    b.add_sphere((3, -1.5, 0.5), 0.8, glass,
                 b.add_solid_texture((.95, .95, 1.0)),
                 substance=b.add_substance(1.5))
    b.add_sphere((3, 1.5, 0.5), 0.7, glass, b.add_solid_texture((1., 1., 1.)))
    b.add_sphere((3, -1.5, 0.5), 0.35, glass,
                 b.add_solid_texture((0.9, 1.0, 1.0)),
                 substance=b.add_substance(1.333))
    b.add_sphere((5, .5, 4.0), 1.0, light, b.add_solid_texture((1.,) * 3))
    return b.build(device)


def near_miss_field(n: int = 600, seed: int = 0, device=None):
    """Many small spheres in a block ahead of the camera: most rays pass
    close to several spheres (the phantom-hit class of an inexact sphere
    dot product)."""
    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((.35, .45, .65)))
    m = b.add_material(ResponseType.REFLECTION)
    mm = b.add_material(ResponseType.REFLECTION, mirror=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        p = rng.uniform(-4, 4, 3)
        p[0] += 8
        b.add_sphere(tuple(p), 0.25, (m, mm)[i % 3 == 0],
                     b.add_solid_texture((.8, .3, .2)))
    return b.build(device)


def octree_field(builder=SceneBuilder):
    """The octree search's near-miss field, as a builder (the port's or the
    reference's ``SceneBuilder``, whose methods agree): a 4x4x4 lattice of
    spheres with small boxes between them, a few triangles, and a ground
    box that the grid cannot hold (coarse)."""
    b = builder()
    b.set_sky(b.add_solid_texture((0.3, 0.4, 0.6)))
    m = b.add_material(ResponseType.REFLECTION)
    tex = b.add_solid_texture((1.0, 1.0, 1.0))
    for i in range(4):
        for j in range(4):
            for k in range(4):
                b.add_sphere((float(i), float(j), float(k)), 0.3, m, tex)
    for i in range(3):
        for j in range(3):
            b.add_box((i + 0.5, j + 0.5, 1.5), 0.15, m, tex)
    for i in range(3):
        v = np.array([i + 0.2, 0.4, 2.5])
        b.add_triangle(v, v + (0.6, 0.0, 0.0), v + (0.0, 0.6, 0.1), m, tex)
    b.add_box((1.5, 1.5, -3.0), (20.0, 20.0, 0.5), m, tex)
    return b


def _unit(v):
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def octree_field_rays(scene, accel, seed=0):
    """Rays of the near-miss field that stress the walk's and the tests'
    rounding -> (org, dir) f32 on the accel's device, and each ray's kind:
    tangent to spheres within a few ulps, along box faces and edges, on cell
    faces with the direction in the face, origins inside the grid,
    axis-parallel (below and above the 1e-12 clamp), a zero direction and
    origins far from the grid (walks that end at the 3R + 2 cap)."""
    rng = np.random.default_rng(seed)
    sc, sr, bc, bh = (getattr(scene, k).detach().cpu().numpy().astype(
        np.float64) for k in ("sphere_center", "sphere_radius",
                              "box_center", "box_half"))
    lo = accel.root_lo.cpu().numpy()
    size = float(accel.root_size)
    cs = np.float32(accel.root_size.cpu().numpy() / np.float32(accel.res))
    org, dirs, kinds = [], [], []

    def add(kind, o, d):
        org.append(np.asarray(o, np.float64))
        dirs.append(np.asarray(d, np.float64))
        kinds.append(kind)

    for s in rng.choice(len(sr), 12, replace=False):
        d = _unit(rng.normal(size=3))
        u = _unit(np.cross(d, rng.normal(size=3)))
        for eps in (-2e-7, 0.0, 2e-7):
            add("graze_sphere", sc[s] + u * sr[s] * (1 + eps) - 4.0 * d, d)
    for bi in range(min(6, len(bh) - 1)):
        c, h = bc[bi], bh[bi]
        add("graze_box", (c[0] - 3.0, c[1] + h[1], c[2] + 0.5 * h[2]),
            (1.0, 0.0, 0.0))
        add("graze_box", (c[0] - 3.0, c[1] + h[1], c[2] + h[2]),
            _unit((1.0, 1e-7, 0.0)))
        add("graze_box", (c[0] + 0.3 * h[0], c[1] - 3.0, c[2] - h[2]),
            (0.0, 1.0, 0.0))
    for a in range(3):
        for kk in (1, 3, 5):
            o = lo.astype(np.float64) + rng.uniform(0.2, 0.8, 3) * size
            o[a] = float(np.float32(lo[a] + np.float32(kk) * cs))
            d = _unit(rng.normal(size=3))
            d[a] = 0.0
            add("cell_face", o, _unit(d))
            d[a] = 1e-13
            add("cell_face", o, d)
    for _ in range(16):
        add("inside", lo + rng.uniform(0.0, 1.0, 3) * size,
            _unit(rng.normal(size=3)))
    for a in range(3):
        for sgn in (1.0, -1.0):
            o = lo + rng.uniform(0.1, 0.9, 3) * size
            o[a] = lo[a] - 2.0 if sgn > 0 else lo[a] + size + 2.0
            d = np.zeros(3)
            d[a] = sgn
            add("axis", o, d)
            d2 = d.copy()
            d2[(a + 1) % 3] = 5e-13
            add("axis", o, d2)
            d3 = d.copy()
            d3[(a + 2) % 3] = -3e-12
            add("axis", o, d3)
    # a zero direction: t_new is NaN, so the walk never ends before the cap;
    # from far away t_cur + eps_t == t_cur, and a walk can stall on a cell
    # boundary
    add("cap", lo + 0.37 * size, (0.0, 0.0, 0.0))
    for _ in range(24):
        d = _unit(rng.normal(size=3))
        aim = lo + rng.uniform(0.3, 0.7, 3) * size
        add("far", aim - 3e5 * d, d)
    dev = accel.root_lo.device
    return (torch.as_tensor(np.array(org, np.float32), device=dev),
            torch.as_tensor(np.array(dirs, np.float32), device=dev),
            np.array(kinds))


def tri_edge_field(n: int = 16, n_free: int = 300, seed: int = 3,
                   device=None):
    """Triangles that share edges and vertices, and triangles that rays
    pass close to -> (scene, org, dir). An n x n grid of cells, two
    triangles a cell, on a tilted plane ahead of the camera, then
    ``n_free`` small free triangles in front of it; rays from one origin
    aimed at every grid vertex and at the midpoint of every grid edge (the
    cell diagonals too), where float32 rounding decides which triangle (or
    none) a ray hits, and at the free triangles' vertices."""
    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0.35, 0.45, 0.65)))
    m = b.add_material(ResponseType.REFLECTION)
    tex = b.add_solid_texture((0.7, 0.6, 0.5))
    y, z = np.meshgrid(np.linspace(-2.0, 2.0, n + 1),
                       np.linspace(-1.5, 2.5, n + 1), indexing="ij")
    grid = np.stack([6.0 + 0.3 * y + 0.2 * z, y, z], -1).astype(np.float32)
    k = np.arange((n + 1) * (n + 1)).reshape(n + 1, n + 1)
    a, bb, c, d = k[:-1, :-1], k[1:, :-1], k[1:, 1:], k[:-1, 1:]
    faces = np.concatenate([np.stack([a, bb, c], -1).reshape(-1, 3),
                            np.stack([a, c, d], -1).reshape(-1, 3)])
    b.add_mesh(grid.reshape(-1, 3), faces, m, tex)
    rng = np.random.default_rng(seed)
    free = (rng.uniform([3.0, -1.5, -1.0], [5.0, 1.5, 2.0], (n_free, 1, 3))
            + rng.uniform(-0.15, 0.15, (n_free, 3, 3))).astype(np.float32)
    for v in free:
        b.add_triangle(v[0], v[1], v[2], m, tex)
    mid = [(grid[1:] + grid[:-1]) / 2, (grid[:, 1:] + grid[:, :-1]) / 2,
           (grid[1:, 1:] + grid[:-1, :-1]) / 2]
    targets = np.concatenate([grid.reshape(-1, 3)]
                             + [x.reshape(-1, 3) for x in mid]
                             + [free.reshape(-1, 3)]).astype(np.float32)
    o = np.float32([0.0, 0.1, 0.4])
    d = targets - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    org = np.broadcast_to(o, d.shape).copy()
    return (b.build(device), torch.as_tensor(org, device=device),
            torch.as_tensor(d.astype(np.float32), device=device))


def split_tie_field(n: int = 5000, rays: int = 4096, seed: int = 5,
                    device=None):
    """n small spheres, where the first sphere of B4's second split (of two:
    ``nh.dense_splits`` at this size) is a copy of the last sphere of the
    first, set before the field -> (scene, org, dir, pid of that last
    sphere). A quarter of the rays aim at the copies, so their t ties
    across the split boundary, and the tie goes to the lower pid; the rest
    cross the field."""
    first = -(-n // nh.BLOCK_K) // 2 * nh.BLOCK_K - 1
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-4, 4, (n, 3))
    pos[:, 0] += 8
    pos[first] = pos[first + 1] = (2.0, 0.3, 0.6)
    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((.35, .45, .65)))
    m = b.add_material(ResponseType.REFLECTION)
    tex = b.add_solid_texture((.8, .3, .2))
    for p in pos:
        b.add_sphere(tuple(p), 0.25, m, tex)
    o = np.float32([0.0, 0.0, 0.5])
    aim = rays // 4
    targets = np.concatenate([
        pos[first] + rng.uniform(-0.2, 0.2, (aim, 3)),
        rng.uniform([4.0, -4.0, -4.0], [12.0, 4.0, 4.0], (rays - aim, 3))])
    d = (targets - o).astype(np.float32)
    org = np.broadcast_to(o, d.shape).copy()
    return (b.build(device), torch.as_tensor(org, device=device),
            torch.as_tensor(d, device=device), first)


def box_edge_case(device=None):
    """A mirror box met exactly on its x/y edge, and an emitter where the
    x-face reflection (the x > y > z slab tie order) sends the ray; plus a
    ray that misses. -> (scene, org, dir)."""
    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0.2, 0.3, 0.4)))
    white = b.add_solid_texture((1.0, 1.0, 1.0))
    b.add_box((0.0, 0.0, 0.0), 2.0,
              b.add_material(ResponseType.REFLECTION, mirror=True), white)
    b.add_sphere((-1 - 3 / np.sqrt(2), -1 + 3 / np.sqrt(2), 0.0), 0.5,
                 b.add_material(ResponseType.REFLECTION, light=True), white)
    org = torch.tensor([[-3.0, -3.0, 0.0], [-3.0, -2.0, 0.0]], device=device)
    d = torch.tensor([[1.0, 1.0, 0.0], [1.0, 0.0, 0.0]], device=device)
    return b.build(device), org, d / d.norm(dim=1, keepdim=True)


def replay_scene(seed: int = 0, n_sph: int = 9, device=None):
    """The replay-gradient test scene of the reference package
    (``tests/test_replay_grad.py``): a ground box, a mirror box, ``n_sph``
    random diffuse/mirror spheres and an emitter."""
    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0.3, 0.45, 0.7)))
    grey = b.add_solid_texture((0.6, 0.55, 0.5))
    white = b.add_solid_texture((1.0, 0.9, 0.8))
    diffuse = b.add_material(ResponseType.REFLECTION)
    mirror = b.add_material(ResponseType.REFLECTION, mirror=True)
    light = b.add_material(ResponseType.REFLECTION, light=True)
    b.add_box((0.0, 0.0, -51.0), 100.0, diffuse, grey)
    b.add_box((4.0, -2.5, 1.0), (1.0, 2.0, 1.5), mirror, white)
    rng = np.random.default_rng(seed)
    pal = [b.add_solid_texture(rng.uniform(0.2, 1.0, 3)) for _ in range(4)]
    centers = rng.uniform([2.0, -3.0, -0.5], [8.0, 3.0, 3.0], (n_sph, 3))
    radii = rng.uniform(0.3, 0.9, n_sph)
    for i in range(n_sph):
        b.add_sphere(centers[i], float(radii[i]),
                     mirror if i % 3 == 0 else diffuse, pal[i % 4])
    b.add_sphere((5.0, 0.5, 5.0), 1.2, light, white)
    return b.build(device)


def listed_field(n: int = 600, seed: int = 0, device=None):
    """B5's listed class: a ground box, ``n`` small diffuse and mirror
    spheres ahead of the camera and an emitter (more than 384 prims, so B4
    records)."""
    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((.35, .45, .65)))
    m = b.add_material(ResponseType.REFLECTION)
    mm = b.add_material(ResponseType.REFLECTION, mirror=True)
    b.add_box((0.0, 0.0, -51.0), 100.0, m, b.add_solid_texture((.6,) * 3))
    rng = np.random.default_rng(seed)
    pal = [b.add_solid_texture(rng.uniform(0.2, 1.0, 3)) for _ in range(6)]
    for i in range(n):
        p = rng.uniform(-4, 4, 3)
        p[0] += 8
        b.add_sphere(tuple(p), 0.25, (m, mm)[i % 3 == 0], pal[i % 6])
    b.add_sphere((6.0, 0.0, 6.0), 1.0,
                 b.add_material(ResponseType.REFLECTION, light=True),
                 b.add_solid_texture((1.0, 1.0, 1.0)))
    return b.build(device)


def replay_edge_rays(device=None):
    """A mirror box around the origin and a sphere beside it -> (scene,
    exhausted rays, all-miss rays): rays from the box's inside bounce off
    its walls until refmax runs out (but for the odd one that leaves
    through an edge); rays from outside point away."""
    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0.2, 0.3, 0.4)))
    white = b.add_solid_texture((0.9, 0.8, 0.7))
    b.add_box((0.0, 0.0, 0.0), 4.0,
              b.add_material(ResponseType.REFLECTION, mirror=True), white)
    b.add_sphere((0.0, 6.0, 0.0), 1.0, b.add_material(ResponseType.REFLECTION),
                 white)
    rng = np.random.default_rng(7)
    d = rng.normal(size=(300, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    inside = rng.uniform(-1.0, 1.0, (300, 3)).astype(np.float32)
    outside = np.tile(np.float32([[10.0, 0.0, 0.0]]), (300, 1))
    away = d.copy()
    away[:, 0] = np.abs(away[:, 0]) + 0.1
    away /= np.linalg.norm(away, axis=1, keepdims=True)

    def t(a):
        return torch.as_tensor(a, device=device)

    return b.build(device), (t(inside), t(d)), (t(outside), t(away))


def fit_cameras(w: int, h: int, n: int = FIT_VIEWS, device=None):
    """Config 5's view batch (``bench.py:325-326``): ``n`` cameras at
    (0, v - n/2, 0.5), fov pi/2 x pi/2 * h/w."""
    return [make_camera((0.0, float(v - n // 2), 0.5), w, h, np.pi / 2,
                        np.pi / 2 * h / w, device=device) for v in range(n)]


def perturbed(scene, seed: int = 3):
    """The scene with its spheres' colors and centers perturbed (numpy
    seed): the start of the fit."""
    rng = np.random.default_rng(seed)
    rgb = scene.textures.solid_rgb.clone()
    tex = torch.unique(scene.prim_texture[:scene.n_spheres].long())
    noise = rng.uniform(-0.15, 0.15, (len(tex), 3)).astype(np.float32)
    rgb[tex] = torch.clamp(rgb[tex] + torch.as_tensor(noise,
                                                      device=rgb.device),
                           0.05, 1.0)
    shift = rng.normal(0.0, 0.03, (scene.n_spheres, 3)).astype(np.float32)
    return dataclasses.replace(
        scene, textures=dataclasses.replace(scene.textures, solid_rgb=rgb),
        sphere_center=scene.sphere_center + torch.as_tensor(
            shift, device=rgb.device))


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def start_refr(scene, cam):
    return start_substance(scene, cam.pos) if scene.has_transmission else None


def fused_report(scene, lanes, k, p):
    """B1 or B2 against its plain version, ``k`` and ``p`` each (color,
    status, rec, work): color, status and the recorded winner pid bit for
    bit, and the spheres each warp tested at each bounce equal to the plain
    cull's (``tf.cull_counts``); with, per bounce, the warps that had a
    live ray, those of them with a dead lane, and the spheres tested ->
    report with ``ok``."""
    (k_c, k_st, k_rec, k_work), (p_c, p_st, p_rec, p_work) = k, p
    exact = (torch.equal(bits(k_c), bits(p_c)) and torch.equal(k_st, p_st)
             and torch.equal(k_rec["pid"], p_rec["pid"]))
    work_equal = torch.equal(k_work, p_work)
    has_ray = (lanes >= 0).reshape(-1, tf.WARP)
    alive = p_rec["alive"][:, lanes.clamp(min=0)].reshape(
        p_rec["alive"].shape[0], -1, tf.WARP) & has_ray
    live = alive.any(-1)
    return dict(
        rays=int(k_st.numel()), prims=scene.n_prims,
        spheres=scene.n_spheres, bit_exact=exact, work_equal=work_equal,
        ok=exact and work_equal,
        max_abs_err=float(torch.where(torch.isfinite(p_c), (k_c - p_c).abs(),
                                      0.0).max()),
        warps=int(has_ray.shape[0]),
        partial_warps=int((~has_ray.all(-1)).sum()),
        live_warps=live.sum(-1).tolist(),
        live_warps_with_dead_lanes=(live & (alive != has_ray).any(-1))
        .sum(-1).tolist(),
        spheres_tested=k_work.sum(-1).tolist(),
        warps_keeping_all=(k_work == scene.n_spheres).sum(-1).tolist()
        if scene.n_spheres else [0] * k_work.shape[0])


def compare_frame(name, scene, cam, cfg, sample=0):
    """B1 kernel vs its plain version for one sample of one scene, bit for
    bit with the per-warp sphere counts (:func:`fused_report`)."""
    refr = start_refr(scene, cam)
    k = tf.trace_frame_fused_cuda(scene, cfg, cam, sample=sample,
                                  start_refr=refr, record=True, work=True)
    p = tf.trace_frame_fused_plain(scene, cfg, cam, sample=sample,
                                   start_refr=refr, record=True, work=True)
    torch.cuda.synchronize()
    rep = fused_report(scene, tf.frame_lanes(cam.w, cam.h, cam.device), k, p)
    emit(phase="B1", case=name, sample=sample, w=cam.w, h=cam.h,
         refmax=cfg.refmax, **rep)
    check(rep["ok"], f"B1 {name} sample {sample}: {rep}")
    return rep, k[0], p[2]


def compare_rays_once(name, scene, cfg, org, dir, sample=0, **kw):
    """B2 kernel vs its plain version on one wavefront, bit for bit with
    the per-warp sphere counts (:func:`fused_report`) -> (report, color,
    status, the plain version's record)."""
    k = tf.trace_rays_fused_cuda(scene, cfg, org, dir, record=True,
                                 work=True, **kw)
    p = tf.trace_rays_fused_plain(scene, cfg, org, dir, record=True,
                                  work=True, **kw)
    torch.cuda.synchronize()
    rep = fused_report(scene, tf.ray_lanes(org.shape[0], org.device), k, p)
    emit(phase="B2", case=name, sample=sample, refmax=cfg.refmax, **rep)
    check(rep["ok"], f"B2 {name} sample {sample}: {rep}")
    return rep, k[0], k[1], p[2]


def compare_rays(name, scene, cam, cfg, seed=DEFAULT_SEED):
    """B2 kernel vs its plain version per sample, then render_rays FUSED."""
    org, dir = pixel_rays(cam)
    rid0 = torch.arange(org.shape[0], dtype=torch.int32, device=org.device)
    refr = start_refr(scene, cam)
    reps, acc = [], None
    for s in range(cfg.spp):
        rep, k_c, *_ = compare_rays_once(name, scene, cfg, org, dir,
                                         sample=s, seed=seed,
                                         ray_id=rid0 * cfg.spp + s,
                                         start_refr=refr)
        reps.append(rep)
        acc = k_c if acc is None else acc + k_c
    before = tf.LAUNCHES["rays"]
    out = render_rays(scene, cfg, org, dir, seed)
    torch.cuda.synchronize()
    launched = tf.LAUNCHES["rays"] - before
    want = acc / cfg.spp if cfg.spp > 1 and scene.has_rough else acc
    err = float((out - want).abs().max())
    emit(phase="B2", case=name, render_rays_launches=launched,
         render_rays_max_abs_err=err)
    check(launched >= 1, "render_rays FUSED did not launch the wavefront "
          "kernel")
    check(torch.allclose(out, want, rtol=1e-5, atol=1e-6),
          f"render_rays FUSED differs from the per-sample kernel runs: {err}")
    return reps


def compare_hits(phase, name, scene, org, dir, kernel, plain, **kw):
    """A nearest-hit kernel (B3 or B4) against its plain version on one set
    of rays, both on the card."""
    k_t, k_pid = kernel(scene, org, dir, **kw)
    p_t, p_pid = plain(scene, org, dir, **kw)
    torch.cuda.synchronize()
    rep = parity.compare_hits(scene, org, dir, k_t, k_pid, p_t, p_pid)
    emit(phase=phase, case=name, prims=scene.n_prims, **rep)
    check(rep["ok"], f"{phase} {name}: {rep}")
    return rep, (k_t, k_pid)


def compare_scalar(name, scene, org, dir):
    """B3 against its plain version on one set of rays, both on the card: t
    and pid bit for bit, and the spheres each warp tested equal to the
    plain form of its cone cull (``nh.scalar_cull``) -> report."""
    tabs = nh.pack_tables(scene)
    k_t, k_pid, k_tested = nh.launch_scalar(tabs, org, dir, work=True)
    p_t, p_pid = nh.nearest_hit_pallas_scalar_plain(scene, org, dir)
    kept = nh.scalar_cull(tabs, org, dir)
    torch.cuda.synchronize()
    p_tested = kept.sum(dim=1).to(torch.int32)
    exact = torch.equal(bits(k_t), bits(p_t)) and torch.equal(k_pid, p_pid)
    work_equal = torch.equal(k_tested, p_tested)
    rep = dict(rays=org.shape[0], prims=scene.n_prims,
               spheres=scene.n_spheres, hits=int((k_pid >= 0).sum()),
               bit_exact=exact, work_equal=work_equal,
               warps=int(k_tested.numel()),
               spheres_tested=int(k_tested.sum()),
               warps_keeping_all=int((k_tested == scene.n_spheres).sum()),
               max_abs_err=float(torch.where(torch.isfinite(p_t),
                                             (k_t - p_t).abs(), 0.0).max())
               if org.shape[0] else 0.0)
    emit(phase="B3", case=name, **rep)
    check(exact and work_equal, f"B3 {name}: {rep}")
    return rep


def scalar_inputs(scene, cfg, org, dir):
    """The rays of each B3 search of a ``record_paths`` run (one a bounce)
    -> [(org, dir)]."""
    real, seen = nh.nearest_hit_pallas_scalar, []

    def keep(sc, o, d):
        seen.append((o.clone(), d.clone()))
        return real(sc, o, d)

    nh.nearest_hit_pallas_scalar = keep
    try:
        record_paths(scene, cfg, org, dir)
    finally:
        nh.nearest_hit_pallas_scalar = real
    return seen


def compare_dense(name, scene, org, dir, n_live=None):
    """B4 against its plain version on one set of rays, both on the card: t
    and pid bit for bit; -> (report, (t, pid))."""
    st = nh.stream_tables(nh.pack_tables(scene))
    nl = (None if n_live is None else
          torch.tensor([n_live], dtype=torch.int32, device=org.device))
    k_t, k_pid = nh.launch_dense(st, org, dir, n_live=nl)
    p_t, p_pid = nh.nearest_hit_pallas_plain(scene, org, dir, n_live=n_live)
    torch.cuda.synchronize()
    exact = torch.equal(bits(k_t), bits(p_t)) and torch.equal(k_pid, p_pid)
    rep = dict(rays=org.shape[0], n_live=org.shape[0] if n_live is None
               else int(n_live), prims=scene.n_prims,
               spheres=scene.n_spheres, triangles=scene.n_tris,
               splits=nh.dense_splits(st, org.shape[0]),
               hits=int((k_pid >= 0).sum()), bit_exact=exact,
               max_abs_err=float(torch.where(torch.isfinite(p_t),
                                             (k_t - p_t).abs(), 0.0).max())
               if org.shape[0] else 0.0)
    emit(phase="B4", case=name, **rep)
    check(exact, f"B4 {name}: {rep}")
    if n_live is not None:
        check(bool(torch.isinf(k_t[n_live:]).all())
              and bool((k_pid[n_live:] == -1).all()),
              f"B4 {name}: rows past n_live are not misses")
    return rep, (k_t, k_pid)


def compare_replay(name, scene, org, dir, pid_seq, refmax, g_color=None):
    """B5's kernels against their plain versions on one wavefront, both on
    the card (the backward twice, for reproducibility) -> report."""
    tabs = rg.scene_tables(scene)
    k_col = rg.launch_fwd(tabs, org, dir, pid_seq, refmax, 1.0)
    p_col = rg.replay_fwd_plain(tabs, org, dir, pid_seq, refmax, 1.0)
    if g_color is None:
        g_color = torch.as_tensor(np.random.default_rng(1).normal(
            size=(org.shape[0], 3)).astype(np.float32), device=org.device)
    k = rg.launch_bwd(tabs, org, dir, pid_seq, g_color, refmax, 1.0)
    k2 = rg.launch_bwd(tabs, org, dir, pid_seq, g_color, refmax, 1.0)
    g_org, g_dir, keys, rows, skies = rg.replay_bwd_terms(
        tabs, org, dir, pid_seq, g_color, refmax, 1.0)
    p = (g_org, g_dir, *rg.reduce_terms(tabs, keys, rows, skies))
    mag = rg.reduce_terms(tabs, keys, rows.abs(), skies.abs())
    torch.cuda.synchronize()

    def err(a, b):
        return float((a - b).abs().max()) if a.numel() else 0.0

    sums_rel = max(float(((a - b).abs() / torch.clamp(m, min=1e-30)).max())
                   if a.numel() else 0.0 for a, b, m in zip(k[2:], p[2:], mag))
    sums_ok = all(bool(((a - b).abs() <= 1e-5 * m).all())
                  for a, b, m in zip(k[2:], p[2:], mag))
    repro = [bool(torch.equal(a, b)) for a, b in zip(k, k2)]
    # above SCAN_MAX_PRIMS the kernel sums spheres with atomics; below it,
    # its sums are the float32 model of its order, bit for bit
    listed = tabs.n_prims > rg.SCAN_MAX_PRIMS
    repro_ok = all(r for i, r in enumerate(repro) if not (listed and i == 2))
    grid = rg.launch_grid(tabs, org.shape[0], refmax, org.device)
    model_equal = None
    if not listed:
        model = rg.bwd_sums_model(tabs, keys, rows, skies,
                                  (pid_seq >= 0).T, grid)
        model_equal = all(torch.equal(bits(a), bits(b))
                          for a, b in zip(k[2:], model))
    rep = dict(rays=org.shape[0], prims=scene.n_prims, refmax=refmax,
               hits=int((pid_seq >= 0).sum()), listed=listed, grid=grid,
               colors_equal=bool(torch.equal(k_col, p_col)),
               color_max_abs_err=err(k_col, p_col),
               g_org_equal=bool(torch.equal(k[0], p[0])),
               g_dir_equal=bool(torch.equal(k[1], p[1])),
               sums_max_err_over_abs_sum=sums_rel, sums_ok=sums_ok,
               sums_equal_order_model=model_equal, reproducible=repro,
               bwd_max_abs_err=max(err(a, b) for a, b in zip(k, p)))
    emit(phase="B5", case=name, **rep)
    check(rep["colors_equal"] and rep["g_org_equal"] and rep["g_dir_equal"]
          and sums_ok and repro_ok and model_equal is not False,
          f"B5 {name}: {rep}")
    return rep, k_col


def replay_1m_phase(dev) -> dict:
    """B5 at BASELINE config 5's size (phase 6f): the 1M-prim config-4
    field (999,999 spheres, the global-atomic sphere sums), view 0 of config
    5 (1920x1088 at (0, -4, 0.5)) recorded through the octree (depth 8),
    its kernels against their plain versions on the card (colors and
    per-ray cotangents bit for bit, the sums within 1e-5 of the sum of
    the terms' magnitudes) and timed alone -> report."""
    scene = config4_scene(1_000_000, device=dev)
    cfg = RenderConfig(refmax=2, backend=HitBackend.OCTREE)
    check(rg.supports_fit(scene, cfg) and not rg.supports_listed(scene, cfg),
          "the 1M field is not in the fit's class alone")
    accel = octree.build_octree(scene, rt.OctreeConfig(max_depth=8))
    cam = make_camera((0.0, -4.0, 0.5), C4_W, C4_H, np.pi / 2,
                      np.pi / 2 * C4_H / C4_W, device=dev)
    org, dir = pixel_rays(cam)
    pid = record_paths(scene, cfg, org, dir, accel=accel)
    n = org.shape[0]
    target = torch.as_tensor(np.random.default_rng(12).uniform(
        0.0, 1.0, (n, 3)).astype(np.float32), device=dev)
    tabs = rg.scene_tables(scene)
    g = 2.0 * (rg.launch_fwd(tabs, org, dir, pid, 2, 1.0) - target) / n
    rep, _ = compare_replay("f_config5_1m_view0", scene, org, dir, pid, 2, g)
    rep.update(
        fwd_ms=cuda_median_ms(lambda: rg.launch_fwd(tabs, org, dir, pid, 2,
                                                    1.0)),
        bwd_ms=cuda_median_ms(lambda: rg.launch_bwd(tabs, org, dir, pid, g,
                                                    2, 1.0)),
        finite=all(bool(torch.isfinite(x).all()) for x in
                   rg.launch_bwd(tabs, org, dir, pid, g, 2, 1.0)))
    emit(phase="B5", case="f_config5_1m_times", fwd_ms=rep["fwd_ms"],
         bwd_ms=rep["bwd_ms"], finite=rep["finite"])
    check(rep["finite"], "B5 at 1M: non-finite cotangents")
    return rep


def replay_1m_only() -> int:
    """``python3 chip_smoke.py --replay-1m``: phase 6f alone."""
    dev = card()
    if dev is None:
        return 1
    replay_1m_phase(dev)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(dev),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def bits(x):
    """A plane as int32 bits, so a bit-for-bit comparison holds NaNs."""
    return x.contiguous().view(torch.int32) if x.dtype == torch.float32 else x


def block_rule_check(what, k, blk, group_blk):
    """The kernel's planes against the plain version's with the first
    design's exit groups of ``group_blk`` rays (every plane bit for bit),
    and the chunks each warp scanned against its block's -> (planes that
    differ, chunks the blocks scanned)."""
    differ = [n for n in blk if n != "chunks"
              and not torch.equal(bits(k[n]), bits(blk[n]))]
    per_warp = blk["chunks"].repeat_interleave(group_blk // tt.GROUP, dim=0)
    check(bool((k["chunks"] <= per_warp).all()),
          f"{what}: a warp scanned more chunks than its block")
    return differ, int(blk["chunks"].sum())


def compare_tiled(name, scene, cam, tables=None):
    """B7 against its plain version on one frame, both on the card: every
    plane bit for bit, and the chunks each warp scanned; every plane bit
    for bit against the plain version with the first design's 256-ray
    exit groups, whose chunks are never fewer; -> (report, kernel planes,
    tables)."""
    tables = tables or rtl.frame_tables(scene, cam)
    tab, cnts, c_max = tables[:3]
    k = tt.frame_bounce0(scene, cam, tab, cnts, c_max, work=True)
    t0 = time.perf_counter()
    p = tt.frame_bounce0_plain(scene, cam, tab, cnts, c_max, work=True)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    blk = tt.frame_bounce0_plain(scene, cam, tab, cnts, c_max, work=True,
                                 group=tt.GROUP_SUB * tt.LANE)
    differ_blk, blk_chunks = block_rule_check(f"B7 {name}", k, blk,
                                              tt.GROUP_SUB * tt.LANE)
    differ = [n for n in p if not torch.equal(bits(k[n]), bits(p[n]))]
    err = max(float(torch.where(torch.isfinite(p[n]), (k[n] - p[n]).abs(),
                                0.0).max())
              for n in p if p[n].dtype == torch.float32)
    rep = dict(w=cam.w, h=cam.h, tiles=cnts.shape[0], c_max=c_max,
               prims=scene.n_prims, planes=len(p) - 1, differ=differ,
               max_abs_err=err, chunks_scanned=int(k["chunks"].sum()),
               block_rule_chunks=blk_chunks, differ_from_block_rule=differ_blk,
               plain_seconds=plain_s, **{f: v for f, v in
                                        tt._flags(scene).items()})
    ok = not differ and not differ_blk
    if differ:
        # the parity rule, winner flips proven on the bounce-0 rays
        hp, wp = k["cr"].shape
        org, dirs = pixel_rays(cam)
        crop = (lambda x: x[:cam.h, :cam.w].reshape(-1))
        col = (lambda d: torch.stack([crop(d[c]) for c in ("cr", "cg", "cb")],
                                     -1))
        rec = {"pid": crop(p["pid"])[None], "org": org[None],
               "dir": dirs[None]}
        prep = parity.compare(col(k), crop(k["status"]), col(p),
                              crop(p["status"]),
                              prove=parity.flip_prover(
                                  scene, rec, crop(k["pid"])[None]))
        rep["parity"] = prep
        ok = prep["ok"]
    emit(phase="B7", case=name, **rep)
    check(ok, f"B7 {name}: {rep}")
    return rep, k, tables


def live_per_group(live, groups, group, device):
    """Live rays in each of ``groups`` consecutive groups of ``group``
    rays [groups] f64."""
    start = group * torch.arange(groups, device=device)
    return torch.clamp(live - start, 0, group).double()


def ray_slots(slots, live, group):
    """Sum over live rays of the slots (or tiles) each ray's exit group
    streamed, from counts per group of ``group`` rays [..., classes] ->
    [classes] f64."""
    per = slots.reshape(-1, slots.shape[-1]).double()
    return (per * live_per_group(live, per.shape[0], group,
                                 per.device)[:, None]).sum(0)


def compare_listed(name, scene_s, org, dir, n_live=None, **lists):
    """B6 against its plain version (t and pid bit for bit, the same list
    slots streamed per warp), against the plain version with the first
    design's 128-ray exit groups (t and pid bit for bit: the finer exit
    changes no result) and against B4 on the same rays and scene (equal
    pids but for proven flips: the cull is exact), all on the card; ->
    (report, inputs, slots per warp [rows, 4, 2], slots per block [rows,
    1, 2], t)."""
    n = org.shape[0]
    li = nh.listed_inputs(scene_s, n, **lists)
    nl = (None if n_live is None else
          torch.tensor([n_live], dtype=torch.int32, device=org.device))
    k_t, k_pid, k_slots = nh.launch_listed(li, org, dir, n_live=nl,
                                           work=True)
    t0 = time.perf_counter()
    p_t, p_pid, p_slots = nh.nearest_hit_listed_plain(
        scene_s, org, dir, n_live, inputs=li, work=True)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    b_t, b_pid, b_slots = nh.nearest_hit_listed_plain(
        scene_s, org, dir, n_live, inputs=li, work=True, group=128)
    d_t, d_pid = nh.launch_dense(nh.stream_tables(nh.pack_tables(scene_s)),
                                 org, dir, n_live=nl)
    torch.cuda.synchronize()
    exact = (torch.equal(bits(k_t), bits(p_t)) and torch.equal(k_pid, p_pid)
             and torch.equal(k_slots, p_slots))
    same_as_block = (torch.equal(bits(k_t), bits(b_t))
                     and torch.equal(k_pid, b_pid))
    vs_b4 = parity.compare_hits(scene_s, org, dir, k_t, k_pid, d_t, d_pid)
    live = n if n_live is None else min(n_live, n)
    cols = max((lst[0].shape[1] for lst in (li.sph_list, li.tri_list)
                if lst is not None), default=0)
    rep = dict(rays=n, n_live=live, prims=scene_s.n_prims,
               sph_fan=li.sph_fan, tri_fan=li.tri_fan, list_cols=cols,
               warp_slots_streamed=int(k_slots.sum()),
               block_slots_streamed=int(b_slots.sum()),
               ray_slots_warp_rule=ray_slots(k_slots, live, 32).tolist(),
               ray_slots_block_rule=ray_slots(b_slots, live, 128).tolist(),
               bit_exact=exact, same_as_block_rule=same_as_block,
               plain_seconds=plain_s,
               max_abs_err=float(torch.where(torch.isfinite(p_t),
                                             (k_t - p_t).abs(), 0.0).max()),
               vs_b4=vs_b4)
    emit(phase="B6", case=name, **rep)
    check(exact and same_as_block and vs_b4["ok"], f"B6 {name}: {rep}")
    check(bool(torch.isinf(k_t[live:]).all())
          and bool((k_pid[live:] == -1).all()),
          f"B6 {name}: rows past n_live are not misses")
    check(bool((k_slots <= b_slots).all()), f"B6 {name}: a warp streamed "
          f"more slots than its block")
    return rep, li, k_slots, b_slots, k_t


def compare_wave(name, scene, cols, tab, cnts, c_max, static_bases=None,
                 wave_sub=tt.WAVE_SUB):
    """B7-wave against its plain version on one packetized wavefront, both
    on the card: every plane bit for bit and the chunks each warp scanned;
    every plane bit for bit against the plain version with the first
    design's exit groups (two rows, one for one-row packets), whose chunks
    are never fewer; -> (report, kernel planes, block chunks)."""
    k = tt.launch_wave(scene, cols, tab, cnts, c_max, wave_sub, static_bases,
                       work=True)
    t0 = time.perf_counter()
    p = tt.wave_bounce_plain(scene, cols, tab, cnts, c_max, wave_sub,
                             static_bases, work=True)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    g_blk = tt.LANE * tt.group_rows(wave_sub)
    blk = tt.wave_bounce_plain(scene, cols, tab, cnts, c_max, wave_sub,
                               static_bases, work=True, group=g_blk)
    differ_blk, blk_chunks = block_rule_check(f"B7-wave {name}", k, blk,
                                              g_blk)
    differ = [n for n in p if not torch.equal(bits(k[n]), bits(p[n]))]
    err = max(float(torch.where(torch.isfinite(p[n]), (k[n] - p[n]).abs(),
                                0.0).max())
              for n in p if p[n].dtype == torch.float32)
    st_in, st_out = cols[10].reshape(-1), k["status"].reshape(-1)
    unres = (st_in == 0) & (st_out == 0) & (k["pid"].reshape(-1) < 0)
    t_safe = cnts[:, 3]
    rep = dict(rays=cols[0].numel(), packets=cnts.shape[0], c_max=c_max,
               wave_sub=wave_sub, group_rows=tt.group_rows(wave_sub),
               static_bases=list(static_bases or []), prims=scene.n_prims,
               alive_in=int((st_in == 0).sum()),
               resolved_hits=int((k["pid"] >= 0).sum()),
               unresolved=int(unres.sum()),
               finite_t_safe_packets=int(torch.isfinite(t_safe).sum()),
               planes=len(p) - 1, differ=differ, max_abs_err=err,
               chunks_scanned=int(k["chunks"].sum()),
               block_rule_group=g_blk, block_rule_chunks=blk_chunks,
               differ_from_block_rule=differ_blk, plain_seconds=plain_s,
               **tt._flags(scene))
    emit(phase="B7-wave", case=name, **rep)
    check(not differ and not differ_blk, f"B7-wave {name}: {rep}")
    return rep, k, blk["chunks"]


def packet_tables(scene, cols, wave_sub, c_sel=None, c_max=None):
    """The packet tables of a wavefront: the cell grid's (budget
    ``c_sel``) or, with ``c_max``, the rowwise selection -> (tab, cnts,
    c_max, static bases)."""
    org = torch.stack([c.reshape(-1) for c in cols[0:3]], -1)
    dirs = torch.stack([c.reshape(-1) for c in cols[3:6]], -1)
    alive = cols[10].reshape(-1) == 0
    packet = wave_sub * tt.LANE
    if c_max is not None:
        tab, cnts, _ = cand.packet_candidates(scene, org, dirs, alive, packet,
                                              c_max)
        return tab, cnts, c_max, None
    grid = cand.build_cell_grid(scene, c_sel=c_sel)
    tab, cnts, _ = cand.packet_candidates_grid(scene, grid, org, dirs, alive,
                                               packet)
    return tab, cnts, grid.c_max, grid.base[1:]


def camera_wavefront(cam, seed=2):
    """Primary rays of a camera 128 pixels wide as [rows, 128] state
    planes, a few terminated and a few at the bounce cap (status 7)."""
    org, d = pixel_rays(cam)
    n = org.shape[0]
    rng = np.random.default_rng(seed)
    status = np.where(rng.uniform(size=n) < 0.05, 2, 0).astype(np.int32)
    status[rng.uniform(size=n) < 0.02] = 7
    dev = org.device
    col = torch.as_tensor(rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32),
                          device=dev)
    path = torch.as_tensor(rng.uniform(0.0, 2.0, n).astype(np.float32),
                           device=dev)
    planes = ([org[:, k] for k in range(3)] + [d[:, k] for k in range(3)]
              + [col[:, k] for k in range(3)]
              + [path, torch.as_tensor(status, device=dev)])
    return [x.reshape(-1, tt.LANE).contiguous() for x in planes]


def bounce1_wavefront(scene, cam):
    """The wavefront after B7's bounce 0 of a frame (mirror continuations
    alive), as [rows, 128] state planes."""
    tab, cnts, c_max = rtl.frame_tables(scene, cam)[:3]
    st = tt.frame_bounce0(scene, cam, tab, cnts, c_max)
    return [st[k].reshape(-1, tt.LANE).contiguous()
            for k in tt.STATE_NAMES[:11]]


def compare_culled(name, scene_s, org, dir, tb, n_live=None):
    """B8 against its plain version (t, pid and the sphere tiles each warp
    streamed, bit for bit) and against B4 on the same rays and permuted
    scene (t and pid bit for bit: the cull is exact and the fold order
    B4's), all on the card; -> (report, tiles per warp [B, 4])."""
    n = org.shape[0]
    tabs = nh.stream_tables(nh.pack_tables(scene_s))
    nl = (None if n_live is None else
          torch.tensor([n_live], dtype=torch.int32, device=org.device))
    k_t, k_pid, k_tiles = nh.launch_culled(tabs, org, dir, tb, n_live=nl,
                                           work=True)
    t0 = time.perf_counter()
    p_t, p_pid, p_tiles = nh.nearest_hit_culled_plain(scene_s, org, dir, tb,
                                                      n_live, work=True)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    d_t, d_pid = nh.launch_dense(tabs, org, dir, n_live=nl)
    torch.cuda.synchronize()
    exact = (torch.equal(bits(k_t), bits(p_t)) and torch.equal(k_pid, p_pid)
             and torch.equal(k_tiles, p_tiles))
    equal_b4 = torch.equal(bits(k_t), bits(d_t)) and torch.equal(k_pid, d_pid)
    vs_b4 = parity.compare_hits(scene_s, org, dir, k_t, k_pid, d_t, d_pid)
    live = n if n_live is None else min(n_live, n)
    live_w = -(-live // 32)
    n_t = -(-scene_s.n_spheres // nh.BLOCK_K)
    per_warp = k_tiles.reshape(-1)[:live_w]
    rep = dict(rays=n, n_live=live, prims=scene_s.n_prims, sphere_tiles=n_t,
               tiles_streamed=int(k_tiles.sum()),
               mean_tiles_per_live_warp=float(per_warp.float().mean())
               if live else 0.0,
               warps_keeping_all=int((per_warp == n_t).sum()),
               live_warps=live_w, bit_exact=exact, equal_to_b4=equal_b4,
               plain_seconds=plain_s,
               max_abs_err=float(torch.where(torch.isfinite(p_t),
                                             (k_t - p_t).abs(), 0.0).max()),
               vs_b4=vs_b4)
    emit(phase="B8", case=name, **rep)
    check(exact and equal_b4 and vs_b4["ok"] and vs_b4["flips"] == 0,
          f"B8 {name}: {rep}")
    check(bool(torch.isinf(k_t[live:]).all())
          and bool((k_pid[live:] == -1).all()),
          f"B8 {name}: rows past n_live are not misses")
    return rep, k_tiles


def work_phase(li, org_s, dir_s, t_s, n_live, slots, bslots, scene_c,
               org_c, dir_c, tb_c, n_live_c, tiles_c):
    """Phase 9e, on config 4's first sweep round (B6: its inputs ``li``,
    rays, final t, the slots each warp and each block streamed) and its
    cull round (B8: its rays, tile bounds and the tiles each warp
    streamed): what the first design's 128-ray blocks stream, what the
    kernels' warps stream and what the rays need, summed over the live
    rays (each ray is tested against every slot or tile its exit group
    streams) -> ({rule: [classes] f64} for B6, the same for B8).

    B6's need is each ray's slots whose t_lo lies within its own final hit
    or bbox exit, in whole chunks (``listed_need``); B8's the tiles its own
    apex-0, angle-0 cone reaches (``culled_tiles(group=1)``)."""
    dev = org_s.device
    need_s = nh.listed_need(li, org_s, dir_s, t_s, n_live).double().sum(0)
    rules6 = {"block": ray_slots(bslots, n_live, 128),
              "warp": ray_slots(slots, n_live, 32), "need": need_s}
    n_sc = scene_c.n_spheres
    blk_tiles = nh.culled_tiles(org_c, dir_c, n_live_c, tb_c, n_sc,
                                group=128).sum(1, keepdim=True)
    own = torch.zeros((), dtype=torch.float64, device=dev)
    step = 64 * nh.BLOCK_R
    for lo in range(0, n_live_c, step):
        own = own + nh.culled_tiles(
            org_c[lo:lo + step], dir_c[lo:lo + step], n_live_c - lo, tb_c,
            n_sc, group=1)[:min(step, n_live_c - lo)].sum()
    rules8 = {"block": ray_slots(blk_tiles, n_live_c, 128),
              "warp": ray_slots(tiles_c[..., None], n_live_c, 32),
              "need": own.reshape(1)}

    def work_rep(rules, live, classes):
        return {c: {r: {"total": float(v[k]),
                        "mean_per_32_rays": 32.0 * float(v[k]) / live}
                    for r, v in rules.items()}
                for k, c in enumerate(classes)}

    emit(phase="work", kernel="B6", case="config4_first_sweep_round",
         live_rays=n_live, fan=li.sph_fan, unit="list slots of 128-prim "
         "(super)tiles, summed over the live rays",
         **work_rep(rules6, n_live, ("sphere_slots", "triangle_slots")))
    emit(phase="work", kernel="B8", case="config4_cull_round",
         live_rays=n_live_c, unit="128-sphere tiles, summed over the live "
         "rays", **work_rep(rules8, n_live_c, ("sphere_tiles",)))
    for rules, what in ((rules6, "B6"), (rules8, "B8")):
        check(bool((rules["need"] <= rules["warp"]).all())
              and bool((rules["warp"] <= rules["block"]).all()),
              f"{what}: work out of order need <= warp <= block: {rules}")
    return rules6, rules8


def wave_work(wave, k, blk_chunks):
    """Phase 9e for B7-wave, on one packet round (``wave``: its scene,
    planes, tables and keywords; ``k`` the kernel's planes with the chunks
    each warp scanned; ``blk_chunks`` the first design's per block): the
    chunks each rule scans, summed over the rays alive at its start (each
    is tested against every row its exit group scans), and the chunks each
    of them needs (``wave_need``: up to its own exit, given its final hit)
    -> {rule: [3] f64} (spheres, boxes, triangles)."""
    sc, cols, tab, cnts, c_max, kw = wave
    alive = (cols[10] == 0).reshape(-1)
    g_blk = cols[0].numel() // blk_chunks.shape[0]
    need = tt.wave_need(sc, cols, tab, cnts, c_max, k["t"], **kw)
    per_ray = {"block": blk_chunks.repeat_interleave(g_blk, dim=0),
               "warp": k["chunks"].repeat_interleave(tt.GROUP, dim=0),
               "need": need}
    check(bool((per_ray["need"] <= per_ray["warp"]).all())
          and bool((per_ray["warp"] <= per_ray["block"]).all()),
          "B7-wave: a ray's chunks out of order need <= warp <= block")
    rules = {r: v[alive].double().sum(0) for r, v in per_ray.items()}
    live = int(alive.sum())
    emit(phase="work", kernel="B7-wave", case="config4_first_packet_round",
         live_rays=live, block_rule_group=g_blk,
         unit="chunks of 16 candidate rows, summed over the live rays",
         **{c: {r: {"total": float(v[i]),
                    "mean_per_32_rays": 32.0 * float(v[i]) / max(live, 1)}
                for r, v in rules.items()}
            for i, c in enumerate(("sphere_chunks", "box_chunks",
                                   "triangle_chunks"))})
    return rules


#: float operations per intersection test, counted from the kernels'
#: expressions (one each for an add, multiply, compare, min/max, select,
#: sqrt or divide), the running-minimum fold included. The bounds count
#: the tests only: the shading per ray is a few hundred operations, under
#: 1% of the tests at these prim counts. ``octree_step`` is one step of the
#: octree search's walk (the cell, its exit, the jump, the stop test).
OPS = {"sphere": 29, "sphere_unit": 29, "box": 34, "tri": 63,
       "tri_edges": 57, "replay_fwd": 120, "replay_bwd": 400,
       "octree_step": 52}
#: one H100 SXM at its published peaks (NVIDIA data sheet): float32 outside
#: the tensor cores, and HBM3
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12


def bound(ops: float, nbytes: float):
    """The least time the card could take -> (bound_ms, bound_by)."""
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def class_ops(scene, tri_key="tri"):
    """Operations of one ray against every prim of the scene."""
    return (scene.n_spheres * OPS["sphere"] + scene.n_boxes * OPS["box"]
            + scene.n_tris * OPS[tri_key])


def fused_bounds(scene, rec, lanes, nbytes):
    """B1's or B2's bounds on one traced frame (``rec`` from the plain
    version with ``record``; ``lanes`` the kernel's warps): the tests the
    live rays need (each ray's own cone, ``group=1``: its spheres; boxes
    and triangles dense), those the warps ran (each warp's kept spheres,
    ``tf.cull_counts``, against its live rays) and every live ray against
    every prim, each over ``nbytes`` -> their counts and ``bound``s."""
    tabs = tf.pack_tables(scene)
    alive = rec["alive"]
    n = alive.shape[1]
    every = torch.arange(n, device=alive.device)
    live = int(alive.sum())
    need = sum(int(tf.fused_cull(tabs, rec["org"][b], rec["dir"][b],
                                 alive[b], every, group=1)[alive[b]].sum())
               for b in range(alive.shape[0]))
    live_lanes = (alive[:, lanes.clamp(min=0)] & (lanes >= 0)).reshape(
        alive.shape[0], -1, tf.WARP).sum(-1)
    streamed = float((tf.cull_counts(tabs, rec, lanes).double()
                      * live_lanes).sum())
    dense = live * (scene.n_boxes * OPS["box"] + scene.n_tris * OPS["tri"])
    return dict(live_rays=live, sphere_tests_needed=need,
                sphere_tests_streamed=streamed,
                sphere_tests_all=live * scene.n_spheres,
                bound=bound(need * OPS["sphere_unit"] + dense, nbytes),
                bound_streamed=bound(streamed * OPS["sphere_unit"] + dense,
                                     nbytes),
                bound_all=bound(live * class_ops(scene), nbytes))


def replay_grads(scene, cfg, org, dir, target, pid_seq=None, kernel=True):
    """Loss and gradients (every float leaf, then org and dir) of the mean
    squared error against ``target``: given ``pid_seq``, through B5 or
    (``kernel=False``) autograd on the replay; else autograd on the search
    path."""
    params, rebuild = float_partition(scene)
    ps = [p.detach().clone().requires_grad_(True) for p in params]
    o = org.detach().clone().requires_grad_(True)
    d = dir.detach().clone().requires_grad_(True)
    if pid_seq is not None and kernel:
        c = rg.replay_colors(rebuild(ps), cfg, o, d, pid_seq)
    else:
        c = trace_rays(rebuild(ps), cfg, o, d, pid_seq=pid_seq).color
    loss = ((c - target) ** 2).sum() / org.shape[0]
    loss.backward()
    return float(loss.detach()), [torch.zeros_like(p) if p.grad is None else p.grad
                         for p in ps + [o, d]]


def host_median_ms(fn, warmup=1, timed=5) -> float:
    """Median host wall time of a synchronized call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(timed):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def random_rays(n, seed, device):
    rng = np.random.default_rng(seed)
    org = rng.uniform([-1, -2, 0], [2, 2, 1.5], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return (torch.as_tensor(org, device=device),
            torch.as_tensor(d, device=device))


def reset_launches() -> None:
    for counts in (tf.LAUNCHES, nh.LAUNCHES, rg.LAUNCHES, tt.LAUNCHES,
                   od.LAUNCHES):
        for k in counts:
            counts[k] = 0


def launches_now() -> dict:
    return {**tf.LAUNCHES, **nh.LAUNCHES, **rg.LAUNCHES, **od.LAUNCHES,
            "tiled_frame": tt.LAUNCHES["frame"],
            "tiled_wave": tt.LAUNCHES["wave"]}


def event_ms(fn, warmup=WARMUP, timed=TIMED) -> list:
    """``timed`` runs of one call, each bracketed by CUDA events, after
    ``warmup`` calls -> their ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(timed):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in pairs]


def cuda_median_ms(fn, warmup=WARMUP, timed=TIMED) -> float:
    """Median of :func:`event_ms`."""
    return statistics.median(event_ms(fn, warmup, timed))


def spread(xs) -> dict:
    """Min, median and max of one call's timed runs."""
    return dict(min=min(xs), median=statistics.median(xs), max=max(xs),
                runs=len(xs))


def device_events(calls, reps):
    """Run each of ``calls`` ``reps`` times in turn under one
    ``torch.profiler`` trace of the card -> its device operations as
    (name, ms) in start order."""
    act = torch.profiler.ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        for fn in calls:
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if "CUDA" in str(e.device_type)),
                 key=lambda e: e.time_range.start)
    return [(e.name, e.time_range.elapsed_us() * 1e-3) for e in evs]


def kernel_report(fn, family, reps=TIMED):
    """One wrapper call's time two ways: ``ms`` (CUDA events around the
    call, which hold its host work) and ``kernel_ms`` (the device time of
    its kernels whose names hold ``family``, from a profiler trace), each
    as the min, median and max over ``reps`` calls in this run;
    ``device_ms`` all its device operations (fills, copies, gathers
    included), and the list of them with their mean ms; ``trace_ops`` the
    count of device operations in each trace taken. A trace runs
    ``TRACE_PAD + reps`` calls (after one outside it) and keeps the last
    ``reps`` calls' operations: in a long run a trace has been seen to miss
    its first operations (14 of 20 kept, every time). A trace that keeps
    fewer than ``reps`` calls is taken again, up to ``TRACE_TRIES``
    traces; ``kernel_ms`` is None when none does."""
    rep = dict(ms=spread(event_ms(fn, timed=reps)), kernel_ms=None,
               device_ms=None, device_ops=None, trace_ops=[])
    fn()
    n = TRACE_PAD + reps
    for _ in range(TRACE_TRIES):
        evs = device_events([fn], n)
        rep["trace_ops"].append(len(evs))
        fam = [ms for name, ms in evs if family in name]
        k, m = -(-len(fam) // n), -(-len(evs) // n)   # per call
        if k == 0 or len(fam) < reps * k:
            continue
        fam, evs = fam[len(fam) - reps * k:], evs[len(evs) - reps * m:]
        calls = [evs[i * m:(i + 1) * m] for i in range(reps)]
        rep.update(
            kernel_ms=spread([sum(fam[i * k:(i + 1) * k])
                              for i in range(reps)]),
            device_ms=spread([sum(ms for _, ms in c) for c in calls]),
            device_ops=[dict(name=name[:96], ms=statistics.mean(
                c[j][1] for c in calls)) for j, (name, _) in
                enumerate(calls[0])])
        return rep
    return rep


def median_of(rep):
    """The median ``kernel_ms`` of a :func:`kernel_report` (None without a
    device trace)."""
    return None if rep["kernel_ms"] is None else rep["kernel_ms"]["median"]


def ptxas_of(log: str, names) -> dict:
    """ptxas's report (``-Xptxas=-v``: registers, spills, stack, shared
    memory) of each entry function whose mangled name holds one of
    ``names`` -> {name: [lines]}."""
    out, cur = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = ln.split("'")[1] if "'" in ln else ln
            continue
        if cur is None or not any(k in ln for k in ("registers", "spill",
                                                     "stack frame")):
            continue
        for n in names:
            if n in cur:
                out.setdefault(n, []).append(ln.strip())
    return out


#: the entry functions whose ptxas report is printed: B5's kernels at
#: refmax 2 (the fit's), B3, B1, B2 and the octree search
PTXAS_KERNELS = ("replay_bwd_kernelILi2E", "replay_fwd_kernelILi2E",
                 "nh_scalar_kernel", "trace_frame_kernel",
                 "trace_rays_kernel", "octree_dda_kernel",
                 "shade_bounce_kernel")


def host_trace(fn, reps=5) -> dict:
    """The CUDA runtime calls and the device operations of one call of
    ``fn`` (the mean over ``reps`` calls under one ``torch.profiler`` trace,
    after one call outside it) -> {"runtime_calls": {name: count},
    "device_ops": {name: count}, "stream_syncs": n, "copies": n,
    "pageable_copies": n}: a stream synchronization or a copy from pageable
    host memory makes the host wait for the device. ``copies`` counts the
    runtime's copy calls, which a trace keeps when it misses device
    operations."""
    act = torch.profiler.ProfilerActivity
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()    # one cudaDeviceSynchronize, not counted
    calls, ops = {}, {}
    for e in prof.events():
        on_dev = "CUDA" in str(e.device_type)
        if on_dev or e.name.startswith("cuda"):
            tally = ops if on_dev else calls
            tally[e.name[:96]] = tally.get(e.name[:96], 0) + 1 / reps
    return dict(runtime_calls=calls, device_ops=ops,
                stream_syncs=sum(v for k, v in calls.items()
                                 if "StreamSynchronize" in k),
                copies=sum(v for k, v in calls.items() if "Memcpy" in k),
                pageable_copies=sum(v for k, v in ops.items()
                                    if "Pageable" in k))


def device_ms_per_call(calls, name, reps=3):
    """Each call's device time (ms, the mean of ``reps`` runs) of the CUDA
    kernel whose name holds ``name``, from one ``torch.profiler`` trace of
    the card: the kernel's own time, without its wrapper's host work or
    the small kernels that prepare its inputs. None when two traces in
    turn do not hold one such kernel a run (a trace has been seen to miss
    some of a long list of launches)."""
    for _ in range(2):
        ms = [t for n, t in device_events(calls, reps) if name in n]
        if len(ms) == reps * len(calls):
            return [statistics.mean(ms[reps * i:reps * (i + 1)])
                    for i in range(len(calls))]
    return None


def recorded_rays(scene, cfg, org, dir, accel=None) -> dict:
    """``ops/trace.record_paths`` that also keeps each bounce's rays ->
    {"pid", "org", "dir", "alive"} [refmax, N, ...], the record
    ``parity.flip_prover`` takes."""
    state, rng = trace_mod._start(scene, cfg, org, dir, DEFAULT_SEED, None,
                                  None)
    prows = trace_mod.prim_rows(scene)
    out = {"pid": [], "org": [], "dir": [], "alive": []}
    with torch.no_grad():
        for b in range(cfg.refmax):
            alive = state.status == 0
            _t, pid = trace_mod.nearest_hit(scene, cfg, state.org, state.dir,
                                            accel, live=alive)
            pid = torch.where(alive, pid, -1).to(torch.int32)
            for k, v in zip(out, (pid, state.org, state.dir, alive)):
                out[k].append(v)
            state = trace_mod._bounce(scene, cfg, state, rng, b, prows,
                                      pid_override=pid, accel=accel)
    return {k: torch.stack(v) for k, v in out.items()}


@contextlib.contextmanager
def counting_searches(keep=None):
    """Count, while active, the dense and the octree nearest-hit searches
    and the substance queries: over the grid (``accel`` given) and dense
    over more than one point (the camera's own lookup is one point).
    ``keep`` (a list) receives each grid query's (point, cur_refr)."""
    n = {"dense_search": 0, "octree_search": 0, "grid_substance": 0,
         "dense_substance": 0}
    real = (trace_mod.nearest_hit_brute, octree.nearest_hit_octree,
            trace_mod.substance_refr_at)

    def brute(*a, **kw):
        n["dense_search"] += 1
        return real[0](*a, **kw)

    def dda(*a, **kw):
        n["octree_search"] += 1
        return real[1](*a, **kw)

    def substance(scene, point, cur_refr, accel=None):
        if accel is not None:
            n["grid_substance"] += 1
            if keep is not None:
                keep.append((point, cur_refr))
        elif point.shape[0] > 1:
            n["dense_substance"] += 1
        return real[2](scene, point, cur_refr, accel=accel)

    (trace_mod.nearest_hit_brute, octree.nearest_hit_octree,
     trace_mod.substance_refr_at) = brute, dda, substance
    try:
        yield n
    finally:
        (trace_mod.nearest_hit_brute, octree.nearest_hit_octree,
         trace_mod.substance_refr_at) = real


def accel_bytes(accel) -> int:
    return sum(getattr(accel, k).numel() * getattr(accel, k).element_size()
               for k in octree._TENSORS)


def peak_memory(fn) -> tuple:
    """(fn's result, {"peak_bytes": torch.cuda.max_memory_allocated over
    the call, "before_bytes": allocated at its start}), the peak reset
    first."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, {"peak_bytes": torch.cuda.max_memory_allocated(),
                 "before_bytes": before}


def compare_octree(name, scene, accel, org, dir, live=None):
    """The octree search kernel (through ``nearest_hit_octree``) against its
    plain version, the live-ray loop, on one set of rays and live mask
    (None: every ray), both on the card: t bit for bit, pid, each ray's
    steps and tests, and the stats equal; the dead rays (inf, -1, 0, 0) ->
    (report, the kernel's stats, its per-ray counts)."""
    st_k, pr_k, st_p, pr_p = {}, {}, {}, {}
    t_k, p_k = octree.nearest_hit_octree(scene, accel, org, dir, stats=st_k,
                                         per_ray=pr_k, live=live)
    t_p, p_p = octree.nearest_hit_octree_plain(scene, accel, org, dir,
                                               stats=st_p, per_ray=pr_p,
                                               live=live)
    torch.cuda.synchronize()
    both = torch.isfinite(t_k) & torch.isfinite(t_p)
    rep = dict(rays=int(org.shape[0]), hits=int((p_k >= 0).sum()),
               live=int(org.shape[0] if live is None else live.sum()),
               t_bits_equal=torch.equal(bits(t_k), bits(t_p)),
               pid_equal=torch.equal(p_k, p_p),
               steps_equal=torch.equal(pr_k["steps"], pr_p["steps"]),
               tests_equal=torch.equal(pr_k["tests"], pr_p["tests"]),
               stats_kernel=st_k, stats_plain=st_p,
               cap_rays=int((pr_k["steps"] == 3 * accel.res + 2).sum()),
               max_abs_err=float((t_k - t_p)[both].abs().max())
               if bool(both.any()) else 0.0)
    rep["dead_missed"] = live is None or bool(
        torch.isinf(t_k[~live]).all() and (p_k[~live] == -1).all()
        and (pr_k["steps"][~live] == 0).all()
        and (pr_k["tests"][~live] == 0).all())
    rep["ok"] = (rep["t_bits_equal"] and rep["pid_equal"]
                 and rep["steps_equal"] and rep["tests_equal"]
                 and st_k == st_p and rep["dead_missed"])
    emit(phase="octree_dda", case=name, prims=scene.n_prims,
         depth=accel.max_depth, max_per_cell=accel.max_per_cell, **rep)
    check(rep["ok"], f"octree_dda {name}: the kernel differs from the "
          f"live-ray loop: {rep}")
    return rep, st_k, pr_k


def half_dead(n, seed, device):
    """A live mask with a random half of ``n`` rays dead."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.uniform(size=n) < 0.5, device=device)


@contextlib.contextmanager
def unmasked_search():
    """While active, the OCTREE search ignores its live mask: every ray
    walks, as before the mask (for showing that a dead ray's answer is
    never read)."""
    real = octree.nearest_hit_octree

    def search(*a, live=None, **kw):
        return real(*a, **kw)

    octree.nearest_hit_octree = search
    try:
        yield
    finally:
        octree.nearest_hit_octree = real


def frame_breakdown(fn, frames=3) -> dict:
    """One frame's device time by kernel name, from one ``torch.profiler``
    trace of ``frames`` frames (each ended by a synchronize, after one
    outside the trace): the mean ms and count of each name a frame, the
    octree search launches' own ms in order, the device's busy ms (the
    union of its operations) against the frame's host span, and the
    largest gaps between operations."""
    act = torch.profiler.ProfilerActivity
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        for i in range(frames):
            with torch.profiler.record_function(f"bd_frame{i}"):
                fn()
                torch.cuda.synchronize()
    evs = list(prof.events())
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs
                   if e.name.startswith("bd_frame")
                   and "CUDA" not in str(e.device_type))
    ops = sorted(((e.time_range.start, e.time_range.end, e.name)
                  for e in evs if "CUDA" in str(e.device_type)
                  and not e.name.startswith("bd_frame")))
    per = []
    for a, b in spans:
        mine = [o for o in ops if a <= o[0] <= b]
        if not mine:
            continue
        by, busy, gaps = {}, 0.0, []
        cur_a, cur_b = mine[0][0], mine[0][1]
        for x, y, name in mine:
            c, t = by.get(name[:96], (0, 0.0))
            by[name[:96]] = (c + 1, t + (y - x) * 1e-3)
            if x > cur_b:
                busy += cur_b - cur_a
                gaps.append((x - cur_b) * 1e-3)
                cur_a, cur_b = x, y
            else:
                cur_b = max(cur_b, y)
        busy += cur_b - cur_a
        per.append(dict(host_ms=(b - a) * 1e-3, busy_ms=busy * 1e-3,
                        first_op_ms=(mine[0][0] - a) * 1e-3,
                        ops=len(mine), by_name=by,
                        octree_ms=[(y - x) * 1e-3 for x, y, n in mine
                                   if "octree_dda" in n],
                        gaps_ms=sorted(gaps, reverse=True)[:5]))
    if not per:
        return dict(frames=0)
    names = set().union(*(p["by_name"] for p in per))
    by_name = sorted(([n, statistics.mean(p["by_name"].get(n, (0, 0))[0]
                                          for p in per),
                       statistics.mean(p["by_name"].get(n, (0, 0.0))[1]
                                       for p in per)] for n in names),
                     key=lambda r: -r[2])
    return dict(frames=len(per),
                host_ms=[p["host_ms"] for p in per],
                busy_ms=[p["busy_ms"] for p in per],
                idle_share=[1 - p["busy_ms"] / p["host_ms"] for p in per],
                first_op_ms=[p["first_op_ms"] for p in per],
                ops=[p["ops"] for p in per],
                octree_ms=[p["octree_ms"] for p in per],
                gaps_ms=[p["gaps_ms"] for p in per],
                device_ms=statistics.mean(sum(t for _, t in p["by_name"]
                                              .values()) for p in per),
                by_name=by_name[:16],
                rest_ms=sum(r[2] for r in by_name[16:]))


def octree_bound(scene, accel, n, st, live=None):
    """The least time of one octree search of ``n`` rays with the kernel's
    stats ``st`` and live mask ``live`` (None: every ray) -> (bound_ms,
    bound_by). Bytes: a live ray reads its origin and direction (24 B), a
    dead one none; each ray reads its mask byte when there is a mask and
    writes t, pid, steps, tests (16 B). Of the accel, what a search can
    need: the skip field, the CSR offsets an occupied cell reads (a cell
    with skip > 0 reads none), the listed ids, the coarse list and the root,
    each once; the prim tables once. Operations: each DDA step's
    (``OPS["octree_step"]``), each coarse test of a live ray at its class's,
    each grid test at the cheapest of the classes the grid holds (config
    4's grid holds spheres only)."""
    ns, nb = scene.n_spheres, scene.n_boxes
    n_live = n if live is None else int(live.sum())
    cls_ops = torch.tensor([OPS["sphere"], OPS["box"], OPS["tri"]],
                           device=accel.cell_ids.device)

    def ops_of(pid):
        return cls_ops[(pid >= ns).long() + (pid >= ns + nb).long()]

    coarse = accel.coarse_ids[accel.coarse_ids >= 0]
    offs = accel.cell_offsets
    nnz = int(offs[-1])
    occ = offs[1:] > offs[:-1]
    # offsets[c] and offsets[c + 1] of each occupied cell c
    offs_read = int((torch.cat([occ, occ.new_zeros(1)])
                     | torch.cat([occ.new_zeros(1), occ])).sum())
    grid_ops = (int(ops_of(accel.cell_ids[:nnz]).min()) if nnz else 0)
    fine_tests = st["tests"] - n_live * coarse.numel()
    ops = (st["ray_steps"] * OPS["octree_step"] + fine_tests * grid_ops
           + n_live * int(ops_of(coarse).sum()))
    accel_need = (accel.skip_dist.numel() + 4 * offs_read + 4 * nnz
                  + 4 * accel.coarse_ids.numel() + 16)
    nbytes = (n_live * 24 + n * 16 + (0 if live is None else n) + accel_need
              + 16 * ns + 24 * nb + 36 * scene.n_tris)
    return bound(float(ops), float(nbytes))


def octree_phase(dev, head, c4, c4_cam, hdr4_p, pid4_p, org4, dir4) -> dict:
    """Phase 9f, main-OCTREE (module docstring): (a) the native scene kit,
    the search kernel against the live-ray loop on the near-miss field, (b)
    config 2 and (c) config 4 through ``render_hdr`` OCTREE against their
    PALLAS frames (``hdr4_p``, ``pid4_p``: 9b's), the kernel against the
    loop on both bounces of each, (d) config 4's glass variant through
    TILED with the accel, (e) an OCTREE fit against the CPU. Returns the
    numbers PERF.md records and the kernel's row."""
    out = {}
    # (a) the scene kit: built by g++ from csrc/scenekit.cpp, equal to its
    # NumPy specification on the builds' own inputs
    t0 = time.perf_counter()
    built = native.available()
    first_call_s = time.perf_counter() - t0
    check(built, f"the native scene kit did not build: "
          f"{native.build_error()}")
    lib = native.library_path()
    check(native._lib._name == str(lib) and lib.parent == native.BUILD_DIR
          and native.SOURCE.name == "scenekit.cpp",
          f"the scene kit was not loaded from the port's build: {lib}")
    c2 = config2_scene(device=dev)
    cases = []
    for case, sc, depth in (("config2", c2, C2_DEPTH),
                            ("config4_2000", config4_scene(2000, device=dev),
                             C4_DEPTH)):
        lo, hi = (a.cpu().numpy().astype(np.float64) for a in prim_aabbs(sc))
        lo32, hi32, fine, root_lo, size = octree.grid_inputs(lo, hi, depth)
        rl32 = np.asarray(root_lo, np.float32)
        got = native.grid_csr(lo32, hi32, fine, rl32, size, depth)
        want = native._grid_csr_numpy(lo32, hi32, fine, rl32, size, depth)
        lv_n, cell_n = native.covering_levels_native(lo, hi, root_lo, size,
                                                     depth)
        lv_p, cell_p = octree.covering_levels(lo, hi, root_lo, size, depth)
        equal = (np.array_equal(got[0], want[0])
                 and np.array_equal(got[1], want[1]) and got[2] == want[2]
                 and np.array_equal(lv_n, lv_p)
                 and np.array_equal(cell_n, cell_p))
        cases.append(dict(case=case, prims=sc.n_prims, depth=depth,
                          fine=int(fine.sum()), pairs=int(got[1].size),
                          max_per_cell=int(got[2]), equal=bool(equal)))
        check(equal, f"native scene kit differs from NumPy on {case}")
    emit(phase="main-OCTREE", case="a_native", available=built,
         library=str(lib.relative_to(lib.parents[2])),
         compiler=[native.CXX, *native.CXX_FLAGS],
         build_seconds=native.build_seconds,
         first_call_seconds=first_call_s, cases=cases)
    out["native_build_s"] = native.build_seconds
    errs = []

    # (a2) the search kernel against the live-ray loop on the near-miss
    # field: tangent and face-grazing rays, cell faces, axis-parallel rays,
    # and walks that end at the cap
    field = octree_field().build(device=dev)
    for depth in (3, 4):
        acc_f = octree.build_octree(field, rt.OctreeConfig(max_depth=depth))
        org_f, dir_f, kinds = octree_field_rays(field, acc_f, seed=depth)
        rep_f, _, per_ray = compare_octree(
            f"a_near_miss_field_depth{depth}", field, acc_f, org_f, dir_f)
        errs.append(rep_f["max_abs_err"])
        errs.append(compare_octree(
            f"a_near_miss_field_depth{depth}_half_dead", field, acc_f, org_f,
            dir_f, half_dead(org_f.shape[0], depth, dev))[0]["max_abs_err"])
        cap = torch.as_tensor(kinds == "cap", device=dev)
        check(bool((per_ray["steps"][cap] == 3 * acc_f.res + 2).all())
              and rep_f["cap_rays"] >= 1 and rep_f["hits"] > 40,
              f"the near-miss field's cap rays did not reach the cap: "
              f"{rep_f}")

    # (b) BASELINE config 2: 256x256, refmax 2, a depth-4 octree, against
    # PALLAS (B3) under the parity rule (proven flips only)
    c2_cam = config2_camera(dev)
    cfg_o = RenderConfig(refmax=2, backend=HitBackend.OCTREE)
    cfg_p = RenderConfig(refmax=2, backend=HitBackend.PALLAS)
    acc2 = octree.build_octree(c2, rt.OctreeConfig(max_depth=C2_DEPTH))
    torch.cuda.synchronize()
    reset_launches()
    with counting_searches() as n2:
        img2 = rt.render_hdr(c2, c2_cam, cfg_o, accel=acc2)
        torch.cuda.synchronize()
    launched2 = launches_now()
    img2_p = rt.render_hdr(c2, c2_cam, cfg_p)
    org2, dir2 = pixel_rays(c2_cam)
    rec2 = recorded_rays(c2, cfg_o, org2, dir2, acc2)
    # a dead ray's answer is never read: the frame and the recording with
    # every ray walking (no mask) are the same bit for bit
    pid2_o = record_paths(c2, cfg_o, org2, dir2, accel=acc2)
    with unmasked_search():
        same2 = (torch.equal(rt.render_hdr(c2, c2_cam, cfg_o, accel=acc2),
                             img2)
                 and torch.equal(record_paths(c2, cfg_o, org2, dir2,
                                              accel=acc2), pid2_o))
    pid2_p = record_paths(c2, cfg_p, org2, dir2)
    zeros2 = torch.zeros((C2_H, C2_W), dtype=torch.int32, device=dev)
    vs2 = parity.compare(img2, zeros2, img2_p, zeros2,
                         prove=parity.flip_prover(c2, rec2, pid2_p.T))
    pixels_equal2 = torch.equal(img2, img2_p)
    emit(phase="main-OCTREE", case="b_config2_vs_PALLAS", w=C2_W, h=C2_H,
         prims=c2.n_prims, depth=C2_DEPTH, max_per_cell=acc2.max_per_cell,
         coarse=int((acc2.coarse_ids >= 0).sum()), searches=n2,
         launches=launched2, pixels_equal=pixels_equal2,
         frame_and_recording_equal_unmasked=same2,
         winners_equal_frac=float((rec2["pid"].T == pid2_p).all(dim=1)
                                  .float().mean()), **vs2)
    check(vs2["ok"] and pixels_equal2,
          f"config 2 OCTREE differs from PALLAS: {vs2}")
    check(same2, "config 2 OCTREE with the live mask differs from the "
          "search without it")
    check(n2["octree_search"] == cfg_o.refmax and n2["dense_search"] == 0
          and launched2["octree_dda"] == cfg_o.refmax
          and not any(v for k, v in launched2.items() if k != "octree_dda"),
          f"config 2 OCTREE did not search the octree alone, one kernel "
          f"launch a bounce: {n2}, {launched2}")
    for b in range(cfg_o.refmax):
        live = rec2["alive"][b]
        errs.append(compare_octree(
            f"b_config2_bounce{b}", c2, acc2, rec2["org"][b][live],
            rec2["dir"][b][live])[0]["max_abs_err"])
        # full width, as the frame sends them: with the frame's status and
        # with a random half dead
        for tag, mask in (("frame_status", live),
                          ("half_dead", half_dead(live.shape[0], b, dev))):
            errs.append(compare_octree(
                f"b_config2_bounce{b}_full_{tag}", c2, acc2,
                rec2["org"][b], rec2["dir"][b], mask)[0]["max_abs_err"])

    # (c) BASELINE config 4 at full width, as bench.py --c4-backend octree
    t0 = time.perf_counter()
    acc4 = octree.build_octree(c4, rt.OctreeConfig(max_depth=C4_DEPTH))
    torch.cuda.synchronize()
    build4_s = time.perf_counter() - t0
    rec4_o = recorded_rays(c4, cfg_o, org4, dir4, acc4)
    alive4 = rec4_o["alive"][1]
    o1, d1 = rec4_o["org"][1], rec4_o["dir"][1]
    # bounce 0 (every ray live), bounce 1 at full width as the frame sends
    # it (the dead rays masked), bounce 1's live rays alone
    searches = {"bounce0": (org4, dir4, None),
                "bounce1": (o1, d1, alive4),
                "bounce1_live": (o1[alive4].contiguous(),
                                 d1[alive4].contiguous(), None)}
    dda = {}
    for b, (name, (o, d, live)) in enumerate(searches.items()):
        rep_b, st, _ = compare_octree(f"c_config4_{name}", c4, acc4, o, d,
                                      live)
        errs.append(rep_b["max_abs_err"])
        # the other mask: bounce 0 with a random half dead, bounce 1 with
        # every ray walking
        other = (half_dead(o.shape[0], 40 + b, dev) if live is None
                 and name == "bounce0" else None)
        if name != "bounce1_live":
            errs.append(compare_octree(
                f"c_config4_{name}_" + ("half_dead" if other is not None
                                        else "unmasked"),
                c4, acc4, o, d, other)[0]["max_abs_err"])
        # the wrapper by events and alone by the profiler; the live-ray
        # loop on the same rays
        timing = kernel_report(lambda: od.launch(c4, acc4, o, d, live),
                               "octree_dda_kernel")
        plain = event_ms(lambda: octree.nearest_hit_octree_plain(
            c4, acc4, o, d, live=live), warmup=1, timed=3)
        bnd = octree_bound(c4, acc4, int(o.shape[0]), st, live)
        dda[name] = dict(
            rays=int(o.shape[0]),
            live=int(o.shape[0] if live is None else live.sum()), **st,
            ms=timing["ms"]["median"], kernel_ms=median_of(timing),
            timing=timing, plain_ms=statistics.median(plain),
            plain_ms_runs=plain, bound_ms=bnd[0], bound_by=bnd[1])
    reset_launches()
    with counting_searches() as n4:
        hdr4_o, mem4 = peak_memory(
            lambda: rt.render_hdr(c4, c4_cam, cfg_o, accel=acc4))
    launched4 = launches_now()
    # the counted call above is the warm-up
    frame4 = event_ms(lambda: rt.render_hdr(c4, c4_cam, cfg_o, accel=acc4),
                      warmup=0, timed=3)
    breakdown4 = frame_breakdown(
        lambda: rt.render_hdr(c4, c4_cam, cfg_o, accel=acc4))
    # a dead ray's answer is never read: the frame and the recording with
    # every ray walking are the same bit for bit
    with unmasked_search():
        same4 = (torch.equal(rt.render_hdr(c4, c4_cam, cfg_o, accel=acc4),
                             hdr4_o)
                 and torch.equal(record_paths(c4, cfg_o, org4, dir4,
                                              accel=acc4),
                                 rec4_o["pid"].T.contiguous()))
    zeros4 = torch.zeros((C4_H, C4_W), dtype=torch.int32, device=dev)
    graze = [parity.grazing_prover(c4, org4, dir4),
             parity.grazing_prover(c4, org4, dir4, pid=rec4_o["pid"][0]),
             parity.grazing_prover(c4, org4, dir4, pid=pid4_p[:, 0])]
    vs4 = parity.compare(
        hdr4_o, zeros4, hdr4_p, zeros4,
        prove=parity.flip_prover(c4, rec4_o, pid4_p.T),
        prove_rounding=lambda i: graze[0](i) | graze[1](i) | graze[2](i),
        max_rounding_frac=C4_MAX_ROUNDING_FRAC)
    out.update(build4_s=build4_s, frame4_ms=statistics.median(frame4),
               frame4_peak=mem4, dda=dda, breakdown4=breakdown4)
    emit(phase="main-OCTREE", case="c_config4_vs_PALLAS", w=C4_W, h=C4_H,
         prims=c4.n_prims, refmax=cfg_o.refmax, depth=C4_DEPTH,
         build_host_seconds=build4_s, max_per_cell=acc4.max_per_cell,
         coarse=int((acc4.coarse_ids >= 0).sum()),
         cell_ids=int(acc4.cell_ids.numel()),
         accel_device_bytes=accel_bytes(acc4), dda=dda,
         frame_ms=statistics.median(frame4), frame_ms_runs=frame4,
         frame_timing="CUDA events, median of 3 after one warm-up",
         frame_breakdown=breakdown4,
         frame_and_recording_equal_unmasked=same4,
         memory=mem4, searches=n4, launches=launched4,
         finite=bool(torch.isfinite(hdr4_o).all()),
         rounding_frac=vs4["rounding"] / vs4["pixels"],
         max_rounding_frac=C4_MAX_ROUNDING_FRAC,
         winners_equal_frac=float((rec4_o["pid"].T == pid4_p).all(dim=1)
                                  .float().mean()), **vs4)
    check(tuple(hdr4_o.shape) == (C4_H, C4_W, 3)
          and hdr4_o.device.type == "cuda", "bad config-4 OCTREE frame")
    check(n4["octree_search"] == cfg_o.refmax and n4["dense_search"] == 0
          and launched4["octree_dda"] == cfg_o.refmax
          and not any(v for k, v in launched4.items() if k != "octree_dda"),
          f"config 4 OCTREE did not search the octree alone, one kernel "
          f"launch a bounce: {n4}, {launched4}")
    check(vs4["ok"], f"config 4 OCTREE differs from PALLAS: {vs4}")
    check(same4, "config 4 OCTREE with the live mask differs from the "
          "search without it")

    # (d) transmission at scale: config 4's glass variant through TILED,
    # the octree serving the substance query
    t0 = time.perf_counter()
    glass = config4_glass_scene(device=dev)
    glass_build_s = time.perf_counter() - t0
    acc_g = octree.build_octree(glass, rt.OctreeConfig(max_depth=C4_DEPTH))
    t0 = time.perf_counter()
    tables_g = rtl.frame_tables(glass, c4_cam)
    torch.cuda.synchronize()
    tables_g_s = time.perf_counter() - t0
    cfg_t = RenderConfig(refmax=2, backend=HitBackend.TILED)
    reset_launches()
    with counting_searches() as ng_main:
        hdr_g, mem_g = peak_memory(lambda: rt.render_hdr(
            glass, c4_cam, cfg_t, tables=tables_g, accel=acc_g))
    launched_g = launches_now()
    queries = []
    with counting_searches(keep=queries) as ng:
        img_g, diag_g = rtl.render_frame_tiled(
            glass, cfg_t, c4_cam, tables=tables_g, accel=acc_g,
            with_diag=True)
        torch.cuda.synchronize()
    frame_g = event_ms(lambda: rt.render_hdr(
        glass, c4_cam, cfg_t, tables=tables_g, accel=acc_g), warmup=0,
        timed=3)
    # 4,096 of the bounce-0 glue's transmission points (rays whose first
    # winner is a glass sphere), the grid query against the dense one in
    # chunks of rays
    k_g = tt.frame_bounce0(glass, c4_cam, *tables_g[:3])
    pid0 = k_g["pid"].reshape(-1)
    mat = glass.prim_material[pid0.clamp(min=0).long()].long()
    is_t = (pid0 >= 0) & (glass.materials.response[mat]
                          == int(ResponseType.TRANSMISSION))
    point0, cur0 = queries[0]
    check(point0.shape[0] == pid0.shape[0], "the first grid query is not "
          "the bounce-0 glue's")
    cand_t = torch.nonzero(is_t).flatten().cpu().numpy()
    rng = np.random.default_rng(23)
    idx = torch.as_tensor(np.sort(rng.choice(
        cand_t, min(SUBSTANCE_SAMPLES, cand_t.size), replace=False)),
        device=dev)
    pts, cur = point0[idx], cur0[idx]
    grid_q = trace_mod.substance_refr_at(glass, pts, cur, accel=acc_g)
    dense_q = [torch.cat(x) for x in zip(*(
        trace_mod.substance_refr_at(glass, pts[i:i + 256], cur[i:i + 256])
        for i in range(0, pts.shape[0], 256)))]
    sub_equal = (torch.equal(grid_q[0], dense_q[0])
                 and torch.equal(grid_q[1], dense_q[1]))
    dense_elements = sum(q[0].shape[0] for q in queries) * glass.n_prims
    out.update(glass_ms=statistics.median(frame_g), glass_peak=mem_g,
               dense_elements_first=point0.shape[0] * glass.n_prims,
               dense_elements=dense_elements)
    emit(phase="main-OCTREE", case="d_glass_TILED", w=C4_W, h=C4_H,
         prims=glass.n_prims, refmax=cfg_t.refmax, depth=C4_DEPTH,
         glass_winner_pixels=int(is_t.sum()),
         scene_build_seconds=glass_build_s,
         frame_tables_host_seconds=tables_g_s, launches=launched_g,
         rounds=diag_g["rounds"], unresolved=int(diag_g["unresolved"]),
         searches=ng_main, grid_queries=len(queries),
         frame_ms=statistics.median(frame_g), frame_ms_runs=frame_g,
         memory=mem_g, substance_samples=int(idx.numel()),
         substance_grid_equals_dense=sub_equal,
         refracting_samples=int(grid_q[1].sum()),
         dense_query_elements_first_call=point0.shape[0] * glass.n_prims,
         dense_query_elements_frame=dense_elements,
         finite=bool(torch.isfinite(hdr_g).all()))
    check(launched_g["tiled_frame"] == 1
          and launched_g["listed"] == diag_g["rounds"] >= 1
          and launched_g["dense"] == 0 and launched_g["scalar"] == 0,
          f"the glass frame did not run B7 once and B6 each sweep round: "
          f"{launched_g}, {diag_g}")
    check(int(diag_g["unresolved"]) == 0, "the glass frame left rays "
          "unresolved")
    check(ng_main["dense_substance"] == 0 and ng_main["grid_substance"] >= 1
          and ng["dense_substance"] == 0,
          f"the glass frame took the dense substance query: {ng_main}")
    check(torch.equal(img_g, hdr_g) and bool(torch.isfinite(hdr_g).all())
          and tuple(hdr_g.shape) == (C4_H, C4_W, 3), "bad glass frame")
    check(sub_equal and idx.numel() == SUBSTANCE_SAMPLES,
          "the grid substance query differs from the dense one")

    # (e) an OCTREE fit with accel_every=2 on the card and on the CPU
    cams_f = fit_cameras(OCT_FIT_W, OCT_FIT_W, n=OCT_FIT_VIEWS, device=dev)
    targets_f = torch.stack([rt.render_hdr(
        head, c, RenderConfig(refmax=2, backend=HitBackend.FUSED)).reshape(
        -1, 3) for c in cams_f])
    start = perturbed(head)
    # SGD, not Adam: Adam's first step moves every leaf by lr times the
    # sign of its gradient, and a sphere-center gradient that is 0 up to
    # rounding (down to 6e-12 here) takes opposite signs on the card and
    # on the CPU, which sum in other orders: the two runs then part by
    # ~3e-4 after one step. SGD moves such a leaf by lr times the noise.
    fc = FitConfig(steps=4, lr=1.0, optimizer="sgd", accel_every=2)
    builds = []
    real_build = octree.build_octree

    def counting_build(scene, *a, **kw):
        builds.append(scene.device.type)
        return real_build(scene, *a, **kw)

    octree.build_octree = counting_build
    try:
        reset_launches()
        with counting_searches() as nf:
            t0 = time.perf_counter()
            r_dev = fit(start, cfg_o, cams_f, targets_f, fc,
                        accel=octree.build_octree(start, rt.OctreeConfig()))
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
        launched_f = launches_now()
        start_cpu = start.to("cpu")
        r_cpu = fit(start_cpu, cfg_o,
                    fit_cameras(OCT_FIT_W, OCT_FIT_W, n=OCT_FIT_VIEWS,
                                device="cpu"), targets_f.cpu(), fc,
                    accel=octree.build_octree(start_cpu, rt.OctreeConfig()))
    finally:
        octree.build_octree = real_build
    # a dead ray's answer is never read, gradients included: the fit
    # with the mask and with every ray walking, each with PyTorch's
    # deterministic algorithms (the gathers' backward sums in a fixed
    # order), are the same bit for bit
    fits = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for masked in (True, False, True):
            with contextlib.ExitStack() as stack:
                if not masked:
                    stack.enter_context(unmasked_search())
                fits.append(fit(start, cfg_o, cams_f, targets_f, fc,
                                accel=octree.build_octree(
                                    start, rt.OctreeConfig())))
    finally:
        torch.use_deterministic_algorithms(False)
    # each fit's first build is the caller's; the rest are its rebuilds
    rebuilds = {d: builds.count(d) - 1 for d in ("cuda", "cpu")}

    def same_fit(a, b):
        return a.losses == b.losses and all(
            torch.equal(x, y) for x, y in zip(float_partition(a.scene)[0],
                                              float_partition(b.scene)[0]))

    fit_masks = dict(masked_equals_unmasked=same_fit(fits[0], fits[1]),
                     masked_twice_equal=same_fit(fits[0], fits[2]),
                     losses=[f.losses for f in fits])
    emit(phase="main-OCTREE", case="e_fit_card_vs_cpu", views=len(cams_f),
         w=OCT_FIT_W, h=OCT_FIT_W, steps=fc.steps, optimizer=fc.optimizer,
         lr=fc.lr, accel_every=fc.accel_every, seconds=fit_s,
         centers_moved=float((r_dev.scene.sphere_center
                              - start.sphere_center).abs().max()),
         losses_card=r_dev.losses,
         losses_cpu=r_cpu.losses, rebuilds=rebuilds, searches=nf,
         launches=launched_f, masked_vs_unmasked=fit_masks)
    check(fit_masks["masked_equals_unmasked"]
          and fit_masks["masked_twice_equal"],
          f"the OCTREE fit with the live mask differs from the fit without "
          f"it: {fit_masks}")
    check(np.allclose(r_dev.losses, r_cpu.losses, rtol=1e-4, atol=0.0),
          "the OCTREE fit on the card differs from the CPU")
    check(rebuilds["cuda"] == rebuilds["cpu"] == 1,
          f"the fits rebuilt the octree at other steps: {builds}")
    check(nf["octree_search"] == fc.steps * len(cams_f) * cfg_o.refmax
          and nf["dense_search"] == 0
          and launched_f["octree_dda"] == nf["octree_search"],
          f"the OCTREE fit did not search the octree, one kernel launch a "
          f"search: {nf}, {launched_f}")
    check(all(np.isfinite(r_dev.losses)) and r_dev.losses[-1]
          < r_dev.losses[0], f"OCTREE fit losses: {r_dev.losses}")
    out["row"] = dict(launches=launched4["octree_dda"],
                      max_abs_err=max(errs), **dda["bounce0"],
                      bounce1={k: dda["bounce1"][k] for k in (
                          "rays", "live", "ray_steps", "ms", "kernel_ms",
                          "plain_ms", "bound_ms", "bound_by")})
    return out

# ---------------------------------------------------------------------------
# Phases 9g-9i: ray sharding over torch.distributed, and the A9 entry points
# ---------------------------------------------------------------------------

#: the sharded fit of config 5's cut: 8 headline views, PALLAS (B3 records,
#: B5 replays), SGD (world sizes sum in other orders: Adam's first step is
#: lr x sign(g))
SHARD_FIT = FitConfig(steps=2, lr=1e-2, optimizer="sgd", replay_every=1)
#: seconds the two gloo ranks of 9h may take, start to exit
GLOO_JOIN_S = 600


# ---------------------------------------------------------------------------
# Phase 9j: the wavefront shade kernel
# ---------------------------------------------------------------------------

#: TILED's capped status (``render_tiled._CAP``) among the statuses of the
#: all-status case
SHADE_STATUSES = (0, 1, 2, 3, 4, rtl._CAP)


@contextlib.contextmanager
def plain_shade():
    """While active, no wavefront engages the shade kernel: every bounce
    takes the plain ``ops/trace._shade``."""
    real = shade.engages
    shade.engages = lambda *a, **kw: False
    try:
        yield
    finally:
        shade.engages = real


def shade_plain(scene, cfg, state, pid, bounce, rng, last):
    """The kernel's plain twin on the card: ``_shade`` (and the epilogue
    where ``last``) -> (state, the next ALIVE mask)."""
    alive = state.status == 0
    out = trace_mod._shade(scene, cfg, state, rng, bounce,
                           trace_mod.prim_rows(scene), alive, pid, None)
    if last:
        out = trace_mod._epilogue(cfg, out)
    return out, out.status == 0


def float_err(a, b) -> float:
    """The largest |a - b| over two float tensors of one shape: 0 where
    their bits agree, inf where one is NaN and the other is not."""
    if a.numel() == 0:
        return 0.0
    d = torch.where(bits(a) == bits(b), 0.0, (a - b).abs())
    return float(torch.nan_to_num(d, nan=float("inf")).max())


def compare_shade(name, scene, cfg, state, pid, bounce, rng=None,
                  last=False):
    """The shade kernel against its plain twin on one bounce's state and
    winners, both on the card: every column and the next ALIVE mask bit
    for bit, and the largest difference of the float columns -> (report,
    the plain output state, its ALIVE mask)."""
    k, k_alive = trace_mod._bounce_kernel(scene, cfg, state, rng, bounce,
                                          pid_override=pid, last=last)
    p, p_alive = shade_plain(scene, cfg, state, pid, bounce, rng, last)
    torch.cuda.synchronize()
    differ = {}
    for col in ("org", "dir", "color", "path", "refr", "status"):
        a, b = bits(getattr(k, col)), bits(getattr(p, col))
        differ[col] = int((a != b).reshape(a.shape[0], -1).any(dim=1).sum())
    differ["alive"] = int((k_alive != p_alive).sum())
    err = max(float_err(getattr(k, col), getattr(p, col))
              for col in ("org", "dir", "color", "path", "refr"))
    alive = state.status == 0
    rep = dict(rays=int(state.org.shape[0]), alive=int(alive.sum()),
               hits=int((alive & (pid >= 0)).sum()),
               out_status={int(v): int((p.status == v).sum())
                           for v in SHADE_STATUSES},
               bounce=("per ray" if isinstance(bounce, torch.Tensor)
                       else bounce), rough=scene.has_rough, last=last,
               rays_differing=differ, max_abs_err=err)
    rep["ok"] = not any(differ.values()) and err == 0.0
    emit(phase="shade", case=name, prims=scene.n_prims, **rep)
    check(rep["ok"], f"shade {name}: the kernel differs from the plain "
          f"_shade: {rep}")
    return rep, p, p_alive


def shade_bounces(name, scene, cfg, org, dir, accel=None) -> list:
    """A refmax-2 trace's two bounces of ``org``/``dir`` through
    :func:`compare_shade` (the second with the epilogue), each bounce's
    winners searched by ``cfg.backend`` on the plain twin's state."""
    state, rng = trace_mod._start(scene, cfg, org, dir, DEFAULT_SEED, None,
                                  None)
    reps, live = [], None
    for b in range(cfg.refmax):
        _t, pid = trace_mod.nearest_hit(scene, cfg, state.org, state.dir,
                                        accel, live=live)
        rep, state, live = compare_shade(f"{name}_bounce{b}", scene, cfg,
                                         state, pid, b, rng,
                                         last=b == cfg.refmax - 1)
        reps.append(rep)
    return reps


def all_status_state(scene, cfg, org, dir, accel=None, seed=11):
    """A state with every status (TILED's capped one too), random colors
    and paths, each ray's winner from the search and a per-ray bounce ->
    (state, pid, bounce, rng)."""
    g = np.random.default_rng(seed)
    n = org.shape[0]
    dev = org.device
    state, rng = trace_mod._start(scene, cfg, org, dir, DEFAULT_SEED, None,
                                  None)
    status = np.where(g.random(n) < 0.6, 0, g.choice(SHADE_STATUSES, n))
    state = dataclasses.replace(
        state, status=torch.as_tensor(status, dtype=torch.int32, device=dev),
        color=torch.as_tensor(g.uniform(0, 1, (n, 3)), dtype=torch.float32,
                              device=dev),
        path=torch.as_tensor(g.uniform(0, 20, n), dtype=torch.float32,
                             device=dev))
    _t, pid = trace_mod.nearest_hit(scene, cfg, org, dir, accel)
    bounce = torch.as_tensor(g.integers(0, 4, n), dtype=torch.int32,
                             device=dev)
    return state, pid, bounce, rng


def shade_bound(n, scene, per_ray_bounce=False):
    """The least time of one shade launch over ``n`` rays -> (bound_ms,
    bound_by): each ray reads org, dir, color (36 B), path, status, pid (12
    B), a per-ray bounce and, on a rough scene, its ray id (4 B each), and
    writes org, dir, color, path, status and alive (45 B); the tables are
    read at the winners (L2). Operations do not bound it."""
    per_ray = 48 + 45 + 4 * per_ray_bounce + 4 * scene.has_rough
    return bound(0.0, float(n * per_ray))


def host_us(fn, warmup=20, timed=200) -> float:
    """Median host time of ``fn`` in microseconds: for host-only work."""
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(timed):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e6


def shade_phase(dev, c4=None, c4_cam=None, build=None) -> dict:
    """Phase 9j, main-shade (module docstring): the shade kernel against
    the plain ``_shade`` bit for bit on its cases, whole OCTREE and TILED
    frames of config 4 against the plain path's, the scenes outside its
    class on the plain path, and the kernel's time alone against its
    bound."""
    if c4 is None:
        c4, c4_cam = config4_scene(device=dev), config4_camera(dev)
    cfg_o = RenderConfig(refmax=2, backend=HitBackend.OCTREE)
    cfg_p = RenderConfig(refmax=2, backend=HitBackend.PALLAS)
    cam256 = make_camera((0.0, 0.0, 0.5), 256, 256, np.pi / 2, np.pi / 2,
                         device=dev)
    cam512 = make_camera((0.0, 0.0, 0.5), 512, 512, np.pi / 2, np.pi / 2,
                         device=dev)

    # (a) the kernel against its plain twin, both bounces
    t0 = time.perf_counter()
    acc4 = octree.build_octree(c4, rt.OctreeConfig(max_depth=C4_DEPTH))
    org4, dir4 = pixel_rays(c4_cam)
    reps = shade_bounces("a_config4", c4, cfg_o, org4, dir4, acc4)
    field = near_miss_field(device=dev)
    reps += shade_bounces("b_near_miss_600", field, cfg_p, *pixel_rays(cam512))
    # the rough mirror scene with its glass as diffuse, which the class
    # takes: the RNG is live
    rough = dataclasses.replace(rough_scene(device=dev),
                                has_transmission=False)
    check(shade.supports(rough) and rough.has_rough,
          "shade: the rough scene is outside the class")
    reps += shade_bounces("c_rough", rough, cfg_p, *pixel_rays(cam512))
    tri, org_t, dir_t = tri_edge_field(device=dev)
    reps += shade_bounces("d_tri_edge", tri, cfg_p, org_t, dir_t)
    for name, scene, cfg, cam, acc in (
            ("e_all_status_rough", rough, cfg_p, cam512, None),
            ("f_all_status_config4", c4, cfg_o, c4_cam, acc4)):
        st, pid, bounce, rng = all_status_state(scene, cfg, *pixel_rays(cam),
                                                accel=acc)
        for last in (False, True):
            reps.append(compare_shade(
                f"{name}_{'last' if last else 'bounce'}", scene, cfg, st, pid,
                bounce, rng, last=last)[0])
    cases_s = time.perf_counter() - t0

    # (b) whole frames of config 4: the kernel's against the plain path's
    frames = {}
    tables4 = rtl.frame_tables(c4, c4_cam)
    cfg_t = RenderConfig(refmax=2, backend=HitBackend.TILED)
    for path, cfg, kw in (("octree", cfg_o, dict(accel=acc4)),
                          ("tiled", cfg_t, dict(tables=tables4))):
        out = {}
        for mode in ("kernel", "plain"):
            ctx = plain_shade() if mode == "plain" else contextlib.nullcontext()
            with ctx:
                shade.LAUNCHES.update(shade=0, plain=0)
                img = rt.render_hdr(c4, c4_cam, cfg, **kw)
                torch.cuda.synchronize()
                la = dict(shade.LAUNCHES)
                ms = spread(event_ms(lambda: rt.render_hdr(c4, c4_cam, cfg,
                                                           **kw),
                                     warmup=1, timed=5))
                bd = frame_breakdown(lambda: rt.render_hdr(c4, c4_cam, cfg,
                                                           **kw))
            out[mode] = dict(img=img, launches=la, frame_ms=ms,
                             ops=bd.get("ops"), device_ms=bd.get("device_ms"),
                             idle_share=bd.get("idle_share"),
                             by_name=bd.get("by_name", [])[:6])
        equal = torch.equal(bits(out["kernel"]["img"]),
                            bits(out["plain"]["img"]))
        err = float_err(out["kernel"]["img"], out["plain"]["img"])
        for mode in out:
            out[mode].pop("img")
        frames[path] = dict(equal=equal, max_abs_err=err, **out)
        emit(phase="main-shade", case=f"b_config4_{path}_frame", w=c4_cam.w,
             h=c4_cam.h, bit_equal=equal, max_abs_err=err, **out)
        check(equal, f"shade: the {path} frame differs from the plain path's")
    la_o, la_t = (frames[p]["kernel"]["launches"] for p in ("octree",
                                                            "tiled"))
    check(la_o == {"shade": 2, "plain": 0}
          and frames["octree"]["plain"]["launches"] == {"shade": 0,
                                                         "plain": 2},
          f"shade: the OCTREE frame's launches {frames['octree']}")
    check(la_t["shade"] >= 1 and la_t["plain"] == 0
          and frames["tiled"]["plain"]["launches"]["shade"] == 0,
          f"shade: the TILED frame's launches {frames['tiled']}")

    # (c) scenes outside the class take the plain _shade
    small = make_camera((0.0, 0.0, 0.5), 480, 272, np.pi / 2, 0.5 * np.pi
                        * 272 / 480, device=dev)
    glass = config4_glass_scene(device=dev)
    acc_g = octree.build_octree(glass, rt.OctreeConfig(max_depth=C4_DEPTH))
    b = SceneBuilder()
    faces = [b.add_solid_texture(c) for c in
             ((.9, .2, .2), (.2, .9, .2), (.2, .2, .9), (.9, .9, .2),
              (.2, .9, .9), (.9, .2, .9))]
    b.set_sky_box(faces)
    mm = b.add_material(ResponseType.REFLECTION, mirror=True)
    b.add_sphere((4.0, 0.0, 0.3), 1.0, mm, faces[0])
    cube = b.build(dev)
    outside = {}
    for name, scene, cfg, kw in (
            ("glass_octree", glass, cfg_o, dict(accel=acc_g)),
            ("cube_sky_brute", cube, RenderConfig(refmax=2), {})):
        shade.LAUNCHES.update(shade=0, plain=0)
        img = rt.render_hdr(scene, small, cfg, **kw)
        torch.cuda.synchronize()
        outside[name] = dict(launches=dict(shade.LAUNCHES),
                             finite=bool(torch.isfinite(img).all()),
                             in_class=shade.supports(scene))
        check(outside[name]["launches"] == {"shade": 0, "plain": 2}
              and outside[name]["finite"] and not outside[name]["in_class"],
              f"shade: {name} did not take the plain _shade: "
              f"{outside[name]}")
    emit(phase="main-shade", case="c_outside_the_class", **outside)

    # (d) the kernel alone against its bound: config 4's bounce 0 (every
    # ray ALIVE) and bounce 1 as the frame launches it
    st0, rng0 = trace_mod._start(c4, cfg_o, org4, dir4, DEFAULT_SEED, None,
                                 None)
    _t, pid0 = trace_mod.nearest_hit(c4, cfg_o, org4, dir4, acc4)
    st1, alive1 = trace_mod._bounce_kernel(c4, cfg_o, st0, rng0, 0,
                                           pid_override=pid0)
    _t, pid1 = trace_mod.nearest_hit(c4, cfg_o, st1.org, st1.dir, acc4,
                                     live=alive1)
    n4 = org4.shape[0]
    timed = {}
    for name, st, pid, last in (("bounce0", st0, pid0, False),
                                ("bounce1", st1, pid1, True)):
        rep = kernel_report(lambda: shade.launch(
            c4, st.org, st.dir, st.color, st.path, st.status, pid,
            int(name[-1]), rng0, last=last), "shade_bounce")
        plain_ms = cuda_median_ms(lambda: shade_plain(
            c4, cfg_o, st, pid, int(name[-1]), rng0, last), timed=5)
        bound_ms, bound_by = shade_bound(n4, c4)
        timed[name] = dict(alive=int((st.status == 0).sum()),
                           ms=rep["ms"], kernel_ms=rep["kernel_ms"],
                           device_ops=rep["device_ops"], plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           bound_share=(None if rep["kernel_ms"] is None
                                        else bound_ms
                                        / rep["kernel_ms"]["median"]))
    # the dispatch's host time, once a trace: config 4's leaf walk with
    # grad enabled, as a frame of the benchmark pays it
    engages_us = host_us(lambda: shade.engages(c4, st0.org, st0.dir,
                                               st0.refr))
    ptx = ptxas_of(build.log, ["shade_bounce_kernel"]) if build else None
    emit(phase="main-shade", case="d_times", rays=n4, timing=MS_TIMING,
         kernel_timing=KERNEL_MS_TIMING, ptxas=ptx, engages_us=engages_us,
         **timed)
    err = max([r["max_abs_err"] for r in reps]
              + [f["max_abs_err"] for f in frames.values()])
    return dict(cases=len(reps), cases_s=cases_s, frames=frames,
                outside=outside, times=timed, engages_us=engages_us,
                max_abs_err=err)


# ---------------------------------------------------------------------------
# Phase 9k: the octree's fine grid on the card
# ---------------------------------------------------------------------------

#: the build kernels' names on a profiler trace, by pass
BUILD_PASSES = ("count_kernel", "fill_kernel", "sort_kernel", "skip_kernel")


def same_accel(a, b) -> dict:
    """Each array of two accels equal (dtype, shape, values), and the ints."""
    out = {k: bool(getattr(a, k).dtype == getattr(b, k).dtype and torch.equal(
        getattr(a, k).cpu(), getattr(b, k).cpu())) for k in octree._TENSORS}
    out["ints"] = (a.max_depth, a.l_cut, a.max_per_cell) == (
        b.max_depth, b.l_cut, b.max_per_cell)
    return out


def host_build(scene, *args, like=None, build=octree.build_octree, **kw):
    """``build_octree``'s host path for a scene on the card: the build of a
    CPU copy, moved to the card."""
    acc = build(scene.to("cpu"), *args, like=(
        None if like is None else like.to("cpu")), **kw)
    return acc.to(scene.device)


def build_times(scene, cfg, reps) -> dict:
    """A build on the card: the whole ``build_octree`` (host clock to a
    synchronize, median of ``reps``), its host stages alone (the AABB read,
    ``grid_inputs``), and each pass alone on a profiler trace (median of
    its launches; a build's time is their mean times the launches a build
    that ``LAUNCHES`` counts, since a trace can miss its first
    operations)."""
    octree.build_octree(scene, cfg)
    torch.cuda.synchronize()
    whole = []
    for _ in range(reps):
        t0 = time.perf_counter()
        octree.build_octree(scene, cfg)
        torch.cuda.synchronize()
        whole.append((time.perf_counter() - t0) * 1e3)
    lo, hi = octree._aabbs_f64(scene)[2:]
    read_ms = host_median_ms(lambda: octree._aabbs_f64(scene), warmup=1,
                             timed=3)
    inputs_ms = host_median_ms(lambda: octree.grid_inputs(
        lo, hi, cfg.max_depth), warmup=0, timed=3)
    before = dict(ob.LAUNCHES)
    evs = device_events([lambda: octree.build_octree(scene, cfg)], reps)
    passes = {}
    for p in BUILD_PASSES:
        ms = [t for name, t in evs if p in name]
        per_build = (ob.LAUNCHES[p[:-7]] - before[p[:-7]]) / reps
        passes[p] = dict(median_ms=statistics.median(ms) if ms else None,
                         launches=len(ms), per_build_ms=(
                             statistics.fmean(ms) * per_build if ms
                             else None))
    other = [(n, t) for n, t in evs
             if not any(p in n for p in BUILD_PASSES)]
    return dict(whole_ms=spread(whole), aabb_read_ms=read_ms,
                grid_inputs_ms=inputs_ms, passes=passes,
                other_device_ms_per_build=sum(t for _, t in other) / reps,
                other_device_ops_per_build=len(other) / reps)


def octree_build_phase(dev) -> dict:
    """Phase 9k, main-octree-build (module docstring): (a) config 4 (100k
    prims) and config 5's field (1M), depth 8, built on the card and on the
    host, every array equal, and with ``like=``; times; (b) a depth-9 grid
    with one occupied corner, the skip field against the host's, capped at
    255; (c) a 16-step OCTREE fit rebuilding every 8 steps, its losses and
    leaves with the card build equal to those with the host build."""
    out = {}
    cfg = rt.OctreeConfig(max_depth=C4_DEPTH)
    # (a) the two fields
    for case, n, reps, host_reps in (("config4_100k", 100_000, 5, 3),
                                     ("config5_1m", 1_000_000, 5, 2)):
        scene = config4_scene(n, device=dev)
        before = dict(ob.LAUNCHES)
        acc = octree.build_octree(scene, cfg)
        torch.cuda.synchronize()
        launched = {k: ob.LAUNCHES[k] - before[k] for k in before}
        want = host_build(scene, cfg)
        equal = same_accel(acc, want)
        # like=: an accel of more room than the build needs, the prims moved
        n_ids, n_coarse = acc.cell_ids.numel(), acc.coarse_ids.numel()
        roomy = dataclasses.replace(
            acc, cell_ids=torch.zeros(n_ids + n_ids // 20 + 64,
                                      dtype=torch.int32, device=dev),
            coarse_ids=torch.full((n_coarse + 8,), -1, dtype=torch.int32,
                                  device=dev),
            max_per_cell=acc.max_per_cell + 4)
        moved = dataclasses.replace(
            scene, sphere_center=scene.sphere_center + 0.013)
        equal_like = same_accel(octree.build_octree(moved, cfg, like=roomy),
                                host_build(moved, cfg, like=roomy))
        times = build_times(scene, cfg, reps)
        host_ms = [host_median_ms(lambda: host_build(scene, cfg), warmup=0,
                                  timed=1) for _ in range(host_reps)]
        pairs, cells = int(acc.cell_offsets[-1]), (1 << C4_DEPTH) ** 3
        # each input byte read once (AABBs, mask), each output byte written
        # once (offsets, ids, skip field)
        bnd = bound(0.0, 25 * scene.n_prims + 4 * (cells + 1) + 4 * pairs
                    + cells)
        rep = dict(prims=scene.n_prims, depth=C4_DEPTH, pairs=pairs,
                   occupied=int((acc.skip_dist == 0).sum()),
                   max_skip=int(acc.skip_dist.max()),
                   max_per_cell=acc.max_per_cell,
                   coarse=int((acc.coarse_ids >= 0).sum()),
                   launches=launched, equal=equal, equal_like=equal_like,
                   host_build_ms=spread(host_ms),
                   passes_ms=sum(p["per_build_ms"] or 0.0
                                 for p in times["passes"].values()),
                   bound_ms=bnd[0], bound_by=bnd[1], **times)
        emit(phase="main-octree-build", case=f"a_{case}", **rep)
        check(all(equal.values()) and all(equal_like.values()),
              f"the card build differs from the host build on {case}: "
              f"{equal}, like= {equal_like}")
        check(launched == {"count": 1, "fill": 1, "sort": 1, "skip": 3},
              f"the build of a scene on the card did not take the card "
              f"path: {launched}")
        out[case] = rep

    # (b) one occupied corner at depth 9: distances to 511, capped at 255
    depth, R = 9, 512
    lo = torch.full((1, 3), 0.25, device=dev)
    hi = torch.full((1, 3), 0.5, device=dev)
    fine = torch.ones((1,), dtype=torch.uint8, device=dev)
    rl = np.zeros(3, np.float32)
    offsets, total, most = ob.count(lo, hi, fine, rl, float(R), depth)
    ids = ob.fill(lo, hi, fine, rl, float(R), depth, offsets, total)
    skip = ob.skip_field(offsets, depth)
    off_h, ids_h, most_h = native.grid_csr(
        lo.cpu().numpy(), hi.cpu().numpy(), np.ones(1, bool), rl, float(R),
        depth)
    skip_h = octree._skip_field_host(off_h, R)
    corner = dict(total=total, max_per_cell=most,
                  offsets_equal=bool(np.array_equal(offsets.cpu().numpy(),
                                                    off_h)),
                  ids_equal=bool(np.array_equal(ids.cpu().numpy(), ids_h)),
                  skip_equal=bool(np.array_equal(skip.cpu().numpy(),
                                                 skip_h)),
                  capped_cells=int((skip == 255).sum()),
                  skip_ms=cuda_median_ms(lambda: ob.skip_field(offsets,
                                                               depth),
                                         warmup=1, timed=5))
    del skip_h
    emit(phase="main-octree-build", case="b_depth9_corner", **corner)
    check(corner["offsets_equal"] and corner["ids_equal"]
          and corner["skip_equal"] and total == most_h == most == 1
          and corner["capped_cells"] > R ** 3 // 2,
          f"the depth-9 corner grid differs from the host's: {corner}")

    # (c) a fit that rebuilds its octree, with the card build and the host
    # build: the same accel, so the same losses and leaves bit for bit (52
    # prims keep B5's sums in their fixed order; deterministic algorithms
    # fix the gathers' backward)
    head = headline_scene(device=dev)
    cams = fit_cameras(480, 272, n=2, device=dev)
    cfg_o = RenderConfig(refmax=2, backend=HitBackend.OCTREE)
    targets = torch.stack([rt.render_hdr(
        head, c, RenderConfig(refmax=2, backend=HitBackend.FUSED)).reshape(
        -1, 3) for c in cams])
    start = perturbed(head)
    fc = FitConfig(steps=16, lr=1e-2, replay_every=8, accel_every=8)
    real_build = octree.build_octree
    fits, rebuilds = {}, {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for path, build in (("card", real_build), ("host", host_build)):
            before = dict(ob.LAUNCHES)
            octree.build_octree = build
            try:
                fits[path] = fit(start, cfg_o, cams, targets, fc,
                                 accel=build(start, cfg))
            finally:
                octree.build_octree = real_build
            rebuilds[path] = {k: ob.LAUNCHES[k] - before[k] for k in before}
    finally:
        torch.use_deterministic_algorithms(False)
    a, b = fits["card"], fits["host"]
    leaves_equal = all(torch.equal(x, y) for x, y in zip(
        float_partition(a.scene)[0], float_partition(b.scene)[0]))
    fit_rep = dict(steps=fc.steps, accel_every=fc.accel_every,
                   views=len(cams), losses_card=a.losses,
                   losses_host=b.losses, leaves_equal=leaves_equal,
                   launches=rebuilds)
    emit(phase="main-octree-build", case="c_fit_card_vs_host_build",
         **fit_rep)
    check(a.losses == b.losses and leaves_equal,
          f"the fit with the card build differs from the host build's: "
          f"{fit_rep}")
    check(rebuilds["card"]["count"] == 2 and rebuilds["host"]["count"] == 0,
          f"the fits' builds took the wrong path: {rebuilds}")
    out["fit"] = fit_rep
    big = out["config5_1m"]
    out["row"] = dict(launches=big["launches"], ms=big["passes_ms"],
                      plain_ms=big["host_build_ms"]["median"],
                      bound=(big["bound_ms"], big["bound_by"]),
                      whole_build_ms=big["whole_ms"]["median"],
                      passes={k: v["median_ms"]
                              for k, v in big["passes"].items()})
    return out


def octree_build_only() -> int:
    """``python3 chip_smoke.py --octree-build``: the build (with ptxas's
    report of the build kernels) and phase 9k alone."""
    dev = card()
    if dev is None:
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    build = _build.build()
    _build.load()
    emit(phase="build", seconds=time.perf_counter() - t0, card=smi,
         ptxas=ptxas_of(build.log, list(BUILD_PASSES)))
    octree_build_phase(dev)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": smi.split(",")[0],
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def card():
    """The card, current and with TF32 refused; None (and why, on standard
    error) without one."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return None
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def shade_only() -> int:
    """``python3 chip_smoke.py --shade``: the build (with ptxas's report of
    the shade kernel) and phase 9j alone."""
    dev = card()
    if dev is None:
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    build = _build.build()
    _build.load()
    emit(phase="build", seconds=time.perf_counter() - t0, card=smi,
         ptxas=ptxas_of(build.log, ["shade_bounce_kernel"]))
    shade_phase(dev, build=build)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": smi.split(",")[0],
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def unsharded_step(scene, cfg, cam, target, seed):
    """``value_and_grad`` of a view's global loss in one process."""
    org, dirs = pixel_rays(cam)
    params, rebuild = float_partition(scene)
    params = [p.detach().requires_grad_(True) for p in params]
    colors = render_rays(rebuild(params), cfg, org, dirs, seed)
    loss = ((colors - target) ** 2).sum() / org.shape[0]
    loss.backward()
    return loss.detach(), [torch.zeros_like(p) if p.grad is None else p.grad
                           for p in params]


def fit_views(dev):
    """Config 5's cut: the headline scene, its 8 views at 1920x1088 with
    targets rendered FUSED, the start (perturbed colors and centers)."""
    head = headline_scene(device=dev)
    cams = fit_cameras(HEADLINE_W, HEADLINE_H, device=dev)
    cfg_f = RenderConfig(refmax=2, backend=HitBackend.FUSED)
    targets = torch.stack([rt.render_hdr(head, c, cfg_f).reshape(-1, 3)
                           for c in cams])
    return head, cams, targets, perturbed(head)


def gloo_rank(rank, world, rdv, out_dir):
    """One rank of phase 9h: a gloo group whose ranks share the one card
    (NCCL refuses two ranks on one device); the tensors are CUDA tensors.
    Runs the headline frame sharded, the 8-view fit, and times the
    all-reduce of a fit step's gradients; writes its results."""
    ok = pdist.init_distributed(f"file://{rdv}", world, rank, device="cuda",
                                backend="gloo", timeout_s=GLOO_JOIN_S)
    assert ok and dist.get_backend() == "gloo"
    try:
        mesh = make_mesh()
        _build.load()
        cfg_f = RenderConfig(refmax=2, backend=HitBackend.FUSED)
        cfg_p = RenderConfig(refmax=2, backend=HitBackend.PALLAS)
        head, cams, targets, start = fit_views(mesh.device)
        reset_launches()
        img = render_hdr_sharded(mesh, head, headline_camera(mesh.device),
                                 cfg_f)
        torch.cuda.synchronize()
        frame_launches = launches_now()
        reset_launches()
        res = fit(start, cfg_p, cams, targets, SHARD_FIT, mesh=mesh)
        torch.cuda.synchronize()
        fit_launches = launches_now()
        grads = float_partition(start)[0]
        ar = event_ms(lambda: all_reduce_sum(mesh, grads))
        ar_host = host_median_ms(lambda: all_reduce_sum(mesh, grads),
                                 warmup=3, timed=TIMED)
        torch.save({"img": img.cpu(), "losses": res.losses,
                    "frame_launches": frame_launches,
                    "fit_launches": fit_launches, "allreduce_ms": ar,
                    "allreduce_host_ms": ar_host,
                    "device": str(img.device),
                    "params": [p.cpu() for p in
                               float_partition(res.scene)[0]]},
                   pathlib.Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def sharded_phase(dev, head, head_cam, c3, c3_cam) -> dict:
    """Phases 9g and 9h (module docstring): a one-rank NCCL group, then two
    gloo ranks on the card. Returns the times of the ``times`` line."""
    cfg_f = RenderConfig(refmax=2, backend=HitBackend.FUSED)
    cfg_p = RenderConfig(refmax=2, backend=HitBackend.PALLAS)
    cfg_c3 = RenderConfig(refmax=3, backend=HitBackend.PALLAS)
    org, dir = pixel_rays(head_cam)
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        ok = pdist.init_distributed(f"file://{tmp}/rdv", 1, 0, device=dev,
                                    timeout_s=300)
        check(ok and dist.get_backend() == "nccl",
              "the one-rank group is not NCCL")
        try:
            mesh = make_mesh()
            topo = pdist.topology_summary(mesh)
            # (a) the headline frame: B2 on the rank's slice
            reset_launches()
            img = render_hdr_sharded(mesh, head, head_cam, cfg_f)
            torch.cuda.synchronize()
            la = launches_now()
            wave = render_rays(head, cfg_f, org, dir).reshape(img.shape)
            frame = rt.render_hdr(head, head_cam, cfg_f)
            off = ~torch.isclose(img, frame, rtol=1e-4, atol=1e-5).all(-1)
            # (b) config 3 through B4
            reset_launches()
            img3 = render_hdr_sharded(mesh, c3, c3_cam, cfg_c3)
            torch.cuda.synchronize()
            la3 = launches_now()
            one3 = rt.render_hdr(c3, c3_cam, cfg_c3)
            # (c) the sharded fit step on a headline view (B3 searches)
            _, cams, targets, start = fit_views(dev)
            reset_launches()
            loss, grads = sharded_fit_step(mesh, start, cfg_p, cams[0],
                                           targets[0], DEFAULT_SEED)
            torch.cuda.synchronize()
            la_step = launches_now()
            loss_1, grads_1 = unsharded_step(start, cfg_p, cams[0],
                                             targets[0], DEFAULT_SEED)
            grad_err = max(float((a - b).abs().max()) if a.numel() else 0.0
                           for a, b in zip(grads, grads_1))
            grads_ok = all(torch.allclose(a, b, rtol=1e-5, atol=1e-6)
                           for a, b in zip(grads, grads_1))
            # (d) config 5's cut: the 8-view fit, B3 records, B5 replays
            reset_launches()
            r_mesh = fit(start, cfg_p, cams, targets, SHARD_FIT, mesh=mesh)
            torch.cuda.synchronize()
            la_fit = launches_now()
            r_one = fit(start, cfg_p, cams, targets, SHARD_FIT)
            fit_s = {"one": [], "mesh": []}
            for turn in ("one", "mesh", "mesh", "one"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fit(start, cfg_p, cams, targets, SHARD_FIT,
                    mesh=mesh if turn == "mesh" else None)
                torch.cuda.synchronize()
                fit_s[turn].append((time.perf_counter() - t0) * 1e3
                                   / SHARD_FIT.steps)
            # (e) the dry run
            dry = dryrun_multichip(mesh)
            times.update(
                sharded_frame_w1_ms=spread(event_ms(
                    lambda: render_hdr_sharded(mesh, head, head_cam, cfg_f))),
                render_rays_fused_ms=spread(event_ms(
                    lambda: render_rays(head, cfg_f, org, dir))),
                allreduce_grads_w1_nccl_ms=spread(event_ms(
                    lambda: all_reduce_sum(mesh, grads))),
                allreduce_grads_w1_nccl_host_ms=host_median_ms(
                    lambda: all_reduce_sum(mesh, grads), warmup=3,
                    timed=TIMED),
                allreduce_bytes=sum(g.numel() * 4 for g in grads) + 4,
                fit_step_sharded_w1_host_ms=fit_s["mesh"],
                fit_step_unsharded_host_ms=fit_s["one"])
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
    rows = SHARD_FIT.steps * len(cams)
    emit(phase="main-sharded", world_size=1, backend=backend, topology=topo,
         frame_launches=la, frame_equal_render_rays=bool(torch.equal(
             img, wave)), frame_vs_render_hdr_pixels_off=int(off.sum()),
         config3_launches=la3, config3_equal=bool(torch.equal(img3, one3)),
         fit_step_launches=la_step, fit_step_loss=float(loss),
         fit_step_loss_unsharded=float(loss_1),
         fit_step_grad_max_abs_err=grad_err, fit_launches=la_fit,
         fit_losses=r_mesh.losses, fit_losses_unsharded=r_one.losses,
         dryrun_losses=list(dry), device=str(img.device))
    check(img.device.type == "cuda", "the sharded frame is not on the GPU")
    check(la["rays"] == 1 and la["frame"] == 0,
          f"the sharded headline frame did not run B2 once: {la}")
    check(torch.equal(img, wave), "the sharded frame differs from "
          "render_rays FUSED")
    check(int(off.sum()) <= parity.MAX_FLIP_FRAC * off.numel(),
          "the sharded frame and render_hdr FUSED disagree beyond ULP noise")
    check(la3["dense"] == cfg_c3.refmax, f"config 3 sharded did not search "
          f"with B4 once a bounce: {la3}")
    check(torch.equal(img3, one3), "config 3 sharded differs from the "
          "unsharded frame")
    check(la_step["scalar"] == cfg_p.refmax, f"the sharded fit step did not "
          f"search with B3: {la_step}")
    check(abs(float(loss) - float(loss_1)) <= 1e-6 * abs(float(loss_1))
          and grads_ok, "sharded_fit_step differs from value_and_grad")
    check(la_fit["scalar"] == rows * cfg_p.refmax
          and la_fit["fwd"] == rows and la_fit["bwd"] == rows,
          f"the sharded fit did not record with B3 and replay with B5: "
          f"{la_fit}")
    check(np.allclose(r_mesh.losses, r_one.losses, rtol=1e-6, atol=0.0),
          "the sharded fit's losses differ from the unsharded fit's")
    check(all(np.isfinite(dry)), f"dryrun_multichip: {dry}")

    # 9h: two gloo ranks on the one card
    with tempfile.TemporaryDirectory() as tmp:
        ctx = torch_mp.get_context("spawn")
        procs = [ctx.Process(target=gloo_rank, args=(r, 2, f"{tmp}/rdv",
                                                     tmp)) for r in range(2)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        deadline = time.monotonic() + GLOO_JOIN_S
        try:
            while any(p.is_alive() for p in procs):
                left = deadline - time.monotonic()
                if left <= 0 or any(p.exitcode not in (None, 0)
                                    for p in procs):
                    break
                multiprocessing.connection.wait(
                    [p.sentinel for p in procs if p.is_alive()],
                    timeout=min(left, 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(30)
        codes = [p.exitcode for p in procs]
        check(codes == [0, 0], f"the gloo ranks exited {codes} (a negative "
              f"code is a kill; limit {GLOO_JOIN_S} s)")
        ranks = [torch.load(pathlib.Path(tmp) / f"rank{r}.pt",
                            weights_only=False) for r in range(2)]
    wall_s = time.perf_counter() - t0
    emit(phase="main-sharded", world_size=2, backend="gloo",
         seconds=wall_s, devices=[r["device"] for r in ranks],
         frame_launches=[r["frame_launches"] for r in ranks],
         fit_launches=[r["fit_launches"] for r in ranks],
         fit_losses=[r["losses"] for r in ranks],
         fit_losses_one_process=r_one.losses)
    wave_cpu = wave.cpu()
    for r in ranks:
        check(r["device"].startswith("cuda"), "a gloo rank was not on the GPU")
        check(torch.equal(r["img"], wave_cpu), "the two-rank frame differs "
              "from one process")
        check(r["frame_launches"]["rays"] == 1,
              f"a gloo rank did not run B2: {r['frame_launches']}")
        check(r["fit_launches"]["fwd"] == rows
              and r["fit_launches"]["bwd"] == rows
              and r["fit_launches"]["scalar"] == rows * cfg_p.refmax,
              f"a gloo rank did not record with B3 and replay with B5: "
              f"{r['fit_launches']}")
        check(np.allclose(r["losses"], r_one.losses, rtol=1e-5, atol=0.0),
              "the two-rank fit's losses differ from one process's")
    check(ranks[0]["losses"] == ranks[1]["losses"]
          and all(torch.equal(a, b) for a, b in zip(ranks[0]["params"],
                                                    ranks[1]["params"])),
          "the two ranks' fits are not replicated")
    times.update(allreduce_grads_w2_gloo_ms=[
        spread(r["allreduce_ms"]) for r in ranks],
        allreduce_grads_w2_gloo_host_ms=[r["allreduce_host_ms"]
                                         for r in ranks])
    return times


def a9_phase(dev, head, head_cam) -> dict:
    """Phase 9i (module docstring): progressive_render FUSED and the demo."""
    cfg_f = RenderConfig(refmax=2, backend=HitBackend.FUSED)
    tone = ToneMapConfig(kind=ToneMapperKind.STDDEV_AROUND_MEAN)
    reset_launches()
    out = view.progressive_render(head, head_cam, cfg_f, tone, frames=4)
    torch.cuda.synchronize()
    la = launches_now()
    buf = exposure.new_exposure_buffer(head_cam.h, head_cam.w, device=dev)
    for f in range(4):
        buf = exposure.accumulate(buf, rt.render_hdr(
            head, head_cam, cfg_f, seed=step_seed(DEFAULT_SEED, f)))
    loop = view.draw(buf, tone)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, extra in (("frames", []), ("orbit", ["--orbit", "2"])):
            log = io.StringIO()
            with contextlib.redirect_stdout(log):
                rc = demo.main(["--size", "128", "--frames", "4", "--out",
                                f"{tmp}/{name}.png", *extra])
            files = sorted(pathlib.Path(tmp).glob(f"{name}*"))
            imgs = [np.load(f) if f.suffix == ".npy" else None
                    for f in files]
            runs[name] = dict(rc=rc, stdout=log.getvalue().strip(),
                              files=[f.name for f in files],
                              bytes=[f.stat().st_size for f in files],
                              shapes=[list(i.shape) for i in imgs
                                      if i is not None])
    emit(phase="main-A9", progressive_launches=la,
         progressive_equal_loop=bool(torch.equal(out, loop)),
         progressive_shape=list(out.shape), demo=runs)
    check(la["frame"] == 4, f"progressive_render did not launch B1 4 times: "
          f"{la}")
    check(out.device.type == "cuda" and torch.equal(out, loop),
          "progressive_render differs from its render_hdr + accumulate loop")
    check(bool(torch.isfinite(out).all()), "progressive_render not finite")
    for name, n_files in (("frames", 1), ("orbit", 2)):
        r = runs[name]
        check(r["rc"] == 0 and len(r["files"]) == n_files
              and all(b > 0 for b in r["bytes"]) and "on cuda" in r["stdout"]
              and all(sh == [128, 128, 3] for sh in r["shapes"]),
              f"demo {name}: {r}")
    return {}


def main() -> int:
    # ---- 0. device --------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    sm_clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    emit(phase="device", name=name, count=torch.cuda.device_count(),
         nvidia_smi=smi, sm_clock_max_mhz=sm_clock_mhz,
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    build = _build.build()
    _build.load()
    emit(phase="build", seconds=time.perf_counter() - t0,
         nvcc_seconds=build.seconds, library=build.path.name,
         ptxas=[ln.strip() for ln in build.log.splitlines()
                if "registers" in ln or "spill" in ln],
         ptxas_by_kernel=ptxas_of(build.log, PTXAS_KERNELS))

    # ---- 2. B1 against its plain version -----------------------------------
    head = headline_scene(device=dev)
    head_cam = headline_camera(dev)
    cfg_head = RenderConfig(refmax=2, backend=HitBackend.FUSED)
    glass = config1_scene(with_glass=True, with_tri=True, device=dev)
    cam256 = make_camera((0.0, 0.0, 0.5), 256, 256, np.pi / 2, np.pi / 2,
                         device=dev)
    cfg3 = RenderConfig(refmax=3, backend=HitBackend.FUSED)
    rough = rough_scene(device=dev)
    cfg_rough = RenderConfig(refmax=3, spp=4, backend=HitBackend.FUSED)
    field = near_miss_field(device=dev)
    cam512 = make_camera((0.0, 0.0, 0.5), 512, 512, np.pi / 2, np.pi / 2,
                         device=dev)
    cfg2 = RenderConfig(refmax=2, backend=HitBackend.FUSED)
    cam_rot = make_camera((0.2, -0.3, 0.5), 40, 24, np.pi / 2, np.pi / 3,
                          rot_h=0.3, rot_v=-0.2, device=dev)

    b1 = []
    rep, head_img, head_rec = compare_frame("a_headline", head, head_cam,
                                            cfg_head)
    b1.append(rep)
    check(rep["spheres_tested"][0] < rep["warps"] * head.n_spheres,
          "B1 (a): the headline's bounce-0 warps culled no sphere")
    emit(phase="B1", case="a_headline_cull",
         bounce0_spheres_per_warp=rep["spheres_tested"][0] / rep["warps"],
         bounce1_spheres_per_live_warp=rep["spheres_tested"][1]
         / max(rep["live_warps"][1], 1),
         bounce1_warps_keeping_all=rep["warps_keeping_all"][1])
    b1.append(compare_frame("b_config1_glass_tri", glass, cam256, cfg3)[0])
    for s in range(cfg_rough.spp):
        b1.append(compare_frame("c_rough_spp4", rough, cam256, cfg_rough,
                                sample=s)[0])
    b1.append(compare_frame("d_near_miss_600", field, cam512, cfg2)[0])
    b1.append(compare_frame("e_rotated_40x24", glass, cam_rot, cfg3)[0])
    check(b1[-1]["partial_warps"] > 0
          and b1[-1]["live_warps_with_dead_lanes"][1] > 0,
          "B1 (e) has no partial edge warp or no dead lane at bounce 1")
    b1.append(compare_frame("g_windows_45x21", field, make_camera(
        (0.0, 0.0, 0.5), 45, 21, 1.3, 0.7, device=dev), cfg3)[0])
    check(b1[-1]["partial_warps"] > 0
          and b1[-1]["live_warps_with_dead_lanes"][1] > 0,
          "B1 (g) has no partial edge warp or no dead lane at bounce 1")

    # ---- 3. B2 against its plain version ------------------------------------
    # (a) the main path's wavefront: the headline camera's rays
    org, dir = pixel_rays(head_cam)
    rep, *_, head_rec2 = compare_rays_once("a_headline", head, cfg_head, org,
                                           dir)
    b2 = [rep]
    check(rep["spheres_tested"][0] < rep["warps"] * head.n_spheres,
          "B2 (a): the headline's bounce-0 warps culled no sphere")
    b2 += compare_rays("b_config1_glass_tri", glass, cam256, cfg3)
    b2 += compare_rays("c_rough_spp4", rough, cam256, cfg_rough)
    b2 += compare_rays("d_near_miss_600", field, cam512, cfg2)
    edge, e_org, e_dir = box_edge_case(dev)
    rep, _, k_st, _ = compare_rays_once("f_box_edge_tie", edge, cfg3, e_org,
                                        e_dir)
    check(k_st.tolist() == [1, 3], f"B2 box-edge tie: {k_st.tolist()}")
    b2.append(rep)

    # ---- 4. B3 against its plain version -----------------------------------
    cfg_rep = RenderConfig(refmax=2, backend=HitBackend.PALLAS)
    head_b0, head_b1 = scalar_inputs(head, cfg_rep, org, dir)
    b3 = [compare_scalar("a_headline_bounce0", head, *head_b0)]
    b3.append(compare_scalar("a_headline_bounce1", head, *head_b1))
    o256, d256 = pixel_rays(cam256)
    o_r, d_r = random_rays(3001, seed=5, device=dev)
    b3.append(compare_scalar("b_config1_glass_tri", glass,
                             torch.cat([o256, o_r]), torch.cat([d256, d_r])))
    o512, d512 = pixel_rays(cam512)
    b3.append(compare_scalar("c_near_miss_384", near_miss_field(384,
                                                                device=dev),
                             o512, d512))
    check(b3[0]["spheres_tested"] < b3[0]["warps"] * head.n_spheres,
          "B3 (a): the headline's bounce-0 warps culled no sphere")

    # ---- 5. B4 against its plain version -----------------------------------
    dense = (nh.nearest_hit_pallas, nh.nearest_hit_pallas_plain)
    c3 = config3_scene(device=dev)
    c3_cam = config3_camera(dev)
    org3, dir3 = pixel_rays(c3_cam)
    b4 = [compare_dense("a_config3_bounce0", c3, org3, dir3)[0]]
    b4.append(compare_dense("b_near_miss_600", field, o512, d512)[0])
    b4.append(compare_dense("c_config3_n_live", c3, org3, dir3,
                            n_live=org3.shape[0] // 2 + 77)[0])
    empty = SceneBuilder().build(dev)
    before = dict(nh.LAUNCHES)
    b4.append(compare_hits("B4", "d_empty_scene", empty, o_r, d_r,
                           *dense)[0])
    check(nh.LAUNCHES == before, "B4 launched on an empty scene")
    b4.append(compare_dense("e_box_edge", edge, e_org, e_dir)[0])
    tri_f, tri_o, tri_d = tri_edge_field(device=dev)
    b4.append(compare_dense("f_triangle_edges_vertices", tri_f, tri_o,
                            tri_d)[0])
    check(b4[-1]["hits"] > 0.5 * tri_o.shape[0], "B4 (f): too few hits")
    tie_f, tie_o, tie_d, tie_first = split_tie_field(device=dev)
    rep, (_, tie_pid) = compare_dense("i_ties_across_a_split", tie_f, tie_o,
                                      tie_d)
    b4.append(rep)
    check(rep["splits"] == 2 and bool((tie_pid == tie_first).any())
          and not bool((tie_pid == tie_first + 1).any()),
          f"B4 (i): the ties did not cross a split to the lower pid: {rep}")

    # ---- 6. B5 against its plain version -----------------------------------
    pid_head = record_paths(head, cfg_rep, org, dir)            # B3
    n_head = org.shape[0]
    target = torch.as_tensor(np.random.default_rng(11).uniform(
        0.0, 1.0, (n_head, 3)).astype(np.float32), device=dev)
    tabs_head = rg.scene_tables(head)
    g_head = 2.0 * (rg.launch_fwd(tabs_head, org, dir, pid_head, 2, 1.0)
                    - target) / n_head
    b5 = [compare_replay("a_headline", head, org, dir, pid_head, 2,
                         g_head)[0]]
    # (e) the headline's all-ground pixels, packed: every warp's lanes share
    # one winner at bounce 0 (the ground is diffuse: no bounce 1)
    ground = torch.nonzero(pid_head[:, 0] == head.n_spheres).flatten()
    ground = ground[:ground.numel() // 32 * 32]
    b5.append(compare_replay("e_headline_uniform_ground", head, org[ground],
                             dir[ground], pid_head[ground], 2,
                             g_head[ground])[0])
    check(ground.numel() >= 1 << 19 and bool(
        (pid_head[ground, 1] < 0).all()), "B5 (e): too few ground pixels")
    rsc = replay_scene(device=dev)
    o64, d64 = pixel_rays(make_camera((0.0, 0.0, 0.5), 64, 64, np.pi / 2,
                                      np.pi / 2, device=dev))
    for refmax in (3, 4):
        pid = record_paths(rsc, RenderConfig(refmax=refmax,
                                             backend=HitBackend.PALLAS),
                           o64, d64)
        b5.append(compare_replay(f"b_replay_scene_refmax{refmax}", rsc, o64,
                                 d64, pid, refmax)[0])
    lfield = listed_field(device=dev)
    check(rg.supports_listed(lfield, cfg_rep)
          and not rg.supports(lfield, cfg_rep), "listed field not listed")
    before = dict(nh.LAUNCHES)
    pid = record_paths(lfield, cfg_rep, o512, d512)
    check(nh.LAUNCHES["dense"] - before["dense"] == cfg_rep.refmax,
          "the listed field was not recorded by B4")
    b5.append(compare_replay("c_listed_field_600", lfield, o512, d512, pid,
                             2)[0])
    esc, (o_in, d_in), (o_out, d_out) = replay_edge_rays(dev)
    cfg_e = RenderConfig(refmax=3, backend=HitBackend.PALLAS)
    pid_in = record_paths(esc, cfg_e, o_in, d_in)
    pid_out = record_paths(esc, cfg_e, o_out, d_out)
    exhausted = (pid_in >= 0).all(dim=1)
    check(int(exhausted.sum()) >= 0.9 * o_in.shape[0]
          and bool((pid_out < 0).all()),
          "edge rays: too few exhausted / not all missing")
    rep, col = compare_replay("d_exhausted", esc, o_in, d_in, pid_in, 3)
    check(bool((col[exhausted] == 0).all()), "exhausted rays are not black")
    b5.append(rep)
    rep, col = compare_replay("d_all_miss", esc, o_out, d_out, pid_out, 3)
    check(bool((col == esc.textures.solid_rgb[esc.sky_tex]).all()),
          "missing rays do not see the sky")
    b5.append(rep)
    # B5's gradients against autograd through the search path (B3), view (a)
    l_k, g_k = replay_grads(head, cfg_rep, org, dir, target, pid_head)
    l_s, g_s = replay_grads(head, cfg_rep, org, dir, target)
    torch.cuda.synchronize()
    leaves = float_leaf_names(head) + ["org", "dir"]
    ratios = {n: float(((a - b).abs() / (2e-6 + 2e-4 * b.abs())).max())
              for n, a, b in zip(leaves, g_k, g_s) if b.numel()}
    worst = max(ratios.values())
    emit(phase="B5", case="a_headline_vs_search_autograd", loss_kernel=l_k,
         loss_search=l_s, worst_err_over_tol=worst,
         worst_leaf=max(ratios, key=ratios.get))
    check(worst <= 1.0 and abs(l_k - l_s) <= 1e-5 * abs(l_s),
          f"B5 grads differ from the search path's: {worst}")
    b5.append(replay_1m_phase(dev))

    # ---- 6b. B7 against its plain version ----------------------------------
    b7 = [compare_tiled("a_one_tile_128x32", head, make_camera(
        (0.0, 0.0, 0.5), 128, 32, np.pi / 2, np.pi / 8, device=dev))[0]]
    b7.append(compare_tiled("b_edge_tiles_151x37", field, make_camera(
        (0.05, -0.1, 0.45), 151, 37, 1.45, 1.2, device=dev))[0])
    b7.append(compare_tiled("c_image_uv_config3", c3, make_camera(
        (0.05, -0.1, 0.45), 131, 67, 1.45, 1.2, device=dev))[0])
    b7.append(compare_tiled("d_rough_glass_normals", rough, make_camera(
        (0.0, 0.0, 0.5), 200, 90, 1.4, 0.9, device=dev))[0])
    check(b7[2]["want_uv"] and b7[3]["want_normal"] and b7[3]["has_trans"],
          "B7 cases miss the uv or normal planes")

    # ---- 6c. B6 against its plain version and B4 ---------------------------
    sw_field = rtl._sweep_perm(field)
    work512 = torch.ones(o512.shape[0], dtype=torch.bool, device=dev)
    ids_field = rtl._block_tile_select(o512, d512, work512, sw_field[1][1])
    b6 = [compare_listed("a_near_miss_600", sw_field[0], o512, d512,
                         tile_ids=ids_field)[0]]
    sw_c3 = rtl._sweep_perm(c3)
    work3 = torch.ones(org3.shape[0], dtype=torch.bool, device=dev)
    b6.append(compare_listed("b_config3_mesh_triangles", sw_c3[0], org3, dir3,
                             tri_tile_ids=rtl._block_tile_select(
                                 org3, dir3, work3, sw_c3[2][1]),
                             tri_fan=sw_c3[2][2])[0])
    max_tiles = rtl.LISTED_MAX_TILES
    rtl.LISTED_MAX_TILES = 2
    sw_fan = rtl._sweep_perm(field)
    rtl.LISTED_MAX_TILES = max_tiles
    check(sw_fan[1][2] > 1, "no supertile fan")
    b6.append(compare_listed("c_fan_near_miss_600", sw_fan[0], o512, d512,
                             tile_ids=rtl._block_tile_select(
                                 o512, d512, work512, sw_fan[1][1]),
                             sph_fan=sw_fan[1][2])[0])
    n_half = o512.shape[0] // 2 + 77
    b6.append(compare_listed("d_n_live", sw_field[0], o512, d512,
                             n_live=n_half, tile_ids=ids_field)[0])

    # ---- 6d. B7-wave against its plain version -----------------------------
    b7w = []
    cols = camera_wavefront(make_camera((0.0, 0.0, 0.5), 128, 64, np.pi / 2,
                                        np.pi / 4, device=dev))
    b7w.append(compare_wave("b_rowwise_near_miss_600", field, cols,
                            *packet_tables(field, cols, 8, c_max=256))[0])
    b7w.append(compare_wave("c_truncated_grid", lfield, cols,
                            *packet_tables(lfield, cols, 8, c_sel=64))[0])
    check(b7w[-1]["finite_t_safe_packets"] > 0 and b7w[-1]["unresolved"] > 0,
          "B7-wave (c) left no ray unresolved")
    cols = bounce1_wavefront(rough, make_camera((0.0, 0.0, 0.5), 200, 90,
                                                1.4, 0.9, device=dev))
    b7w.append(compare_wave("d_rough_glass_normals", rough, cols,
                            *packet_tables(rough, cols, 8, c_sel=4096))[0])
    cols = bounce1_wavefront(c3, make_camera((0.05, -0.1, 0.45), 131, 67,
                                             1.45, 1.2, device=dev))
    b7w.append(compare_wave("e_image_uv_config3", c3, cols,
                            *packet_tables(c3, cols, 8, c_sel=4096))[0])
    cols = bounce1_wavefront(field, cam512)
    b7w.append(compare_wave("f_wave_sub_1", field, cols,
                            *packet_tables(field, cols, 1, c_sel=256),
                            wave_sub=1)[0])
    check(b7w[2]["want_normal"] and b7w[2]["has_trans"] and b7w[3]["want_uv"]
          and b7w[0]["static_bases"] == [] and b7w[1]["static_bases"],
          "B7-wave cases miss the normal or uv planes or a table layout")

    # ---- 6e. B8 against its plain version and B4 ---------------------------
    tb_field = sw_field[1][1]
    b8 = [compare_culled("a_near_miss_600", sw_field[0], o512, d512,
                         tb_field)[0]]
    o_in, d_in = random_rays(4096, seed=9, device=dev)
    b8.append(compare_culled("c_incoherent_blocks", sw_field[0], o_in,
                             d_in / d_in.norm(dim=1, keepdim=True),
                             tb_field)[0])
    check(b8[0]["tiles_streamed"] < b8[0]["sphere_tiles"] * (
        o512.shape[0] // 32), "B8 (a) culled no tile")
    check(b8[1]["warps_keeping_all"] == b8[1]["live_warps"],
          "B8 (c): an incoherent warp culled a tile")

    # ---- 7. the main path -----------------------------------------------------
    reset_launches()
    t0 = time.perf_counter()
    hdr = rt.render_hdr(head, head_cam, cfg_head)
    buf = exposure.accumulate(
        exposure.new_exposure_buffer(head_cam.h, head_cam.w, device=dev), hdr)
    ldr = view.draw(buf, ToneMapConfig(kind=ToneMapperKind.STDDEV_AROUND_MEAN))
    with tempfile.TemporaryDirectory() as tmp:
        png = screen.write_png(pathlib.Path(tmp) / "headline.png", ldr)
        png_bytes = png.stat().st_size if png.exists() else 0
    wave = render_rays(head, cfg_head, org, dir).reshape(hdr.shape)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = launches_now()
    frame_vs_wave = ~torch.isclose(wave, hdr, rtol=1e-4, atol=1e-5).all(-1)
    emit(phase="main", seconds=main_s, launches=launches,
         shape=list(hdr.shape), device=str(hdr.device),
         finite=bool(torch.isfinite(hdr).all()), png_bytes=png_bytes,
         ldr_min=float(ldr.min()), ldr_max=float(ldr.max()),
         same_as_b1_case_a=bool(torch.equal(hdr, head_img)),
         frame_vs_wavefront_pixels_off=int(frame_vs_wave.sum()))
    check(launches["frame"] >= 1, "the main path did not launch B1")
    check(launches["rays"] >= 1, "the main path did not launch B2")
    check(hdr.device.type == "cuda", "the HDR image is not on the GPU")
    check(tuple(hdr.shape) == (HEADLINE_H, HEADLINE_W, 3), "bad image shape")
    check(bool(torch.isfinite(hdr).all()), "non-finite HDR values")
    check(png_bytes > 0, "no PNG written")
    check(float(ldr.min()) >= 0.0 and float(ldr.max()) <= 1.0,
          "tone-mapped image outside [0, 1]")
    check(torch.equal(hdr, head_img), "render_hdr differs from the B1 run "
          "of case (a)")
    check(int(frame_vs_wave.sum()) <= parity.MAX_FLIP_FRAC * hdr[..., 0].numel(),
          "frame and wavefront kernels disagree beyond ULP noise")
    # the frame's host work: one launch, no wait for the device, no copy
    # from pageable host memory (the tables stay on the scene)
    frame_trace = host_trace(lambda: rt.render_hdr(head, head_cam, cfg_head))
    emit(phase="main", case="render_hdr_fused_host_trace", **frame_trace)
    check(frame_trace["stream_syncs"] == 0 and frame_trace["copies"] == 0
          and frame_trace["pageable_copies"] == 0,
          f"render_hdr FUSED waits for the device or copies from the host: "
          f"{frame_trace}")

    # ---- 8. main-PALLAS: config 3 through B4, the headline through B3 -------
    cfg_c3 = RenderConfig(refmax=3, backend=HitBackend.PALLAS)
    reset_launches()
    t0 = time.perf_counter()
    hdr3 = rt.render_hdr(c3, c3_cam, cfg_c3)
    buf3 = exposure.accumulate(
        exposure.new_exposure_buffer(C3_H, C3_W, device=dev), hdr3)
    ldr3 = view.draw(buf3, ToneMapConfig(kind=ToneMapperKind.STDDEV_AROUND_MEAN))
    with tempfile.TemporaryDirectory() as tmp:
        png = screen.write_png(pathlib.Path(tmp) / "config3.png", ldr3)
        png3_bytes = png.stat().st_size if png.exists() else 0
    torch.cuda.synchronize()
    c3_s = time.perf_counter() - t0
    c3_launches = launches_now()
    cfg_head_p = RenderConfig(refmax=cfg_head.refmax,
                              backend=HitBackend.PALLAS)
    reset_launches()
    wave_p = render_rays(head, cfg_head_p, org, dir).reshape(hdr.shape)
    torch.cuda.synchronize()
    head_launches = launches_now()
    # the same path with the plain versions on the CPU, at a small size and
    # an off-grid camera (no equirect texel boundary on a pixel center)
    small = (0.0, 0.0, 0.5), 40, 32, 1.5, 1.4
    small_dev = rt.render_hdr(c3, make_camera(*small, device=dev), cfg_c3)
    c3_cpu, small_cam = c3.to("cpu"), make_camera(*small, device="cpu")
    small_cpu = rt.render_hdr(c3_cpu, small_cam, cfg_c3)
    zeros = torch.zeros(small_cpu.shape[:2], dtype=torch.int32)
    small_rep = parity.compare(
        small_dev.cpu(), zeros, small_cpu, zeros,
        prove_rounding=parity.grazing_prover(c3_cpu, *pixel_rays(small_cam)))
    pallas_vs_fused = ~torch.isclose(wave_p, hdr, rtol=1e-4, atol=1e-5).all(-1)
    emit(phase="main-PALLAS", seconds=c3_s, launches=c3_launches,
         shape=list(hdr3.shape), device=str(hdr3.device),
         finite=bool(torch.isfinite(hdr3).all()), png_bytes=png3_bytes,
         ldr_min=float(ldr3.min()), ldr_max=float(ldr3.max()),
         refmax=cfg_c3.refmax, prims=c3.n_prims,
         small_vs_cpu_plain=small_rep,
         headline_render_rays_launches=head_launches,
         headline_pallas_vs_fused_pixels_off=int(pallas_vs_fused.sum()))
    check(c3_launches["dense"] == cfg_c3.refmax
          and c3_launches["scalar"] == 0,
          f"config 3 PALLAS did not search with B4 once a bounce: "
          f"{c3_launches}")
    check(head_launches["scalar"] == cfg_head_p.refmax
          and head_launches["dense"] == 0,
          f"headline render_rays PALLAS did not search with B3 once a "
          f"bounce: {head_launches}")
    check(hdr3.device.type == "cuda", "the config-3 image is not on the GPU")
    check(tuple(hdr3.shape) == (C3_H, C3_W, 3), "bad config-3 image shape")
    check(bool(torch.isfinite(hdr3).all()), "non-finite config-3 HDR values")
    check(png3_bytes > 0, "no config-3 PNG written")
    check(float(ldr3.min()) >= 0.0 and float(ldr3.max()) <= 1.0,
          "config-3 tone-mapped image outside [0, 1]")
    check(small_rep["ok"], f"config-3 PALLAS on the card differs from the "
          f"plain versions on the CPU: {small_rep}")
    check(int(pallas_vs_fused.sum())
          <= parity.MAX_FLIP_FRAC * hdr[..., 0].numel(),
          "headline PALLAS and FUSED renders disagree beyond ULP noise")

    # ---- 9. main-fit: config 5's 8-view fit, B3 records, B5 differentiates -
    cams = fit_cameras(HEADLINE_W, HEADLINE_H, device=dev)
    cfg_fused = RenderConfig(refmax=2, backend=HitBackend.FUSED)
    targets = torch.stack([rt.render_hdr(head, c, cfg_fused).reshape(-1, 3)
                           for c in cams])
    start = perturbed(head)
    fc = FitConfig(steps=4, lr=1e-2, replay_every=2)
    # the first torch.optim optimizer of a process imports torch._dynamo
    # (seconds): a one-time set-up cost, taken here outside the fit's time
    t0 = time.perf_counter()
    torch.optim.Adam([torch.zeros(1, device=dev, requires_grad=True)])
    emit(phase="main-fit", case="first_optimizer_setup",
         seconds=time.perf_counter() - t0)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = fit(start, cfg_rep, cams, targets, fc)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = launches_now()
    recordings = -(-fc.steps // fc.replay_every)
    tex = torch.unique(head.prim_texture[:head.n_spheres].long())

    def rgb_err(sc):
        return float((sc.textures.solid_rgb[tex]
                      - head.textures.solid_rgb[tex]).abs().mean())

    emit(phase="main-fit", seconds=fit_s, seconds_per_step=fit_s / fc.steps,
         views=len(cams), w=cams[0].w, h=cams[0].h, refmax=cfg_rep.refmax,
         prims=head.n_prims, steps=fc.steps, replay_every=fc.replay_every,
         losses=res.losses, launches=fit_launches,
         sphere_rgb_err_start=rgb_err(start),
         sphere_rgb_err_end=rgb_err(res.scene))
    check(fit_launches["scalar"] == recordings * len(cams) * cfg_rep.refmax
          and fit_launches["dense"] == 0,
          f"the fit did not record with B3 once a bounce: {fit_launches}")
    check(fit_launches["fwd"] == fc.steps * len(cams)
          and fit_launches["bwd"] == fc.steps * len(cams),
          f"the fit did not differentiate through B5: {fit_launches}")
    check(fit_launches["frame"] == 0 and fit_launches["rays"] == 0,
          "the fit launched a fused kernel")
    check(all(np.isfinite(res.losses)) and res.losses[3] < res.losses[0],
          f"fit losses not finite and falling: {res.losses}")
    check(res.scene.device.type == "cuda"
          and all(bool(torch.isfinite(p).all())
                  for p in float_partition(res.scene)[0]),
          "the fitted scene is not finite on the GPU")
    # one camera-pose step through B5's ray cotangents
    true_cam = make_camera((0.0, 0.0, 0.5), 256, 256, np.pi / 2, np.pi / 2,
                           device=dev)
    cam_tgt = rt.render_hdr(head, true_cam, cfg_fused).reshape(1, -1, 3)
    start_cam = rotate_h(move(true_cam, (0.05, 0.1, -0.05)), 0.03)
    n_scene = len(float_partition(head)[0])
    before = dict(rg.LAUNCHES)
    res_c = fit(head, cfg_rep, [start_cam], cam_tgt,
                FitConfig(steps=1, lr=1e-2, fit_cameras=True,
                          replay_every=1),
                trainable=lambda i, p: i >= n_scene)
    c = res_c.cameras[0]
    tri = torch.stack([c.front, c.left, c.up])
    orth = float((tri @ tri.T - torch.eye(3, device=dev)).abs().max())
    moved = float((c.pos - start_cam.pos).abs().max())
    emit(phase="main-fit", case="fit_cameras_256", losses=res_c.losses,
         triad_orthonormal_err=orth, pos_moved=moved,
         b5_bwd_launches=rg.LAUNCHES["bwd"] - before["bwd"])
    check(np.isfinite(res_c.losses[0]) and orth <= 1e-5 and moved > 0.0
          and rg.LAUNCHES["bwd"] - before["bwd"] == 1,
          "the fit_cameras step failed")
    # the same small fit on the card and on the CPU plain versions
    small_cams = fit_cameras(64, 48, n=2, device=dev)
    small_tgt = torch.stack([rt.render_hdr(head, c, cfg_fused).reshape(-1, 3)
                             for c in small_cams])
    fc_small = FitConfig(steps=3, lr=1e-2, replay_every=2)
    r_dev = fit(start, cfg_rep, small_cams, small_tgt, fc_small)
    r_cpu = fit(start.to("cpu"), cfg_rep, fit_cameras(64, 48, n=2,
                                                     device="cpu"),
                small_tgt.cpu(), fc_small)
    emit(phase="main-fit", case="small_card_vs_cpu_plain",
         losses_card=r_dev.losses, losses_cpu=r_cpu.losses)
    check(np.allclose(r_dev.losses, r_cpu.losses, rtol=1e-4, atol=0.0),
          "the fit on the card differs from the CPU plain versions")

    # ---- 9b. main-TILED: BASELINE config 4 through B7 and B6 ---------------
    t0 = time.perf_counter()
    c4, c4_cam = config4_scene(device=dev), config4_camera(dev)
    c4_build_s = time.perf_counter() - t0
    cfg_c4 = RenderConfig(refmax=2, backend=HitBackend.TILED)
    searches = []       # each sweep round's search inputs, kept for 6c (e)
    real_search = nh.nearest_hit_pallas

    def keep_inputs(scene_s, org, dir, **kw):
        searches.append((scene_s, org, dir, kw))
        return real_search(scene_s, org, dir, **kw)

    nh.nearest_hit_pallas = keep_inputs
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    hdr4 = rt.render_hdr(c4, c4_cam, cfg_c4)
    buf4 = exposure.accumulate(
        exposure.new_exposure_buffer(C4_H, C4_W, device=dev), hdr4)
    ldr4 = view.draw(buf4, ToneMapConfig(kind=ToneMapperKind.STDDEV_AROUND_MEAN))
    with tempfile.TemporaryDirectory() as tmp:
        png = screen.write_png(pathlib.Path(tmp) / "config4.png", ldr4)
        png4_bytes = png.stat().st_size if png.exists() else 0
    torch.cuda.synchronize()
    c4_s = time.perf_counter() - t0
    c4_launches = launches_now()
    nh.nearest_hit_pallas = real_search
    t0 = time.perf_counter()
    tables4 = rtl.frame_tables(c4, c4_cam)
    torch.cuda.synchronize()
    tables4_s = time.perf_counter() - t0
    img4, diag4, rec4 = rtl.render_frame_tiled(c4, cfg_c4, c4_cam,
                                               tables=tables4, with_diag=True,
                                               with_record=True)
    torch.cuda.synchronize()
    c_max4 = tables4[2]
    emit(phase="main-TILED", seconds=c4_s, scene_build_seconds=c4_build_s,
         frame_tables_host_seconds=tables4_s, launches=c4_launches,
         shape=list(hdr4.shape), device=str(hdr4.device), prims=c4.n_prims,
         refmax=cfg_c4.refmax, tiles=tables4[1].shape[0], c_max=c_max4,
         table_bytes=tables4[0].numel() * 4,
         unresolved=int(diag4["unresolved"]), rounds=diag4["rounds"],
         finite=bool(torch.isfinite(hdr4).all()), png_bytes=png4_bytes,
         ldr_min=float(ldr4.min()), ldr_max=float(ldr4.max()),
         same_as_render_frame_tiled=bool(torch.equal(img4, hdr4)))
    check(c4_launches["tiled_frame"] == 1, f"config 4 TILED did not launch "
          f"B7 exactly once: {c4_launches}")
    check(c4_launches["listed"] >= 1 and c4_launches["dense"] == 0
          and c4_launches["scalar"] == 0, f"config 4 TILED did not search "
          f"its sweep rounds with B6 alone: {c4_launches}")
    check(len(searches) == c4_launches["listed"] == diag4["rounds"],
          "config 4: sweep rounds and B6 launches disagree")
    check(int(diag4["unresolved"]) == 0, "config 4 left rays unresolved")
    check(tuple(hdr4.shape) == (C4_H, C4_W, 3) and hdr4.device.type == "cuda",
          "bad config-4 image")
    check(bool(torch.isfinite(hdr4).all()), "non-finite config-4 HDR values")
    check(torch.equal(img4, hdr4), "render_hdr and render_frame_tiled differ")
    check(png4_bytes > 0 and float(ldr4.min()) >= 0.0
          and float(ldr4.max()) <= 1.0, "bad config-4 PNG")

    # B7 at config 4's full frame, B6 on its first sweep round's slice
    rep, k4, _ = compare_tiled("e_config4_full", c4, c4_cam, tables4)
    b7.append(rep)
    scene_s, org_s, dir_s, kw_s = searches[0]
    n_live4 = int(kw_s.pop("n_live"))
    rep, li4, slots4, bslots4, t_s = compare_listed(
        "e_config4_first_sweep_round", scene_s, org_s, dir_s,
        n_live=n_live4, **kw_s)
    b6.append(rep)

    # the same frame through PALLAS (B4 over all 100k prims a bounce), under
    # the parity rule: flips proven on the TILED side's rays per bounce;
    # rounding proven where the first hit is a sphere whose t is not
    # determined in float32 on either side (TILED's bounce 0 takes the
    # factored quadratic, the PALLAS loop recomputes the hit from o - c)
    cfg_c4p = RenderConfig(refmax=2, backend=HitBackend.PALLAS)
    hdr4_p = rt.render_hdr(c4, c4_cam, cfg_c4p)
    org4, dir4 = pixel_rays(c4_cam)
    pid4_p = record_paths(c4, cfg_c4p, org4, dir4)
    crop = (lambda x: x[:C4_H, :C4_W].reshape(-1))
    rec4_t = {"pid": rec4.T.contiguous(), "org": torch.stack([org4, torch.stack(
        [crop(k4[c]) for c in ("ox", "oy", "oz")], -1)]),
        "dir": torch.stack([dir4, torch.stack(
            [crop(k4[c]) for c in ("dx", "dy", "dz")], -1)])}
    graze = [parity.grazing_prover(c4, org4, dir4),
             parity.grazing_prover(c4, org4, dir4, pid=rec4[:, 0])]
    zeros4 = torch.zeros((C4_H, C4_W), dtype=torch.int32, device=dev)
    vs_pallas = parity.compare(
        hdr4, zeros4, hdr4_p, zeros4,
        prove=parity.flip_prover(c4, rec4_t, pid4_p.T),
        prove_rounding=lambda idx: graze[0](idx) | graze[1](idx),
        max_rounding_frac=C4_MAX_ROUNDING_FRAC)
    winners_equal = float((rec4 == pid4_p).all(dim=1).float().mean())
    emit(phase="main-TILED", case="vs_PALLAS", winners_equal_frac=winners_equal,
         rounding_frac=vs_pallas["rounding"] / vs_pallas["pixels"],
         max_rounding_frac=C4_MAX_ROUNDING_FRAC, **vs_pallas)
    check(vs_pallas["ok"], f"config 4 TILED differs from PALLAS: {vs_pallas}")

    # ---- 9c. main-packet: config 4 and 1.1M prims through B7-wave ----------
    t0 = time.perf_counter()
    cand.build_cell_grid(c4)
    grid4_s = time.perf_counter() - t0
    waves = []          # every packet round's wavefront, kept for 6d (a)
    rescues = []        # every rescue round's search (B4), kept for 5 (g)
    real_wave = tt.wave_bounce

    def keep_wave(scene, cols, tab, cnts, c_max, **kw):
        waves.append((scene, [c.clone() for c in cols], tab, cnts, c_max, kw))
        return real_wave(scene, cols, tab, cnts, c_max, **kw)

    def keep_rescue(scene, org, dir, n_live=None, **kw):
        check(not kw, f"a packet-mode rescue round searched with {kw}")
        rescues.append((scene, org, dir, n_live.clone()))
        return real_search(scene, org, dir, n_live=n_live)

    def packet_frame(scene, cam, tables):
        """The main path (render_hdr TILED, counters reset first), then the
        same frame with its diagnostics, recording and wavefronts."""
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        hdr = rt.render_hdr(scene, cam, cfg_c4, tables=tables)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = launches_now()
        waves.clear()
        rescues.clear()
        tt.wave_bounce, nh.nearest_hit_pallas = keep_wave, keep_rescue
        try:
            img, diag, rec = rtl.render_frame_tiled(
                scene, cfg_c4, cam, tables=tables, with_diag=True,
                with_record=True)
            torch.cuda.synchronize()
        finally:
            tt.wave_bounce, nh.nearest_hit_pallas = real_wave, real_search
        check(launched["tiled_frame"] == 1 and launched["tiled_wave"] >= 1
              and launched["listed"] == 0 and launched["culled"] == 0
              and launched["scalar"] == 0, f"packet mode did not run B7 "
              f"once and B7-wave: {launched}")
        check(launched["dense"] == diag["rounds"] == len(rescues),
              "packet mode: rescue rounds and B4 launches disagree")
        check(launched["tiled_wave"] == len(waves), "packet mode: B7-wave "
              "launches differ between two runs of the frame")
        check(int(diag["unresolved"]) == 0, "packet mode left rays "
              "unresolved")
        check(torch.equal(img, hdr) and bool(torch.isfinite(hdr).all())
              and tuple(hdr.shape) == (cam.h, cam.w, 3),
              "bad packet-mode frame")
        return hdr, rec, diag, launched, secs, list(waves), list(rescues)

    rtl.SWEEP_MAX_PRIMS = 0
    try:
        (hdr_pa, rec_pa, diag_pa, launches_pa, pa_s, waves_a,
         rescues_a) = packet_frame(c4, c4_cam, tables4)
    finally:
        rtl.SWEEP_MAX_PRIMS = SWEEP_MAX_PRIMS
    # (a) against the sweep frame of 9b at the reference's packet tolerance;
    # every pixel whose winners differ is a proven flip or a grazing sphere
    # hit whose t float32 leaves undetermined (B7-wave takes the unit-d
    # quadratic, B6 the a-weighted one)
    org1 = torch.stack([crop(k4[c]) for c in ("ox", "oy", "oz")], -1)
    dir1 = torch.stack([crop(k4[c]) for c in ("dx", "dy", "dz")], -1)
    rec_pa_t = {"pid": rec_pa.T.contiguous(), "org": torch.stack([org4,
                                                                  org1]),
                "dir": torch.stack([dir4, dir1])}
    flips_pa = parity.flip_prover(c4, rec_pa_t, rec4.T)
    graze_pa = [parity.grazing_prover(c4, org1, dir1),
                parity.grazing_prover(c4, org1, dir1, pid=rec_pa[:, 1]),
                parity.grazing_prover(c4, org1, dir1, pid=rec4[:, 1])]
    diff_win = torch.nonzero((rec_pa != rec4).any(dim=1)).flatten()
    proven = (flips_pa(diff_win) | graze_pa[0](diff_win)
              | graze_pa[1](diff_win) | graze_pa[2](diff_win))
    off_pa = ~torch.isclose(hdr_pa, hdr4, rtol=1e-4, atol=1e-5).all(-1)
    rep_pa = dict(w=C4_W, h=C4_H, prims=c4.n_prims, seconds=pa_s,
                  launches=launches_pa, packet_rounds=diag_pa["packet_rounds"],
                  rescue_rounds=diag_pa["rounds"],
                  unresolved=int(diag_pa["unresolved"]),
                  grid_c_max=tables4[3].c_max,
                  grid_host_seconds=grid4_s,
                  winners_differ=int(diff_win.numel()),
                  winners_proven=int(proven.sum()),
                  pixels_off_packet_tol=int(off_pa.sum()),
                  pixels_off_frac=float(off_pa.float().mean()))
    emit(phase="main-packet", case="a_config4_vs_sweep", **rep_pa)
    check(bool(proven.all()), f"config 4 packet vs sweep: unproven winner "
          f"differences: {rep_pa}")
    check(rep_pa["pixels_off_frac"] < 0.002, f"config 4 packet frame beyond "
          f"the packet tolerance of the sweep frame: {rep_pa}")

    # (b) 1,099,998 spheres in the same slab: packet mode by the default
    # threshold, held against PALLAS (B4) on 65,536 sampled pixels
    t0 = time.perf_counter()
    c4b = config4_scene(C4B_PRIMS, device=dev)
    c4b_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tables_b = rtl.frame_tables(c4b, c4_cam)
    torch.cuda.synchronize()
    tables_b_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cand.build_cell_grid(c4b)
    grid_b_s = time.perf_counter() - t0
    check(c4b.n_prims > rtl.SWEEP_MAX_PRIMS, "case (b) is not above the "
          "sweep threshold")
    (hdr_pb, rec_pb, diag_pb, launches_pb, pb_s, waves_b,
     rescues_b) = packet_frame(c4b, c4_cam, tables_b)
    rng = np.random.default_rng(17)
    idx = torch.as_tensor(np.sort(rng.choice(C4_W * C4_H, C4B_SAMPLES,
                                             replace=False)), device=dev)
    kb = tt.frame_bounce0(c4b, c4_cam, *tables_b[:3])
    org_b, dir_b = org4[idx], dir4[idx]
    org_b1 = torch.stack([crop(kb[c])[idx] for c in ("ox", "oy", "oz")], -1)
    dir_b1 = torch.stack([crop(kb[c])[idx] for c in ("dx", "dy", "dz")], -1)
    col_p = render_rays(c4b, cfg_c4p, org_b, dir_b)
    pid_bp = record_paths(c4b, cfg_c4p, org_b, dir_b)
    rec_b = rec_pb[idx]
    rec_b_t = {"pid": rec_b.T.contiguous(), "org": torch.stack([org_b,
                                                                org_b1]),
               "dir": torch.stack([dir_b, dir_b1])}
    graze_b = [parity.grazing_prover(c4b, org_b, dir_b),
               parity.grazing_prover(c4b, org_b, dir_b, pid=rec_b[:, 0])]
    zeros_b = torch.zeros(C4B_SAMPLES, dtype=torch.int32, device=dev)
    vs_pallas_b = parity.compare(
        hdr_pb.reshape(-1, 3)[idx], zeros_b, col_p, zeros_b,
        prove=parity.flip_prover(c4b, rec_b_t, pid_bp.T),
        prove_rounding=lambda i: graze_b[0](i) | graze_b[1](i),
        max_rounding_frac=C4B_MAX_ROUNDING_FRAC)
    emit(phase="main-packet", case="b_1.1M_vs_PALLAS_sampled",
         w=C4_W, h=C4_H, prims=c4b.n_prims, seconds=pb_s,
         scene_build_seconds=c4b_build_s,
         frame_tables_host_seconds=tables_b_s,
         grid_host_seconds=grid_b_s, frame_c_max=tables_b[2],
         table_bytes=tables_b[0].numel() * 4, grid_c_max=tables_b[3].c_max,
         launches=launches_pb, packet_rounds=diag_pb["packet_rounds"],
         rescue_rounds=diag_pb["rounds"],
         unresolved=int(diag_pb["unresolved"]), samples=C4B_SAMPLES,
         max_rounding_frac=C4B_MAX_ROUNDING_FRAC,
         winners_equal_frac=float((rec_b == pid_bp).all(dim=1).float()
                                  .mean()), **vs_pallas_b)
    check(vs_pallas_b["ok"], f"1.1M packet frame differs from PALLAS on the "
          f"sampled pixels: {vs_pallas_b}")

    # ---- 9d. main-cull: config 4's sweep rounds through B8 -----------------
    culls = []          # each sweep round's search inputs, kept for 6e (b)

    def keep_cull(scene_s, org, dir, **kw):
        culls.append((scene_s, org, dir, kw))
        return real_search(scene_s, org, dir, **kw)

    rtl.SWEEP_LISTED, rtl.SWEEP_CULL = False, True
    nh.nearest_hit_pallas = keep_cull
    try:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        hdr_c = rt.render_hdr(c4, c4_cam, cfg_c4, tables=tables4)
        torch.cuda.synchronize()
        cull_s = time.perf_counter() - t0
        launches_c = launches_now()
        nh.nearest_hit_pallas = real_search
        img_c, diag_c, rec_c = rtl.render_frame_tiled(
            c4, cfg_c4, c4_cam, tables=tables4, with_diag=True,
            with_record=True)
        torch.cuda.synchronize()
    finally:
        nh.nearest_hit_pallas = real_search
        rtl.SWEEP_LISTED, rtl.SWEEP_CULL = True, False
    rec_c_t = {"pid": rec_c.T.contiguous(), "org": torch.stack([org4, org1]),
               "dir": torch.stack([dir4, dir1])}
    vs_sweep = parity.compare(hdr_c, zeros4, hdr4, zeros4,
                              prove=parity.flip_prover(c4, rec_c_t, rec4.T))
    diff_c = torch.nonzero((rec_c != rec4).any(dim=1)).flatten()
    flips_c = parity.flip_prover(c4, rec_c_t, rec4.T)(diff_c)
    emit(phase="main-cull", seconds=cull_s, launches=launches_c,
         rounds=diag_c["rounds"], unresolved=int(diag_c["unresolved"]),
         winners_differ=int(diff_c.numel()),
         winners_proven_flips=int(flips_c.sum()), vs_sweep=vs_sweep)
    check(launches_c["culled"] == diag_c["rounds"] == len(culls) >= 1
          and launches_c["listed"] == 0 and launches_c["dense"] == 0
          and launches_c["tiled_frame"] == 1,
          f"config 4 with SWEEP_CULL did not search with B8: {launches_c}")
    check(int(diag_c["unresolved"]) == 0 and torch.equal(img_c, hdr_c),
          "bad config-4 cull frame")
    check(vs_sweep["ok"] and bool(flips_c.all()),
          f"config 4 through B8 differs from the sweep frame: {vs_sweep}")

    # B7-wave on config 4's first packet round, B8 on its first sweep round
    wave_a0 = waves_a[0]
    rep, k_wa, blk_wa = compare_wave("a_config4_first_packet_round",
                                     *wave_a0[:5], **wave_a0[5])
    b7w.insert(0, rep)
    # B4 on config 4's first and last rescue rounds: 100k spheres, their
    # n_live (the last round's few live rays over a split scan)
    for case, (sc_r, org_r, dir_r, nl_r) in (
            ("g_config4_first_rescue_round", rescues_a[0]),
            ("h_config4_last_rescue_round", rescues_a[-1])):
        b4.append(compare_dense(case, sc_r, org_r, dir_r,
                                n_live=int(nl_r))[0])
    scene_c, org_c, dir_c, kw_c = culls[0]
    n_live_c = int(kw_c["n_live"])
    check(n_live_c < org_c.shape[0], "config 4's sweep slice is all live")
    rep, tiles_c = compare_culled("b_config4_first_sweep_round", scene_c,
                                  org_c, dir_c, kw_c["tile_bounds"], n_live_c)
    b8.insert(1, rep)

    # ---- 9e. work: what each exit rule streams, and what the rays need ---
    tb_c = kw_c["tile_bounds"]
    rules6, rules8 = work_phase(li4, org_s, dir_s, t_s, n_live4, slots4,
                                bslots4, scene_c, org_c, dir_c, tb_c,
                                n_live_c, tiles_c)
    rules7w = wave_work(wave_a0, k_wa, blk_wa)

    # ---- 9f. main-OCTREE: the octree accel and its search kernel ------------
    oct_row = octree_phase(dev, head, c4, c4_cam, hdr4_p, pid4_p, org4,
                           dir4)["row"]

    # ---- 9g, 9h. main-sharded: one NCCL rank, two gloo ranks ---------------
    shard_times = sharded_phase(dev, head, head_cam, c3, c3_cam)
    emit(phase="times", what="sharded paths (9g, 9h): ms by CUDA events "
         "unless host", card=smi, **shard_times)

    # ---- 9i. main-A9: progressive_render FUSED, the demo on the card -------
    a9_phase(dev, head, head_cam)

    # ---- 9j. main-shade: the wavefront shade kernel -------------------------
    shade_row = shade_phase(dev, c4, c4_cam, build)

    # ---- 9k. main-octree-build: the octree's fine grid on the card ----------
    build_row = octree_build_phase(dev)["row"]

    # ---- 10. times at the main paths' shapes -------------------------------
    # B1 and B2 by events around their wrappers (the tables kept on the
    # scene) and alone by the profiler, at refmax 2 and 1
    fused = fused_times(head, head_cam, org, dir)
    b1_ms = fused["b1_refmax2"]["ms"]["median"]
    b1_kernel_ms = median_of(fused["b1_refmax2"])
    b2_ms = fused["b2_refmax2"]["ms"]["median"]
    b2_kernel_ms = median_of(fused["b2_refmax2"])
    b1_plain_ms = cuda_median_ms(lambda: tf.trace_frame_fused_plain(
        head, cfg_head, head_cam))
    view_ms = cuda_median_ms(lambda: view.draw(
        exposure.accumulate(buf, hdr),
        ToneMapConfig(kind=ToneMapperKind.STDDEV_AROUND_MEAN)))
    b2_plain_ms = cuda_median_ms(lambda: tf.trace_rays_fused_plain(
        head, cfg_head, org, dir))
    pixels = HEADLINE_W * HEADLINE_H
    for what, ms in (("B1 wrapper (tables kept, one launch)", b1_ms),
                     ("B1 plain", b1_plain_ms),
                     ("render_hdr FUSED",
                      fused["render_hdr_fused_ms"]["median"]),
                     ("exposure + STDDEV tone map", view_ms),
                     ("B2 wrapper", b2_ms), ("B2 plain", b2_plain_ms)):
        emit(phase="times", what=what, ms_per_frame=ms,
             primary_rays_per_s=pixels / (ms * 1e-3), w=HEADLINE_W,
             h=HEADLINE_H, refmax=cfg_head.refmax, prims=head.n_prims,
             frames=TIMED, card=name, nvidia_smi=smi)
    for key in ("b1_refmax2", "b1_refmax1", "b2_refmax2", "b2_refmax1"):
        emit(phase="times", what=f"{key[:2].upper()} alone, refmax "
             f"{key[-1]}", **fused[key], timing=MS_TIMING,
             kernel_timing=KERNEL_MS_TIMING, card=name, nvidia_smi=smi)
    emit(phase="times", what="render_hdr FUSED, events, host clock and "
         "return", ms=fused["render_hdr_fused_ms"],
         host_ms=fused["render_hdr_fused_host_ms"],
         return_ms=fused["render_hdr_fused_return_ms"], card=name,
         nvidia_smi=smi)

    # B3 on the headline wavefront, B4 on config 3's; render_hdr PALLAS
    head_tabs = nh.pack_tables(head)
    c3_st = nh.stream_tables(nh.pack_tables(c3))
    # B3 and B5 alone (profiler) beside the events around their wrappers,
    # each with its spread over this run's timed calls
    b3_rep = kernel_report(lambda: nh.launch_scalar(head_tabs, org, dir),
                           "nh_scalar")
    b3_ms, b3_kernel_ms = b3_rep["ms"]["median"], median_of(b3_rep)
    b3_plain_ms = cuda_median_ms(
        lambda: nh.nearest_hit_pallas_scalar_plain(head, org, dir))
    # B4, B6, B7 and B8 alone too (the profiler; B4 with its merge)
    b4_rep = kernel_report(lambda: nh.launch_dense(c3_st, org3, dir3), "nh_")
    b4_ms, b4_kernel_ms = b4_rep["ms"]["median"], median_of(b4_rep)
    b4_plain_ms = cuda_median_ms(
        lambda: nh.nearest_hit_pallas_plain(c3, org3, dir3), warmup=1,
        timed=5)
    c3_render_ms = cuda_median_ms(lambda: rt.render_hdr(c3, c3_cam, cfg_c3),
                                  warmup=2, timed=10)
    head_pallas_ms = cuda_median_ms(
        lambda: rt.render_hdr(head, head_cam, cfg_head_p), warmup=2,
        timed=10)
    for what, ms, scene, cam, refmax, frames in (
            ("B3 wrapper (one search)", b3_ms, head, head_cam, 1, TIMED),
            ("B3 plain (one search)", b3_plain_ms, head, head_cam, 1, TIMED),
            ("render_hdr PALLAS headline", head_pallas_ms, head, head_cam,
             cfg_head_p.refmax, 10),
            ("B4 kernel (one search)", b4_ms, c3, c3_cam, 1, TIMED),
            ("B4 plain (one search)", b4_plain_ms, c3, c3_cam, 1, 5),
            ("render_hdr PALLAS config 3", c3_render_ms, c3, c3_cam,
             cfg_c3.refmax, 10)):
        emit(phase="times", what=what, ms_per_frame=ms,
             primary_rays_per_s=cam.w * cam.h / (ms * 1e-3), w=cam.w,
             h=cam.h, refmax=refmax, prims=scene.n_prims, frames=frames,
             card=name, nvidia_smi=smi)

    # B5 on one headline view; the replay step with B5 and with autograd;
    # an 8-view fit step and an 8-view recording
    b5f_rep = kernel_report(lambda: rg.launch_fwd(
        tabs_head, org, dir, pid_head, 2, 1.0), "replay_fwd")
    b5_fwd_ms, b5_fwd_kernel_ms = b5f_rep["ms"]["median"], median_of(b5f_rep)
    b5_fwd_plain_ms = cuda_median_ms(lambda: rg.replay_fwd_plain(
        tabs_head, org, dir, pid_head, 2, 1.0), warmup=1, timed=5)
    b5b_rep = kernel_report(lambda: rg.launch_bwd(
        tabs_head, org, dir, pid_head, g_head, 2, 1.0), "replay_")
    b5_bwd_ms, b5_bwd_kernel_ms = b5b_rep["ms"]["median"], median_of(b5b_rep)
    for what, rep in (("B3 alone (one headline search)", b3_rep),
                      ("B5 fwd alone (one view)", b5f_rep),
                      ("B5 bwd alone (one view)", b5b_rep)):
        emit(phase="times", what=what, **rep, timing=MS_TIMING,
             kernel_timing=KERNEL_MS_TIMING, card=name, nvidia_smi=smi)
    b5_bwd_plain_ms = cuda_median_ms(lambda: rg.replay_bwd_plain(
        tabs_head, org, dir, pid_head, g_head, 2, 1.0), warmup=1, timed=5)
    step_b5_ms = cuda_median_ms(lambda: replay_grads(
        head, cfg_rep, org, dir, target, pid_head), warmup=2, timed=10)
    step_autograd_ms = cuda_median_ms(lambda: replay_grads(
        head, cfg_rep, org, dir, target, pid_head, kernel=False), warmup=1,
        timed=5)
    recs = record_views(start, cfg_rep, cams)
    rec_ms = host_median_ms(lambda: record_views(start, cfg_rep, cams))
    fit_params, rebuild_start = float_partition(start)
    fit_params = [p.detach().clone().requires_grad_(True) for p in fit_params]
    adam = torch.optim.Adam(fit_params, lr=1e-2)

    def fit_step():
        adam.zero_grad(set_to_none=True)
        replay_loss(rebuild_start(fit_params), cfg_rep, cams, targets,
                    recs).backward()
        adam.step()

    fit_step_ms = host_median_ms(fit_step)
    views = len(cams)
    for what, ms, n_views, frames in (
            ("B5 fwd wrapper (one view)", b5_fwd_ms, 1, TIMED),
            ("B5 fwd plain (one view)", b5_fwd_plain_ms, 1, 5),
            ("B5 bwd wrapper (one view)", b5_bwd_ms, 1, TIMED),
            ("B5 bwd plain (one view)", b5_bwd_plain_ms, 1, 5),
            ("replay value_and_grad step, B5 (one view)", step_b5_ms, 1,
             10),
            ("replay value_and_grad step, autograd (one view)",
             step_autograd_ms, 1, 5),
            ("fit step, 8 views, B5 + Adam (host clock)", fit_step_ms,
             views, 5),
            ("recording, 8 views, B3 (host clock)", rec_ms, views, 5)):
        emit(phase="times", what=what, ms_per_frame=ms,
             primary_rays_per_s=n_views * pixels / (ms * 1e-3),
             w=HEADLINE_W, h=HEADLINE_H, views=n_views,
             refmax=cfg_rep.refmax, prims=head.n_prims, frames=frames,
             card=name, nvidia_smi=smi)

    # config 4: render_hdr TILED with cached tables, B7 alone, B6 on the
    # first sweep round, and the PALLAS frame for comparison
    c4_render_ms = cuda_median_ms(lambda: rt.render_hdr(
        c4, c4_cam, cfg_c4, tables=tables4), warmup=1, timed=5)
    cam_arr4, nby4, nbx4 = tt._frame_inputs(c4, c4_cam, *tables4[:3])
    b7_rep = kernel_report(lambda: tt.launch_frame(
        tables4[0], tables4[1], cam_arr4, c_max4, nby4, nbx4,
        **tt._flags(c4)), "tiled_frame")
    b7_ms, b7_kernel_ms = b7_rep["ms"]["median"], median_of(b7_rep)
    b7_plain_ms = cuda_median_ms(lambda: tt.frame_bounce0_plain(
        c4, c4_cam, *tables4[:3]), warmup=0, timed=1)
    nl4 = torch.tensor([n_live4], dtype=torch.int32, device=dev)
    b6_rep = kernel_report(lambda: nh.launch_listed(li4, org_s, dir_s,
                                                    n_live=nl4), "nh_listed")
    b6_ms, b6_kernel_ms = b6_rep["ms"]["median"], median_of(b6_rep)
    b6_plain_ms = cuda_median_ms(lambda: nh.nearest_hit_listed_plain(
        scene_s, org_s, dir_s, n_live4, inputs=li4), warmup=0, timed=1)
    c4_pallas_ms = cuda_median_ms(lambda: rt.render_hdr(c4, c4_cam, cfg_c4p),
                                  warmup=0, timed=2)
    px4 = C4_W * C4_H
    for what, ms, frames in (
            ("render_hdr TILED config 4 (tables cached)", c4_render_ms, 5),
            ("B7 kernel (bounce 0)", b7_ms, TIMED),
            ("B7 plain (bounce 0)", b7_plain_ms, 1),
            ("B6 kernel (first sweep round)", b6_ms, TIMED),
            ("B6 plain (first sweep round)", b6_plain_ms, 1),
            ("render_hdr PALLAS config 4", c4_pallas_ms, 2)):
        emit(phase="times", what=what, ms_per_frame=ms,
             primary_rays_per_s=px4 / (ms * 1e-3), w=C4_W, h=C4_H,
             refmax=cfg_c4.refmax, prims=c4.n_prims, frames=frames,
             rounds_per_frame=diag4["rounds"], sweep_slice_live=n_live4,
             frame_tables_host_ms=tables4_s * 1e3, card=name,
             nvidia_smi=smi)

    # config 4 in packet mode and through B8, and the 1.1M-prim packet
    # frame: the frames, B7-wave summed over a frame's packet rounds, B8 on
    # the first sweep round, each against its plain version
    def wave_runs(wave_list):
        """Per launch of a frame's packet rounds: the kernel's and the plain
        version's ms, the chunks each warp scanned [warps, 3], the chunks
        each ray needs [rays, 3], the rays alive at its start, and the
        output planes' count."""
        runs = []
        for sc, cols, tab, cnts, c_max, kw in wave_list:
            k_ms = cuda_median_ms(lambda: tt.launch_wave(
                sc, cols, tab, cnts, c_max, **kw), warmup=1, timed=3)
            p_ms = cuda_median_ms(lambda: tt.wave_bounce_plain(
                sc, cols, tab, cnts, c_max, **kw), warmup=0, timed=1)
            k = tt.launch_wave(sc, cols, tab, cnts, c_max, **kw, work=True)
            runs.append(dict(
                ms=k_ms, plain_ms=p_ms, chunks=k["chunks"],
                need=tt.wave_need(sc, cols, tab, cnts, c_max, k["t"], **kw),
                alive=(cols[10] == 0).reshape(-1), packets=cnts.shape[0],
                n_out=18 if tt._flags(sc)["want_normal"] else 15))
        torch.cuda.synchronize()
        return runs

    def rescue_runs(rescue_list):
        """Per rescue round of a frame: B4's ms over the round's rays and
        n_live."""
        runs, st = [], None
        for sc, o, d, nl in rescue_list:
            if st is None:
                st = nh.stream_tables(nh.pack_tables(sc))
            nl1 = nl.reshape(1).to(torch.int32)
            runs.append(dict(n_live=int(nl), rays=o.shape[0],
                             ms=cuda_median_ms(lambda: nh.launch_dense(
                                 st, o, d, n_live=nl1), warmup=1, timed=3)))
        return runs

    wave_a, wave_b = wave_runs(waves_a), wave_runs(waves_b)
    # beside the events (as every kernel is timed: they also hold the
    # wrapper's per-launch preparation, the scene bounds and the stacked
    # planes), each launch's kernel alone from the profiler; None without a
    # device trace
    for runs, wave_list in ((wave_a, waves_a), (wave_b, waves_b)):
        dev_ms = device_ms_per_call(
            [lambda w=w: tt.launch_wave(*w[:5], **w[5]) for w in wave_list],
            "tiled_wave_kernel")
        for i, r in enumerate(runs):
            r["kernel_ms"] = None if dev_ms is None else dev_ms[i]

    def kernel_sum(runs):
        ks = [r["kernel_ms"] for r in runs]
        return None if None in ks else sum(ks)

    b7w_ms = sum(r["ms"] for r in wave_a)
    b7w_kernel_ms = kernel_sum(wave_a)
    b7w_plain_ms = sum(r["plain_ms"] for r in wave_a)
    b7w_b_ms = sum(r["ms"] for r in wave_b)
    b7w_b_kernel_ms = kernel_sum(wave_b)
    b7w_b_plain_ms = sum(r["plain_ms"] for r in wave_b)
    resc_a = rescue_runs(rescues_a)
    resc_b = rescue_runs(rescues_b)
    cam_arr4b, nby4b, nbx4b = tt._frame_inputs(c4b, c4_cam, *tables_b[:3])
    b7_b_ms = cuda_median_ms(lambda: tt.launch_frame(
        tables_b[0], tables_b[1], cam_arr4b, tables_b[2], nby4b, nbx4b,
        **tt._flags(c4b)))
    nl_c = torch.tensor([n_live_c], dtype=torch.int32, device=dev)
    tabs_c = nh.stream_tables(nh.pack_tables(scene_c))
    b8_rep = kernel_report(lambda: nh.launch_culled(tabs_c, org_c, dir_c,
                                                    tb_c, n_live=nl_c),
                           "nh_culled")
    b8_ms, b8_kernel_ms = b8_rep["ms"]["median"], median_of(b8_rep)
    b8_plain_ms = cuda_median_ms(lambda: nh.nearest_hit_culled_plain(
        scene_c, org_c, dir_c, tb_c, n_live_c), warmup=0, timed=1)

    def packet_render_ms(scene, tables, threshold):
        rtl.SWEEP_MAX_PRIMS = threshold
        try:
            return cuda_median_ms(lambda: rt.render_hdr(
                scene, c4_cam, cfg_c4, tables=tables), warmup=1, timed=3)
        finally:
            rtl.SWEEP_MAX_PRIMS = SWEEP_MAX_PRIMS

    pa_render_ms = packet_render_ms(c4, tables4, 0)
    pb_render_ms = packet_render_ms(c4b, tables_b, SWEEP_MAX_PRIMS)
    rtl.SWEEP_LISTED, rtl.SWEEP_CULL = False, True
    try:
        cull_render_ms = cuda_median_ms(lambda: rt.render_hdr(
            c4, c4_cam, cfg_c4, tables=tables4), warmup=1, timed=3)
    finally:
        rtl.SWEEP_LISTED, rtl.SWEEP_CULL = True, False
    for frame, ms, b7f_ms, w_ms, resc in (
            ("config 4", pa_render_ms, b7_ms, b7w_ms, resc_a),
            ("1.1M prims", pb_render_ms, b7_b_ms, b7w_b_ms, resc_b)):
        b4_sum = sum(r["ms"] for r in resc)
        emit(phase="times", what=f"B4 kernel per rescue round, packet "
             f"frame ({frame})", rounds=resc, b4_ms_per_frame=b4_sum,
             frame_ms=ms, b7_frame_ms=b7f_ms, b7_wave_ms=w_ms,
             glue_ms=ms - b7f_ms - w_ms - b4_sum, card=name,
             nvidia_smi=smi)
    for what, ms, prims, frames, extra in (
            ("render_hdr TILED packet mode config 4 (tables cached)",
             pa_render_ms, c4.n_prims, 3,
             dict(packet_rounds=diag_pa["packet_rounds"],
                  rescue_rounds=diag_pa["rounds"],
                  wave_launches=len(waves_a),
                  grid_host_ms=grid4_s * 1e3)),
            ("B7-wave kernel, summed over the packet rounds (config 4)",
             b7w_ms, c4.n_prims, 3, dict(wave_launches=len(waves_a),
                                         kernel_ms=b7w_kernel_ms)),
            ("B7-wave plain, summed over the packet rounds (config 4)",
             b7w_plain_ms, c4.n_prims, 1, dict(wave_launches=len(waves_a))),
            ("render_hdr TILED packet mode 1.1M prims (tables cached)",
             pb_render_ms, c4b.n_prims, 3,
             dict(packet_rounds=diag_pb["packet_rounds"],
                  rescue_rounds=diag_pb["rounds"],
                  wave_launches=len(waves_b),
                  frame_tables_host_ms=tables_b_s * 1e3,
                  grid_host_ms=grid_b_s * 1e3)),
            ("B7-wave kernel, summed over the packet rounds (1.1M prims)",
             b7w_b_ms, c4b.n_prims, 3, dict(wave_launches=len(waves_b),
                                            kernel_ms=b7w_b_kernel_ms)),
            ("B7-wave plain, summed over the packet rounds (1.1M prims)",
             b7w_b_plain_ms, c4b.n_prims, 1,
             dict(wave_launches=len(waves_b))),
            ("B7 kernel (bounce 0, 1.1M prims)", b7_b_ms, c4b.n_prims,
             TIMED, {}),
            ("render_hdr TILED config 4 through B8 (tables cached)",
             cull_render_ms, c4.n_prims, 3,
             dict(sweep_rounds=diag_c["rounds"])),
            ("B8 kernel (first sweep round)", b8_ms, c4.n_prims, TIMED,
             dict(sweep_slice_live=n_live_c)),
            ("B8 plain (first sweep round)", b8_plain_ms, c4.n_prims, 1,
             dict(sweep_slice_live=n_live_c))):
        emit(phase="times", what=what, ms_per_frame=ms,
             primary_rays_per_s=px4 / (ms * 1e-3), w=C4_W, h=C4_H,
             refmax=cfg_c4.refmax, prims=prims, frames=frames, card=name,
             nvidia_smi=smi, **extra)

    # ---- bounds: the tests these inputs need, the bytes in and out ----------
    n_head, n_c3 = org.shape[0], org3.shape[0]
    head_tab = 4 * (13 * head.n_spheres + 13 * head.n_boxes + 17 * head.n_tris)
    # B1 and B2 on the headline: 16 bytes a pixel out (B2: also 28 of ray
    # and id in), the tables and the spheres' arrays of structs read once
    b1b = fused_bounds(head, head_rec, tf.frame_lanes(HEADLINE_W,
                                                      HEADLINE_H, dev),
                       16 * n_head + head_tab + 32 * head.n_spheres)
    b2b = fused_bounds(head, head_rec2, tf.ray_lanes(n_head, dev),
                       44 * n_head + head_tab + 32 * head.n_spheres)
    for kname, b, ms, k_ms in (("B1", b1b, b1_ms, b1_kernel_ms),
                               ("B2", b2b, b2_ms, b2_kernel_ms)):
        emit(phase="bounds", kernel=kname, rays=n_head,
             **{k: v for k, v in b.items() if not k.startswith("bound")},
             bound_ms=b["bound"][0], bound_by=b["bound"][1],
             bound_ms_streamed=b["bound_streamed"][0],
             bound_ms_all_tests=b["bound_all"][0], ms=ms, kernel_ms=k_ms,
             card=name, nvidia_smi=smi)
    # B3 on the headline's bounce-0 rays: every ray against every prim; the
    # tests the rays need (each ray's own cone, ``group=1``: its spheres;
    # boxes and triangles dense); those the warps ran (each warp's kept
    # spheres against its rays)
    b3_bytes = 32 * n_head + head_tab + 16 * head.n_spheres
    b3_bound = bound(n_head * class_ops(head), b3_bytes)
    b3_dense = n_head * (head.n_boxes * OPS["box"] + head.n_tris * OPS["tri"])
    b3_need = int(nh.scalar_cull(head_tabs, org, dir, group=1).sum())
    warp_rays = torch.full((-(-n_head // 32),), 32.0, device=dev)
    warp_rays[-1] = n_head - 32 * (warp_rays.numel() - 1)
    b3_streamed = float((nh.scalar_cull(head_tabs, org, dir).sum(1)
                         * warp_rays).sum())
    b3_bound_need = bound(b3_need * OPS["sphere"] + b3_dense, b3_bytes)
    b3_bound_streamed = bound(b3_streamed * OPS["sphere"] + b3_dense,
                              b3_bytes)
    emit(phase="bounds", kernel="B3", rays=n_head,
         sphere_tests_all=n_head * head.n_spheres,
         sphere_tests_streamed=b3_streamed, sphere_tests_needed=b3_need,
         bound_ms=b3_bound_need[0], bound_by=b3_bound_need[1],
         bound_ms_needed=b3_bound_need[0],
         bound_ms_streamed=b3_bound_streamed[0],
         bound_ms_all_tests=b3_bound[0],
         ms=b3_ms, kernel_ms=b3_kernel_ms, card=name, nvidia_smi=smi)
    b4_bound = bound(n_c3 * class_ops(c3), 32 * n_c3 + 4 * (
        4 * c3.n_spheres + 6 * c3.n_boxes + 9 * c3.n_tris))
    b5f_bound = bound(n_head * 2 * OPS["replay_fwd"], n_head * (24 + 8 + 12))
    b5b_bound = bound(n_head * 2 * OPS["replay_bwd"],
                      n_head * (24 + 8 + 12 + 24))
    # B7 and B7-wave: the tests of the chunks the rays need (``frame_need``,
    # ``wave_need``: each ray up to its own exit, given its final hit), a
    # table's rows read once (as many as its neediest ray scans), the
    # planes in and out; beside it, the same over the chunks the warps
    # scanned
    ops_per_class = torch.tensor([OPS["sphere_unit"], OPS["box"],
                                  OPS["tri_edges"]], dtype=torch.float64,
                                 device=dev)

    def chunk_ops(ray_chunks):
        """Operations of ray-chunks [..., 3] (a ray against 16 rows)."""
        return float((ray_chunks.double().reshape(-1, 3)
                      * ops_per_class).sum()) * tt.CHUNK

    def table_bytes(need_rays, rays_per_table):
        """Rows that some ray of each table needs, at 80 bytes a row."""
        per = need_rays.sum(-1).reshape(-1, rays_per_table).max(1).values
        return float(per.double().sum()) * tt.CHUNK * 80

    hp4, wp4 = k4["cr"].shape
    need4 = tt.frame_need(c4, c4_cam, *tables4[:3], k4["t"])
    b7_io = 15 * 4 * hp4 * wp4 + 32 * tables4[1].shape[0]
    b7_tile_need = torch.stack([tt.to_groups(need4[..., k], nby4, nbx4,
                                             tt.TILE_SUB * tt.LANE)
                                for k in range(3)], -1)
    b7_bound = bound(chunk_ops(need4), table_bytes(
        b7_tile_need, tt.TILE_SUB * tt.LANE) + b7_io)
    b7_bound_streamed = bound(chunk_ops(k4["chunks"]) * tt.GROUP,
                              float(k4["chunks"].sum(1).reshape(
                                  -1, tt.GROUPS_PER_TILE).max(1).values
                                  .double().sum()) * tt.CHUNK * 80 + b7_io)

    def wave_bounds(runs):
        """(needed bound, streamed bound, live-ray tests streamed, per
        launch: ms and chunks per scanning warp) of a frame's launches."""
        ops_n = ops_s = nbytes = tests = 0.0
        launches = []
        for r in runs:
            rays = r["need"].shape[0]
            ops_n += chunk_ops(r["need"])
            ops_s += chunk_ops(r["chunks"]) * tt.GROUP
            nbytes += (table_bytes(r["need"], rays // r["packets"])
                       + (11 + r["n_out"]) * 4 * rays + 32 * r["packets"])
            per_ray = r["chunks"].repeat_interleave(tt.GROUP, dim=0)
            tests += float(per_ray[r["alive"]].sum()) * tt.CHUNK
            c = r["chunks"].sum(1)
            scan = c[c > 0].double()
            launches.append(dict(
                ms=r["ms"], kernel_ms=r["kernel_ms"], warps=c.numel(),
                warps_scanning=scan.numel(),
                mean_chunks_per_scanning_warp=float(scan.mean())
                if scan.numel() else 0.0, max_chunks_per_warp=int(c.max())))
        return bound(ops_n, nbytes), bound(ops_s, nbytes), tests, launches

    b7w_bound, b7w_bound_streamed, tests7w, w_launches_a = wave_bounds(wave_a)
    _, _, tests7w_b, w_launches_b = wave_bounds(wave_b)
    # B6 and B8 on config 4's sweep round: the sphere (and triangle) tests
    # of the slots or tiles the rays need (9e), boxes and unlisted classes
    # dense; beside it, the same count over what the warps streamed
    def b6_ops(ray_sl):
        return (float(ray_sl[0]) * li4.sph_fan * nh.BLOCK_K * OPS["sphere"]
                + float(ray_sl[1]) * li4.tri_fan * nh.BLOCK_K * OPS["tri"]
                + n_live4 * scene_s.n_boxes * OPS["box"]
                + (n_live4 * scene_s.n_spheres * OPS["sphere"]
                   if li4.sph_list is None else 0)
                + (n_live4 * scene_s.n_tris * OPS["tri"]
                   if li4.tri_list is None else 0))

    lists_bytes = sum(lst[0].numel() * 8 for lst in (li4.sph_list,
                                                      li4.tri_list)
                      if lst is not None)
    b6_bytes = 32 * org_s.shape[0] + lists_bytes + 4 * (
        4 * scene_s.n_spheres + 6 * scene_s.n_boxes + 9 * scene_s.n_tris)
    b6_bound = bound(b6_ops(rules6["need"]), b6_bytes)
    b6_bound_streamed = bound(b6_ops(rules6["warp"]), b6_bytes)
    # B8 on the cull round: the sphere tiles needed (or streamed) against
    # the live rays, boxes and triangles dense
    def b8_ops(ray_tiles):
        return (float(ray_tiles[0]) * nh.BLOCK_K * OPS["sphere"]
                + n_live_c * (scene_c.n_boxes * OPS["box"]
                              + scene_c.n_tris * OPS["tri"]))

    b8_bytes = 32 * org_c.shape[0] + 16 * tb_c.shape[0] + 4 * (
        4 * scene_c.n_spheres + 6 * scene_c.n_boxes + 9 * scene_c.n_tris)
    b8_bound = bound(b8_ops(rules8["need"]), b8_bytes)
    b8_bound_streamed = bound(b8_ops(rules8["warp"]), b8_bytes)
    # the time of one streamed test (a live ray against a prim), in ns and
    # in FP32 lane-cycles (132 SMs x 128 lanes at the card's top SM clock)
    tests6 = float(rules6["warp"][0]) * li4.sph_fan * nh.BLOCK_K
    tests8 = float(rules8["warp"][0]) * nh.BLOCK_K
    tests4 = float(n_c3 * c3.n_prims)

    def per_test(ms, tests):
        ns = ms * 1e6 / tests
        return dict(tests_streamed=tests, ns_per_streamed_test=ns,
                    lane_cycles_per_streamed_test=ns * 1e-9 * 132 * 128
                    * sm_clock_mhz * 1e6)

    emit(phase="bounds", card=name, nvidia_smi=smi,
         sm_clock_max_mhz=sm_clock_mhz,
         b4=dict(ms=b4_ms, kernel_ms=b4_kernel_ms, bound_ms=b4_bound[0],
                 bound_by=b4_bound[1],
                 **per_test(b4_ms, tests4)),
         b6=dict(ms=b6_ms, kernel_ms=b6_kernel_ms,
                 bound_ms_needed=b6_bound[0],
                 bound_ms_streamed=b6_bound_streamed[0],
                 bound_by=b6_bound[1], **per_test(b6_ms, tests6)),
         b7=dict(ms=b7_ms, kernel_ms=b7_kernel_ms,
                 bound_ms_needed=b7_bound[0],
                 bound_ms_streamed=b7_bound_streamed[0],
                 bound_by=b7_bound[1]),
         b7_wave=dict(ms=b7w_ms, kernel_ms=b7w_kernel_ms,
                      bound_ms_needed=b7w_bound[0],
                      bound_ms_streamed=b7w_bound_streamed[0],
                      bound_by=b7w_bound[1], **per_test(b7w_ms, tests7w)),
         b8=dict(ms=b8_ms, kernel_ms=b8_kernel_ms,
                 bound_ms_needed=b8_bound[0],
                 bound_ms_streamed=b8_bound_streamed[0],
                 bound_by=b8_bound[1], **per_test(b8_ms, tests8)))
    # B7-wave's launches: does the slowest warp or the mean set the time?
    for frame, per_launch, tests in (("config 4", w_launches_a, tests7w),
                                     ("1.1M prims", w_launches_b,
                                      tests7w_b)):
        emit(phase="bounds", kernel="B7-wave", case=frame,
             live_ray_tests_streamed=tests, launches=per_launch)

    # ---- kernels summary and the last line ------------------------------------
    def worst(reps, key="max_abs_err"):
        return max(r[key] for r in reps)

    def row(kname, source, replaces, launched, err, ms, plain_ms, bnd,
            **extra):
        return {"name": kname, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launched,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
                "timing": MS_TIMING, **extra}

    src = "raytracer_js_tpu/kernels/"
    print(json.dumps({"kernels": [
        row("trace_frame_kernel", KERNEL_SOURCE, src + "trace_fused.py:678",
            launches["frame"], worst(b1), b1_ms, b1_plain_ms, b1b["bound"],
            kernel_ms=b1_kernel_ms, kernel_timing=KERNEL_MS_TIMING,
            bound_ms_streamed=b1b["bound_streamed"][0],
            bound_ms_all_tests=b1b["bound_all"][0],
            ptxas=ptxas_of(build.log, ["trace_frame_kernel"])),
        row("trace_rays_kernel", KERNEL_SOURCE, src + "trace_fused.py:636",
            launches["rays"], worst(b2), b2_ms, b2_plain_ms, b2b["bound"],
            kernel_ms=b2_kernel_ms, kernel_timing=KERNEL_MS_TIMING,
            bound_ms_streamed=b2b["bound_streamed"][0],
            bound_ms_all_tests=b2b["bound_all"][0],
            ptxas=ptxas_of(build.log, ["trace_rays_kernel"])),
        row("nh_scalar_kernel", NH_SOURCE, src + "nearest_hit.py:702",
            head_launches["scalar"], worst(b3), b3_ms, b3_plain_ms,
            b3_bound_need, kernel_ms=b3_kernel_ms,
            kernel_timing=KERNEL_MS_TIMING,
            bound_ms_needed=b3_bound_need[0],
            bound_ms_streamed=b3_bound_streamed[0],
            bound_ms_all_tests=b3_bound[0]),
        row("nh_dense_kernel", NH_SOURCE, src + "nearest_hit.py:91",
            c3_launches["dense"], worst(b4), b4_ms, b4_plain_ms, b4_bound,
            kernel_ms=b4_kernel_ms, kernel_timing=KERNEL_MS_TIMING),
        row("replay_fwd_kernel", REPLAY_SOURCE, src + "replay_grad.py:399",
            fit_launches["fwd"], worst(b5, "color_max_abs_err"), b5_fwd_ms,
            b5_fwd_plain_ms, b5f_bound, kernel_ms=b5_fwd_kernel_ms,
            kernel_timing=KERNEL_MS_TIMING),
        row("replay_bwd_kernel", REPLAY_SOURCE, src + "replay_grad.py:592",
            fit_launches["bwd"], worst(b5, "bwd_max_abs_err"), b5_bwd_ms,
            b5_bwd_plain_ms, b5b_bound, kernel_ms=b5_bwd_kernel_ms,
            kernel_timing=KERNEL_MS_TIMING),
        row("nh_listed_kernel", NH_SOURCE, src + "nearest_hit.py:155",
            c4_launches["listed"], worst(b6), b6_ms, b6_plain_ms, b6_bound,
            kernel_ms=b6_kernel_ms, kernel_timing=KERNEL_MS_TIMING),
        row("tiled_frame_kernel", TILED_SOURCE, src + "trace_tiled.py:468",
            c4_launches["tiled_frame"], worst(b7), b7_ms, b7_plain_ms,
            b7_bound, kernel_ms=b7_kernel_ms, kernel_timing=KERNEL_MS_TIMING),
        row("tiled_wave_kernel", TILED_SOURCE, src + "trace_tiled.py:518",
            launches_pa["tiled_wave"], worst(b7w), b7w_ms, b7w_plain_ms,
            b7w_bound, kernel_ms=b7w_kernel_ms,
            kernel_timing=KERNEL_MS_TIMING),
        row("nh_culled_kernel", NH_SOURCE, src + "nearest_hit.py:113",
            launches_c["culled"], worst(b8), b8_ms, b8_plain_ms, b8_bound,
            kernel_ms=b8_kernel_ms, kernel_timing=KERNEL_MS_TIMING),
        # no Pallas kernel: the reference's DDA is a lax.while_loop (:530)
        row("octree_dda_kernel", OCTREE_SOURCE,
            "raytracer_js_tpu/accel/octree.py:426", oct_row["launches"],
            oct_row["max_abs_err"], oct_row["ms"], oct_row["plain_ms"],
            (oct_row["bound_ms"], oct_row["bound_by"]),
            kernel_ms=oct_row["kernel_ms"], kernel_timing=KERNEL_MS_TIMING,
            case="config 4 bounce 0, 2,088,960 rays, depth 8",
            bounce1_as_the_frame_launches_it=oct_row["bounce1"],
            ptxas=ptxas_of(build.log, ["octree_dda_kernel"])),
        # no Pallas kernel: the reference's shade is XLA-fused glue
        row("shade_bounce_kernel", SHADE_SOURCE,
            "raytracer_js_tpu/ops/trace.py (XLA-fused, no kernel)",
            shade_row["frames"]["octree"]["kernel"]["launches"]["shade"],
            shade_row["max_abs_err"],
            shade_row["times"]["bounce0"]["ms"]["median"],
            shade_row["times"]["bounce0"]["plain_ms"],
            (shade_row["times"]["bounce0"]["bound_ms"],
             shade_row["times"]["bounce0"]["bound_by"]),
            kernel_ms=shade_row["times"]["bounce0"]["kernel_ms"],
            kernel_timing=KERNEL_MS_TIMING,
            case="config 4 bounce 0, 2,088,960 rays",
            bounce1_as_the_frame_launches_it=shade_row["times"]["bounce1"],
            engages_us=shade_row["engages_us"],
            ptxas=ptxas_of(build.log, ["shade_bounce_kernel"])),
        # no kernel: the reference builds its octree on the host; the four
        # passes' device time a build against the host build of the grid
        row("octree_build (count, fill, sort, skip)", BUILD_SOURCE,
            "raytracer_js_tpu/accel/octree.py build_octree (host, no kernel)",
            build_row["launches"], 0, build_row["ms"],
            build_row["plain_ms"], build_row["bound"],
            timing="the passes' kernel times summed a build: each pass's "
                   "mean in a torch.profiler trace of the card times its "
                   "launches a build",
            case="config 5's field, 1M prims, depth 8: the passes' device "
                 "time a build; plain_ms the host build (host clock)",
            passes_ms=build_row["passes"],
            whole_build_ms=build_row["whole_build_ms"],
            ptxas=ptxas_of(build.log, list(BUILD_PASSES))),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def enqueue_ms(fn, warmup=3, timed=TIMED) -> float:
    """Median host time until ``fn`` returns, the device idle before each
    call: the time to enqueue its work, or more when it waits for the
    device."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(out)


def fused_times(head, cam, org, dir) -> dict:
    """The FUSED rows of ``--frame-times`` on the headline: B1 (the frame
    wrapper) and B2 (the wavefront wrapper over the camera's rays) at
    refmax 2 and 1 by :func:`kernel_report` (events around the wrapper,
    the kernel alone by the profiler; refmax 2 less refmax 1 is what the
    bounce-1 scan costs); ``render_hdr`` FUSED by events (min, median,
    max), by the host clock to the end of its work and to its return, and
    its :func:`host_trace`. Only entry points that earlier trees share."""
    out = {}
    for refmax in (2, 1):
        cfg = RenderConfig(refmax=refmax, backend=HitBackend.FUSED)
        out[f"b1_refmax{refmax}"] = kernel_report(
            lambda: tf.trace_frame_fused_cuda(head, cfg, cam), "trace_frame")
        out[f"b2_refmax{refmax}"] = kernel_report(
            lambda: tf.trace_rays_fused_cuda(head, cfg, org, dir),
            "trace_rays")
    cfg = RenderConfig(refmax=2, backend=HitBackend.FUSED)

    def frame():
        return rt.render_hdr(head, cam, cfg)

    out.update(render_hdr_fused_ms=spread(event_ms(frame)),
               render_hdr_fused_host_ms=host_median_ms(frame, warmup=3,
                                                       timed=TIMED),
               render_hdr_fused_return_ms=enqueue_ms(frame),
               render_hdr_fused_trace=host_trace(frame))
    return out


def headline_times(dev) -> dict:
    """The headline's rows of ``--frame-times``: B3 (one bounce-0 search)
    and B5 (one view's forward and backward) alone, each by CUDA events
    around the wrapper and by the profiler (:func:`kernel_report`); the
    PALLAS frame; the 8-view recording; the one-view replay step through
    B5; the 8-view fit step (B5 and Adam on recorded winners); the FUSED
    rows (:func:`fused_times`). Only entry points and signatures that
    earlier trees of the port share."""
    head, cam = headline_scene(device=dev), headline_camera(dev)
    org, dir = pixel_rays(cam)
    fused = fused_times(head, cam, org, dir)
    cfg_p = RenderConfig(refmax=2, backend=HitBackend.PALLAS)
    cfg_f = RenderConfig(refmax=2, backend=HitBackend.FUSED)
    n = org.shape[0]
    pid = record_paths(head, cfg_p, org, dir)
    target = torch.as_tensor(np.random.default_rng(11).uniform(
        0.0, 1.0, (n, 3)).astype(np.float32), device=dev)
    tabs_r = rg.scene_tables(head)
    g = 2.0 * (rg.launch_fwd(tabs_r, org, dir, pid, 2, 1.0) - target) / n
    tabs_h = nh.pack_tables(head)
    cams = fit_cameras(HEADLINE_W, HEADLINE_H, device=dev)
    targets = torch.stack([rt.render_hdr(head, c, cfg_f).reshape(-1, 3)
                           for c in cams])
    start = perturbed(head)
    recs = record_views(start, cfg_p, cams)
    params, rebuild = float_partition(start)
    params = [p.detach().clone().requires_grad_(True) for p in params]
    adam = torch.optim.Adam(params, lr=1e-2)

    def fit_step():
        adam.zero_grad(set_to_none=True)
        replay_loss(rebuild(params), cfg_p, cams, targets, recs).backward()
        adam.step()

    return dict(
        b3=kernel_report(lambda: nh.launch_scalar(tabs_h, org, dir),
                         "nh_scalar"),
        b5_fwd=kernel_report(lambda: rg.launch_fwd(tabs_r, org, dir, pid, 2,
                                                   1.0), "replay_fwd"),
        b5_bwd=kernel_report(lambda: rg.launch_bwd(tabs_r, org, dir, pid, g,
                                                   2, 1.0), "replay_"),
        pallas_headline_ms=cuda_median_ms(
            lambda: rt.render_hdr(head, cam, cfg_p), warmup=2, timed=10),
        recording_8_views_host_ms=host_median_ms(
            lambda: record_views(start, cfg_p, cams)),
        replay_step_b5_ms=cuda_median_ms(lambda: replay_grads(
            head, cfg_p, org, dir, target, pid), warmup=2, timed=10),
        fit_step_8_views_host_ms=host_median_ms(fit_step), **fused)


def frame_times(headline_only: bool = False) -> int:
    """``python3 chip_smoke.py --frame-times [--headline-only]``: the rows
    whose time holds host work, and B1, B2, B3 and B5 alone, and nothing
    else: the headline's rows (:func:`headline_times`), the ptxas report of
    B1's, B2's, B3's and B5's kernels, then (unless ``--headline-only``)
    config 4 TILED in sweep mode (B6), in packet mode and through B8
    (tables cached), the 1.1M-sphere packet frame, and config 3 PALLAS,
    each a median of CUDA events around ``render_hdr``. It calls only entry points that earlier
    trees of the port share, so a copy of this script placed at the root
    of another checkout times that checkout's package: run two trees in
    turns in one session to tell a change from the host's drift. Prints
    the card and one JSON line."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    build = _build.build()
    _build.load()
    ms = headline_times(dev)
    ptxas = ptxas_of(build.log, PTXAS_KERNELS)
    if not headline_only:
        c3, c3_cam = config3_scene(device=dev), config3_camera(dev)
        cam = config4_camera(dev)
        cfg = RenderConfig(refmax=2, backend=HitBackend.TILED)
        c4 = config4_scene(device=dev)
        tables = rtl.frame_tables(c4, cam)
        c4b = config4_scene(C4B_PRIMS, device=dev)
        tables_b = rtl.frame_tables(c4b, cam)

        def frame_ms(scene, tbl, timed, threshold=SWEEP_MAX_PRIMS,
                     listed=True, cull=False):
            rtl.SWEEP_MAX_PRIMS = threshold
            rtl.SWEEP_LISTED, rtl.SWEEP_CULL = listed, cull
            try:
                return cuda_median_ms(lambda: rt.render_hdr(
                    scene, cam, cfg, tables=tbl), warmup=1, timed=timed)
            finally:
                rtl.SWEEP_MAX_PRIMS = SWEEP_MAX_PRIMS
                rtl.SWEEP_LISTED, rtl.SWEEP_CULL = True, False

        ms.update(
            sweep_config4=frame_ms(c4, tables, 5),
            packet_config4=frame_ms(c4, tables, 5, threshold=0),
            cull_config4=frame_ms(c4, tables, 5, listed=False, cull=True),
            packet_1_1m=frame_ms(c4b, tables_b, 3),
            pallas_config3=cuda_median_ms(lambda: rt.render_hdr(
                c3, c3_cam, RenderConfig(refmax=3,
                                         backend=HitBackend.PALLAS)),
                warmup=2, timed=10))
    emit(phase="frame_times",
         tree=str(pathlib.Path(rt.__file__).resolve().parent.parent),
         times=ms, ptxas=ptxas, timing=MS_TIMING,
         kernel_timing=KERNEL_MS_TIMING, card=smi)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--frame-times"]:
        sys.exit(frame_times(sys.argv[2:] == ["--headline-only"]))
    if sys.argv[1:2] == ["--shade"]:
        sys.exit(shade_only())
    if sys.argv[1:2] == ["--replay-1m"]:
        sys.exit(replay_1m_only())
    if sys.argv[1:2] == ["--octree-build"]:
        sys.exit(octree_build_only())
    sys.exit(main())
