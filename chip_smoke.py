#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``raytracer_js_tpu_torch``) on one
NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, one JSON line each:
  0. device   — needs CUDA (exit 1 without it); prints the card's name and
                ``nvidia-smi`` name/power limit; TF32 off.
  1. build    — nvcc builds the kernels from ``raytracer_js_tpu_torch/csrc``.
  2. B1       — the frame kernel against its plain PyTorch version on five
                scenes: (a) the headline scene at 1920x1088, refmax 2;
                (b) config 1 with glass and a triangle, 256x256, refmax 3;
                (c) a rough + glass scene, spp 4; (d) a 600-sphere near-miss
                field at 512x512; (e) a 40x24 rotated camera.
  3. B2       — the wavefront kernel against its plain version on (b), (c)
                and (d), and ``render_rays`` with FUSED; (f) a ray on a
                mirror box's edge (the x > y > z face tie).
  4. B3       — the scalar nearest-hit kernel against its plain version:
                (a) the headline scene's 1920x1088 bounce-0 rays; (b) config
                1 with glass and a triangle, camera and random rays; (c) a
                384-sphere near-miss field at 512x512.
  5. B4       — the dense nearest-hit kernel against its plain version:
                (a) BASELINE config 3's 512x512 bounce-0 rays (5124 prims);
                (b) the 600-sphere near-miss field; (c) config 3 with
                n_live < N; (d) the empty scene; (e) a ray on a box edge.
  6. main     — ``render_hdr`` FUSED on the headline scene -> exposure ->
                STDDEV tone map -> PNG, plus ``render_rays`` FUSED over the
                same camera's rays, with the launch counters reset first.
  7. main-PALLAS — ``render_hdr`` PALLAS on config 3 (B4 at every bounce)
                -> exposure -> STDDEV tone map -> PNG, held against the same
                path with the plain versions on the CPU at a small size;
                then ``render_rays`` PALLAS over the headline camera's rays
                (B3), held against the FUSED frame. Counters reset first.
  8. times    — CUDA-event medians of each kernel and its plain version at
                the main paths' shapes, and ``render_hdr`` end to end.
Parity rule: allclose(rtol=1e-5, atol=1e-6) and equal status per pixel (or
pid per ray), except proven winner flips (``utils/parity``), at most 0.1%.
Any failure raises, so the script exits non-zero and never prints the last
line, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import raytracer_js_tpu_torch as rt
from raytracer_js_tpu_torch import (HitBackend, RenderConfig, ResponseType,
                                    SceneBuilder, ToneMapConfig,
                                    ToneMapperKind, make_camera)
from raytracer_js_tpu_torch.kernels import _build
from raytracer_js_tpu_torch.kernels import nearest_hit as nh
from raytracer_js_tpu_torch.kernels import trace_fused as tf
from raytracer_js_tpu_torch.models.camera import pixel_rays
from raytracer_js_tpu_torch.ops.sampling import DEFAULT_SEED
from raytracer_js_tpu_torch.render import render_rays, start_substance
from raytracer_js_tpu_torch.utils import parity
from raytracer_js_tpu_torch.utils.mesh import icosphere
from raytracer_js_tpu_torch.view import exposure, screen, view

HEADLINE_W, HEADLINE_H = 1920, 1088
C3_W, C3_H = 512, 512
WARMUP, TIMED = 3, 20
KERNEL_SOURCE = "raytracer_js_tpu_torch/csrc/trace_fused.cu"
NH_SOURCE = "raytracer_js_tpu_torch/csrc/nearest_hit.cu"


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


def compare_frame(name, scene, cam, cfg, sample=0):
    """B1 kernel vs its plain version for one sample of one scene."""
    refr = start_refr(scene, cam)
    k_img, k_st, k_rec = tf.trace_frame_fused_cuda(
        scene, cfg, cam, sample=sample, start_refr=refr, record=True)
    p_img, p_st, p_rec = tf.trace_frame_fused_plain(
        scene, cfg, cam, sample=sample, start_refr=refr, record=True)
    torch.cuda.synchronize()
    rep = parity.compare(k_img, k_st, p_img, p_st,
                         prove=parity.flip_prover(scene, p_rec, k_rec["pid"]))
    emit(phase="B1", case=name, sample=sample, w=cam.w, h=cam.h,
         refmax=cfg.refmax, prims=scene.n_prims, **rep)
    check(rep["ok"], f"B1 {name} sample {sample}: {rep}")
    return rep, k_img


def compare_rays(name, scene, cam, cfg, seed=DEFAULT_SEED):
    """B2 kernel vs its plain version per sample, then render_rays FUSED."""
    org, dir = pixel_rays(cam)
    rid0 = torch.arange(org.shape[0], dtype=torch.int32, device=org.device)
    refr = start_refr(scene, cam)
    reps, acc = [], None
    for s in range(cfg.spp):
        rid = rid0 * cfg.spp + s
        k_c, k_st, k_rec = tf.trace_rays_fused_cuda(
            scene, cfg, org, dir, seed=seed, ray_id=rid, start_refr=refr,
            record=True)
        p_c, p_st, p_rec = tf.trace_rays_fused_plain(
            scene, cfg, org, dir, seed=seed, ray_id=rid, start_refr=refr,
            record=True)
        torch.cuda.synchronize()
        rep = parity.compare(k_c, k_st, p_c, p_st, prove=parity.flip_prover(
            scene, p_rec, k_rec["pid"]))
        emit(phase="B2", case=name, sample=s, rays=org.shape[0],
             refmax=cfg.refmax, prims=scene.n_prims, **rep)
        check(rep["ok"], f"B2 {name} sample {s}: {rep}")
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


def random_rays(n, seed, device):
    rng = np.random.default_rng(seed)
    org = rng.uniform([-1, -2, 0], [2, 2, 1.5], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return (torch.as_tensor(org, device=device),
            torch.as_tensor(d, device=device))


def reset_launches() -> None:
    for counts in (tf.LAUNCHES, nh.LAUNCHES):
        for k in counts:
            counts[k] = 0


def launches_now() -> dict:
    return {**tf.LAUNCHES, **nh.LAUNCHES}


def cuda_median_ms(fn, warmup=WARMUP, timed=TIMED) -> float:
    """Median over ``timed`` runs of one call, each bracketed by CUDA
    events, after ``warmup`` calls."""
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
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


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
    emit(phase="device", name=name, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    build = _build.build()
    _build.load()
    emit(phase="build", seconds=time.perf_counter() - t0,
         nvcc_seconds=build.seconds, library=build.path.name,
         ptxas=[ln for ln in build.log.splitlines() if "registers" in ln])

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
    rep, head_img = compare_frame("a_headline", head, head_cam, cfg_head)
    b1.append(rep)
    b1.append(compare_frame("b_config1_glass_tri", glass, cam256, cfg3)[0])
    for s in range(cfg_rough.spp):
        b1.append(compare_frame("c_rough_spp4", rough, cam256, cfg_rough,
                                sample=s)[0])
    b1.append(compare_frame("d_near_miss_600", field, cam512, cfg2)[0])
    b1.append(compare_frame("e_rotated_40x24", glass, cam_rot, cfg3)[0])

    # ---- 3. B2 against its plain version ------------------------------------
    b2 = []
    b2 += compare_rays("b_config1_glass_tri", glass, cam256, cfg3)
    b2 += compare_rays("c_rough_spp4", rough, cam256, cfg_rough)
    b2 += compare_rays("d_near_miss_600", field, cam512, cfg2)
    edge, e_org, e_dir = box_edge_case(dev)
    k_c, k_st, _ = tf.trace_rays_fused_cuda(edge, cfg3, e_org, e_dir)
    p_c, p_st, _ = tf.trace_rays_fused_plain(edge, cfg3, e_org, e_dir)
    torch.cuda.synchronize()
    rep = parity.compare(k_c, k_st, p_c, p_st)
    emit(phase="B2", case="f_box_edge_tie", status=k_st.tolist(), **rep)
    check(rep["ok"] and k_st.tolist() == [1, 3],
          f"B2 box-edge tie: {k_st.tolist()} {rep}")
    b2.append(rep)

    # ---- 4. B3 against its plain version -----------------------------------
    org, dir = pixel_rays(head_cam)
    scalar = (nh.nearest_hit_pallas_scalar, nh.nearest_hit_pallas_scalar_plain)
    b3 = [compare_hits("B3", "a_headline_bounce0", head, org, dir,
                       *scalar)[0]]
    o256, d256 = pixel_rays(cam256)
    o_r, d_r = random_rays(3001, seed=5, device=dev)
    b3.append(compare_hits("B3", "b_config1_glass_tri", glass,
                           torch.cat([o256, o_r]), torch.cat([d256, d_r]),
                           *scalar)[0])
    o512, d512 = pixel_rays(cam512)
    b3.append(compare_hits("B3", "c_near_miss_384", near_miss_field(384,
                                                                    device=dev),
                           o512, d512, *scalar)[0])

    # ---- 5. B4 against its plain version -----------------------------------
    dense = (nh.nearest_hit_pallas, nh.nearest_hit_pallas_plain)
    c3 = config3_scene(device=dev)
    c3_cam = config3_camera(dev)
    org3, dir3 = pixel_rays(c3_cam)
    b4 = [compare_hits("B4", "a_config3_bounce0", c3, org3, dir3, *dense)[0]]
    b4.append(compare_hits("B4", "b_near_miss_600", field, o512, d512,
                           *dense)[0])
    n_live = org3.shape[0] // 2 + 77
    rep, (k_t, k_pid) = compare_hits("B4", "c_config3_n_live", c3, org3, dir3,
                                     *dense, n_live=n_live)
    check(bool(torch.isinf(k_t[n_live:]).all())
          and bool((k_pid[n_live:] == -1).all()),
          "B4 rows past n_live are not misses")
    b4.append(rep)
    empty = SceneBuilder().build(dev)
    before = dict(nh.LAUNCHES)
    b4.append(compare_hits("B4", "d_empty_scene", empty, o_r, d_r,
                           *dense)[0])
    check(nh.LAUNCHES == before, "B4 launched on an empty scene")
    b4.append(compare_hits("B4", "e_box_edge", edge, e_org, e_dir,
                           *dense)[0])

    # ---- 6. the main path -----------------------------------------------------
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

    # ---- 7. main-PALLAS: config 3 through B4, the headline through B3 -------
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
    c3_cpu, small_cam = c3.to("cpu"), make_camera(*small)
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

    # ---- 8. times at the main paths' shapes --------------------------------
    tabs = tf.pack_tables(head, cam_pos=head_cam.pos)
    refr = tf._refr_pair(head, None)
    cam_arr = tf._cam_array(head_cam, refr)
    rid = torch.arange(org.shape[0], dtype=torch.int32, device=dev)
    kw = dict(refmax=cfg_head.refmax, atten=1.0, seed=DEFAULT_SEED)
    b1_ms = cuda_median_ms(lambda: tf.launch_frame(
        tabs, cam_arr, HEADLINE_W, HEADLINE_H, spp=1, sample=0, **kw))
    b1_plain_ms = cuda_median_ms(lambda: tf.trace_frame_fused_plain(
        head, cfg_head, head_cam))
    wrapper_ms = cuda_median_ms(lambda: tf.trace_frame_fused_cuda(
        head, cfg_head, head_cam))
    render_ms = cuda_median_ms(lambda: rt.render_hdr(head, head_cam, cfg_head))
    view_ms = cuda_median_ms(lambda: view.draw(
        exposure.accumulate(buf, hdr),
        ToneMapConfig(kind=ToneMapperKind.STDDEV_AROUND_MEAN)))
    b2_ms = cuda_median_ms(lambda: tf.launch_rays(
        tabs, refr, org, dir, rid, **kw))
    b2_plain_ms = cuda_median_ms(lambda: tf.trace_rays_fused_plain(
        head, cfg_head, org, dir))
    pixels = HEADLINE_W * HEADLINE_H
    for what, ms in (("B1 kernel", b1_ms), ("B1 plain", b1_plain_ms),
                     ("B1 wrapper (pack + launch)", wrapper_ms),
                     ("render_hdr FUSED", render_ms),
                     ("exposure + STDDEV tone map", view_ms),
                     ("B2 kernel", b2_ms), ("B2 plain", b2_plain_ms)):
        emit(phase="times", what=what, ms_per_frame=ms,
             primary_rays_per_s=pixels / (ms * 1e-3), w=HEADLINE_W,
             h=HEADLINE_H, refmax=cfg_head.refmax, prims=head.n_prims,
             frames=TIMED, card=name, nvidia_smi=smi)

    # B3 on the headline wavefront, B4 on config 3's; render_hdr PALLAS
    head_tabs, c3_tabs = nh.pack_tables(head), nh.pack_tables(c3)
    b3_ms = cuda_median_ms(lambda: nh.launch_scalar(head_tabs, org, dir))
    b3_plain_ms = cuda_median_ms(
        lambda: nh.nearest_hit_pallas_scalar_plain(head, org, dir))
    b4_ms = cuda_median_ms(lambda: nh.launch_dense(c3_tabs, org3, dir3))
    b4_plain_ms = cuda_median_ms(
        lambda: nh.nearest_hit_pallas_plain(c3, org3, dir3), warmup=1,
        timed=5)
    c3_render_ms = cuda_median_ms(lambda: rt.render_hdr(c3, c3_cam, cfg_c3),
                                  warmup=2, timed=10)
    head_pallas_ms = cuda_median_ms(
        lambda: rt.render_hdr(head, head_cam, cfg_head_p), warmup=2,
        timed=10)
    for what, ms, scene, cam, refmax, frames in (
            ("B3 kernel (one search)", b3_ms, head, head_cam, 1, TIMED),
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

    # ---- kernels summary and the last line ------------------------------------
    def worst(reps):
        return max(r["max_abs_err"] for r in reps)

    print(json.dumps({"kernels": [
        {"name": "trace_frame_kernel", "route": "cuda",
         "source": KERNEL_SOURCE,
         "replaces": "raytracer_js_tpu/kernels/trace_fused.py:678",
         "launches": launches["frame"], "max_abs_err": worst(b1),
         "ms": b1_ms, "plain_ms": b1_plain_ms},
        {"name": "trace_rays_kernel", "route": "cuda",
         "source": KERNEL_SOURCE,
         "replaces": "raytracer_js_tpu/kernels/trace_fused.py:636",
         "launches": launches["rays"], "max_abs_err": worst(b2),
         "ms": b2_ms, "plain_ms": b2_plain_ms},
        {"name": "nh_scalar_kernel", "route": "cuda", "source": NH_SOURCE,
         "replaces": "raytracer_js_tpu/kernels/nearest_hit.py:702",
         "launches": head_launches["scalar"], "max_abs_err": worst(b3),
         "ms": b3_ms, "plain_ms": b3_plain_ms},
        {"name": "nh_dense_kernel", "route": "cuda", "source": NH_SOURCE,
         "replaces": "raytracer_js_tpu/kernels/nearest_hit.py:91",
         "launches": c3_launches["dense"], "max_abs_err": worst(b4),
         "ms": b4_ms, "plain_ms": b4_plain_ms},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
