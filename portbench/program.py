"""The system under test, as the benchmark drives it: the port's public
entry points and nothing else. Every call from the harness into the
program goes through this module, so a test can put a broken program in
its place."""
from __future__ import annotations

import numpy as np

import raytracer_js_tpu_torch as rt
from raytracer_js_tpu_torch import render_tiled
from raytracer_js_tpu_torch.accel.octree import build_octree

from .reference.scene import SceneSpec


def build_scene(spec: SceneSpec, device):
    """The spec through the program's scene builder, as a user builds a
    scene."""
    b = rt.SceneBuilder()
    for rgb in spec.tex_rgb:
        b.add_solid_texture(rgb)
    b.set_sky(int(spec.sky_tex))
    for mirror, light in zip(spec.mat_mirror, spec.mat_light):
        b.add_material(rt.ResponseType.REFLECTION, light=bool(light),
                       mirror=bool(mirror))
    for c, r, m, t in zip(spec.sphere_center, spec.sphere_radius,
                          spec.sphere_mat, spec.sphere_tex):
        b.add_sphere(c, float(r), int(m), int(t))
    for c, h, m, t in zip(spec.box_center, spec.box_half, spec.box_mat,
                          spec.box_tex):
        b.add_box(c, np.float32(2.0) * h, int(m), int(t))
    return b.build(device)


def camera(pos, w: int, h: int, fov_h: float, fov_v: float, yaw: float,
           device):
    return rt.make_camera(pos, w, h, fov_h, fov_v, rot_h=yaw, device=device)


def render_config(refmax: int, spp: int, backend: str):
    return rt.RenderConfig(refmax=refmax, spp=spp,
                           backend=rt.HitBackend[backend.upper()])


def render(scene, cam, cfg, seed: int, accel=None, tables=None):
    return rt.render_hdr(scene, cam, cfg, seed=seed, accel=accel,
                         tables=tables)


def octree(scene, max_depth: int):
    return build_octree(scene, rt.OctreeConfig(max_depth=max_depth))


def frame_tables(scene, cam):
    return render_tiled.frame_tables(scene, cam)

