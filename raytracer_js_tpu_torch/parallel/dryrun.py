"""A sharded training dry run at tiny shapes, on the caller's mesh.

Port of the reference's ``dryrun_multichip`` (its root ``__graft_entry__``):
the three gradient modes of the production fit, each one step over every
rank of ``mesh``. Every rank calls :func:`dryrun_multichip` with its mesh.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..accel import octree
from ..config import HitBackend, OctreeConfig, RenderConfig, ResponseType
from ..models.camera import make_camera
from ..models.scene import Scene, SceneBuilder
from ..optim.fit import FitConfig, fit
from .sharding import Mesh, sharded_fit_step


def demo_scene(n_spheres: int = 16, device=None) -> Scene:
    """The dry run's scene (the reference's ``_demo_scene``): a ground box,
    ``n_spheres`` diffuse and mirror spheres from numpy seed 42, a light."""
    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0.35, 0.45, 0.65)))
    grey = b.add_solid_texture((0.6, 0.6, 0.6))
    white = b.add_solid_texture((1.0, 1.0, 1.0))
    diffuse = b.add_material(ResponseType.REFLECTION)
    mirror = b.add_material(ResponseType.REFLECTION, mirror=True)
    light = b.add_material(ResponseType.REFLECTION, light=True)
    b.add_box((0.0, 0.0, -51.0), 100.0, diffuse, grey)
    rng = np.random.default_rng(42)
    for i in range(n_spheres):
        c = rng.uniform([2.0, -3.0, -0.5], [8.0, 3.0, 2.5])
        r = rng.uniform(0.2, 0.7)
        tex = b.add_solid_texture(rng.uniform(0.2, 1.0, 3))
        b.add_sphere(c, float(r), (diffuse, mirror)[i % 2], tex)
    b.add_sphere((5.0, 0.5, 3.0), 0.8, light, white)
    return b.build(device=device)


def dryrun_multichip(mesh: Mesh, seed: int = 0) -> Tuple[float, float,
                                                          float]:
    """One step of each gradient mode over ``mesh`` -> their three losses:

    (a) ``sharded_fit_step`` (render, pixel loss, grad, all-reduce);
    (b) an OCTREE ``fit(mesh=...)`` with a depth-3 accel and
        ``replay_every=1``: per-shard recording and the replay gradient;
    (c) ``fit(mesh=..., fit_cameras=True)``: rays made per rank from the
        rebuilt cameras and sliced.

    The camera is 8 * world_size by 8 pixels: 64 rays a rank.
    """
    dev = mesh.device
    scene = demo_scene(n_spheres=4, device=dev)
    cfg = RenderConfig(refmax=2)
    cam = make_camera((0.0, 0.0, 0.5), 8 * mesh.world_size, 8, np.pi / 2,
                      np.pi / 2, device=dev)
    target = torch.zeros((cam.h * cam.w, 3), dtype=torch.float32,
                         device=dev)
    loss, _ = sharded_fit_step(mesh, scene, cfg, cam, target, seed)
    accel = octree.build_octree(scene, OctreeConfig(max_depth=3))
    res = fit(scene, RenderConfig(refmax=2, backend=HitBackend.OCTREE),
              [cam], target[None], FitConfig(steps=1, lr=1e-2,
                                             replay_every=1),
              seed=seed, mesh=mesh, accel=accel)
    res_c = fit(scene, cfg, [cam], target[None],
                FitConfig(steps=1, lr=1e-2, fit_cameras=True), seed=seed,
                mesh=mesh)
    return float(loss), res.losses[0], res_c.losses[0]
