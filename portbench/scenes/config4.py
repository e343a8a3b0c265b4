"""BASELINE config 4 (the JAX package's ``bench.build_config4_scene``, as
``chip_smoke.config4_scene`` builds it on the port): ``n_prims - 2`` small
spheres drawn from the seed, uniform over a slab ahead of the camera (every
third a mirror, colors from a 16-entry palette), a ground box and an
emitter."""
from __future__ import annotations

import numpy as np

from portbench.reference.scene import SceneSpec


def spec(config: dict, rng: np.random.Generator) -> SceneSpec:
    n = int(config["n_prims"]) - 2
    centers = rng.uniform([4.0, -20.0, -1.0], [44.0, 20.0, 7.0], (n, 3))
    radii = rng.uniform(0.05, 0.18, n)
    palette = [rng.uniform(0.2, 1.0, 3) for _ in range(16)]
    tex = np.array([(0.35, 0.45, 0.65), (0.6, 0.6, 0.6), (1.0, 1.0, 1.0)]
                   + palette, np.float32)
    idx = np.arange(n)
    return SceneSpec(
        tex_rgb=tex, mat_mirror=np.array([False, True, False]),
        mat_light=np.array([False, False, True]), sky_tex=0,
        sphere_center=np.concatenate(
            [centers, [(24.0, 0.0, 14.0)]]).astype(np.float32),
        sphere_radius=np.concatenate([radii, [3.0]]).astype(np.float32),
        sphere_mat=np.concatenate([np.where(idx % 3 == 0, 1, 0), [2]]
                                  ).astype(np.int32),
        sphere_tex=np.concatenate([3 + idx % 16, [2]]).astype(np.int32),
        box_center=np.array([(20.0, 0.0, -52.0)], np.float32),
        box_half=np.full((1, 3), np.float32(100.0) / np.float32(2.0)),
        box_mat=np.zeros(1, np.int32), box_tex=np.ones(1, np.int32))
