"""The headline scene (the JAX package's ``bench.build_scene``, as
``chip_smoke.headline_scene`` builds it on the port): a ground box,
``n_spheres`` spheres drawn from the seed (every third a mirror, the rest
diffuse, colors from an 8-entry palette) and one emitter."""
from __future__ import annotations

import numpy as np

from portbench.reference.scene import SceneSpec


def spec(config: dict, rng: np.random.Generator) -> SceneSpec:
    n = int(config["n_spheres"])
    centers = rng.uniform([2.0, -6.0, -0.5], [14.0, 6.0, 5.0], (n, 3))
    radii = rng.uniform(0.15, 0.6, n)
    palette = [rng.uniform(0.2, 1.0, 3) for _ in range(8)]
    # textures: sky, grey, white, the palette; materials: diffuse, mirror,
    # emitter
    tex = np.array([(0.35, 0.45, 0.65), (0.6, 0.6, 0.6), (1.0, 1.0, 1.0)]
                   + palette, np.float32)
    idx = np.arange(n)
    return SceneSpec(
        tex_rgb=tex, mat_mirror=np.array([False, True, False]),
        mat_light=np.array([False, False, True]), sky_tex=0,
        sphere_center=np.concatenate(
            [centers, [(8.0, 0.5, 6.0)]]).astype(np.float32),
        sphere_radius=np.concatenate([radii, [1.0]]).astype(np.float32),
        sphere_mat=np.concatenate([np.where(idx % 3 == 0, 1, 0), [2]]
                                  ).astype(np.int32),
        sphere_tex=np.concatenate([3 + idx % 8, [2]]).astype(np.int32),
        box_center=np.array([(0.0, 0.0, -51.0)], np.float32),
        box_half=np.full((1, 3), np.float32(100.0) / np.float32(2.0)),
        box_mat=np.zeros(1, np.int32), box_tex=np.ones(1, np.int32))
