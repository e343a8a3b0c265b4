"""Procedural triangle meshes (port of ``raytracer_js_tpu.utils.mesh``).

numpy only, so scenes with meshes build on a machine without jax; the
output is array for array the reference package's.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def icosphere(subdivisions: int = 2, radius: float = 1.0,
              center=(0.0, 0.0, 0.0)) -> Tuple[np.ndarray, np.ndarray]:
    """Subdivided icosahedron -> (vertices [V, 3] f32, faces [T, 3] i32),
    T = 20 * 4^subdivisions (4 -> 5120, BASELINE config 3's mesh)."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)

    for _ in range(subdivisions):
        vlist = list(verts)
        cache = {}

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = (verts[a] + verts[b]) / 2.0
                vlist.append(m / np.linalg.norm(m))
                cache[key] = len(vlist) - 1
            return cache[key]

        new_faces = []
        for f in faces:
            a, b, c = (int(x) for x in f)
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, np.int64)

    verts = verts * radius + np.asarray(center, np.float64)
    return verts.astype(np.float32), faces.astype(np.int32)


def grid_plane(nx: int, ny: int, size: float = 1.0,
               center=(0.0, 0.0, 0.0)) -> Tuple[np.ndarray, np.ndarray]:
    """Triangulated XY plane grid -> 2*nx*ny triangles."""
    xs = np.linspace(-size / 2, size / 2, nx + 1)
    ys = np.linspace(-size / 2, size / 2, ny + 1)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    verts = np.stack([gx, gy, np.zeros_like(gx)], axis=-1).reshape(-1, 3)
    verts = (verts + np.asarray(center)).astype(np.float32)
    faces = []
    for i in range(nx):
        for j in range(ny):
            a = i * (ny + 1) + j
            b = a + (ny + 1)
            faces += [[a, b, a + 1], [b, b + 1, a + 1]]
    return verts, np.asarray(faces, np.int32)


def mesh_stats(verts: np.ndarray, faces: np.ndarray) -> dict:
    """Vertex and triangle counts and the total surface area."""
    e = verts[faces]
    n = np.cross(e[:, 1] - e[:, 0], e[:, 2] - e[:, 0])
    area = 0.5 * np.linalg.norm(n, axis=1)
    return {"n_verts": int(verts.shape[0]), "n_tris": int(faces.shape[0]),
            "area": float(area.sum())}
