"""Scene and runtime validation — the sanitizer analogue.

Port of ``raytracer_js_tpu.utils.validate``. The reference's defensive
layer is scattered runtime throws (vector size checks, octree bounds,
walker sanity, UV bounds) and an acute-normal warning
(raytracer.ts:199-203). A wavefront cannot throw per lane, so the
equivalents are a structural check of the scene on the host, a host check
of a wavefront, and a finite-value check that reports a count.
"""
from __future__ import annotations

import sys
from typing import List

import numpy as np
import torch

from ..models.scene import Scene


class SceneValidationError(ValueError):
    pass


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def validate_scene(scene: Scene, strict: bool = True) -> List[str]:
    """Structural validation -> list of problem strings (raises when
    ``strict``). Checks the invariants every kernel assumes: id columns in
    range, positive radii and extents, finite geometry, valid materials."""
    problems: List[str] = []

    def chk(cond, msg):
        if not cond:
            problems.append(msg)

    p = scene.n_prims
    chk(tuple(scene.prim_material.shape) == (p,), "prim_material wrong shape")
    chk(tuple(scene.prim_texture.shape) == (p,), "prim_texture wrong shape")
    chk(tuple(scene.prim_substance.shape) == (p,),
        "prim_substance wrong shape")

    n_mat = scene.materials.response.shape[0]
    n_tex = scene.textures.kind.shape[0]
    n_sub = scene.sub_refr.shape[0]
    if p:
        mat, tex = _np(scene.prim_material), _np(scene.prim_texture)
        sub = _np(scene.prim_substance)
        chk(((mat >= 0) & (mat < n_mat)).all(), "material id out of range")
        chk(((tex >= 0) & (tex < n_tex)).all(), "texture id out of range")
        chk(((sub >= -1) & (sub < n_sub)).all(), "substance id out of range")

    for name in ("sphere_center", "sphere_radius", "box_center", "box_half",
                 "tri_v0", "tri_v1", "tri_v2"):
        chk(np.isfinite(_np(getattr(scene, name))).all(),
            f"{name} contains non-finite values")
    chk((_np(scene.sphere_radius) > 0).all() or scene.n_spheres == 0,
        "non-positive sphere radius")
    chk((_np(scene.box_half) > 0).all() or scene.n_boxes == 0,
        "non-positive box extent")
    rough = _np(scene.materials.roughness)
    chk(((rough >= 0) & (rough <= 1)).all(), "roughness outside [0, 1]")
    chk((_np(scene.sub_refr) > 0).all(), "non-positive refractive index")
    chk(0 <= scene.sky_tex < n_tex, "sky texture id out of range")
    chk(bool(np.isfinite(_np(scene.textures.solid_rgb)).all()),
        "non-finite texture colors")

    if strict and problems:
        raise SceneValidationError("; ".join(problems))
    return problems


def assert_rays_sane(org: torch.Tensor, dir: torch.Tensor) -> None:
    """Host-side wavefront sanity (the walker's set_position check,
    octree_space.ts:232-238): finite origins, near-unit directions."""
    if not np.isfinite(_np(org)).all():
        raise SceneValidationError("non-finite ray origins")
    n = np.linalg.norm(_np(dir), axis=-1)
    if not np.allclose(n, 1.0, atol=1e-3):
        raise SceneValidationError(
            f"ray directions not unit (|d| in [{n.min():.4f}, {n.max():.4f}])")


def finite_or_debug(x: torch.Tensor, name: str = "value") -> torch.Tensor:
    """Count the non-finite lanes of ``x`` and report a non-zero count on
    stderr (per-lane throws are impossible on a wavefront: the
    acute-normal console.warn analogue, raytracer.ts:199-203); returns
    ``x``. Reading the count waits for the device."""
    bad = x.numel() - int(torch.isfinite(x).sum())
    if bad:
        print(f"[raytracer_js_tpu_torch] {bad} non-finite lanes in {name}",
              file=sys.stderr)
    return x
