"""The benchmark's scene description, and its tensors for the reference.

A :class:`SceneSpec` is what a configuration's recipe draws from the seed:
numpy arrays, nothing built by the program. The harness hands the same
spec to the program (through its public scene builder) and to the
reference (:func:`tensors`).

Global primitive ids are ordered [spheres | boxes], as the program orders
them: on a tie in ``t`` the lower id wins on both sides.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SceneSpec:
    tex_rgb: np.ndarray        # [T, 3] f32 solid texture colors
    mat_mirror: np.ndarray     # [M] bool
    mat_light: np.ndarray      # [M] bool (emissive)
    sky_tex: int               # texture id of the solid sky
    sphere_center: np.ndarray  # [S, 3] f32
    sphere_radius: np.ndarray  # [S] f32
    sphere_mat: np.ndarray     # [S] i32
    sphere_tex: np.ndarray     # [S] i32
    box_center: np.ndarray     # [B, 3] f32
    box_half: np.ndarray       # [B, 3] f32 half edge lengths
    box_mat: np.ndarray        # [B] i32
    box_tex: np.ndarray        # [B] i32

    @property
    def n_spheres(self) -> int:
        return int(self.sphere_center.shape[0])

    @property
    def n_boxes(self) -> int:
        return int(self.box_center.shape[0])

    @property
    def n_prims(self) -> int:
        return self.n_spheres + self.n_boxes


@dataclasses.dataclass(frozen=True)
class RefScene:
    """The spec as tensors. The float leaves (``sphere_center``,
    ``sphere_radius``, ``box_center``, ``box_half``, ``tex_rgb``) are what
    the control casts to its lower precision."""

    sphere_center: torch.Tensor
    sphere_radius: torch.Tensor
    box_center: torch.Tensor
    box_half: torch.Tensor
    tex_rgb: torch.Tensor
    prim_tex: torch.Tensor     # [P] long
    prim_mirror: torch.Tensor  # [P] bool
    prim_light: torch.Tensor   # [P] bool
    sky_tex: int

    @property
    def n_spheres(self) -> int:
        return self.sphere_center.shape[0]

    @property
    def n_boxes(self) -> int:
        return self.box_center.shape[0]

    @property
    def n_prims(self) -> int:
        return self.n_spheres + self.n_boxes

    #: names of the float leaves, in the order :func:`leaves` gives them
    LEAVES = ("sphere_center", "sphere_radius", "box_center", "box_half",
              "tex_rgb")

    def leaves(self):
        return [getattr(self, k) for k in self.LEAVES]

    def with_leaves(self, values) -> "RefScene":
        return dataclasses.replace(self, **dict(zip(self.LEAVES, values)))


def tensors(spec: SceneSpec, device, dtype=torch.float32) -> RefScene:
    """The spec on ``device``, its floats in ``dtype``."""
    def f(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device
                               ).to(dtype)

    mat = np.concatenate([spec.sphere_mat, spec.box_mat]).astype(np.int64)
    tex = np.concatenate([spec.sphere_tex, spec.box_tex]).astype(np.int64)
    return RefScene(
        sphere_center=f(spec.sphere_center).reshape(-1, 3),
        sphere_radius=f(spec.sphere_radius).reshape(-1),
        box_center=f(spec.box_center).reshape(-1, 3),
        box_half=f(spec.box_half).reshape(-1, 3),
        tex_rgb=f(spec.tex_rgb).reshape(-1, 3),
        prim_tex=torch.as_tensor(tex, device=device),
        prim_mirror=torch.as_tensor(np.asarray(spec.mat_mirror, bool)[mat],
                                    device=device),
        prim_light=torch.as_tensor(np.asarray(spec.mat_light, bool)[mat],
                                   device=device),
        sky_tex=int(spec.sky_tex))
