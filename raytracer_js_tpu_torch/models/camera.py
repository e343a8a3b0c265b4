"""Equiangular camera (port of ``raytracer_js_tpu.models.camera``).

Pixel directions come from the closed form

    dir(x, y) = cos(th_h) * cos(th_v) * front
              + cos(th_h) * sin(th_v) * up
              + sin(th_h) * left

with ``th_h = (x - w//2) * fov_h / w`` and ``th_v = (y - h//2) * fov_v / h``
— what the reference's incremental Givens steps (camera.ts:207-250)
compose to. The angle step ``fov / size`` is taken in Python double and
rounded once to f32, exactly as the reference package and the frame kernel
(``csrc/trace_fused.cu``) do.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..config import resolve_device
from ..ops import vecmath as vm

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pose tensors plus the static screen size and fields of view."""

    pos: Tensor     # [3]
    front: Tensor   # [3] unit
    left: Tensor    # [3] unit
    up: Tensor      # [3] unit
    fov_h: float = math.pi / 2
    fov_v: float = math.pi / 2
    w: int = 128
    h: int = 128

    @property
    def device(self) -> torch.device:
        return self.pos.device

    def to(self, device) -> "Camera":
        return dataclasses.replace(self, pos=self.pos.to(device),
                                   front=self.front.to(device),
                                   left=self.left.to(device),
                                   up=self.up.to(device))


def camera_from_numpy(arrays: dict, *, fov_h: float, fov_v: float, w: int,
                      h: int, device=None) -> Camera:
    """Build a :class:`Camera` from numpy ``pos``, ``front``, ``left`` and
    ``up`` arrays (the reference package's ``Camera`` fields), on the card
    unless ``device`` says otherwise."""
    device = resolve_device(device)

    def vec(k):
        return torch.as_tensor(np.array(arrays[k], np.float32),
                               device=device).reshape(3)

    return Camera(pos=vec("pos"), front=vec("front"), left=vec("left"),
                  up=vec("up"), fov_h=float(fov_h), fov_v=float(fov_v),
                  w=int(w), h=int(h))


def make_camera(pos, w: int, h: int, fov_h: float, fov_v: float,
                rot_h: float = 0.0, rot_v: float = 0.0,
                device=None) -> Camera:
    """Identity triad front=(1,0,0), left=(0,1,0), up=(0,0,1)
    (camera.ts:64-66), then optional rotations (camera.ts:70-74). On the
    card unless ``device`` says otherwise."""
    device = resolve_device(device)

    def vec(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    cam = Camera(pos=torch.as_tensor(pos, dtype=torch.float32,
                                     device=device).reshape(3),
                 front=vec([1.0, 0.0, 0.0]), left=vec([0.0, 1.0, 0.0]),
                 up=vec([0.0, 0.0, 1.0]),
                 fov_h=float(fov_h), fov_v=float(fov_v), w=int(w), h=int(h))
    if rot_h:
        cam = rotate_h(cam, rot_h)
    if rot_v:
        cam = rotate_v(cam, rot_v)
    return cam


def _cos_sin(angle, like: Tensor):
    a = torch.as_tensor(angle, dtype=torch.float32, device=like.device)
    return torch.cos(a), torch.sin(a)


def rotate_h(cam: Camera, angle) -> Camera:
    """Yaw: rotate the XY projections of front/left and rebuild
    up = front x left (camera.ts:121-130)."""
    c, s = _cos_sin(angle, cam.pos)
    fr_xy = cam.front[:2]
    lf_xy = cam.left[:2]
    fr_xy, _ = vm.rotate_vectors(fr_xy, vm.ortho2(fr_xy), c, s)
    lf_xy, _ = vm.rotate_vectors(lf_xy, vm.ortho2(lf_xy), c, s)
    front = torch.cat([fr_xy, cam.front[2:]])
    left = torch.cat([lf_xy, cam.left[2:]])
    up = vm.cross(front, left)
    return dataclasses.replace(cam, front=front, left=left, up=up)


def rotate_v(cam: Camera, angle, lock: bool = False) -> Camera:
    """Pitch: rotate the (front, up) pair (camera.ts:134-145); ``lock``
    rejects a rotation that would turn up's Z negative."""
    c, s = _cos_sin(angle, cam.pos)
    front, up = vm.rotate_vectors(cam.front, cam.up, c, s)
    if lock:
        ok = up[2] >= 0.0
        front = torch.where(ok, front, cam.front)
        up = torch.where(ok, up, cam.up)
    return dataclasses.replace(cam, front=front, up=up)


def move(cam: Camera, delta) -> Camera:
    """Translate (camera.ts:162-164)."""
    d = torch.as_tensor(delta, dtype=torch.float32, device=cam.device)
    return dataclasses.replace(cam, pos=cam.pos + d)


def move_xy_forward(cam: Camera, scale=1.0) -> Camera:
    """WASD-style planar move along the XY projection of front
    (camera.ts:167-170)."""
    fr = cam.front[:2]
    fr = fr / (torch.linalg.vector_norm(fr) + 1e-20)
    return move(cam, torch.cat([fr * scale, torch.zeros_like(cam.pos[:1])]))


def renormalized(cam: Camera) -> Camera:
    """Re-orthonormalize the triad (Gram-Schmidt) after gradient updates."""
    f = vm.normalize(cam.front)
    lf = cam.left - vm.dot(cam.left, f) * f
    lf = vm.normalize(lf)
    return dataclasses.replace(cam, front=f, left=lf, up=vm.cross(f, lf))


def angle_steps(cam: Camera):
    """(step_h, step_v, off_h, off_v): the f32 angle step per pixel and the
    integer center offsets of the closed form."""
    return (float(torch.tensor(cam.fov_h / cam.w, dtype=torch.float32)),
            float(torch.tensor(cam.fov_v / cam.h, dtype=torch.float32)),
            cam.w // 2, cam.h // 2)


def pixel_rays(cam: Camera):
    """Closed-form per-pixel unit directions -> (org [h*w, 3], dir [h*w, 3]),
    row-major over (y, x)."""
    step_h, step_v, off_h, off_v = angle_steps(cam)
    f32 = torch.float32
    x = torch.arange(cam.w, dtype=f32, device=cam.device)
    y = torch.arange(cam.h, dtype=f32, device=cam.device)
    th_h = (x - off_h) * step_h                       # [w]
    th_v = (y - off_v) * step_v                       # [h]
    ch, sh = torch.cos(th_h)[None, :], torch.sin(th_h)[None, :]   # [1, w]
    cv, sv = torch.cos(th_v)[:, None], torch.sin(th_v)[:, None]   # [h, 1]
    a1 = (ch * cv)[..., None]
    a2 = (ch * sv)[..., None]
    d = a1 * cam.front + a2 * cam.up + sh[..., None] * cam.left
    d = d.reshape(-1, 3)
    org = cam.pos.expand_as(d).contiguous()
    return org, d
