"""The wavefront shade kernel: one launch for a bounce's shading
(``csrc/shade.cu``, ``shade_bounce_kernel``).

It replaces ``ops/trace._shade`` (and, on a trace's last bounce, the
epilogue of ``ops/trace.trace_rays``) for the scenes of its class, on CUDA
tensors: the surface recompute of each winner, the texture and material
gathers, the mirror reflection with the rough scatter, the sky, the status
decisions and the respawn, which the plain twin spreads over ~240 PyTorch
launches a bounce. The JAX reference has no Pallas kernel for it (XLA
fuses that glue). It equals the plain ``_shade`` (with the epilogue where
``last``) bit for bit in every column.

``ops/trace._shader`` decides once per ``trace_rays`` or
``record_paths`` call, and once per TILED frame, whether the kernel shades
(:func:`engages`): CUDA tensors, a scene in the class (:func:`supports`)
and nothing that autograd would record (``models/scene.records_grad``,
the test ``ops/trace.refuse_grad`` makes too). Everything else keeps the
plain ``_shade``. ``LAUNCHES`` counts the kernel's launches (``"shade"``)
and the bounces on CUDA tensors that took the plain ``_shade``
(``"plain"``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models.scene import records_grad
from . import _build

Tensor = torch.Tensor

LAUNCHES = {"shade": 0, "plain": 0}


def supports(scene) -> bool:
    """The kernel's class: solid textures (so a solid equirect sky), no
    cube-map sky, no transmission (and so no BOTH)."""
    return (not scene.textures.has_images and scene.sky_box is None
            and not scene.has_transmission and not scene.has_both)


def engages(scene, *tensors: Tensor) -> bool:
    """Whether the kernel shades a wavefront of these state ``tensors``:
    CUDA tensors, a scene in the class, and nothing autograd would record
    (grad off, or no tensor given and no float tensor of the scene requires
    grad)."""
    return (not _build.on_cpu(tensors[0].device) and supports(scene)
            and not records_grad(scene, *tensors))


def count_plain(device: torch.device) -> None:
    """Count a bounce on the card that took the plain ``_shade``."""
    if not _build.on_cpu(device):
        LAUNCHES["plain"] += 1


def launch(scene, org: Tensor, dir: Tensor, color: Tensor, path: Tensor,
           status: Tensor, pid: Tensor, bounce, rng=None, last: bool = False,
           atten: float = 1.0
           ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Shade one bounce of n rays on the current stream -> (org, dir,
    color [n, 3], path [n], status [n] i32, alive [n] bool), new tensors;
    the substance index never changes in the class. ``pid`` [n] is each
    ray's winner (-1 = miss); ``bounce`` the RNG's bounce index, an int or
    a per-ray [n] int tensor; ``rng`` = (seed, ray ids [n]) where the scene
    is rough. ``last`` applies ``trace_rays``'s epilogue with the
    attenuation factor ``atten``. Does not synchronize."""
    dev = org.device
    if _build.on_cpu(dev):
        raise ValueError(f"the shade kernel needs CUDA tensors, got {dev}")
    n = org.shape[0]
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    org, dir, color, path, status = (
        x.contiguous() for x in (org, dir, color, path, status))
    pid = pid.to(torch.int32).contiguous()
    for x, name, dtype, shape in (
            (org, "org", f32, (n, 3)), (dir, "dir", f32, (n, 3)),
            (color, "color", f32, (n, 3)), (path, "path", f32, (n,)),
            (status, "status", i32, (n,)), (pid, "pid", i32, (n,))):
        _build.need(x, name, dtype, shape, dev)
    outs = (torch.empty((n, 3), dtype=f32, device=dev),
            torch.empty((n, 3), dtype=f32, device=dev),
            torch.empty((n, 3), dtype=f32, device=dev),
            torch.empty((n,), dtype=f32, device=dev),
            torch.empty((n,), dtype=i32, device=dev),
            torch.empty((n,), dtype=u8, device=dev))
    if n == 0:
        return outs
    bounce_t: Optional[Tensor] = None
    if isinstance(bounce, Tensor):
        bounce_t = _build.need(bounce.to(i32).contiguous(), "bounce", i32,
                               (n,), dev)
        bounce = 0
    rid, seed = None, 0
    if scene.has_rough:
        seed, rid = rng
        rid = _build.need(rid.to(i32).contiguous(), "rid", i32, (n,), dev)
    ns, nb, nt = scene.n_spheres, scene.n_boxes, scene.n_tris
    prims = _build.prim_ptrs(scene, dev)
    m, tex = scene.materials, scene.textures
    n_mat, n_tex = m.response.shape[0], tex.solid_rgb.shape[0]
    tables = [
        _build.ptr(_build.need(scene.prim_material, "prim_material", i32,
                               (ns + nb + nt,), dev)),
        _build.ptr(_build.need(scene.prim_texture, "prim_texture", i32,
                               (ns + nb + nt,), dev)),
        _build.ptr(_build.need(m.response, "response", i32, (n_mat,), dev)),
        _build.ptr(_build.need(m.light, "light", u8, (n_mat,), dev)),
        _build.ptr(_build.need(m.mirror, "mirror", u8, (n_mat,), dev)),
        _build.ptr(_build.need(m.roughness.detach(), "roughness", f32,
                               (n_mat,), dev)),
        _build.ptr(_build.need(tex.solid_rgb.detach(), "solid_rgb", f32,
                               (n_tex, 3), dev)),
        min(max(int(scene.sky_tex), 0), n_tex - 1)]
    lib = _build.load()
    err = lib.rt_shade_bounce(
        *prims, *tables, _build.ptr(org), _build.ptr(dir), _build.ptr(color),
        _build.ptr(path), _build.ptr(status), _build.ptr(pid),
        _build.ptr(bounce_t), int(bounce), _build.ptr(rid),
        int(scene.has_rough), int(seed) & 0xFFFFFFFF, int(last),
        float(atten), n, *(_build.ptr(x) for x in outs), dev.index or 0,
        _build.stream(dev))
    _build.check(lib, err, "shade_bounce_kernel")
    LAUNCHES["shade"] += 1
    return outs
