"""The differentiable-parameter partition of a scene.

Port of ``raytracer_js_tpu.parallel.sharding.float_partition``. The rest of
that module (ray-sharded rendering and the sharded fit step over a device
mesh) is not ported yet (ROADMAP A13).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

import torch

from ..models.scene import Scene

Tensor = torch.Tensor


def _float_paths(obj, prefix=()) -> List[tuple]:
    """Field paths of the floating-point tensors of a (nested) dataclass,
    in field-declaration order."""
    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out += _float_paths(v, prefix + (f.name,))
        elif isinstance(v, torch.Tensor) and v.is_floating_point():
            out.append(prefix + (f.name,))
    return out


def _get(obj, path):
    for name in path:
        obj = getattr(obj, name)
    return obj


def _replace(obj, path, value):
    if len(path) == 1:
        return dataclasses.replace(obj, **{path[0]: value})
    inner = getattr(obj, path[0])
    return dataclasses.replace(
        obj, **{path[0]: _replace(inner, path[1:], value)})


def float_leaf_names(scene: Scene) -> List[str]:
    """Dotted field names of :func:`float_partition`'s params, in order."""
    return [".".join(p) for p in _float_paths(scene)]


def float_partition(scene: Scene) -> Tuple[List[Tensor],
                                            Callable[[list], Scene]]:
    """Split a scene into ``(params, rebuild)``.

    ``params`` lists the float tensors — the differentiable degrees of
    freedom — in the reference package's pytree order: ``sphere_center,
    sphere_radius, box_center, box_half, tri_v0, tri_v1, tri_v2,
    materials.roughness, textures.solid_rgb, textures.atlas, sub_refr,
    default_refr``. ``rebuild(new_params)`` returns the scene with those
    tensors replaced; integer id columns and static fields stay.
    """
    paths = _float_paths(scene)
    params = [_get(scene, p) for p in paths]

    def rebuild(new_params) -> Scene:
        new_params = list(new_params)
        if len(new_params) != len(paths):
            raise ValueError(f"expected {len(paths)} params, got "
                             f"{len(new_params)}")
        out = scene
        for p, v in zip(paths, new_params):
            out = _replace(out, p, v)
        return out

    return params, rebuild
