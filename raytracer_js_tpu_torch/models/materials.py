"""Material table (port of ``raytracer_js_tpu.models.materials``).

The reference's virtual Material hierarchy (material.ts:29-103) becomes
columns indexed by material id, so shading dispatches with mask selects.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import ResponseType, resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MaterialTable:
    response: Tensor   # [M] i32: ResponseType
    light: Tensor      # [M] bool: is_light_source (material.ts:51-53)
    mirror: Tensor     # [M] bool: is_mirror (material.ts:44-46)
    roughness: Tensor  # [M] f32 in [0, 1] (material.ts:62-64)

    def to(self, device) -> "MaterialTable":
        return MaterialTable(*(getattr(self, f.name).to(device)
                               for f in dataclasses.fields(self)))


# The reference's four canned materials (materials/material_solid.ts:39-44),
# as (response, light, mirror, roughness) rows:
SIMPLE_SMOOTH = (ResponseType.REFLECTION, False, True, 0.0)
SIMPLE_LIGHT = (ResponseType.REFLECTION, True, False, 0.0)
SIMPLE_ROUGH = (ResponseType.REFLECTION, False, True, 0.5)
SIMPLE_TRANSPARENT = (ResponseType.TRANSMISSION, False, False, 0.0)


def make_material_table(rows, device=None) -> MaterialTable:
    """Build from a list of (response, light, mirror, roughness) tuples, on
    the card unless ``device`` says otherwise."""
    device = resolve_device(device)
    rows = list(rows)
    if not rows:
        rows = [SIMPLE_SMOOTH]
    return MaterialTable(
        response=torch.tensor([int(r[0]) for r in rows], dtype=torch.int32,
                              device=device),
        light=torch.tensor([bool(r[1]) for r in rows], dtype=torch.bool,
                           device=device),
        mirror=torch.tensor([bool(r[2]) for r in rows], dtype=torch.bool,
                            device=device),
        roughness=torch.tensor([float(r[3]) for r in rows],
                               dtype=torch.float32, device=device),
    )
