"""Spatial containment predicates.

Port of ``raytracer_js_tpu.ops.space`` (reference space.ts:40-128): the
scalar point, box and overlap functions as broadcasting predicates over
``[..., 3]`` batches. ``RangeCoverage`` is the reference's interval
convention: CLOSE_OPEN ``[lo, hi)`` (octree cells), OPEN_CLOSE
``(lo, hi]``, FULL ``[lo, hi]``.
"""
from __future__ import annotations

import enum
from typing import Tuple

import torch

Tensor = torch.Tensor


class RangeCoverage(enum.IntEnum):
    """Interval endpoint convention (reference space.ts:40-52)."""

    CLOSE_OPEN = 0   # [lo, hi) — octree cells
    OPEN_CLOSE = 1   # (lo, hi]
    FULL = 2         # [lo, hi]


def point_in_space(point: Tensor, pos: Tensor, size: Tensor,
                   coverage: RangeCoverage = RangeCoverage.CLOSE_OPEN
                   ) -> Tensor:
    """Is ``point`` inside the box at ``pos`` with extent ``size``
    (space.ts:55-82)? Broadcasts over leading dims -> bool[...]."""
    hi = pos + size
    if coverage == RangeCoverage.CLOSE_OPEN:
        ok = (point >= pos) & (point < hi)
    elif coverage == RangeCoverage.OPEN_CLOSE:
        ok = (point > pos) & (point <= hi)
    else:
        ok = (point >= pos) & (point <= hi)
    return ok.all(dim=-1)


def space_in_space(inner_pos: Tensor, inner_size: Tensor, outer_pos: Tensor,
                   outer_size: Tensor) -> Tensor:
    """Full containment of one box in another (space.ts:85-97)."""
    return ((inner_pos >= outer_pos)
            & (inner_pos + inner_size <= outer_pos + outer_size)).all(dim=-1)


def aabb_in_space(aabb_pos: Tensor, aabb_size, outer_pos: Tensor,
                  outer_size: Tensor) -> Tensor:
    """Cubic-AABB containment (space.ts:99-103): ``aabb_size`` is the
    scalar edge length."""
    size = torch.as_tensor(aabb_size, dtype=aabb_pos.dtype,
                           device=aabb_pos.device)[..., None]
    return space_in_space(aabb_pos, size.expand(aabb_pos.shape), outer_pos,
                          outer_size)


def get_overlap_space(pos_a: Tensor, size_a: Tensor, pos_b: Tensor,
                      size_b: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Intersection box of two boxes -> (pos, size, nonempty)
    (space.ts:106-120); ``size`` is clamped at 0 where they are disjoint."""
    lo = torch.maximum(pos_a, pos_b)
    hi = torch.minimum(pos_a + size_a, pos_b + size_b)
    size = torch.clamp(hi - lo, min=0.0)
    return lo, size, (size > 0.0).all(dim=-1)


def aabb_overlap_volume(pos_a: Tensor, size_a: Tensor, pos_b: Tensor,
                        size_b: Tensor) -> Tensor:
    """Overlap volume (space.ts:122-128); 0 where disjoint."""
    return get_overlap_space(pos_a, size_a, pos_b, size_b)[1].prod(dim=-1)
