"""The octree's fine grid on the card (``csrc/octree_build.cu``): the CSR
scatter of the fine prims into the finest cells and the chessboard skip
field, for ``accel/octree.build_octree`` on a scene whose tensors are on
the card.

They replace the host's ``native.grid_csr`` and scipy's distance transform,
which stay the path of CPU scenes and the plain versions the card is held
to: :func:`count` (with a scan and the build's one read of the pair total
and the largest count), :func:`fill` and :func:`skip_field` give the same
``cell_offsets``, ``cell_ids``, ``max_per_cell`` and ``skip_dist`` array
for array. The reference package builds on the host and has no kernel for
it. ``LAUNCHES`` counts each pass's launches.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils.profiling import span
from . import _build

Tensor = torch.Tensor

LAUNCHES = {"count": 0, "fill": 0, "sort": 0, "skip": 0}

_INT32_MAX = 2 ** 31 - 1


def _prims(lo: Tensor, hi: Tensor, fine: Tensor, root_lo: np.ndarray,
           root_size: float, depth: int) -> list:
    """What count and fill take: lo, hi [n, 3] f32 and fine [n] u8 on the
    card, n, the root as float32 (as ``native.grid_csr`` rounds it) and the
    depth."""
    dev = lo.device
    if _build.on_cpu(dev):
        raise ValueError(f"the octree build kernels need CUDA tensors, got "
                         f"{dev}")
    n = lo.shape[0]
    _build.need(lo, "lo", torch.float32, (n, 3), dev)
    _build.need(hi, "hi", torch.float32, (n, 3), dev)
    _build.need(fine, "fine", torch.uint8, (n,), dev)
    rl = np.asarray(root_lo, np.float32)
    return [_build.ptr(lo), _build.ptr(hi), _build.ptr(fine), n,
            *(float(v) for v in rl), float(root_size), int(depth)]


def count(lo: Tensor, hi: Tensor, fine: Tensor, root_lo: np.ndarray,
          root_size: float, depth: int) -> Tuple[Tensor, int, int]:
    """The count pass and the scan -> (cell_offsets [R^3 + 1] i32, the pair
    total, max_per_cell); the two ints are read back in one ``rt.sync``
    span. Raises "octree CSR overflow" past int32 pairs, as
    ``native.grid_csr`` does."""
    args = _prims(lo, hi, fine, root_lo, root_size, depth)
    dev = lo.device
    cells = (1 << depth) ** 3
    counts = torch.zeros((cells,), dtype=torch.int32, device=dev)
    lib = _build.load()
    _build.check(lib, lib.rt_octree_count(*args, _build.ptr(counts),
                                          dev.index or 0, _build.stream(dev)),
                 "octree count_kernel")
    LAUNCHES["count"] += 1
    offsets = torch.zeros((cells + 1,), dtype=torch.int32, device=dev)
    torch.cumsum(counts, 0, dtype=torch.int32, out=offsets[1:])
    with span("rt.sync"):
        total, most = torch.stack([counts.sum(dtype=torch.int64),
                                   counts.max().to(torch.int64)]).tolist()
    if total > _INT32_MAX:
        raise ValueError("octree CSR overflow")
    return offsets, total, most


def fill(lo: Tensor, hi: Tensor, fine: Tensor, root_lo: np.ndarray,
         root_size: float, depth: int, offsets: Tensor,
         capacity: int) -> Tensor:
    """The fill and sort passes (one C entry) over :func:`count`'s offsets
    -> cell_ids [capacity] i32: each cell's prims in prim order, zeros past
    the pairs."""
    args = _prims(lo, hi, fine, root_lo, root_size, depth)
    dev = lo.device
    cells = (1 << depth) ** 3
    _build.need(offsets, "offsets", torch.int32, (cells + 1,), dev)
    cursor = offsets[:-1].clone()
    ids = torch.zeros((capacity,), dtype=torch.int32, device=dev)
    lib = _build.load()
    _build.check(lib, lib.rt_octree_fill(
        *args, _build.ptr(offsets), _build.ptr(cursor), _build.ptr(ids),
        dev.index or 0, _build.stream(dev)), "octree fill_kernel")
    LAUNCHES["fill"] += 1
    LAUNCHES["sort"] += 1
    return ids


def skip_field(offsets: Tensor, depth: int) -> Tensor:
    """The three skip passes (z, y, x; one C entry) -> skip_dist [R^3] u8:
    the chessboard distance from each cell to the nearest cell whose count
    is > 0, capped at 255 (255 everywhere when none is)."""
    dev = offsets.device
    R = 1 << depth
    _build.need(offsets, "offsets", torch.int32, (R ** 3 + 1,), dev)
    out = torch.empty((R ** 3,), dtype=torch.uint8, device=dev)
    tmp = torch.empty_like(out)
    deq = torch.empty((R ** 3,), dtype=torch.int32, device=dev)
    lib = _build.load()
    _build.check(lib, lib.rt_octree_skip(
        _build.ptr(offsets), _build.ptr(out), _build.ptr(tmp),
        _build.ptr(deq), R, dev.index or 0, _build.stream(dev)),
        "octree skip_kernel")
    LAUNCHES["skip"] += 3
    return out
