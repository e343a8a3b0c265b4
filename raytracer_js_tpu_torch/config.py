"""Typed configuration records for the PyTorch/CUDA raytracer.

Same enums, constants and records as ``raytracer_js_tpu.config`` (the
reference package), with the same values, so that a configuration means the
same thing in both. The reference's ``RT_*`` tunable registry is not carried
over: its knobs tune TPU kernels that this package does not have.
"""
from __future__ import annotations

import dataclasses
import enum

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point builds on: the card unless the caller asks
    for another. ``None`` means CUDA; a machine without CUDA raises rather
    than fall back to the CPU quietly (pass ``device="cpu"`` there)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this package runs on the card by "
                           "default; pass device=\"cpu\" to run the plain "
                           "PyTorch versions on the CPU")
    return torch.device("cuda")


class ResponseType(enum.IntEnum):
    """Material response taxonomy (reference material.ts:22-26)."""

    REFLECTION = 0
    TRANSMISSION = 1
    BOTH = 2


class RayStatus(enum.IntEnum):
    """Terminal state of a wavefront ray (raytracer.ts:166-277).

    ``ALIVE`` still bouncing; ``LIGHT`` hit an emitter (inverse-square
    attenuation applied); ``KEEP`` terminated keeping its color; ``MISS``
    left the scene (color times sky); ``EXHAUST`` bounce budget spent
    (black).
    """

    ALIVE = 0
    LIGHT = 1
    KEEP = 2
    MISS = 3
    EXHAUST = 4


class TextureKind(enum.IntEnum):
    SOLID = 0
    IMAGE = 1
    IMAGE_BILINEAR = 2


class ToneMapperKind(enum.IntEnum):
    """Tone mapping strategies (reference tone_mapping.ts:21-79)."""

    IDENTITY = 0
    STDDEV_AROUND_MEAN = 1
    ABSDEV_AROUND_MEAN = 2
    DR_LIMITED = 3


class HitBackend(enum.Enum):
    """Nearest-hit search backend.

    * ``BRUTE`` — dense [rays, prims] intersection + argmin in PyTorch.
    * ``FUSED`` — whole-trace CUDA kernel (``kernels/trace_fused``) for the
      fused scene class (solid textures and sky, no BOTH); other scenes
      route to BRUTE.
    * ``PALLAS`` — the wavefront loop with the nearest-hit CUDA kernels
      (``kernels/nearest_hit``): B3 up to 384 prims, B4 above.
    * ``TILED`` — the big-scene path (``render_tiled``: kernel B7, then
      sweep rounds up to ``SWEEP_MAX_PRIMS`` prims, packet rounds above);
      ``render_hdr`` sends scenes of at most 2048 prims without cached
      tables, and BOTH scenes, to PALLAS, and ``render_rays`` takes BRUTE,
      as in the reference.
    * ``OCTREE`` — with an ``accel=`` (``accel/octree.build_octree``: a
      host NumPy build with the native scene kit, tensors on the scene's
      device), a coarse brute pass plus the fine-grid DDA with the
      empty-space skip, plain PyTorch on the CPU and on the card alike;
      without one, the dense search (BRUTE), the reference's fallback.
    """

    BRUTE = "brute"
    OCTREE = "octree"
    PALLAS = "pallas"
    FUSED = "fused"
    TILED = "tiled"


# Epsilon a respawned ray is advanced by to escape the previous collision
# point (raytracer.ts:158-164).
EPS_ADVANCE = 1e-3
# JS Number.EPSILON, used in the inverse-square-law denominator
# (raytracer.ts:274).
JS_EPSILON = 2.0 ** -52


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render parameters (reference RaytracerConfig, raytracer.ts:33-43)."""

    refmax: int = 4
    distance_attenuation_factor: float = 1.0
    #: samples per pixel per call, averaged
    spp: int = 1
    backend: HitBackend = HitBackend.BRUTE
    #: genuine ``ResponseType.BOTH``: a stochastic Fresnel split drawn from
    #: the (seed, ray id, bounce) counter RNG. False reproduces the
    #: reference's terminal default (raytracer.ts:250-251).
    fresnel_both: bool = False
    #: kept for field parity with the reference package; a PyTorch loop
    #: has nothing to unroll
    unroll: bool = False
    #: recompute each bounce of ``ops/trace.trace_rays`` in the backward
    #: (``torch.utils.checkpoint``) instead of keeping its residuals: the
    #: memory knob for gradients over big wavefronts and prim tables
    remat: bool = False
    #: nearest forward hit (argmin t), the documented divergence from
    #: first-entity-in-set-order (raytracer.ts:186-195)
    nearest_hit: bool = True


@dataclasses.dataclass(frozen=True)
class OctreeConfig:
    """Octree build parameters (``accel/octree.build_octree``).

    ``max_depth`` plays the role of the reference's ``max_in_depth``
    (octree_entity.ts:81-90): the fine grid has ``2^max_depth`` cells per
    axis. The root cube is chosen up front to cover the scene's small
    entities, so there is no outward re-rooting.
    """

    max_depth: int = 4
    #: kept for field parity with the reference package, whose build does
    #: not read it either
    max_entities_per_node: int = 64


@dataclasses.dataclass(frozen=True)
class ToneMapConfig:
    """Dynamic-range windowing (reference tone_mapping.ts:35-79)."""

    kind: ToneMapperKind = ToneMapperKind.IDENTITY
    #: log2 of the dynamic range span
    dynamic_range: int = 8
    min_dynamic: float = 1e-4
    max_dynamic: float = 1e4
