"""raytracer_js_tpu_torch — the raytracer in PyTorch, with CUDA kernels.

The port of ``raytracer_js_tpu`` (JAX/XLA/Pallas) to PyTorch and hand-written
CUDA for NVIDIA Hopper. Modules sit at the paths of their counterparts and
keep their public names and layouts ([N, 3] rays, [h, w, 3] images). It
imports ``torch`` and ``numpy``, never ``jax``.

The headline path is ``render_hdr`` with ``HitBackend.FUSED`` on a
fused-class scene: one CUDA kernel renders the whole frame
(``kernels/trace_fused``, ``csrc/trace_fused.cu``). ``HitBackend.PALLAS``
runs the wavefront loop with the nearest-hit kernels
(``kernels/nearest_hit``, ``csrc/nearest_hit.cu``) and carries every scene
class, image textures and cube-map skies included. ``HitBackend.TILED``
renders big scenes (``render_tiled``: per-tile candidate tables and the
tiled frame kernel for bounce 0, ``kernels/trace_tiled``,
``csrc/trace_tiled.cu``; sweep rounds through the listed nearest-hit
kernel for later bounces). ``HitBackend.OCTREE`` with an ``accel``
(``accel/octree.build_octree``, host-built with the native scene kit,
``native``) searches the octree's grid with one CUDA kernel launch a search
(``kernels/octree_dda``, ``csrc/octree_dda.cu``); the same accel serves the
transmission substance query of every backend. The wavefront loop
(``ops/trace``: BRUTE, PALLAS, OCTREE and TILED's later bounces) shades
each bounce of a solid-textured scene without transmission in one launch
of the shade kernel (``kernels/shade``, ``csrc/shade.cu``). Inverse
rendering (``fit``, ``optim/fit``) differentiates the search path, or the
replay of recorded winners through the replay kernels
(``kernels/replay_grad``, ``csrc/replay_grad.cu``). On CPU tensors every
kernel runs its plain PyTorch version instead.

The modules form one stack, each importing only from those below it:
``config`` and ``models``, ``ops``, ``kernels`` (with
``accel/candidates``), ``accel/octree``, ``ops/trace``, ``render_tiled``,
``render``, ``parallel`` and ``optim``, then ``view``, ``demo`` and
``live`` (``tests/test_torch_layers.py`` holds them to it).
"""
from .config import (
    HitBackend,
    OctreeConfig,
    RenderConfig,
    ResponseType,
    RayStatus,
    TextureKind,
    ToneMapConfig,
    ToneMapperKind,
)
from .models.camera import Camera, make_camera, pixel_rays
from .models.scene import Scene, SceneBuilder
from .optim import FitConfig, FitStep, fit
from .models.scene import float_leaf_names
from .render import render, render_hdr

__all__ = [
    "Camera",
    "FitConfig",
    "FitStep",
    "HitBackend",
    "OctreeConfig",
    "RenderConfig",
    "ResponseType",
    "RayStatus",
    "Scene",
    "SceneBuilder",
    "TextureKind",
    "ToneMapConfig",
    "ToneMapperKind",
    "fit",
    "float_leaf_names",
    "make_camera",
    "pixel_rays",
    "render",
    "render_hdr",
]

__version__ = "0.1.0"
