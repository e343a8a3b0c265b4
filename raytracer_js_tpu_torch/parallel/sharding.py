"""Ray-space sharding over a ``torch.distributed`` process group.

Port of ``raytracer_js_tpu.parallel.sharding``. The reference runs one
controller over a device ``Mesh`` (``shard_map``); PyTorch runs one process
per rank, so the port's mesh is a process group (:class:`Mesh`). The
semantics are the reference's: rays are split by rank in contiguous slices,
the scene, materials, textures, accel and camera poses are replicated, the
forward pass needs no collective, and the loss and gradients are all-reduced
once. Each ray's RNG stream is keyed by its *global* ray id
(``ops/sampling``), so an image is bitwise equal to one process at any world
size.

The differentiable-parameter partition of a scene (``float_partition``)
is the scene's own (``models/scene``); this module re-exports it under the
reference's name.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..config import RenderConfig, resolve_device
from ..models.camera import Camera, pixel_rays
from ..models.scene import Scene, float_leaf_names, float_partition
from ..ops.sampling import DEFAULT_SEED
from ..render import render_rays

Tensor = torch.Tensor

#: name of the one axis rays are sharded over (every rank of every host;
#: rays never communicate)
RAY_AXIS = "rays"
#: collectives :func:`all_reduce_sum` ran (``calls``) and the bytes it
#: handed them (``bytes``); a one-rank mesh runs none and counts nothing
ALLREDUCE = {"calls": 0, "bytes": 0}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks rays are sharded over: a process group, this process's rank
    in it, its size and this rank's device. ``group`` None is the one-rank
    mesh of a single process, which runs no collective."""

    group: Optional[object]
    rank: int
    world_size: int
    device: torch.device

    def rows(self, n: int) -> slice:
        """This rank's contiguous slice of ``n`` rays."""
        assert n % self.world_size == 0, (
            f"ray count {n} must divide over {self.world_size} ranks; pad "
            f"the wavefront")
        k = n // self.world_size
        return slice(self.rank * k, (self.rank + 1) * k)


def make_mesh(group=None, device=None) -> Mesh:
    """The mesh over ``group`` (the default process group when one is
    initialised, ``parallel.distributed.init_distributed``), with this rank
    on ``device`` (the card unless the caller asks for the CPU; a bare
    ``"cuda"`` means the current CUDA device). With no process group
    initialised it is the one-rank mesh of this process, the counterpart
    of ``make_mesh(jax.devices()[:1])``."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if dist.is_available() and dist.is_initialized():
        group = group if group is not None else dist.group.WORLD
        return Mesh(group=group, rank=dist.get_rank(group),
                    world_size=dist.get_world_size(group), device=device)
    if group is not None:
        raise ValueError("make_mesh(group=...) needs an initialised process "
                         "group (parallel.distributed.init_distributed)")
    return Mesh(group=None, rank=0, world_size=1, device=device)


def all_reduce_sum(mesh: Mesh, tensors: Sequence[Tensor]) -> List[Tensor]:
    """Sum each tensor over the mesh's ranks, in one collective over their
    flattened concatenation -> new tensors of the same shapes, counted in
    :data:`ALLREDUCE`. The one-rank mesh of a single process returns them
    unchanged."""
    if mesh.group is None:
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    ALLREDUCE["calls"] += 1
    ALLREDUCE["bytes"] += flat.numel() * flat.element_size()
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    sizes = [t.numel() for t in tensors]
    return [part.reshape(t.shape)
            for part, t in zip(torch.split(flat, sizes), tensors)]


def all_gather_rows(mesh: Mesh, local: Tensor) -> Tensor:
    """Every rank's ``local`` rows, in rank order -> the whole array."""
    if mesh.group is None:
        return local
    parts = [torch.empty_like(local) for _ in range(mesh.world_size)]
    dist.all_gather(parts, local.contiguous(), group=mesh.group)
    return torch.cat(parts)


def render_rays_sharded(mesh: Mesh, scene: Scene, cfg: RenderConfig,
                        org: Tensor, dir: Tensor, seed: int,
                        ray_id: Tensor) -> Tensor:
    """Shard a flat wavefront over the mesh -> [N, 3] colors on every rank.

    Each rank traces its contiguous slice with the slice's global ray ids
    (``render.render_rays``, so FUSED runs the wavefront kernel per rank);
    an all-gather then gives every rank the whole array, as the reference's
    global array does. The forward pass needs no other collective."""
    rows = mesh.rows(org.shape[0])
    local = render_rays(scene, cfg, org[rows], dir[rows], seed, ray_id[rows])
    return all_gather_rows(mesh, local)


def render_hdr_sharded(mesh: Mesh, scene: Scene, camera: Camera,
                       cfg: RenderConfig,
                       seed: int = DEFAULT_SEED) -> Tensor:
    """Full-frame sharded render -> [h, w, 3] HDR, bitwise equal to
    ``render_rays`` over the camera's rays for any world size."""
    org, dirs = pixel_rays(camera)
    ray_id = torch.arange(org.shape[0], dtype=torch.int32, device=org.device)
    colors = render_rays_sharded(mesh, scene, cfg, org, dirs, seed, ray_id)
    return colors.reshape(camera.h, camera.w, 3)


# ---------------------------------------------------------------------------
# Sharded inverse-rendering step
# ---------------------------------------------------------------------------

def sharded_fit_step(mesh: Mesh, scene: Scene, cfg: RenderConfig,
                     camera: Camera, target: Tensor,
                     seed: int = DEFAULT_SEED) -> Tuple[Tensor, List[Tensor]]:
    """One data-parallel inverse-rendering step -> ``(loss, grads)``.

    Pixel L2 loss against ``target`` ([N, 3] flat). Each rank renders its
    ray slice and differentiates its *local* contribution
    ``sum((colors - target)^2) / N`` (N the global ray count) with respect
    to the replicated scene parameters; then the loss and each gradient are
    all-reduced (summed) exactly once. A second reduction would count the
    gradient ``world_size`` times (the reference's NOTE on its implicit
    psum). ``grads`` is in :func:`float_partition` order; a parameter the
    loss never reaches gets zeros.
    """
    org, dirs = pixel_rays(camera)
    n = org.shape[0]
    rows = mesh.rows(n)
    ray_id = torch.arange(n, dtype=torch.int32, device=org.device)
    params, rebuild = float_partition(scene)
    params = [p.detach().requires_grad_(True) for p in params]
    colors = render_rays(rebuild(params), cfg, org[rows], dirs[rows], seed,
                         ray_id[rows])
    loss = ((colors - target[rows]) ** 2).sum() / n
    loss.backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params]
    loss, *grads = all_reduce_sum(mesh, [loss.detach(), *grads])
    return loss, grads
