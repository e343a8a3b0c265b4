"""Multi-process initialization (``torch.distributed``) and topology helpers.

Port of ``raytracer_js_tpu.parallel.distributed``. PyTorch runs one process
per rank; rays are sharded over every rank of every host and only the
gradient all-reduce crosses processes (``parallel/sharding``). This module
owns process bootstrap and mesh construction, so every entry point
initializes the same way.

Typical launches (2 ranks):
    JAX_COORDINATOR=host0:1234 NPROC=2 PROC_ID=<0|1> python -m ...
    torchrun --nproc-per-node 2 -m ...
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..config import resolve_device
from .sharding import RAY_AXIS, Mesh, make_mesh


def _coordinator_from_env() -> Optional[str]:
    if os.environ.get("JAX_COORDINATOR"):
        return os.environ["JAX_COORDINATOR"]
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    return f"{addr}:{port}" if addr and port else None


def rank_device(device, local_rank: int) -> torch.device:
    """This rank's device: a CUDA request without an index takes
    ``cuda:{local_rank % device_count}``; any other device is kept."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
    return device


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device=None,
                     backend: Optional[str] = None,
                     timeout_s: Optional[float] = None) -> bool:
    """Initialize the default process group from args or environment;
    idempotent. Returns True when a process group is active, False in a
    single process (nothing initialised: the path every unit test takes).

    Environment: the reference's ``JAX_COORDINATOR`` (host:port), ``NPROC``
    and ``PROC_ID``, or what ``torchrun`` sets (``MASTER_ADDR`` /
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``). A
    coordinator with ``://`` is an init method as it stands (``file://``
    for ranks on one host); ``host:port`` becomes ``tcp://host:port``.

    ``device``: CUDA unless the caller asks for the CPU; each CUDA rank
    takes ``cuda:{LOCAL_RANK % device_count}`` (``LOCAL_RANK`` defaults to
    the rank) and makes it current. ``backend``: NCCL for a CUDA device,
    gloo for the CPU; a given ``backend`` overrides that, and nothing else
    does (no NCCL failure falls back to gloo). ``timeout_s`` bounds the
    rendezvous and every collective (torch's default when None).
    """
    if dist.is_initialized():
        return True
    env = os.environ
    coordinator = coordinator or _coordinator_from_env()
    num_processes = (num_processes or int(env.get("NPROC", "0"))
                     or int(env.get("WORLD_SIZE", "0")) or None)
    if process_id is None:
        process_id = int(env.get("PROC_ID", env.get("RANK", "-1")))
    if not (coordinator and num_processes and process_id >= 0):
        return False
    local_rank = int(env.get("LOCAL_RANK", str(process_id)))
    dev = rank_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    init_method = (coordinator if "://" in coordinator
                   else f"tcp://{coordinator}")
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=num_processes, rank=process_id, **kw)
    return True


def global_mesh(device=None) -> Mesh:
    """The ray mesh over every rank of every host (the default process
    group; one rank without one), this rank on ``device`` (its current
    CUDA device unless the caller asks for another)."""
    return make_mesh(device=device)


def topology_summary(mesh: Optional[Mesh] = None) -> dict:
    """Host/rank topology for logs and the scaling report (``mesh``: the
    :func:`global_mesh` unless given)."""
    mesh = mesh if mesh is not None else global_mesh()
    gpu = mesh.device.type == "cuda"
    return {
        "process_index": mesh.rank,
        "process_count": mesh.world_size,
        "local_devices": torch.cuda.device_count() if gpu else 1,
        "global_devices": mesh.world_size,
        "platform": "gpu" if gpu else "cpu",
        "ray_axis": RAY_AXIS,
    }
