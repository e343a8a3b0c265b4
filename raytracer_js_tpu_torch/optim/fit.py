"""Inverse-rendering fit loop (port of ``raytracer_js_tpu.optim.fit``).

Pixel loss -> gradients on material colors, entity geometry and camera
pose, optimized with ``torch.optim`` (Adam or SGD with optax's defaults).
A fit renders a batch of views per step (BASELINE config 5: 8 views) and
differentiates either the search path or, with ``replay_every``, the
search-free replay of recorded winners: kernel B5
(``kernels/replay_grad``) on the port's class for it
(``replay_grad.supports_fit``, any sphere count), autograd through
``ops/trace.trace_rays(..., pid_seq=...)`` elsewhere. The OCTREE backend
searches an ``accel/octree.OctreeAccel``, rebuilt from the moving geometry
every ``accel_every`` steps. With a ``mesh`` (``parallel/sharding``) every
view's rays are split over the ranks and the gradients all-reduced once.
A step's parts are ``rt.fit.*`` spans (``utils/profiling.span``), and a
``hook`` sees each step's parameters, gradients, loss and recording.
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..accel import octree
from ..config import HitBackend, OctreeConfig, RenderConfig
from ..kernels import replay_grad as rg_kernel
from ..models.camera import Camera, pixel_rays, renormalized
from ..models.scene import Scene, float_partition
from ..ops import sampling
from ..ops.sampling import step_seed
from ..ops.trace import record_paths, start_substance, trace_rays
from ..ops.vecmath import cross
from ..parallel import sharding
from ..render import render_rays
from ..utils import checkpoint as ckpt
from ..utils.profiling import span

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FitConfig:
    steps: int = 100
    lr: float = 1e-2
    optimizer: str = "adam"   # "adam" | "sgd"
    #: checkpoint every N steps into ``ckpt_dir`` (0 = off); a fit restarted
    #: with the same ckpt_dir resumes from the newest snapshot
    save_every: int = 0
    ckpt_dir: Optional[str] = None
    #: path-replay gradients: record the winners per bounce
    #: (ops/trace.record_paths) at the first step and every N steps, and
    #: differentiate the search-free replay in between (0 = off). Between
    #: recordings the winners go stale as geometry moves; replay_every=1 is
    #: the search path's gradient at every step.
    replay_every: int = 0
    #: the OCTREE accel's staleness policy: rebuild the octree from the
    #: current geometry every N steps after the first (0 = never; the
    #: accel then goes stale as geometry moves, which changes which prim
    #: is found, never the gradient flow). Each rebuild is a fresh build
    #: at the first accel's depth, so moved geometry never outgrows it
    accel_every: int = 0
    #: optimize the camera poses too: each camera's (pos, front, left, up)
    #: joins the params after the scene's float leaves; the triad gradient
    #: is projected onto rotations and the triad re-orthonormalized after
    #: every step (raw triad gradients diverge)
    fit_cameras: bool = False


@dataclasses.dataclass
class FitResult:
    scene: Scene
    losses: list
    #: fitted cameras (None unless FitConfig.fit_cameras)
    cameras: Optional[list] = None


@dataclasses.dataclass(frozen=True)
class FitStep:
    """What :func:`fit`'s ``hook`` sees of a step, after the gradients are
    final (all-reduced, masked, projected) and before the optimizer step.
    The tensors are the fit's own: copy what outlives the call.

    With a ``mesh`` each rank's hook sees its own step: ``loss`` and
    ``grads`` are already summed over the ranks (the same on every rank),
    ``params`` and the optimizer's state are the rank's replica (the same
    bits on every rank), and ``recs`` holds the winners of the rank's own
    rows of each view only (``mesh.rows``)."""

    step: int
    #: the step's loss (0-d, detached; the sum over the ranks with a mesh)
    loss: Tensor
    #: the parameters as the step used them, in ``trainable``'s order
    #: (``models/scene.float_leaf_names``, then each camera's pos,
    #: front, left, up with ``fit_cameras``), and their gradients
    params: List[Tensor]
    grads: List[Tensor]
    #: the winners the step replayed (per view, [rays, refmax] of this
    #: rank's rows; None without ``replay_every``), and whether it recorded
    #: them
    recs: Optional[List[Tensor]]
    recorded: bool
    #: the fit's ``torch.optim`` optimizer, before its step (its ``state``
    #: holds Adam's moments and step count)
    optimizer: torch.optim.Optimizer


def _project_triad_grads(params, grads, n_scene: int, n_cams: int):
    """Riemannian projection of camera-triad gradients onto rotations.

    The raw (front, left, up) gradient has radial components (shrinking
    ``front`` dims every path length, so the loss can fall that way), which
    the re-orthonormalization after each step undoes: plain Adam or SGD on
    raw triad leaves diverges. The tangent space of the orthonormal triads
    is {dv = w x v}; the projected gradient is the rotation vector
    ``w = sum_v v x g_v`` written back per leaf as ``g_v := w x v``, a strict
    descent direction.
    """
    grads = list(grads)
    for i in range(n_cams):
        o = n_scene + 4 * i + 1
        f, lf, u = params[o], params[o + 1], params[o + 2]
        w = cross(f, grads[o]) + cross(lf, grads[o + 1]) + cross(u,
                                                                  grads[o + 2])
        grads[o] = cross(w, f)
        grads[o + 1] = cross(w, lf)
        grads[o + 2] = cross(w, u)
    return grads


def _make_opt(cfg: FitConfig, params):
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999),
                                eps=1e-8)
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(params, lr=cfg.lr)
    raise ValueError(cfg.optimizer)


ALL_ROWS = slice(None)


def _view_rays(cam: Camera, v: int, rows: slice = ALL_ROWS):
    """(org, dir, global ray ids) of ``rows`` of view v, whose rays are
    numbered from v * N. The rows are sliced after ``pixel_rays``, so a
    pose gradient flows through the slice."""
    org, dirs = pixel_rays(cam)
    n = org.shape[0]
    rid = torch.arange(n, dtype=torch.int32, device=org.device) + v * n
    return org[rows], dirs[rows], rid[rows]


def multiview_loss(scene: Scene, cfg: RenderConfig, cameras: Sequence[Camera],
                   targets: Tensor, seed: int = sampling.DEFAULT_SEED,
                   accel=None, rows: slice = ALL_ROWS) -> Tensor:
    """Mean squared pixel loss over a view batch, through the search path.

    ``targets`` is [V, h*w, 3] (flattened per view). ``rows`` (a sharded
    fit) traces only that slice of every view's rays; the sum is still
    divided by every view's whole pixel count, so the ranks' losses add up
    to the loss.
    """
    total = torch.zeros((), dtype=torch.float32, device=targets.device)
    n_pix = 0
    for v, cam in enumerate(cameras):
        org, dirs, rid = _view_rays(cam, v, rows)
        colors = render_rays(scene, cfg, org, dirs, seed, rid, accel=accel)
        total = total + ((colors - targets[v][rows]) ** 2).sum()
        n_pix += cam.h * cam.w
    return total / n_pix


@torch.no_grad()
def record_views(scene: Scene, cfg: RenderConfig, cameras: Sequence[Camera],
                 seed: int = sampling.DEFAULT_SEED, accel=None,
                 rows: slice = ALL_ROWS) -> List[Tensor]:
    """The winners per bounce of every view -> [pid_seq [h*w, refmax]]
    (of ``rows`` only: the same winners as those rows of the whole view,
    since each ray's stream is keyed by its global id)."""
    recs = []
    for v, cam in enumerate(cameras):
        org, dirs, rid = _view_rays(cam, v, rows)
        refr0 = start_substance(scene, cam.pos).expand(org.shape[0])
        recs.append(record_paths(scene, cfg, org, dirs, seed, rid,
                                 start_refr=refr0, accel=accel))
    return recs


def replay_loss(scene: Scene, cfg: RenderConfig, cameras: Sequence[Camera],
                targets: Tensor, recs: Sequence[Tensor],
                seed: int = sampling.DEFAULT_SEED,
                rows: slice = ALL_ROWS) -> Tensor:
    """:func:`multiview_loss` through the replay of recorded winners:
    kernel B5 where ``replay_grad.supports_fit`` holds, else autograd
    through the replaying trace loop. ``recs`` holds the winners of
    ``rows``."""
    use_kernel = rg_kernel.supports_fit(scene, cfg)
    total = torch.zeros((), dtype=torch.float32, device=targets.device)
    n_pix = 0
    for v, cam in enumerate(cameras):
        org, dirs, rid = _view_rays(cam, v, rows)
        if use_kernel:
            colors = rg_kernel.replay_colors(scene, cfg, org, dirs, recs[v])
        else:
            refr0 = start_substance(scene, cam.pos).expand(org.shape[0])
            colors = trace_rays(scene, cfg, org, dirs, seed, rid,
                                start_refr=refr0, pid_seq=recs[v]).color
        total = total + ((colors - targets[v][rows]) ** 2).sum()
        n_pix += cam.h * cam.w
    return total / n_pix


def fit(scene: Scene, cfg: RenderConfig, cameras: Sequence[Camera],
        targets: Tensor, fit_cfg: FitConfig = FitConfig(),
        seed: int = sampling.DEFAULT_SEED,
        trainable: Optional[Callable[[int, Tensor], bool]] = None,
        mesh=None, accel=None,
        hook: Optional[Callable[[FitStep], Optional[bool]]] = None
        ) -> FitResult:
    """Optimize the scene's float leaves (and, with ``fit_cameras``, the
    camera poses) to match ``targets`` [V, h*w, 3].

    ``trainable(i, param)`` masks which params receive updates (by zeroing
    their gradients). A param the loss never reaches gets a zero gradient,
    as under ``jax.grad``. Step ``s`` draws its random numbers from
    :func:`step_seed` ``(seed, s)``. ``accel`` (an
    ``accel/octree.OctreeAccel`` of ``scene``) serves the OCTREE search of
    the search and recording steps, and is rebuilt every
    ``fit_cfg.accel_every`` steps.

    ``mesh`` (``parallel.sharding.make_mesh``): every rank calls ``fit``
    with the same arguments; each view's rays split over the ranks in
    contiguous slices (rays per view must divide over them), each rank
    traces, records and replays its slice (a TILED ``cfg`` as BRUTE) and
    differentiates its part of the loss, then the loss and gradients are
    all-reduced once (the span ``rt.fit.allreduce``; the collective is
    counted in ``sharding.ALLREDUCE``), before the mask, the triad
    projection and the optimizer step. Every rank thus takes the same step and the params stay
    replicated bit for bit. Each rank rebuilds the same accel. Only rank 0
    writes checkpoints; every rank restores.

    ``hook(FitStep)`` is called once a step, after the gradients are final
    and before the optimizer step; a true return ends the fit after that
    step. Unset, it costs nothing and the steps are the same.
    """
    rows = ALL_ROWS
    if mesh is not None:
        n_view = cameras[0].h * cameras[0].w
        if n_view % mesh.world_size:
            raise ValueError(f"rays per view ({n_view}) must divide over "
                             f"{mesh.world_size} ranks")
        rows = mesh.rows(n_view)
        if cfg.backend == HitBackend.TILED:
            # the tiled path is frame-shaped; a shard is a wavefront
            cfg = dataclasses.replace(cfg, backend=HitBackend.BRUTE)
    if fit_cfg.replay_every and cfg.spp != 1:
        raise ValueError("replay_every requires spp == 1 (one recorded "
                         "structure per ray)")
    scene_params, rebuild_scene = float_partition(scene)
    n_scene = len(scene_params)
    init = list(scene_params)
    if fit_cfg.fit_cameras:
        for cam in cameras:
            init += [cam.pos, cam.front, cam.left, cam.up]
    params = [p.detach().clone().requires_grad_(True) for p in init]

    def rebuild_all(ps):
        sc = rebuild_scene(ps[:n_scene])
        if not fit_cfg.fit_cameras:
            return sc, list(cameras)
        cams = [dataclasses.replace(cam, pos=ps[n_scene + 4 * i],
                                    front=ps[n_scene + 4 * i + 1],
                                    left=ps[n_scene + 4 * i + 2],
                                    up=ps[n_scene + 4 * i + 3])
                for i, cam in enumerate(cameras)]
        return sc, cams

    opt = _make_opt(fit_cfg, params)
    start_step = 0
    if fit_cfg.ckpt_dir:
        newest = ckpt.latest(fit_cfg.ckpt_dir)
        if newest is not None:
            (saved, opt_state), start_step, _ = ckpt.restore(
                newest, device=params[0].device)
            with torch.no_grad():
                for p, q in zip(params, saved, strict=True):
                    p.copy_(q)
            opt.load_state_dict(opt_state)

    losses = []
    recs = None
    for step in range(start_step, fit_cfg.steps):
        with span("rt.fit.step"):
            if (accel is not None and fit_cfg.accel_every
                    and step > start_step
                    and (step - start_step) % fit_cfg.accel_every == 0):
                with span("rt.fit.rebuild"):
                    accel = octree.build_octree(
                        rebuild_scene([p.detach() for p in params[:n_scene]]),
                        OctreeConfig(max_depth=accel.max_depth),
                        l_cut=accel.l_cut)
            k = step_seed(seed, step)
            opt.zero_grad(set_to_none=True)
            sc, cams = rebuild_all(params)
            recorded = False
            if fit_cfg.replay_every:
                if (step - start_step) % fit_cfg.replay_every == 0:
                    with span("rt.fit.record"):
                        recs = record_views(sc, cfg, cams, k, accel=accel,
                                            rows=rows)
                    recorded = True
                with span("rt.fit.replay"):
                    loss = replay_loss(sc, cfg, cams, targets, recs, k,
                                       rows=rows)
            else:
                loss = multiview_loss(sc, cfg, cams, targets, k, accel=accel,
                                      rows=rows)
            with span("rt.fit.backward"):
                loss.backward()
            with torch.no_grad():
                grads = [torch.zeros_like(p) if p.grad is None else p.grad
                         for p in params]
                if mesh is not None:
                    with span("rt.fit.allreduce"):
                        loss, *grads = sharding.all_reduce_sum(
                            mesh, [loss.detach(), *grads])
                if trainable is not None:
                    grads = [g if trainable(i, p) else torch.zeros_like(g)
                             for i, (g, p) in enumerate(zip(grads, params))]
                if fit_cfg.fit_cameras:
                    grads = _project_triad_grads(params, grads, n_scene,
                                                 len(cameras))
                for p, g in zip(params, grads):
                    p.grad = g
            stop = hook is not None and hook(FitStep(
                step=step, loss=loss.detach(), params=params, grads=grads,
                recs=recs, recorded=recorded, optimizer=opt))
            with span("rt.fit.opt"):
                opt.step()
                if fit_cfg.fit_cameras:
                    # the retraction: a gradient step denormalizes the triad
                    with torch.no_grad():
                        for i, cam in enumerate(rebuild_all(params)[1]):
                            cam = renormalized(cam)
                            o = n_scene + 4 * i
                            params[o + 1].copy_(cam.front)
                            params[o + 2].copy_(cam.left)
                            params[o + 3].copy_(cam.up)
            with span("rt.sync"):
                losses.append(float(loss.detach()))
            if (fit_cfg.ckpt_dir and fit_cfg.save_every
                    and (step + 1) % fit_cfg.save_every == 0):
                if mesh is None or mesh.rank == 0:
                    pathlib.Path(fit_cfg.ckpt_dir).mkdir(parents=True,
                                                         exist_ok=True)
                    ckpt.save(
                        pathlib.Path(fit_cfg.ckpt_dir) / f"ckpt_{step + 1}",
                        (params, opt.state_dict()), step=step + 1)
                if mesh is not None and mesh.group is not None:
                    dist.barrier(group=mesh.group)
        if stop:
            break
    sc_out, cams_out = rebuild_all([p.detach() for p in params])
    return FitResult(scene=sc_out, losses=losses,
                     cameras=cams_out if fit_cfg.fit_cameras else None)
