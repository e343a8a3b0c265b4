"""The fit's plain reference: the replay of recorded winners under
autograd, and the dense winner chain of a sample of rays.

BASELINE config 5 fits sphere centers and texture colors to target images
through the search-free replay of recorded winners (the JAX package's
``bench.run_config5``: record the winners every ``replay_every`` steps,
replay them in between). This file states that arithmetic again, from the
benchmark's own scene tensors (:class:`scene.RefScene`), to judge what a
fit step produced:

- :func:`replay` follows the bounce chain of given winners [N, refmax]
  with no search; autograd through it gives the loss's gradients
  (:func:`loss_and_grads`);
- :func:`dense_chain` finds each ray's winner per bounce with
  ``render.nearest_hit``'s dense search, -1 where the ray has ended: what
  a recording of those rays must hold;
- :func:`adam_step` is the change one Adam step makes to a parameter
  (Kingma and Ba's update with optax's defaults), from the moments before
  the step and a gradient: what the fit's optimizer must apply.

Both take one bounce of ``render.trace``, statement for statement
(:func:`_bounce`): the surface recompute of the winner, the color
product, mirror reflection with the ``1e-3`` advance, the sky on a miss;
at the end the inverse-square law on an emitter. Departures from the
published description (raytracer.js's path loop): pixel centres only
(spp 1), the scene class of ``render`` (spheres and boxes, solid textures
and sky, REFLECTION materials), a distance attenuation factor of 1, and
the loss of ``bench.run_config5``: the squared error summed over the
channels and averaged over every pixel of every view. Everything runs in
the scene's dtype (float32; the control casts to bfloat16), but for
:func:`adam_step`, which runs in float64 (the program's float32 step
rounds each parameter; the comparison reads that rounding as error).
"""
from __future__ import annotations

import math

import torch

from . import render as ref
from .scene import RefScene

Tensor = torch.Tensor


def _bounce(scene: RefScene, rgb: Tensor, sky: Tensor, org: Tensor,
            dir: Tensor, color: Tensor, path: Tensor, status: Tensor,
            pid: Tensor):
    """One bounce of ``render.trace`` with the winners ``pid`` [N] given
    (-1: none) -> the next (org, dir, color, path, status)."""
    alive = status == ref.ALIVE
    hit = alive & (pid >= 0)
    pid_c = torch.clamp(pid, 0, max(scene.n_prims - 1, 0))
    point, normal, t_surf = ref.surface_at(scene, org, dir, pid_c)
    color = torch.where(hit[:, None], color * rgb.index_select(0, pid_c),
                        color)
    path = torch.where(hit, path + t_surf, path)
    is_light = scene.prim_light.index_select(0, pid_c) & hit
    cont = hit & ~is_light & scene.prim_mirror.index_select(0, pid_c)
    refl = dir - 2.0 * ref.dot(dir, normal)[..., None] * normal
    new_dir = torch.where(cont[:, None], refl, dir)
    new_org = torch.where(cont[:, None], point + ref.EPS_ADVANCE * refl, org)
    miss = alive & (pid < 0)
    color = torch.where(miss[:, None], color * sky, color)
    keep = hit & ~is_light & ~cont
    status = torch.where(is_light, ref.LIGHT, status)
    status = torch.where(keep, ref.KEEP, status)
    status = torch.where(miss, ref.MISS, status)
    return new_org, new_dir, color, path, status


def _start(org: Tensor):
    n = org.shape[0]
    return (torch.ones_like(org), torch.zeros_like(org[:, 0]),
            torch.zeros((n,), dtype=torch.int64, device=org.device))


def replay(scene: RefScene, org: Tensor, dir: Tensor, pid_seq: Tensor
           ) -> Tensor:
    """The colors [N, 3] of rays that take the winners ``pid_seq``
    [N, refmax] (no search), differentiable in the scene's float leaves."""
    color, path, status = _start(org)
    rgb = scene.tex_rgb.index_select(0, scene.prim_tex)
    sky = scene.tex_rgb[scene.sky_tex]
    for b in range(pid_seq.shape[1]):
        org, dir, color, path, status = _bounce(
            scene, rgb, sky, org, dir, color, path, status,
            pid_seq[:, b].long())
    exhausted = status == ref.ALIVE
    color = torch.where(exhausted[:, None], 0.0, color)
    isl = 1.0 / (ref.JS_EPSILON + path * path)
    return torch.where((status == ref.LIGHT)[:, None], color * isl[:, None],
                       color)


@torch.no_grad()
def dense_chain(scene: RefScene, org: Tensor, dir: Tensor, refmax: int
                ) -> Tensor:
    """Each ray's winner per bounce by the dense search -> [N, refmax]
    int64, -1 for a miss or a ray that has ended (as a recording)."""
    color, path, status = _start(org)
    rgb = scene.tex_rgb.index_select(0, scene.prim_tex)
    sky = scene.tex_rgb[scene.sky_tex]
    out = []
    for _ in range(refmax):
        alive = status == ref.ALIVE
        idx = torch.nonzero(alive)[:, 0]
        pid = torch.full_like(status, -1)
        if idx.numel():
            pid[idx] = ref.nearest_hit(scene, org[idx], dir[idx])[1]
        out.append(pid)
        org, dir, color, path, status = _bounce(
            scene, rgb, sky, org, dir, color, path, status, pid)
    return torch.stack(out, dim=1)


def loss_and_grads(scene: RefScene, rays, recs, targets: Tensor,
                   leaves=("sphere_center", "tex_rgb")):
    """The fit's loss over the views and its gradients on ``leaves``.

    ``rays`` holds each view's (org, dir) [N, 3], ``recs`` its winners
    [N, refmax], ``targets`` [V, N, 3]. The views are replayed and
    differentiated one at a time (their graphs do not all fit at once);
    the gradients add up over them. -> (loss, {leaf: gradient})."""
    params = {k: getattr(scene, k).detach().clone().requires_grad_(True)
              for k in leaves}
    sc = scene.with_leaves([params.get(k, getattr(scene, k))
                            for k in scene.LEAVES])
    n_pix = sum(org.shape[0] for org, _ in rays)
    loss = torch.zeros((), dtype=torch.float64, device=targets.device)
    for v, ((org, dir), rec) in enumerate(zip(rays, recs)):
        col = replay(sc, org, dir, rec)
        part = ((col - targets[v].to(col.dtype)) ** 2).sum() / n_pix
        part.backward()
        loss += part.detach().double()
    return loss, {k: p.grad for k, p in params.items()}


#: optax's ``adam`` defaults: the moments' decay rates and the
#: denominator's epsilon, added to the bias-corrected root
BETAS, EPS = (0.9, 0.999), 1e-8


def adam_step(grad: Tensor, exp_avg: Tensor, exp_avg_sq: Tensor,
              steps: int, lr: float) -> Tensor:
    """The change one Adam step makes to a parameter, in float64:
    ``grad`` its gradient, ``exp_avg`` and ``exp_avg_sq`` the first and
    second moments before the step (zeros before the first) and ``steps``
    the steps taken before it."""
    b1, b2 = BETAS
    g = grad.double()
    m = b1 * exp_avg.double() + (1.0 - b1) * g
    v = b2 * exp_avg_sq.double() + (1.0 - b2) * g * g
    t = steps + 1
    return (-lr / (1.0 - b1 ** t)) * m / (
        v.sqrt() / math.sqrt(1.0 - b2 ** t) + EPS)
