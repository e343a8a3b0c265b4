"""Image parity with a winner-flip proof.

Two correct traces of one scene may still differ at a pixel whose nearest
hit is a tie to within rounding: each side picks another primitive there,
and the rest of that ray's path differs. Such a pixel is a *proven flip*
when, at the first bounce where the two sides' winning primitive ids differ,
both primitives are hit at parameters that agree to ``FLIP_RTOL``, both
evaluated on the same recorded ray. Every other pixel must agree to the
stated tolerance with equal status, and flips may be at most
``MAX_FLIP_FRAC`` of the pixels.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..kernels.nearest_hit import nearest_hit_pallas_plain
from ..models.scene import Scene
from ..ops import intersect

Tensor = torch.Tensor

RTOL, ATOL = 1e-5, 1e-6
FLIP_RTOL = 1e-5
MAX_FLIP_FRAC = 1e-3


def prim_hit_t(scene: Scene, pid: Tensor, org: Tensor, dir: Tensor) -> Tensor:
    """Forward hit parameter of primitive ``pid[k]`` along ray k (+inf for
    pid -1 or no forward hit)."""
    n = org.shape[0]
    if n == 0 or scene.n_prims == 0:
        return torch.full((n,), float("inf"), device=org.device)
    out = []
    # in chunks of rays: the [rays, prims] matrix of a 100k-prim scene
    step = max(1, (1 << 25) // scene.n_prims)
    for lo in range(0, n, step):
        o, d = org[lo:lo + step], dir[lo:lo + step]
        t_all = torch.cat([
            intersect.sphere_hit_t(o, d, scene.sphere_center,
                                   scene.sphere_radius),
            intersect.box_hit_t(o, d, scene.box_center, scene.box_half),
            intersect.tri_hit_t(o, d, scene.tri_v0, scene.tri_v1,
                                scene.tri_v2)], dim=1)
        out.append(t_all.gather(
            1, pid[lo:lo + step].long().clamp(min=0)[:, None])[:, 0])
    return torch.where(pid >= 0, torch.cat(out), float("inf"))


def flip_prover(scene: Scene, rec: dict, other_pid: Tensor) -> Callable:
    """Prover for :func:`compare`: ``rec`` is a plain-core record (``pid``,
    ``org``, ``dir`` per bounce, [refmax, N, ...]) and ``other_pid`` the
    other side's winner ids [refmax, N]."""
    def prove(idx: Tensor) -> Tensor:
        pa = rec["pid"][:, idx].long()
        pb = other_pid[:, idx].long().to(pa.device)
        differ = pa != pb
        first = differ.to(torch.int8).argmax(dim=0)       # first differing
        k = torch.arange(idx.shape[0], device=pa.device)
        org = rec["org"][first, idx]
        dir = rec["dir"][first, idx]
        ta = prim_hit_t(scene, pa[first, k], org, dir)
        tb = prim_hit_t(scene, pb[first, k], org, dir)
        tie = (ta - tb).abs() <= FLIP_RTOL * torch.maximum(ta.abs(), tb.abs())
        return differ.any(dim=0) & torch.isfinite(ta) & torch.isfinite(tb) \
            & tie
    return prove


#: rounding steps charged to each term of the sphere error bound
_ROUNDINGS = 2.0
_EPS32 = 2.0 ** -24


def sphere_t_bound(scene: Scene, pid: Tensor, org: Tensor,
                   dir: Tensor) -> Tensor:
    """Bound, in float64, on the float32 rounding error of the factored
    sphere quadratic's t for sphere ``pid[k]`` along ray k (0 for other
    prims and misses).

    ``c = o.o - 2 o.c + (c.c - r^2)`` cancels terms of size |o|^2 and |c|^2
    into a small number, and a grazing ray divides the discriminant's
    error by ``2 sqrt(disc)``: one rounding step more or less (a fused
    multiply-add, say) moves t of a grazing hit by far more than 1e-5.
    """
    is_sph = (pid >= 0) & (pid < scene.n_spheres)
    out = torch.zeros(pid.shape, dtype=torch.float64, device=pid.device)
    if not bool(is_sph.any()):
        return out
    f64 = torch.float64
    k = torch.clamp(pid.long(), 0, max(scene.n_spheres - 1, 0))
    c = scene.sphere_center.to(f64)[k]
    r = scene.sphere_radius.to(f64)[k]
    o, d = org.to(f64), dir.to(f64)
    a = (d * d).sum(-1)
    b = (o * d).sum(-1) - (d * c).sum(-1)
    cc = (o * o).sum(-1) - 2.0 * (o * c).sum(-1) + (c * c).sum(-1) - r * r
    sq = torch.sqrt(torch.clamp(b * b - a * cc, min=0.0))
    t_near = (-b - sq) / a
    t = torch.where(t_near >= 0.0, t_near, (-b + sq) / a)
    e = _ROUNDINGS * _EPS32
    db = e * ((o * d).abs().sum(-1) + (d * c).abs().sum(-1))
    dc = e * ((o * o).sum(-1) + 2.0 * (o * c).abs().sum(-1)
              + (c * c).sum(-1) + r * r)
    da = e * a
    d_disc = (2.0 * b.abs() * db + cc.abs() * da + a * dc
              + e * (b * b + (a * cc).abs()))
    dt = (db + d_disc / (2.0 * torch.clamp(sq, min=1e-30))) / a \
        + t.abs() * (da / a + e)
    return torch.where(is_sph, dt, 0.0)


def compare_hits(scene: Scene, org: Tensor, dir: Tensor, t_a: Tensor,
                 pid_a: Tensor, t_b: Tensor, pid_b: Tensor,
                 rtol: float = RTOL, atol: float = ATOL,
                 rounding_slack: bool = False) -> dict:
    """Compare two nearest-hit results ray by ray -> report dict with ``ok``.

    A ray agrees when both sides name the same pid and, on a hit, t agrees
    to ``allclose(rtol, atol)`` (a miss is +inf on both sides). A ray whose
    pids differ is a proven flip when both prims are hit on that ray at
    parameters equal to ``FLIP_RTOL``; flips may be at most
    ``MAX_FLIP_FRAC`` of the rays.

    ``rounding_slack`` is for two implementations that round differently
    (another summation order, fused multiply-adds): a sphere hit whose t
    differs beyond the tolerance still agrees when the difference is within
    twice :func:`sphere_t_bound`; such rays are counted as ``rounding``.
    Kernel against plain version leaves it off: they round alike.
    """
    pa, pb = pid_a.long(), pid_b.to(pid_a.device).long()
    ta, tb = t_a.float(), t_b.to(t_a.device).float()
    miss = (pa < 0) & (pb < 0)
    err = torch.where(miss, 0.0, (ta - tb).abs())
    tol = atol + rtol * tb.abs()
    close = (pa == pb) & torch.where(
        miss, torch.isinf(ta) & torch.isinf(tb), err <= tol)
    rounding = torch.zeros_like(close)
    if rounding_slack:
        slack = 2.0 * sphere_t_bound(scene, pa, org, dir)
        rounding = (~close & (pa == pb) & ~miss
                    & (err.double() <= tol.double() + slack))
        close = close | rounding
    bad = torch.nonzero(~close).flatten()
    flips = torch.zeros(bad.shape[0], dtype=torch.bool, device=ta.device)
    if bad.numel():
        o, d = org[bad], dir[bad]
        ha = prim_hit_t(scene, pa[bad], o, d)
        hb = prim_hit_t(scene, pb[bad], o, d)
        flips = ((pa[bad] != pb[bad]) & torch.isfinite(ha)
                 & torch.isfinite(hb)
                 & ((ha - hb).abs()
                    <= FLIP_RTOL * torch.maximum(ha.abs(), hb.abs())))
    n = ta.shape[0]
    n_flips = int(flips.sum())
    unproven = int(bad.numel()) - n_flips
    return {
        "ok": unproven == 0 and n_flips <= MAX_FLIP_FRAC * n,
        "rays": n,
        "hits": int((pa >= 0).sum()),
        "flips": n_flips,
        "rounding": int(rounding.sum()),
        "unproven": unproven,
        "max_abs_err": float(err[close].max()) if close.any() else 0.0,
    }


def grazing_prover(scene: Scene, org: Tensor, dir: Tensor,
                   rtol: float = RTOL,
                   pid: Optional[Tensor] = None) -> Callable:
    """Prover for :func:`compare`'s ``prove_rounding``, for two
    implementations that round differently: pixel k's ray (``org[k]``,
    ``dir[k]``) first hits a sphere at a t that float32 arithmetic does not
    determine to ``rtol`` (:func:`sphere_t_bound`), so its hit point, uv
    and shading are not determined to ``rtol`` either. The first hit is
    searched for, or given as one side's winners ``pid`` [N] (a hit that
    side found and the other missed)."""
    def prove(idx: Tensor) -> Tensor:
        o, d = org[idx], dir[idx]
        if pid is None:
            t, p = nearest_hit_pallas_plain(scene, o, d)
        else:
            # this side's winner may be a miss under the other side's
            # formula: measure t then by the projection on the center
            p = pid[idx].to(o.device)
            t = prim_hit_t(scene, p, o, d)
            c = scene.sphere_center[torch.clamp(
                p.long(), 0, max(scene.n_spheres - 1, 0))]
            t = torch.where(torch.isfinite(t), t, ((c - o) * d).sum(-1))
        bound = sphere_t_bound(scene, p, o, d)
        return (p >= 0) & (bound > rtol * t.abs().double())
    return prove


def compare(color_a: Tensor, status_a: Tensor, color_b: Tensor,
            status_b: Tensor, prove: Optional[Callable] = None,
            rtol: float = RTOL, atol: float = ATOL,
            prove_rounding: Optional[Callable] = None,
            max_rounding_frac: Optional[float] = None) -> dict:
    """Compare two traces pixel by pixel -> report dict with ``ok``.

    ``color_*`` are [..., 3] and ``status_*`` [...] of one shape; a pixel
    outside ``allclose(rtol, atol)`` or with another status fails unless
    ``prove`` (given the flat indices of the failing pixels) shows it is a
    winner flip, or ``prove_rounding`` (e.g. :func:`grazing_prover`) shows
    that float32 rounding leaves it undetermined at this tolerance; such
    pixels are counted as ``rounding``, and may be at most
    ``max_rounding_frac`` of the pixels when that is given.
    """
    a = color_a.reshape(-1, 3).float()
    b = color_b.reshape(-1, 3).to(a.device).float()
    sa = status_a.reshape(-1)
    sb = status_b.reshape(-1).to(sa.device)
    err = (a - b).abs()
    close = (err <= atol + rtol * b.abs()).all(dim=1) & (sa == sb)
    bad = torch.nonzero(~close).flatten()
    flips = torch.zeros(bad.shape[0], dtype=torch.bool, device=a.device)
    rounding = torch.zeros_like(flips)
    if bad.numel() and prove is not None:
        flips = prove(bad).to(a.device)
    if bad.numel() and prove_rounding is not None:
        rounding = prove_rounding(bad).to(a.device) & ~flips
    n = a.shape[0]
    n_flips = int(flips.sum())
    n_rounding = int(rounding.sum())
    unproven = int(bad.numel()) - n_flips - n_rounding
    keep = torch.ones(n, dtype=torch.bool, device=a.device)
    keep[bad[flips | rounding]] = False
    finite = torch.isfinite(a).all() and torch.isfinite(b).all()
    return {
        "ok": bool(finite) and unproven == 0
        and n_flips <= MAX_FLIP_FRAC * n
        and (max_rounding_frac is None or n_rounding <= max_rounding_frac * n),
        "pixels": n,
        "flips": n_flips,
        "rounding": n_rounding,
        "unproven": unproven,
        "max_abs_err": float(err[keep].max()) if keep.any() else 0.0,
        "max_abs_err_all": float(err.max()) if n else 0.0,
    }
