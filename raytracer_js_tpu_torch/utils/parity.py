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
    t_all = torch.cat([
        intersect.sphere_hit_t(org, dir, scene.sphere_center,
                               scene.sphere_radius),
        intersect.box_hit_t(org, dir, scene.box_center, scene.box_half),
        intersect.tri_hit_t(org, dir, scene.tri_v0, scene.tri_v1,
                            scene.tri_v2)], dim=1)
    t = t_all.gather(1, pid.long().clamp(min=0)[:, None])[:, 0]
    return torch.where(pid >= 0, t, float("inf"))


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


def compare(color_a: Tensor, status_a: Tensor, color_b: Tensor,
            status_b: Tensor, prove: Optional[Callable] = None,
            rtol: float = RTOL, atol: float = ATOL) -> dict:
    """Compare two traces pixel by pixel -> report dict with ``ok``.

    ``color_*`` are [..., 3] and ``status_*`` [...] of one shape; a pixel
    outside ``allclose(rtol, atol)`` or with another status fails unless
    ``prove`` (given the flat indices of the failing pixels) shows it is a
    winner flip.
    """
    a = color_a.reshape(-1, 3).float()
    b = color_b.reshape(-1, 3).to(a.device).float()
    sa = status_a.reshape(-1)
    sb = status_b.reshape(-1).to(sa.device)
    err = (a - b).abs()
    close = (err <= atol + rtol * b.abs()).all(dim=1) & (sa == sb)
    bad = torch.nonzero(~close).flatten()
    flips = torch.zeros(bad.shape[0], dtype=torch.bool, device=a.device)
    if bad.numel() and prove is not None:
        flips = prove(bad).to(a.device)
    n = a.shape[0]
    n_flips = int(flips.sum())
    unproven = int(bad.numel()) - n_flips
    keep = torch.ones(n, dtype=torch.bool, device=a.device)
    keep[bad[flips]] = False
    finite = torch.isfinite(a).all() and torch.isfinite(b).all()
    return {
        "ok": bool(finite) and unproven == 0
        and n_flips <= MAX_FLIP_FRAC * n,
        "pixels": n,
        "flips": n_flips,
        "unproven": unproven,
        "max_abs_err": float(err[keep].max()) if keep.any() else 0.0,
        "max_abs_err_all": float(err.max()) if n else 0.0,
    }
