"""Kernel B5's backward sums: the float32 model of the kernel's summation
order (``replay_grad.bwd_sums_model``), the reduce-scatter its warps sum
with, and its grid (``replay_grad.bwd_grid``).

The model gives the same bits on a repeat run and stays within 1e-5 of
the sum of the terms' magnitudes of the float64 sums (``reduce_terms``,
which the reference package's Pallas backward is held to in
``tests/test_torch_replay_grad.py``), for any grid. The reduce-scatter
gives every sum the bits of the full xor butterfly (the same tree). On the
card the kernel's sums equal the model's bit for bit (``chip_smoke.py``
phase 6)."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from raytracer_js_tpu import make_camera
from raytracer_js_tpu.models.camera import pixel_rays
from raytracer_js_tpu_torch import HitBackend, RenderConfig
from raytracer_js_tpu_torch.kernels import replay_grad as rg
from raytracer_js_tpu_torch.models.camera import pixel_rays as p_pixel_rays
from raytracer_js_tpu_torch.ops.trace import record_paths

from test_replay_grad import _scene
from test_torch_parity import ROOT, load_by_path, to_port_scene


def _view(kind, refmax):
    """(port scene, org, dir, pid_seq) of a small view."""
    if kind == "replay9":
        ps = to_port_scene(_scene(seed=0, n_sph=9))
        org, d = (torch.as_tensor(np.array(x)) for x in pixel_rays(
            make_camera((0.0, 0.0, 0.5), 40, 30, np.pi / 2, np.pi / 2)))
    else:
        smoke = load_by_path("chip_smoke", ROOT / "chip_smoke.py")
        ps = smoke.headline_scene(device="cpu")
        org, d = p_pixel_rays(smoke.make_camera(
            (0.0, 0.0, 0.5), 64, 36, np.pi / 2, np.pi / 2 * 36 / 64,
            device="cpu"))
    pid = record_paths(ps, RenderConfig(refmax=refmax,
                                        backend=HitBackend.PALLAS), org, d)
    if kind == "ground":
        # the all-ground rays, packed: every warp has one winner
        g = torch.nonzero(pid[:, 0] == ps.n_spheres).flatten()
        g = g[:g.numel() // 32 * 32]
        org, d, pid = org[g], d[g], pid[g]
    return ps, org, d, pid


@pytest.mark.parametrize("kind,refmax,grid", [
    ("replay9", 2, 1), ("replay9", 3, 3), ("replay9", 4, 7),
    ("headline", 2, 2), ("headline", 2, 13), ("ground", 2, 3)])
def test_model_repeats_and_holds_the_float64_sums(kind, refmax, grid):
    ps, org, d, pid = _view(kind, refmax)
    tabs = rg.scene_tables(ps)
    g_color = torch.as_tensor(np.random.default_rng(1).normal(
        size=(org.shape[0], 3)).astype(np.float32))
    _go, _gd, keys, rows, skies = rg.replay_bwd_terms(
        tabs, org, d, pid, g_color, refmax, 1.0)
    hits = (pid >= 0).T
    got = rg.bwd_sums_model(tabs, keys, rows, skies, hits, grid)
    again = rg.bwd_sums_model(tabs, keys, rows, skies, hits, grid)
    want = rg.reduce_terms(tabs, keys, rows, skies)
    mag = rg.reduce_terms(tabs, keys, rows.abs(), skies.abs())
    assert [x.shape for x in got] == [x.shape for x in want]
    for a, b, w, m in zip(got, again, want, mag):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert bool(((a - w).abs() <= 1e-5 * m).all())
    assert float(mag[0].sum() + mag[1].sum()) > 0.0


def test_model_order_is_not_the_float64_order():
    """The model is float32 in the kernel's order, not a relabelled float64
    sum: on the headline view some sum differs from the float64 one in its
    last bits, and the grid moves some bits."""
    ps, org, d, pid = _view("headline", 2)
    tabs = rg.scene_tables(ps)
    g_color = torch.as_tensor(np.random.default_rng(2).normal(
        size=(org.shape[0], 3)).astype(np.float32))
    _go, _gd, keys, rows, skies = rg.replay_bwd_terms(
        tabs, org, d, pid, g_color, 2, 1.0)
    hits = (pid >= 0).T
    one, many = (rg.bwd_sums_model(tabs, keys, rows, skies, hits, g)
                 for g in (1, 9))
    want = rg.reduce_terms(tabs, keys, rows, skies)
    assert not all(torch.equal(a, w) for a, w in zip(one, want))
    assert not all(torch.equal(a, b) for a, b in zip(one, many))


def _scatter(v, n_vals):
    """The kernel's ``Scatter<n_vals, 16>`` on per-lane values v [32, n]:
    the halving levels, then the plain butterfly -> (sum on each lane,
    its value index q)."""
    lanes = torch.arange(32)
    vals, q, off, n = v.clone(), torch.zeros(32, dtype=torch.long), 16, n_vals
    while n > 1:
        up = (lanes & off) != 0
        h = n // 2
        send = torch.where(up[:, None], vals[:, :h], vals[:, h:n])
        keep = torch.where(up[:, None], vals[:, h:n], vals[:, :h])
        vals = keep + send[lanes ^ off]
        q = 2 * q + up.long()
        n, off = h, off // 2
    s = vals[:, 0]
    while off:
        s = s + s[lanes ^ off]
        off //= 2
    return s, q


@pytest.mark.parametrize("n_vals", [4, 8])
def test_reduce_scatter_gives_the_butterflys_bits(n_vals):
    rng = np.random.default_rng(n_vals)
    for _ in range(20):
        v = torch.as_tensor((rng.normal(size=(32, n_vals))
                             * 10.0 ** rng.integers(-6, 6, (32, n_vals)))
                            .astype(np.float32))
        s, q = _scatter(v, n_vals)
        tree = rg._lane_tree(v.T[:, :, None])[:, 0]          # [n_vals]
        assert torch.equal(s.view(torch.int32), tree[q].view(torch.int32))
        # value 8 of a row, by the full butterfly, lands on every lane alike
        full, _ = _scatter(v[:, :1], 1)
        assert bool((full == full[0]).all()) and torch.equal(
            full[0].view(torch.int32), tree[0].view(torch.int32))


@pytest.mark.parametrize("n,per_sm,sms,want", [
    (0, 4, 132, 0), (1, 4, 132, 1), (127, 4, 132, 1), (128, 4, 132, 1),
    (129, 4, 132, 2), (528 * 128, 4, 132, 528), (528 * 128 + 1, 4, 132, 528),
    (2_088_960, 4, 132, 528), (2_088_960, 5, 132, 660), (300, 1, 1, 1)])
def test_bwd_grid(n, per_sm, sms, want):
    assert rg.bwd_grid(n, per_sm, sms) == want


@pytest.mark.parametrize("args", [(-1, 4, 132), (10, 0, 132), (10, 4, 0)])
def test_bwd_grid_refuses_bad_inputs(args):
    with pytest.raises(ValueError):
        rg.bwd_grid(*args)


def test_model_refuses_the_listed_class():
    ps = to_port_scene(_scene(seed=0, n_sph=200))
    tabs = rg.scene_tables(ps)
    z = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="at most"):
        rg.bwd_sums_model(tabs, z, torch.zeros((1, 4, 9)),
                          torch.zeros((1, 4, 3)), z >= 0, 1)
