"""Kernel B3's per-warp cone cull (``nearest_hit.scalar_cull``, the plain
form of the predicate ``nh_scalar_kernel`` evaluates): it never drops a
sphere that any ray of its warp hits, so the culled search is B3's plain
version bit for bit (the kernel tests only the kept spheres, in pid
order), and that search holds against the reference's scalar Pallas kernel
(interpret mode on the CPU); the sphere tests each ray needs, the warps
stream and a dense search runs are ordered.

Rays: the reference's 384-sphere near-miss field (``tests/test_pallas.py``'s
kind) under a 64x64 camera, a small view of the headline scene
(``chip_smoke.headline_scene``, tested equal to ``bench.build_scene(50)``)
and that view's bounce-1 rays (mirror continuations among the stale rays
of finished paths, as the PALLAS loop searches them).

Tolerances: bit for bit against the port's plain version; against the
reference, t within rtol 1e-5 / atol 1e-6 and equal pids but for proven
winner flips, with float32 rounding slack for grazing sphere hits
(``parity.compare_hits``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from raytracer_js_tpu.kernels import nearest_hit as jnh
from raytracer_js_tpu_torch import HitBackend, RenderConfig
from raytracer_js_tpu_torch.kernels import nearest_hit as nh
from raytracer_js_tpu_torch.models.camera import pixel_rays
from raytracer_js_tpu_torch.utils import parity

from test_torch_nearest_hit import camera_rays, near_miss_field
from test_torch_parity import ROOT, load_by_path, to_port_scene

CASES = ("near_miss_384", "headline_bounce0", "headline_bounce1")


@pytest.fixture(scope="module")
def smoke():
    return load_by_path("chip_smoke", ROOT / "chip_smoke.py")


@pytest.fixture(scope="module")
def cases(smoke):
    """name -> (reference scene or None, port scene, org, dir)."""
    js = near_miss_field(384)
    org, d = camera_rays(64, 64)
    out = {"near_miss_384": (js, to_port_scene(js), torch.as_tensor(org),
                             torch.as_tensor(d))}
    head = smoke.headline_scene(device="cpu")
    cam = smoke.make_camera((0.0, 0.0, 0.5), 96, 54, np.pi / 2,
                            np.pi / 2 * 54 / 96, device="cpu")
    o, dd = pixel_rays(cam)
    b0, b1 = smoke.scalar_inputs(
        head, RenderConfig(refmax=2, backend=HitBackend.PALLAS), o, dd)
    out["headline_bounce0"] = (None, head, *b0)
    out["headline_bounce1"] = (None, head, *b1)
    return out


def _sphere_hits(tabs, org, d):
    """[N, S] bool: B3's sphere test is finite (a forward hit)."""
    t = nh._sphere_scalar(nh._rays(org, d), tabs.sph[:, :tabs.n_sph])
    return torch.isfinite(t)


@pytest.mark.parametrize("name", CASES)
def test_cone_never_drops_a_sphere_a_ray_hits(cases, name):
    _js, ps, org, d = cases[name]
    tabs = nh.pack_tables(ps)
    inc = nh.scalar_cull(tabs, org, d)
    assert inc.shape == (-(-org.shape[0] // 32), ps.n_spheres)
    warp = torch.arange(org.shape[0]) // 32
    hits = _sphere_hits(tabs, org, d)
    assert int(hits.sum()) > 100
    assert not bool((hits & ~inc[warp]).any())
    # the cull does cut work: some warp skips some sphere
    assert int(inc.sum()) < inc.numel()


@pytest.mark.parametrize("name", CASES)
def test_culled_search_is_b3s_bit_for_bit(cases, name):
    js, ps, org, d = cases[name]
    tabs = nh.pack_tables(ps)
    inc = nh.scalar_cull(tabs, org, d)

    def mask(lo, hi):
        return inc[torch.arange(lo, hi) // 32]

    t, pid = nh._search_plain(tabs, org, d, nh._sphere_scalar, sph_mask=mask)
    p_t, p_pid = nh.nearest_hit_pallas_scalar_plain(ps, org, d)
    assert torch.equal(t, p_t) and torch.equal(pid, p_pid)
    if js is None:
        return
    r_t, r_pid = jnh.nearest_hit_pallas_scalar(js, jnp.asarray(org.numpy()),
                                               jnp.asarray(d.numpy()))
    rep = parity.compare_hits(ps, org, d, t, pid,
                              torch.as_tensor(np.array(r_t)),
                              torch.as_tensor(np.array(r_pid)),
                              rounding_slack=True)
    assert rep["ok"] and rep["hits"] > 100, rep


@pytest.mark.parametrize("name", CASES)
def test_needed_streamed_all_counts_are_ordered(cases, name):
    """The sphere tests each ray needs (its own cone, ``group=1``) <= those
    its warp streams (the warp's kept spheres against each of its rays) <=
    a dense search's; each ray's own spheres lie within its warp's."""
    _js, ps, org, d = cases[name]
    tabs = nh.pack_tables(ps)
    n = org.shape[0]
    own = nh.scalar_cull(tabs, org, d, group=1)
    warp_inc = nh.scalar_cull(tabs, org, d)
    assert own.shape == (n, ps.n_spheres)
    rays = torch.full((warp_inc.shape[0],), 32)
    rays[-1] = n - 32 * (rays.numel() - 1)
    need = int(own.sum())
    streamed = int((warp_inc.sum(dim=1) * rays).sum())
    assert 0 < need <= streamed < n * ps.n_spheres
    assert bool((own <= warp_inc[torch.arange(n) // 32]).all())
    # a ray's own cone holds every sphere it hits
    assert not bool((_sphere_hits(tabs, org, d) & ~own).any())


def test_scalar_cull_edges(cases):
    _js, ps, org, d = cases["near_miss_384"]
    tabs = nh.pack_tables(ps)
    assert nh.scalar_cull(tabs, org[:0], d[:0]).shape == (0, ps.n_spheres)
    assert nh.scalar_cull(tabs, org[:33], d[:33]).shape == (2, ps.n_spheres)
    # a lone ray in its warp: its warp's cone is its own
    one = nh.scalar_cull(tabs, org[:1], d[:1])
    assert torch.equal(one, nh.scalar_cull(tabs, org[:1], d[:1], group=1))


def test_pack_tables_sphere_bounds(cases):
    from raytracer_js_tpu import SceneBuilder

    js, ps = cases["near_miss_384"][:2]
    tabs = nh.pack_tables(ps)
    want = np.concatenate([np.asarray(js.sphere_center),
                           np.asarray(js.sphere_radius)[:, None]], 1)
    assert tabs.bounds.shape == (384, 4) and tabs.bounds.is_contiguous()
    np.testing.assert_array_equal(tabs.bounds.numpy(), want)
    empty = nh.pack_tables(to_port_scene(SceneBuilder().build()))
    assert empty.bounds.shape == (1, 4)


def test_sphere_bounds_built_on_first_use(cases):
    import dataclasses

    ps = cases["near_miss_384"][1]
    tabs = nh.pack_tables(ps)
    # the other searches never pay for B3's table
    assert "bounds" not in vars(tabs)
    first = tabs.bounds
    assert tabs.bounds is first
    # a table padded to whole supertiles (B6's) gives the same bounds
    padded = dataclasses.replace(
        tabs, sph=nh._pad_tiles(tabs.sph, tabs.n_sph, 2, 3))
    assert padded.sph.shape[1] > tabs.n_sph
    assert torch.equal(padded.bounds, first)
