"""The redesigned octree search (``csrc/octree_dda.cu``: the skip byte read
first, a live mask) on the CPU: the occupancy invariant the kernel's read
order rests on, for every way an accel is made; the live mask of the plain
loop, bit for bit against the unmasked loop; and the OCTREE frame,
recording and fit, which pass the mask, equal to the same with the
unmasked search, and held to the reference package's frame. The kernel
itself runs only on the card (``chip_smoke.py`` phase 9f); its source is
also compiled here by g++ against a header that runs each thread of a
launch in turn, and held to the plain loop bit for bit, the live mask
included."""
import dataclasses
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import raytracer_js_tpu as jrt
from raytracer_js_tpu.accel.octree import build_octree as j_build
from raytracer_js_tpu.config import HitBackend as JB
from raytracer_js_tpu.config import OctreeConfig as JOctreeConfig
from raytracer_js_tpu_torch import HitBackend, RenderConfig
from raytracer_js_tpu_torch import render_hdr
from raytracer_js_tpu_torch.accel import octree as po
from raytracer_js_tpu_torch.config import OctreeConfig
from raytracer_js_tpu_torch.kernels import octree_dda
from raytracer_js_tpu_torch.models.camera import pixel_rays
from raytracer_js_tpu_torch.models.scene import float_partition
from raytracer_js_tpu_torch.ops.trace import record_paths
from raytracer_js_tpu_torch.optim import FitConfig, fit
from raytracer_js_tpu_torch.utils import parity

import cuda_emu
from scenes import config1_scene
from test_octree import _random_scene
from test_torch_octree_dda import _model, _rays
from test_torch_parity import (ROOT, assert_parity, load_by_path,
                               to_port_camera, to_port_scene)

INF_BITS = torch.tensor(float("inf")).view(torch.int32)


def _assert_skip_marks_the_occupied_cells(pa):
    """skip 0 exactly where the cell's CSR count is > 0."""
    count = pa.cell_offsets[1:] - pa.cell_offsets[:-1]
    assert torch.equal(pa.skip_dist == 0, count > 0)
    assert bool((count >= 0).all())


# ---------------------------------------------------------------------------
# The occupancy invariant, for every way an accel is made
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixed():
    js = _random_scene(30)
    return js, to_port_scene(js)


@pytest.fixture(scope="module")
def smoke():
    return load_by_path("chip_smoke", ROOT / "chip_smoke.py")


@pytest.mark.parametrize("depth", [2, 3, 4, 5])
def test_skip_is_zero_exactly_on_occupied_cells_of_a_fresh_build(mixed,
                                                                  depth):
    _, ps = mixed
    pa = po.build_octree(ps, OctreeConfig(max_depth=depth))
    _assert_skip_marks_the_occupied_cells(pa)
    assert bool((pa.skip_dist == 0).any()) and bool((pa.skip_dist > 0).any())


@pytest.mark.parametrize("depth", [3, 6])
def test_skip_is_zero_exactly_on_occupied_cells_of_config4_and_the_field(
        smoke, depth):
    for scene in (smoke.config4_scene(2000, device="cpu"),
                  smoke.octree_field().build(device="cpu")):
        _assert_skip_marks_the_occupied_cells(
            po.build_octree(scene, OctreeConfig(max_depth=depth)))


def test_skip_is_zero_exactly_on_occupied_cells_of_a_like_rebuild(mixed):
    """``like=`` pads the ids and the coarse list to the pinned shapes; the
    padding is never a cell's id, and the skip field follows the new
    counts."""
    _, ps = mixed
    base = po.build_octree(ps, OctreeConfig(max_depth=3))
    moved = dataclasses.replace(ps, sphere_center=ps.sphere_center + 0.3)
    pa = po.build_octree(moved, OctreeConfig(max_depth=3), like=base)
    assert pa.cell_ids.shape == base.cell_ids.shape
    assert int(pa.cell_offsets[-1]) < pa.cell_ids.shape[0]   # padded
    assert not torch.equal(pa.skip_dist, base.skip_dist)
    _assert_skip_marks_the_occupied_cells(pa)


def test_skip_is_255_and_offsets_0_on_the_empty_scene():
    from raytracer_js_tpu_torch import SceneBuilder

    b = SceneBuilder()
    b.set_sky(b.add_solid_texture((0.5, 0.5, 0.5)))
    pa = po.build_octree(b.build(device="cpu"), OctreeConfig(max_depth=2))
    assert bool((pa.skip_dist == 255).all())
    assert bool((pa.cell_offsets == 0).all())
    _assert_skip_marks_the_occupied_cells(pa)


def test_skip_is_zero_exactly_on_occupied_cells_without_scipy(smoke,
                                                              monkeypatch):
    """The NumPy fallback (``_chebyshev_dist_np``, capped at 15) when scipy
    cannot be imported: the exact distance capped at 15, a weaker skip with
    the same zeros (config 4's layout at depth 6 has cells 25 rings from an
    occupied one)."""
    scene = smoke.config4_scene(2000, device="cpu")
    with_scipy = po.build_octree(scene, OctreeConfig(max_depth=6))
    calls = []
    real = po._chebyshev_dist_np

    def spy(occ, cap=15):
        calls.append(cap)
        return real(occ, cap)

    monkeypatch.setitem(sys.modules, "scipy", None)
    monkeypatch.setitem(sys.modules, "scipy.ndimage", None)
    monkeypatch.setattr(po, "_chebyshev_dist_np", spy)
    pa = po.build_octree(scene, OctreeConfig(max_depth=6))
    assert calls == [15]
    _assert_skip_marks_the_occupied_cells(pa)
    assert torch.equal(pa.skip_dist, with_scipy.skip_dist.clamp(max=15))
    assert int(with_scipy.skip_dist.max()) > 15


# ---------------------------------------------------------------------------
# The live mask of the plain loop
# ---------------------------------------------------------------------------

def _check_masked(ps, pa, o, d, live):
    """The masked loop against the unmasked one: bit for bit on the live
    rays (t, pid, steps, tests), (inf, -1, 0, 0) on the dead ones, and the
    stats of the live rays alone."""
    st_u, pr_u, st_m, pr_m = {}, {}, {}, {}
    t_u, p_u = po.nearest_hit_octree_plain(ps, pa, o, d, st_u, pr_u)
    t_m, p_m = po.nearest_hit_octree_plain(ps, pa, o, d, st_m, pr_m,
                                           live=live)
    assert torch.equal(t_m[live].view(torch.int32),
                       t_u[live].view(torch.int32))
    assert torch.equal(p_m[live], p_u[live])
    for k in ("steps", "tests"):
        assert torch.equal(pr_m[k][live], pr_u[k][live]), k
        assert bool((pr_m[k][~live] == 0).all()), k
    assert bool((t_m[~live].view(torch.int32) == INF_BITS).all())
    assert bool((p_m[~live] == -1).all())
    assert st_m == {"steps": int(pr_m["steps"].max()),
                    "ray_steps": int(pr_u["steps"][live].sum()),
                    "tests": int(pr_u["tests"][live].sum())}
    # the dispatcher passes the mask on
    t_a, p_a = po.nearest_hit_octree(ps, pa, o, d, live=live)
    assert torch.equal(t_a, t_m) and torch.equal(p_a, p_m)
    return pr_u


@pytest.mark.parametrize("depth", [2, 3, 4])
def test_masked_loop_equals_the_unmasked_loop_on_live_rays(mixed, depth):
    _, ps = mixed
    pa = po.build_octree(ps, OctreeConfig(max_depth=depth))
    o, d = _rays(256, 200 + depth)
    live = torch.as_tensor(np.random.default_rng(depth).uniform(
        size=256) < 0.5)
    pr_u = _check_masked(ps, pa, o, d, live)
    # the dead rays would have walked and hit
    assert int(pr_u["steps"][~live].sum()) > 100
    # the kernel's per-ray model, unmasked, on the same rays
    t_k, p_k, s_k, n_k = _model(ps, pa, o, d)
    assert torch.equal(s_k, pr_u["steps"]) and torch.equal(n_k,
                                                           pr_u["tests"])


@pytest.mark.parametrize("depth", [3, 4])
def test_masked_loop_on_the_near_miss_field(smoke, depth):
    field = smoke.octree_field().build(device="cpu")
    pa = po.build_octree(field, OctreeConfig(max_depth=depth))
    o, d, kinds = smoke.octree_field_rays(field, pa, seed=depth)
    live = torch.as_tensor(np.random.default_rng(9 + depth).uniform(
        size=o.shape[0]) < 0.5)
    live[torch.as_tensor(kinds == "cap")] = True     # a cap walk stays
    _check_masked(field, pa, o, d, live)
    # every ray dead, and every ray live
    _check_masked(field, pa, o, d, torch.zeros_like(live))
    _check_masked(field, pa, o, d, torch.ones_like(live))


def test_masked_loop_without_a_grid(mixed):
    """An accel with no grid ids: the coarse pass only."""
    _, ps = mixed
    pa = po.build_octree(ps, OctreeConfig(max_depth=2))
    cells = pa.skip_dist.shape[0]
    coarse_only = dataclasses.replace(
        pa, coarse_ids=torch.arange(ps.n_prims, dtype=torch.int32),
        cell_offsets=torch.zeros((cells + 1,), dtype=torch.int32),
        cell_ids=torch.zeros((0,), dtype=torch.int32),
        skip_dist=torch.full((cells,), 255, dtype=torch.uint8))
    o, d = _rays(64, 12)
    live = torch.arange(64) % 2 == 1
    pr_u = _check_masked(ps, coarse_only, o, d, live)
    assert int(pr_u["steps"].sum()) == 0


def test_dispatch_passes_the_live_mask_to_the_kernel(mixed, monkeypatch):
    _, ps = mixed
    pa = po.build_octree(ps, OctreeConfig(max_depth=3))
    o, d = _rays(32, 8)
    live = torch.arange(32) % 3 == 0
    seen = []

    def fake_launch(scene, accel, org, dir, live=None):
        seen.append(live)
        n = org.shape[0]
        return (torch.full((n,), float("inf")),
                torch.full((n,), -1, dtype=torch.int32),
                torch.zeros((n,), dtype=torch.int32),
                torch.zeros((n,), dtype=torch.int32))

    monkeypatch.setattr(po._build, "on_cpu", lambda dev: False)
    monkeypatch.setattr(octree_dda, "launch", fake_launch)
    po.nearest_hit_octree(ps, pa, o, d, live=live)
    po.nearest_hit_octree(ps, pa, o, d)
    assert seen[0] is live and seen[1] is None


# ---------------------------------------------------------------------------
# Frames, recordings and fits: dead rays' answers are never read
# ---------------------------------------------------------------------------

@pytest.fixture
def unmasked(monkeypatch):
    """Within the fixture's test, a switch that makes the OCTREE search
    ignore its live mask (the search as it was before the mask), and the
    ray-steps each search walked."""
    real = po.nearest_hit_octree
    state = {"mask": True, "ray_steps": []}

    def search(scene, accel, org, dir, stats=None, per_ray=None, live=None):
        st = {}
        out = real(scene, accel, org, dir, stats=st, per_ray=per_ray,
                   live=live if state["mask"] else None)
        state["ray_steps"].append(st["ray_steps"])
        if stats is not None:
            stats.update(st)
        return out

    monkeypatch.setattr(po, "nearest_hit_octree", search)
    return state


def _scenes():
    jm = _random_scene(30)
    jc = config1_scene(with_glass=True, with_tri=True)
    return {"mixed": (jm, jrt.make_camera((0.0, 0.0, 9.0), 20, 18, 1.3, 1.1,
                                          rot_v=-0.9)),
            "config1_glass_tri": (jc, jrt.make_camera(
                (0.0, 0.0, 0.5), 20, 18, np.pi / 2, np.pi / 2))}


@pytest.mark.parametrize("name", ["mixed", "config1_glass_tri"])
def test_masked_frame_and_recording_equal_the_unmasked_ones(name,
                                                            unmasked):
    js, jcam = _scenes()[name]
    ps, pc = to_port_scene(js), to_port_camera(jcam)
    pa = po.build_octree(ps, OctreeConfig(max_depth=3))
    cfg = RenderConfig(refmax=3, backend=HitBackend.OCTREE)
    org, dirs = pixel_rays(pc)
    img_m = render_hdr(ps, pc, cfg, accel=pa)
    rec_m = record_paths(ps, cfg, org, dirs, accel=pa)
    walked_m = list(unmasked["ray_steps"])
    unmasked["mask"], unmasked["ray_steps"] = False, []
    img_u = render_hdr(ps, pc, cfg, accel=pa)
    rec_u = record_paths(ps, cfg, org, dirs, accel=pa)
    walked_u = unmasked["ray_steps"]
    assert torch.equal(img_m, img_u) and torch.equal(rec_m, rec_u)
    # bounce 0 walks every ray either way; later bounces walk fewer rays
    # with the mask, and dead rays were there to skip
    assert len(walked_m) == len(walked_u) == 2 * cfg.refmax
    assert walked_m[0] == walked_u[0] > 0
    assert sum(walked_m) < sum(walked_u)
    assert int((rec_m[:, 1:] < 0).sum()) > 0
    # the masked frame against the reference's OCTREE frame, by the rule
    # of tests/test_torch_configs.py
    ref = np.asarray(jrt.render_hdr(js, jcam, jrt.RenderConfig(
        refmax=3, backend=JB.OCTREE), accel=j_build(js, JOctreeConfig(
            max_depth=3))))
    zeros = np.zeros((pc.h, pc.w), np.int32)
    assert_parity(img_m, zeros, ref, zeros,
                  prove_rounding=parity.grazing_prover(ps, org, dirs))


def test_masked_fit_equals_the_unmasked_fit(unmasked):
    """The search path's gradients (``replay_every=0``: autograd through
    the bounces, whose dead rays now carry pid -1) and an accel rebuild:
    losses and every leaf bit for bit."""
    js, jcam = _scenes()["config1_glass_tri"]
    ps, pc = to_port_scene(js), to_port_camera(jcam)
    cfg = RenderConfig(refmax=3, backend=HitBackend.OCTREE)
    target = torch.full((1, pc.h * pc.w, 3), 0.2)
    fc = FitConfig(steps=3, lr=1e-2, optimizer="sgd", accel_every=2)

    def run():
        return fit(ps, cfg, [pc], target, fc,
                   accel=po.build_octree(ps, OctreeConfig(max_depth=3)))

    got = run()
    unmasked["mask"] = False
    want = run()
    assert got.losses == want.losses
    assert got.losses[-1] < got.losses[0]
    for g, w in zip(float_partition(got.scene)[0],
                    float_partition(want.scene)[0]):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# The CUDA source on the CPU: one thread a ray, run in turn
# ---------------------------------------------------------------------------

#: what the search kernel uses beyond ``cuda_emu.STUB``: cvt.rzi's
#: truncation, saturating and NaN to 0
_EXTRA = r"""
inline int __float2int_rz(float x) {
  if (x != x) return 0;
  const double d = std::trunc((double)x);
  return d < (double)INT_MIN ? INT_MIN : (d > (double)INT_MAX ? INT_MAX
                                                             : (int)d);
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """``csrc/octree_dda.cu`` built by g++ for the CPU."""
    return cuda_emu.build(tmp_path_factory, "octree_dda", 1, _EXTRA)


def _emulated_search(cdll, scene, accel, org, dir, live=None):
    """The entry's arguments as ``kernels/octree_dda.launch`` passes them,
    on CPU tensors -> (t, pid, steps, tests)."""
    n = org.shape[0]
    t = torch.empty((n,))
    pid = torch.empty((n,), dtype=torch.int32)
    steps = torch.empty((n,), dtype=torch.int32)
    tests = torch.empty((n,), dtype=torch.int32)

    def ptr(x):
        return None if x is None or x.numel() == 0 else x.data_ptr()

    err = cdll.rt_octree_dda(
        ptr(scene.sphere_center), ptr(scene.sphere_radius), scene.n_spheres,
        ptr(scene.box_center), ptr(scene.box_half), scene.n_boxes,
        ptr(scene.tri_v0), ptr(scene.tri_v1), ptr(scene.tri_v2),
        scene.n_tris, ptr(accel.root_lo), ptr(accel.root_size),
        ptr(accel.coarse_ids), accel.coarse_ids.shape[0],
        ptr(accel.cell_offsets), ptr(accel.cell_ids),
        accel.cell_ids.shape[0], ptr(accel.skip_dist), accel.res,
        accel.max_per_cell, ptr(org), ptr(dir), ptr(live), n, ptr(t),
        ptr(pid), ptr(steps), ptr(tests), 0, None)
    assert err == 0
    return t, pid, steps, tests


class _IEEESqrt:
    """``torch`` for ``accel/octree`` with an IEEE square root: the kernel's
    sqrtf is correctly rounded, torch's CPU sqrt is not on every CPU (with
    AVX-512 it is 1 ulp off for ~0.6% of inputs)."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def sqrt(x):
        return torch.from_numpy(np.sqrt(x.numpy()))


def _check_emulated(cdll, scene, pa, o, d, live, monkeypatch):
    monkeypatch.setattr(po, "torch", _IEEESqrt())
    st, pr = {}, {}
    t_p, p_p = po.nearest_hit_octree_plain(scene, pa, o, d, st, pr,
                                           live=live)
    monkeypatch.undo()
    t_k, p_k, s_k, n_k = _emulated_search(cdll, scene, pa, o, d, live)
    assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
    assert torch.equal(p_k, p_p)
    assert torch.equal(s_k, pr["steps"]) and torch.equal(n_k, pr["tests"])
    return s_k


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("depth", [2, 4])
def test_kernel_source_on_the_cpu_equals_the_loop_on_the_mixed_scene(
        emulated, mixed, depth, masked, monkeypatch):
    _, ps = mixed
    pa = po.build_octree(ps, OctreeConfig(max_depth=depth))
    o, d = _rays(1000, 300 + depth)
    live = (torch.as_tensor(np.random.default_rng(depth).uniform(
        size=1000) < 0.5) if masked else None)
    steps = _check_emulated(emulated, ps, pa, o, d, live, monkeypatch)
    assert int(steps.max()) > 2
    # fewer rays than a warp, and than a block
    for n in (1, 29, 100):
        _check_emulated(emulated, ps, pa, o[:n].contiguous(),
                        d[:n].contiguous(),
                        None if live is None else live[:n].contiguous(),
                        monkeypatch)


@pytest.mark.parametrize("depth", [3, 4])
def test_kernel_source_on_the_cpu_equals_the_loop_on_the_near_miss_field(
        emulated, smoke, depth, monkeypatch):
    field = smoke.octree_field().build(device="cpu")
    pa = po.build_octree(field, OctreeConfig(max_depth=depth))
    o, d, kinds = smoke.octree_field_rays(field, pa, seed=depth)
    steps = _check_emulated(emulated, field, pa, o, d, None, monkeypatch)
    assert bool((steps[torch.as_tensor(kinds == "cap")]
                 == 3 * pa.res + 2).all())
    live = torch.as_tensor(np.random.default_rng(depth).uniform(
        size=o.shape[0]) < 0.5)
    _check_emulated(emulated, field, pa, o, d, live, monkeypatch)
