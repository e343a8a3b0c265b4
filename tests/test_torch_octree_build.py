"""The octree's fine grid on the card (``csrc/octree_build.cu``,
``kernels/octree_build``) on the CPU.

The CUDA source is compiled here by g++ against a header that runs every
thread of a launch in turn, in launch order or in a scrambled order, with
the atomics as plain adds (``cuda_emu``), and called through the real
wrappers on CPU tensors. ``accel/octree.build_octree`` then takes its card path for a CPU
scene, and every array of the accel is held to the host build
(``native.grid_csr`` and scipy's distance transform), which
``tests/test_torch_octree.py`` holds to the reference package. The
wrappers' passes are also held, one by one, to the host's on grids chosen
by hand: AABBs on the cell planes and the root's faces and one float32
ulp off them, one occupied cell, crowded cells. The dispatch: a CPU scene
takes the host path and launches nothing.

The kernels run on the card in ``chip_smoke.py`` (phase 9k), which holds
them to the host build there at 100k and 1M prims and checks the 255 cap
at depth 9."""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import raytracer_js_tpu_torch as prt
from raytracer_js_tpu_torch import native
from raytracer_js_tpu_torch.accel import octree as po
from raytracer_js_tpu_torch.config import OctreeConfig, ResponseType
from raytracer_js_tpu_torch.kernels import _build
from raytracer_js_tpu_torch.kernels import octree_build as ob

import cuda_emu
from test_octree import _random_scene
from test_torch_parity import to_port_scene

ARRAYS = ("root_lo", "root_size", "coarse_ids", "cell_offsets", "cell_ids",
          "skip_dist")

#: what the build kernels use beyond ``cuda_emu.STUB``: IEEE float32
#: arithmetic, and the atomics as plain adds (the threads run in turn)
_EXTRA = r"""
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline int atomicAdd(int* p, int v) { int o = *p; *p += v; return o; }
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """``csrc/octree_build.cu`` built by g++ for the CPU."""
    return cuda_emu.build(tmp_path_factory, "octree_build", 6, _EXTRA)


@pytest.fixture(params=["in_order", "scrambled"])
def card(emulated, monkeypatch, request):
    """The CPU as the card for the octree build: ``build_octree`` takes its
    card path and the wrappers launch the g++ build, its threads in launch
    order or scrambled. -> the passes' launch counts."""
    emulated.scramble.value = int(request.param == "scrambled")
    fake = cuda_emu.EmulatedBuild(load=lambda: emulated)
    monkeypatch.setattr(ob, "_build", fake)
    monkeypatch.setattr(po, "_build", fake)
    monkeypatch.setattr(ob, "LAUNCHES", dict.fromkeys(ob.LAUNCHES, 0))
    yield ob.LAUNCHES
    emulated.scramble.value = 0


def _host(scene, cfg, **kw):
    """The host build, whatever the ``card`` fixture has patched."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(po, "_build", _build)
        return po.build_octree(scene, cfg, **kw)


def _assert_same(got, want):
    for k in ARRAYS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert torch.equal(a, b), k
    assert (got.max_depth, got.l_cut, got.max_per_cell) == (
        want.max_depth, want.l_cut, want.max_per_cell)


@pytest.fixture(scope="module")
def mixed():
    return to_port_scene(_random_scene(30))


# ---------------------------------------------------------------------------
# build_octree's card path against its host path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [2, 3, 4, 5])
def test_card_build_equals_the_host_build(mixed, card, depth):
    cfg = OctreeConfig(max_depth=depth)
    got = po.build_octree(mixed, cfg)
    want = _host(mixed, cfg)
    _assert_same(got, want)
    assert card == {"count": 1, "fill": 1, "sort": 1, "skip": 3}
    # the grid is neither empty nor full; at depth 2 cells list several ids
    occ = want.skip_dist == 0
    assert 0 < int(occ.sum()) < (1 << depth) ** 3
    assert want.coarse_ids.numel() >= 1
    assert want.max_per_cell > 1 or depth > 2


def test_card_build_with_like_pads_and_refuses_growth(mixed, card):
    cfg = OctreeConfig(max_depth=3)
    base = _host(mixed, cfg)
    moved = dataclasses.replace(mixed,
                                sphere_center=mixed.sphere_center + 0.05)
    got = po.build_octree(moved, cfg, like=base)
    _assert_same(got, _host(moved, cfg, like=base))
    assert got.cell_ids.shape == base.cell_ids.shape
    assert got.coarse_ids.shape == base.coarse_ids.shape
    n_ids = int(got.cell_offsets[-1])
    assert n_ids < got.cell_ids.shape[0]
    assert not bool(got.cell_ids[n_ids:].any())
    tight = dataclasses.replace(base, cell_ids=base.cell_ids[:3])
    for like, depth in ((tight, 3), (base, 4)):
        for build in (po.build_octree, _host):
            with pytest.raises(ValueError, match="pinned capacity"):
                build(mixed, OctreeConfig(max_depth=depth), like=like)


def _boxes(centers, halves):
    b = prt.SceneBuilder()
    b.set_sky(b.add_solid_texture((0.4, 0.5, 0.6)))
    m = b.add_material(ResponseType.REFLECTION)
    t = b.add_solid_texture((0.9, 0.9, 0.9))
    for c, h in zip(centers, halves):
        b.add_box(tuple(float(v) for v in c), tuple(float(v) for v in h), m,
                  t)
    return b.build(device="cpu")


def test_card_build_of_an_empty_and_an_all_coarse_scene(card):
    b = prt.SceneBuilder()
    b.set_sky(b.add_solid_texture((0.4, 0.5, 0.6)))
    empty = b.build(device="cpu")
    cfg = OctreeConfig(max_depth=2)
    _assert_same(po.build_octree(empty, cfg), _host(empty, cfg))
    assert card == {"count": 0, "fill": 0, "sort": 0, "skip": 0}
    # three boxes over one another: the root is their cube, and each
    # overlaps every one of the 32^3 cells, past the fine cap of 64
    coarse = _boxes([(0.0, 0.0, 0.0)] * 3, [(1.0, 1.0, 1.0)] * 3)
    cfg = OctreeConfig(max_depth=5)
    got = po.build_octree(coarse, cfg)
    _assert_same(got, _host(coarse, cfg))
    assert got.coarse_ids.tolist() == [0, 1, 2]
    assert got.cell_ids.numel() == 0 and bool((got.skip_dist == 255).all())
    assert card == {"count": 1, "fill": 1, "sort": 1, "skip": 3}


def test_card_build_raises_the_hosts_csr_overflow(mixed, card, monkeypatch):
    monkeypatch.setattr(ob, "_INT32_MAX", 10)
    with pytest.raises(ValueError, match="octree CSR overflow"):
        po.build_octree(mixed, OctreeConfig(max_depth=3))


def test_cpu_scenes_take_the_host_build(mixed, monkeypatch):
    monkeypatch.setattr(ob, "LAUNCHES", dict.fromkeys(ob.LAUNCHES, 0))
    accel = po.build_octree(mixed, OctreeConfig(max_depth=3))
    assert ob.LAUNCHES == dict.fromkeys(ob.LAUNCHES, 0)
    assert accel.cell_offsets.device.type == "cpu"
    with pytest.raises(ValueError, match="need CUDA tensors"):
        lo, hi = (torch.zeros((1, 3)),) * 2
        ob.count(lo, hi, torch.ones((1,), dtype=torch.uint8),
                 np.zeros(3), 1.0, 2)


# ---------------------------------------------------------------------------
# The passes on grids chosen by hand, against native.grid_csr and scipy
# ---------------------------------------------------------------------------

def _passes(lo, hi, fine, root_lo, size, depth, capacity=None):
    """The wrappers' passes -> (offsets, ids, max_per_cell, skip) as NumPy."""
    lo_t, hi_t = torch.as_tensor(lo), torch.as_tensor(hi)
    fine_t = torch.as_tensor(fine.astype(np.uint8))
    offsets, total, most = ob.count(lo_t, hi_t, fine_t, root_lo, size,
                                    depth)
    ids = ob.fill(lo_t, hi_t, fine_t, root_lo, size, depth, offsets,
                  total if capacity is None else capacity)
    skip = ob.skip_field(offsets, depth)
    return offsets.numpy(), ids.numpy(), most, skip.numpy()


def _assert_passes_equal_the_host(lo, hi, fine, root_lo, size, depth):
    off, ids, most, skip = _passes(lo, hi, fine, root_lo, size, depth)
    off_h, ids_h, most_h = native.grid_csr(lo, hi, fine, root_lo, size,
                                           depth)
    np.testing.assert_array_equal(off, off_h)
    np.testing.assert_array_equal(ids, ids_h)
    assert most == most_h
    np.testing.assert_array_equal(skip, po._skip_field_host(off_h,
                                                            1 << depth))
    return off_h, ids_h, most_h


def _ulp_field(root_lo, size, depth, n, seed):
    """AABBs whose faces lie on the cell planes (the root's faces among
    them), or one float32 ulp either side of them, or anywhere, in float32
    as the host rounds them."""
    rng = np.random.default_rng(seed)
    R = 1 << depth
    cell = np.float32(size) / np.float32(R)
    rl = np.asarray(root_lo, np.float32)

    def on_planes(k):
        v = rl + (k * cell).astype(np.float32)
        return np.where(rng.random(v.shape) < 0.5, v, np.where(
            rng.random(v.shape) < 0.5, np.nextafter(v, np.float32(-np.inf)),
            np.nextafter(v, np.float32(np.inf)))).astype(np.float32)

    k0 = rng.integers(0, R, (n, 3))
    k1 = np.minimum(k0 + rng.integers(0, 3, (n, 3)), R)
    lo, hi = on_planes(k0), on_planes(k1)
    free = rng.random(n) < 0.25
    lo[free] = rl + rng.uniform(0, size, (free.sum(), 3)).astype(np.float32)
    hi[free] = lo[free] + rng.uniform(0, 2 * float(cell),
                                      (free.sum(), 3)).astype(np.float32)
    hi = np.maximum(lo, hi)
    fine = rng.random(n) < 0.9
    return lo, hi, fine


@pytest.mark.parametrize("depth", [2, 3, 4, 5])
@pytest.mark.parametrize("root", ["unit_cells", "odd_size"],
                         ids=["unit_cells", "odd_size"])
def test_passes_on_cell_planes_and_ulps_equal_the_host(card, depth, root):
    root_lo, size = ((np.full(3, -4.0, np.float32), 8.0) if root ==
                     "unit_cells" else (np.float32([-3.1, 0.7, -4.6]), 9.3))
    lo, hi, fine = _ulp_field(root_lo, size, depth, 120, seed=depth)
    _, _, most = _assert_passes_equal_the_host(lo, hi, fine, root_lo, size,
                                               depth)
    assert most > 1


def test_one_occupied_cell_runs_the_distances_to_the_far_corner(card):
    depth, R = 5, 32
    root_lo = np.zeros(3, np.float32)
    for corner in ((0, 0, 0), (31, 0, 17), (5, 31, 31)):
        c = np.float32(corner)
        lo, hi = (c + np.float32(0.25))[None], (c + np.float32(0.5))[None]
        _, _, _, skip = _passes(lo, hi, np.ones(1, bool), root_lo, 32.0,
                                depth)
        g = np.indices((R, R, R)).reshape(3, -1).T
        want = np.abs(g - np.asarray(corner)).max(axis=1)
        np.testing.assert_array_equal(skip, want.astype(np.uint8))
    _assert_passes_equal_the_host(lo, hi, np.ones(1, bool), root_lo, 32.0,
                                  depth)


def test_crowded_cells_list_their_prims_in_prim_order(card):
    """200 prims in one cell and 64 in another beside it: the sort's gaps
    above 1, the ids in prim order whatever order the atomics took."""
    rng = np.random.default_rng(9)
    n = 300
    lo = np.zeros((n, 3), np.float32) + np.float32(0.1)
    lo[200:264, 0] += 1.0
    lo[264:] = rng.uniform(0, 3.5, (n - 264, 3))
    hi = lo + np.float32(0.3)
    _, ids, most = _assert_passes_equal_the_host(
        lo, hi, np.ones(n, bool), np.zeros(3, np.float32), 4.0, 2)
    assert most >= 200


def test_fill_pads_to_the_capacity_with_zeros(card):
    lo, hi, fine = _ulp_field(np.zeros(3, np.float32), 4.0, 3, 40, seed=1)
    off, ids, _, _ = _passes(lo, hi, fine, np.zeros(3, np.float32), 4.0, 3,
                             capacity=10_000)
    k = int(off[-1])
    np.testing.assert_array_equal(
        ids[:k], native.grid_csr(lo, hi, fine, np.zeros(3, np.float32), 4.0,
                                 3)[1])
    assert ids.shape == (10_000,) and not ids[k:].any()


@pytest.mark.parametrize("depth", [2, 3, 4, 5])
def test_skip_passes_equal_scipy(card, depth):
    """Occupancy at several densities (none, one cell, sparse, dense, all)
    through the skip passes alone, against scipy's field."""
    R = 1 << depth
    rng = np.random.default_rng(depth)
    for share in (0.0, -1.0, 0.002, 0.05, 0.5, 1.0):
        if share < 0:
            occ = np.zeros(R ** 3, bool)
            occ[rng.integers(R ** 3)] = True
        else:
            occ = rng.random(R ** 3) < share
        counts = np.where(occ, rng.integers(1, 4, R ** 3), 0)
        off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        got = ob.skip_field(torch.as_tensor(off), depth).numpy()
        np.testing.assert_array_equal(got, po._skip_field_host(off, R),
                                      err_msg=str(share))
