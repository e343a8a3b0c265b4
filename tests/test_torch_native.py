"""The port's native scene kit (``raytracer_js_tpu_torch/native.py``,
``csrc/scenekit.cpp``): built with g++ from the port's own source, equal
to its NumPy specification and to the reference package's ``native``."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from raytracer_js_tpu import native as jnative
from raytracer_js_tpu_torch import native
from raytracer_js_tpu_torch.accel.octree import covering_levels

from test_native import OBJ_TEXT, _aabbs
from test_torch_parity import build_cpu


def test_native_builds_from_the_ports_source():
    assert native.available(), native.build_error()
    lib = native.library_path()
    assert lib.exists() and lib.parent == native.BUILD_DIR
    assert native.SOURCE.name == "scenekit.cpp"
    assert native.SOURCE.parent.name == "csrc"
    # never the committed library of the reference package, and no
    # machine-specific code generation
    assert "native" not in lib.parent.parts[-2:]
    assert not any(f.startswith("-march") for f in native.CXX_FLAGS)
    assert native._lib._name == str(lib)


@pytest.mark.parametrize("depth", [3, 4, 6])
def test_grid_csr_native_matches_numpy_and_reference(depth):
    lo, hi = _aabbs()
    fine = (np.arange(lo.shape[0]) % 5 != 0)
    root_lo = np.full(3, -4.0, np.float32)
    off_n, ids_n, mpc_n = native.grid_csr(lo, hi, fine, root_lo, 9.0, depth)
    off_p, ids_p, mpc_p = native._grid_csr_numpy(lo, hi, fine, root_lo, 9.0,
                                                 depth)
    off_j, ids_j, mpc_j = jnative.grid_csr(lo, hi, fine, root_lo, 9.0, depth)
    for off, ids, mpc in ((off_p, ids_p, mpc_p), (off_j, ids_j, mpc_j)):
        np.testing.assert_array_equal(off_n, off)
        np.testing.assert_array_equal(ids_n, ids)
        assert off_n.dtype == off.dtype and ids_n.dtype == ids.dtype
        assert mpc_n == mpc


def test_grid_csr_with_nothing_fine():
    lo, hi = _aabbs(20)
    fine = np.zeros(20, bool)
    out_n = native.grid_csr(lo, hi, fine, np.zeros(3, np.float32), 4.0, 2)
    out_p = native._grid_csr_numpy(lo, hi, fine, np.zeros(3, np.float32),
                                   4.0, 2)
    assert out_n[1].size == 0 and out_n[2] == out_p[2] == 0
    np.testing.assert_array_equal(out_n[0], out_p[0])


@pytest.mark.parametrize("depth", [2, 5])
def test_covering_levels_native_matches_numpy(depth):
    lo, hi = _aabbs(100, seed=2)
    root_lo = np.full(3, -4.0)
    lv_n, cell_n = native.covering_levels_native(lo, hi, root_lo, 9.0, depth)
    lv_p, cell_p = covering_levels(lo.astype(np.float64),
                                   hi.astype(np.float64), root_lo, 9.0, depth)
    np.testing.assert_array_equal(lv_n, lv_p)
    np.testing.assert_array_equal(cell_n, cell_p)
    lv_j, cell_j = jnative.covering_levels_native(lo, hi, root_lo, 9.0, depth)
    np.testing.assert_array_equal(lv_n, lv_j)
    np.testing.assert_array_equal(cell_n, cell_j)


def test_obj_load_roundtrip(tmp_path):
    p = tmp_path / "mesh.obj"
    p.write_text(OBJ_TEXT)
    v_n, f_n = native.load_obj(p)
    v_p, f_p = native._load_obj_python(p)
    np.testing.assert_allclose(v_n, v_p)
    np.testing.assert_array_equal(f_n, f_p)
    v_j, f_j = jnative.load_obj(p)
    np.testing.assert_array_equal(v_n, v_j)
    np.testing.assert_array_equal(f_n, f_j)
    assert v_n.shape == (5, 3) and f_n.shape == (4, 3)
    np.testing.assert_array_equal(f_n, [[0, 1, 2], [0, 2, 3], [0, 1, 4],
                                        [2, 3, 4]])
    with pytest.raises(IOError):
        native.load_obj(tmp_path / "missing.obj")


def test_obj_into_scene(tmp_path):
    import raytracer_js_tpu_torch as prt

    p = tmp_path / "mesh.obj"
    p.write_text(OBJ_TEXT)
    v, f = native.load_obj(p)
    b = prt.SceneBuilder()
    b.set_sky(b.add_solid_texture((0.1, 0.1, 0.1)))
    m = b.add_material(prt.ResponseType.REFLECTION)
    b.add_mesh(v, f, m, b.add_solid_texture((1, 0, 0)))
    scene = build_cpu(b)
    assert scene.n_tris == 4 and scene.device.type == "cpu"
    torch.testing.assert_close(scene.tri_v2[3], torch.as_tensor(v[4]))


def test_unbuildable_library_falls_back_to_numpy(monkeypatch, tmp_path):
    """Without a compiler the module reports why and every entry takes its
    NumPy specification."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "CXX", "no-such-compiler-xyz")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "b")
    assert not native.available()
    assert "no-such-compiler-xyz" in native.build_error()
    lo, hi = _aabbs(30)
    fine = np.ones(30, bool)
    off, ids, mpc = native.grid_csr(lo, hi, fine, np.full(3, -4, np.float32),
                                    9.0, 3)
    off_p, ids_p, mpc_p = native._grid_csr_numpy(
        lo, hi, fine, np.full(3, -4, np.float32), 9.0, 3)
    np.testing.assert_array_equal(off, off_p)
    np.testing.assert_array_equal(ids, ids_p)
    assert native.covering_levels_native(lo, hi, np.zeros(3), 9.0, 3) is None
    p = tmp_path / "mesh.obj"
    p.write_text(OBJ_TEXT)
    assert native.load_obj(p)[1].shape == (4, 3)
