"""The kernel build: its sources, the hash over sources and flags, the error
without nvcc, and the ctypes signatures against the C entry points in
``csrc/`` (this machine has no CUDA compiler to check them)."""
import ctypes
import re

import pytest
import torch

torch.set_num_threads(1)

from raytracer_js_tpu_torch.kernels import _build

_C_TYPES = {"int": ctypes.c_int, "unsigned int": ctypes.c_uint,
            "float": ctypes.c_float, "long long": ctypes.c_longlong}


def _c_entries() -> dict:
    """name -> (return type, [parameter declarations]) of every
    ``extern "C"`` function in the sources."""
    out = {}
    for src in _build.SOURCES:
        for ret, name, params in re.findall(
                r'extern "C" ([\w\s*]+?)\s*(rt_\w+)\(([^)]*)\)',
                src.read_text()):
            out[name] = (ret.strip(), [p.strip() for p in params.split(",")])
    return out


def _ctype(param: str):
    if "*" in param:
        return ctypes.c_void_p
    return _C_TYPES[" ".join(param.split()[:-1]).replace("const ", "")]


def test_sources_are_every_cu_file():
    assert sorted(p.name for p in _build.SOURCES) == ["nearest_hit.cu",
                                                      "octree_build.cu",
                                                      "octree_dda.cu",
                                                      "replay_grad.cu",
                                                      "shade.cu",
                                                      "trace_fused.cu",
                                                      "trace_tiled.cu"]


def test_signatures_match_the_c_entries():
    entries = _c_entries()
    assert sorted(entries) == sorted(_build.SIGNATURES)
    assert "rt_octree_dda" in entries
    for name, (ret, params) in entries.items():
        argtypes, restype = _build.SIGNATURES[name]
        assert [_ctype(p) for p in params] == argtypes, name
        assert restype == (ctypes.c_char_p if "char" in ret
                           else ctypes.c_int), name


def test_digest_covers_sources_and_flags(monkeypatch):
    d0 = _build._digest()
    assert d0 == _build._digest()
    monkeypatch.setattr(_build, "NVCC_FLAGS",
                        _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build._digest() != d0
    for flag in ("--fmad=false", "arch=compute_90a,code=sm_90a"):
        assert flag in _build.NVCC_FLAGS
    assert not any("fast" in f for f in _build.NVCC_FLAGS)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as ext

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not list(tmp_path.iterdir())
