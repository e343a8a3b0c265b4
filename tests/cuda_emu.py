"""A CUDA source of the port built for the CPU, for the tests.

g++ compiles ``raytracer_js_tpu_torch/csrc/<name>.cu`` against a header
that stands in for ``cuda_runtime.h`` (:data:`STUB`, plus what the source
needs beyond it): each ``kernel<<<grid, block, smem, stream>>>(args);``
becomes a launch that runs every thread of the grid in turn, in launch
order, or with ``emu_scramble`` set in the order of an affine map of the
thread index. A source whose threads never wait on one another (no
barrier, no shared memory) then computes on the CPU what it computes on
the card, and its C entries are called through the real launch wrappers on
CPU tensors (:class:`EmulatedBuild`)."""
import ctypes
import pathlib
import re
import shutil
import subprocess
import types

import pytest

from raytracer_js_tpu_torch.kernels import _build

ROOT = pathlib.Path(__file__).resolve().parent.parent

#: the CUDA built-ins every emulated source may use
STUB = r"""
#pragma once
#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>
#include <functional>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
struct Dim3 { unsigned x = 0, y = 0, z = 0; };
inline Dim3 threadIdx, blockIdx;
using std::max;
using std::min;
template <class T> inline T __ldg(const T* p) { return *p; }
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
extern "C" { int emu_scramble = 0; }
inline void emu_launch(unsigned grid, unsigned block,
                       const std::function<void()>& body) {
  const unsigned long long n = (unsigned long long)grid * block;
  for (unsigned long long i = 0; i < n; ++i) {
    // 1000003 is a prime above every grid of the tests: a bijection
    const unsigned long long k =
        emu_scramble ? (1000003ull * i + 12345ull) % n : i;
    blockIdx.x = (unsigned)(k / block);
    threadIdx.x = (unsigned)(k % block);
    body();
  }
}
"""

_LAUNCH = re.compile(r"(\w+)<<<\s*([^,]+),\s*([^,]+),[^>]*>>>\s*\(([^;]*)\);",
                     re.S)


def build(tmp_path_factory, name: str, launches: int,
          extra: str = "") -> ctypes.CDLL:
    """``csrc/<name>.cu`` built by g++ against :data:`STUB` and ``extra``
    (``launches`` is the number of launch sites it holds), each of its C
    entries typed as ``_build.SIGNATURES`` types it; ``.scramble`` is the
    ``emu_scramble`` flag. Skips the test without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel's source for the CPU")
    d = tmp_path_factory.mktemp(f"{name}_cpu")
    (d / "cuda_runtime.h").write_text(STUB + extra)
    src = (ROOT / "raytracer_js_tpu_torch" / "csrc" / f"{name}.cu").read_text()
    src, n = _LAUNCH.subn(
        lambda m: (f"emu_launch({m.group(2)}, {m.group(3)}, [&] "
                   f"{{ {m.group(1)}({m.group(4)}); }});"), src)
    assert n == launches
    (d / f"{name}.cpp").write_text(src)
    lib = d / f"lib{name}_cpu.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", f"-I{d}", str(d / f"{name}.cpp"), "-o",
                    str(lib)], check=True, capture_output=True)
    cdll = ctypes.CDLL(str(lib))
    for entry, (argtypes, restype) in _build.SIGNATURES.items():
        fn = getattr(cdll, entry, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = restype
    cdll.scramble = ctypes.c_int.in_dll(cdll, "emu_scramble")
    return cdll


class EmulatedBuild(types.SimpleNamespace):
    """``kernels/_build`` with the CPU as the card (``load`` given): a
    wrapper or dispatcher given it runs as on the card, into the g++
    build."""

    def __getattr__(self, name):
        return getattr(_build, name)

    @staticmethod
    def on_cpu(device):
        return False if device.type == "cpu" else _build.on_cpu(device)

    @staticmethod
    def stream(device):
        return None
