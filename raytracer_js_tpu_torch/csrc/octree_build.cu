// The octree's fine grid on the card (Hopper, sm_90a): the CSR of each
// finest cell's prim ids and the chessboard skip field, for a scene whose
// tensors are on the card.
//
// What it replaces: the host half of accel/octree.build_octree that costs
// the time at a million prims, native.grid_csr (csrc/scenekit.cpp's
// sk_count_pairs and sk_fill_csr) and scipy's distance_transform_cdt over
// the R^3 cells, with the uploads of their results (4 (R^3 + 1) + 4 K + R^3
// bytes). The reference package builds its octree on the host
// (raytracer_js_tpu/accel/octree.py); it has no kernel for it. What stays on
// the host is every float64 decision of the build: the root cube, the fine
// mask and the coarse list. The card takes the prims' float32 AABBs (already
// there), the fine mask and the float32 root, the inputs of the host
// scatter, and makes the same integer arrays from them.
//
// The passes, on the caller's stream, behind three C entries:
// - count (rt_octree_count): one thread a prim. A fine prim takes the cells
//   its AABB overlaps (cell_range: scenekit.cpp's float32 arithmetic,
//   rounded the same, with the same clamps) and adds one to each cell's
//   count (an atomic add). The caller scans the counts into the CSR
//   offsets and reads the pair total and the largest count back.
// - fill, then sort (rt_octree_fill): fill is one thread a prim again. Each
//   overlapped cell hands it a slot of its segment by an atomic increment
//   of the cell's cursor (a copy of its offset the caller gives), so a
//   segment holds its prims in an order the atomics choose. Sort is one
//   thread a cell, sorting its segment by prim id in place (a Shell sort).
//   A prim lists each cell once, so a segment's ids differ, and the sorted
//   order is the host's: its scatter is stable in prim order.
// - skip (rt_octree_skip): three launches, one an axis (z, y, x), one
//   thread a line of R cells along it: f'(x) = min over x' of max(|x - x'|, f(x')). Started
//   from 0 on a cell whose count is > 0 and 255 elsewhere, the three passes
//   give the exact chessboard distance to the nearest occupied cell, and
//   min(., 255) commutes with each pass, so u8 holds every stage exactly
//   (as np.minimum(distance_transform_cdt(~occ, "chessboard"), 255); 255
//   everywhere when no cell is occupied). A line is the lower envelope of
//   the flat-bottomed cones max(|x - i|, f(i)), swept once each way with a
//   deque of candidates: an older candidate i goes from the back when a
//   newer one j has f(j) <= f(i) (j is never worse from then on), and from
//   the front when the next one is no worse at x (it stays no worse); the
//   candidates' costs at x fall and then rise, so the front is the minimum.
//   O(R) a line, whatever the field holds.
//
// No pass waits on another thread: no barrier, no shared memory, so the
// tests run the source on the CPU one thread after another with the
// atomics as plain adds (tests/test_torch_octree_build.py).
//
// What bounds it on this card: not the bytes. At 1M prims and depth 8
// (16.5M pairs, R^3 = 16.7M cells) the passes take ~3.3 ms on an H100,
// against 0.05 ms to read the AABBs and write the arrays once: the fill's
// atomics (1.4 ms), the sort's and the skip sweeps' dependent loads. The
// host build of the same grid takes ~1.8 s, and the build's host stages
// (the root, the fine mask) ~0.35 s, so the passes are left simple.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

// The grid the host scatter rounds to: root_lo and root_size as float32,
// cell_sz = root_size / R in float32.
struct Grid {
  float rl[3];
  float cell_sz;
  int R;
};

__device__ __forceinline__ void cell_range(const float* lo, const float* hi,
                                           long long p, const Grid& g,
                                           int* c_lo, int* c_hi) {
  for (int a = 0; a < 3; ++a) {
    const float flo =
        floorf(__fdiv_rn(__fsub_rn(lo[3 * p + a], g.rl[a]), g.cell_sz));
    const float fhi = floorf(__fsub_rn(
        __fdiv_rn(__fsub_rn(hi[3 * p + a], g.rl[a]), g.cell_sz), 1e-9f));
    int il = (int)flo, ih = (int)fhi;
    if (il < 0) il = 0;
    if (il > g.R - 1) il = g.R - 1;
    if (ih < 0) ih = 0;
    if (ih > g.R - 1) ih = g.R - 1;
    c_lo[a] = il;
    c_hi[a] = ih;
  }
}

__global__ void __launch_bounds__(kBlock)
    count_kernel(const float* __restrict__ lo, const float* __restrict__ hi,
                 const unsigned char* __restrict__ fine, long long n,
                 const Grid g, int* counts) {
  const long long p = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (p >= n || !fine[p]) return;
  int cl[3], ch[3];
  cell_range(lo, hi, p, g, cl, ch);
  for (int x = cl[0]; x <= ch[0]; ++x)
    for (int y = cl[1]; y <= ch[1]; ++y)
      for (int z = cl[2]; z <= ch[2]; ++z)
        atomicAdd(&counts[((long long)x * g.R + y) * g.R + z], 1);
}

__global__ void __launch_bounds__(kBlock)
    fill_kernel(const float* __restrict__ lo, const float* __restrict__ hi,
                const unsigned char* __restrict__ fine, long long n,
                const Grid g, int* cursor, int* ids) {
  const long long p = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (p >= n || !fine[p]) return;
  int cl[3], ch[3];
  cell_range(lo, hi, p, g, cl, ch);
  for (int x = cl[0]; x <= ch[0]; ++x)
    for (int y = cl[1]; y <= ch[1]; ++y)
      for (int z = cl[2]; z <= ch[2]; ++z) {
        const long long c = ((long long)x * g.R + y) * g.R + z;
        ids[atomicAdd(&cursor[c], 1)] = (int)p;
      }
}

__global__ void __launch_bounds__(kBlock)
    sort_kernel(const int* __restrict__ offsets, int* ids, long long n_cells) {
  const long long c = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (c >= n_cells) return;
  const int s = offsets[c], n = offsets[c + 1] - s;
  int* a = ids + s;
  int h = 1;
  while (h < n / 3) h = 3 * h + 1;
  for (; h >= 1; h /= 3)
    for (int i = h; i < n; ++i) {
      const int v = a[i];
      int j = i;
      for (; j >= h && a[j - h] > v; j -= h) a[j] = a[j - h];
      a[j] = v;
    }
}

// A deque entry: the candidate's position along the line and its value.
__device__ __forceinline__ int cone(uint32_t e, int x) {
  const int d = x - (int)(e >> 8);
  const int v = (int)(e & 255u);
  return max(d < 0 ? -d : d, v);
}

// One line of the pass along `axis` (0: x, stride R^2; 1: y, stride R; 2:
// z, stride 1): `in` (or, where `offsets` is given, 0 on a cell whose count
// is > 0 and 255 elsewhere) -> `out`. deq holds the line's candidates,
// entry k at deq[k * R^2 + line], so a warp's entries lie side by side.
__global__ void __launch_bounds__(kBlock)
    skip_kernel(const int* __restrict__ offsets,
                const unsigned char* __restrict__ in, unsigned char* out,
                uint32_t* deq, int R, int axis) {
  const long long lines = (long long)R * R;
  const long long line = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (line >= lines) return;
  long long base, stride;
  if (axis == 2) {
    base = line * R;
    stride = 1;
  } else if (axis == 1) {
    base = (line / R) * lines + line % R;
    stride = R;
  } else {
    base = line;
    stride = lines;
  }
  uint32_t* dq = deq + line;
  for (int pass = 0; pass < 2; ++pass) {
    int head = 0, tail = 0;
    for (int k = 0; k < R; ++k) {
      const int x = pass == 0 ? k : R - 1 - k;
      const long long c = base + x * stride;
      const int v = offsets ? (offsets[c + 1] > offsets[c] ? 0 : 255)
                            : (int)in[c];
      while (tail > head && (int)(dq[(tail - 1) * lines] & 255u) >= v)
        --tail;
      dq[tail * lines] = ((uint32_t)x << 8) | (uint32_t)v;
      ++tail;
      while (tail - head >= 2 &&
             cone(dq[head * lines], x) >= cone(dq[(head + 1) * lines], x))
        ++head;
      const int d = cone(dq[head * lines], x);
      out[c] = (unsigned char)(pass == 0 ? d : min(d, (int)out[c]));
    }
  }
}

Grid make_grid(float rl0, float rl1, float rl2, float root_size, int depth) {
  Grid g;
  g.rl[0] = rl0;
  g.rl[1] = rl1;
  g.rl[2] = rl2;
  g.R = 1 << depth;
  g.cell_sz = root_size / (float)g.R;
  return g;
}

unsigned int blocks(long long n) {
  return (unsigned int)((n + kBlock - 1) / kBlock);
}

}  // namespace

// The C entries return the launch's CUDA error (0 on success). lo, hi
// [n, 3] f32 and fine [n] u8 are the prims' AABBs and fine mask; rl0-2 and
// root_size the root as float32; the grid is R = 2^depth cells an axis,
// cell (x, y, z) at (x R + y) R + z.

// counts [R^3] i32, zeroed by the caller: each cell's pair count.
extern "C" int rt_octree_count(const float* lo, const float* hi,
                               const unsigned char* fine, long long n,
                               float rl0, float rl1, float rl2,
                               float root_size, int depth, int* counts,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  const Grid g = make_grid(rl0, rl1, rl2, root_size, depth);
  count_kernel<<<blocks(n), kBlock, 0, (cudaStream_t)stream>>>(lo, hi, fine,
                                                               n, g, counts);
  return (int)cudaGetLastError();
}

// offsets [R^3 + 1] i32, the scan of count's counts; cursor [R^3] i32, a
// copy of offsets[0, R^3), which this spends; writes ids [offsets[R^3]]
// i32, each segment sorted by prim id.
extern "C" int rt_octree_fill(const float* lo, const float* hi,
                              const unsigned char* fine, long long n,
                              float rl0, float rl1, float rl2,
                              float root_size, int depth, const int* offsets,
                              int* cursor, int* ids, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  const Grid g = make_grid(rl0, rl1, rl2, root_size, depth);
  const cudaStream_t st = (cudaStream_t)stream;
  fill_kernel<<<blocks(n), kBlock, 0, st>>>(lo, hi, fine, n, g, cursor, ids);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long cells = (long long)g.R * g.R * g.R;
  sort_kernel<<<blocks(cells), kBlock, 0, st>>>(offsets, ids, cells);
  return (int)cudaGetLastError();
}

// The skip field of the R^3 grid (res = R) from offsets, into out [R^3] u8,
// with tmp [R^3] u8 and deq [R^3] u32 for scratch: the z pass from offsets
// into out, the y pass into tmp, the x pass into out.
extern "C" int rt_octree_skip(const int* offsets, unsigned char* out,
                              unsigned char* tmp, unsigned int* deq, int res,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (res < 1 || res > (1 << 16)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned int nb = blocks((long long)res * res);
  skip_kernel<<<nb, kBlock, 0, st>>>(offsets, nullptr, out, deq, res, 2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  skip_kernel<<<nb, kBlock, 0, st>>>(nullptr, out, tmp, deq, res, 1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  skip_kernel<<<nb, kBlock, 0, st>>>(nullptr, tmp, out, deq, res, 0);
  return (int)cudaGetLastError();
}
