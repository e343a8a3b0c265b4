// Nearest-hit search kernels for the PALLAS backend (Hopper, sm_90a).
//
// What they replace (the reference package's TPU kernels):
//   nh_scalar_kernel (B3) -> _nh_scalar_kernel
//       (raytracer_js_tpu/kernels/nearest_hit.py:702, entry
//       nearest_hit_pallas_scalar :863): prims streamed one at a time,
//       for scenes of at most 384 prims.
//   nh_dense_kernel (B4)  -> _nearest_hit_kernel, body _nearest_hit_block
//       (nearest_hit.py:91 and :196, entry nearest_hit_pallas :898): the
//       dense search over 128-prim tiles with the n_live dead-row skip.
// Both compute, per ray, the nearest forward hit (t, pid) over the global
// [spheres | boxes | triangles] order: pid -1 and t = +inf on a miss, a tie
// in t to the lowest pid (strict < in class order). Their plain PyTorch
// twins are kernels/nearest_hit.nearest_hit_pallas_scalar_plain and
// nearest_hit_pallas_plain, which run the same expressions in the same
// order; the two kernels differ in their sphere test, as the TPU kernels do.
//
// What bounds them on this card: per-ray ALU work. Each thread tests every
// primitive: an IEEE sqrt per sphere, a slab test per box, and a
// Moeller-Trumbore test with an IEEE divide per triangle (config 3: 5124
// prims, 5120 of them triangles, for each of 262,144 rays per bounce).
// Device-memory traffic is 24 bytes of ray in and 8 bytes of result out per
// ray; the tables are at most a few hundred KB and stay in L1/L2.
//
// What this first design does about it: one thread per ray, no ray state
// outside registers. B3 reads its (at most 384-prim) tables with __ldg: all
// threads of a warp read the same address, so each load is one broadcast.
// B4 stages 128-prim tiles of each class in shared memory, the GPU
// counterpart of streaming 128-prim tiles from VMEM, so a block of 128 rays
// reads each table from device memory once. The TPU layouts (256x128 ray
// tiles, lane-replicated rows, 128 x DENSE_SPAN padding with poisoned
// spheres) are not carried over: the loops run to the true counts. No culls,
// no wgmma, no TMA yet.
//
// Precision: built with --fmad=false and without fast math, so every
// expression rounds once, as in PyTorch; sqrtf and division are IEEE. The
// sphere dots are products summed left to right (never a matmul).
//
// Tables (row-major [rows, stride] float32, one per primitive class):
//   spheres   cx cy cz ccmr        (ccmr = c.c - r^2, packed on the host)
//   boxes     cx cy cz hx hy hz
//   triangles v0(3) v1(3) v2(3)

#include <cuda_runtime.h>
#include <stdint.h>

#include <limits>

namespace {

constexpr float kInf = std::numeric_limits<float>::infinity();
constexpr float kSlabEps = 1e-12f;
constexpr float kMtEps = 1e-9f;
constexpr int kTile = 128;        // prims per shared-memory tile (B4)
constexpr int kBlock = 128;       // rays per block (B4); kBlock >= kTile

struct Tables {
  const float* sph;
  const float* box;
  const float* tri;
  int n_sph, n_box, n_tri;
  int s_stride, b_stride, t_stride;
};

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float a, inv_a, ix, iy, iz, o_dot_o, o_dot_d;
};

__device__ __forceinline__ float safe_inv(float d) {
  float ds = fabsf(d) < kSlabEps ? (d < 0.0f ? -kSlabEps : kSlabEps) : d;
  return 1.0f / ds;
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ org,
                                        const float* __restrict__ dir,
                                        long long i) {
  Ray r;
  r.ox = __ldg(org + 3 * i);
  r.oy = __ldg(org + 3 * i + 1);
  r.oz = __ldg(org + 3 * i + 2);
  r.dx = __ldg(dir + 3 * i);
  r.dy = __ldg(dir + 3 * i + 1);
  r.dz = __ldg(dir + 3 * i + 2);
  r.a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  r.inv_a = 1.0f / r.a;
  r.ix = safe_inv(r.dx);
  r.iy = safe_inv(r.dy);
  r.iz = safe_inv(r.dz);
  r.o_dot_o = r.ox * r.ox + r.oy * r.oy + r.oz * r.oz;
  r.o_dot_d = r.ox * r.dx + r.oy * r.dy + r.oz * r.dz;
  return r;
}

// B3's sphere test (nearest_hit.py:728-736): clamped discriminant and an
// explicit disc >= 0 mask.
__device__ __forceinline__ float sphere_scalar(const Ray& r, float cx,
                                               float cy, float cz,
                                               float ccmr) {
  float b_half = r.o_dot_d - (r.dx * cx + r.dy * cy + r.dz * cz);
  float c = r.o_dot_o - 2.0f * (r.ox * cx + r.oy * cy + r.oz * cz) + ccmr;
  float disc = b_half * b_half - r.a * c;
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float t_near = (-b_half - sq) * r.inv_a;
  float t_far = (-b_half + sq) * r.inv_a;
  float t = t_near >= 0.0f ? t_near : (t_far >= 0.0f ? t_far : kInf);
  return disc >= 0.0f ? t : kInf;
}

// B4's sphere test (nearest_hit.py:289-303): the factored form; a negative
// discriminant makes sq NaN, every compare on it false, and t = +inf.
__device__ __forceinline__ float sphere_dense(const Ray& r, float cx,
                                              float cy, float cz,
                                              float ccmr) {
  float d_dot_c = r.dx * cx + r.dy * cy + r.dz * cz;
  float o_dot_c = r.ox * cx + r.oy * cy + r.oz * cz;
  float b_half = r.o_dot_d - d_dot_c;
  float c = r.o_dot_o - 2.0f * o_dot_c + ccmr;
  float disc = b_half * b_half - r.a * c;
  float sq = sqrtf(disc);
  float u = (d_dot_c - r.o_dot_d) * r.inv_a;
  float s = sq * r.inv_a;
  float t_sel = u - s >= 0.0f ? u - s : u + s;
  return u + s >= 0.0f ? t_sel : kInf;
}

// Slab test, first forward parameter (both kernels).
__device__ __forceinline__ float box_t(const Ray& r, float cx, float cy,
                                       float cz, float hx, float hy,
                                       float hz) {
  float tax = (cx - hx - r.ox) * r.ix;
  float tbx = (cx + hx - r.ox) * r.ix;
  float tay = (cy - hy - r.oy) * r.iy;
  float tby = (cy + hy - r.oy) * r.iy;
  float taz = (cz - hz - r.oz) * r.iz;
  float tbz = (cz + hz - r.oz) * r.iz;
  float t_enter = fmaxf(fmaxf(fminf(tax, tbx), fminf(tay, tby)),
                        fminf(taz, tbz));
  float t_exit = fminf(fminf(fmaxf(tax, tbx), fmaxf(tay, tby)),
                       fmaxf(taz, tbz));
  float t = t_enter >= 0.0f ? t_enter : (t_exit >= 0.0f ? t_exit : kInf);
  return t_enter <= t_exit ? t : kInf;
}

// Moeller-Trumbore with the 1e-9 determinant floor (both kernels).
__device__ __forceinline__ float tri_t(const Ray& r, float v0x, float v0y,
                                       float v0z, float v1x, float v1y,
                                       float v1z, float v2x, float v2y,
                                       float v2z) {
  float e1x = v1x - v0x, e1y = v1y - v0y, e1z = v1z - v0z;
  float e2x = v2x - v0x, e2y = v2y - v0y, e2z = v2z - v0z;
  float px = r.dy * e2z - r.dz * e2y;
  float py = r.dz * e2x - r.dx * e2z;
  float pz = r.dx * e2y - r.dy * e2x;
  float det = e1x * px + e1y * py + e1z * pz;
  float inv_det = 1.0f / (fabsf(det) < kMtEps ? kMtEps : det);
  float sx = r.ox - v0x, sy = r.oy - v0y, sz = r.oz - v0z;
  float u = (sx * px + sy * py + sz * pz) * inv_det;
  float qx = sy * e1z - sz * e1y;
  float qy = sz * e1x - sx * e1z;
  float qz = sx * e1y - sy * e1x;
  float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  bool ok = fabsf(det) >= kMtEps && u >= 0.0f && v >= 0.0f &&
            u + v <= 1.0f && t >= 0.0f;
  return ok ? t : kInf;
}

__device__ __forceinline__ void fold(float t, int pid, float& t_best,
                                     int& pid_best) {
  if (t < t_best) {
    t_best = t;
    pid_best = pid;
  }
}

__device__ __forceinline__ float ld(const float* tab, int row, int stride,
                                    int p) {
  return __ldg(tab + (long long)row * stride + p);
}

__global__ void nh_scalar_kernel(Tables T, const float* __restrict__ org,
                                 const float* __restrict__ dir, long long n,
                                 float* __restrict__ t_out,
                                 int* __restrict__ pid_out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(org, dir, i);
  float t_best = kInf;
  int pid = -1;
  for (int p = 0; p < T.n_sph; ++p) {
    const int s = T.s_stride;
    fold(sphere_scalar(r, ld(T.sph, 0, s, p), ld(T.sph, 1, s, p),
                       ld(T.sph, 2, s, p), ld(T.sph, 3, s, p)),
         p, t_best, pid);
  }
  for (int p = 0; p < T.n_box; ++p) {
    const int s = T.b_stride;
    fold(box_t(r, ld(T.box, 0, s, p), ld(T.box, 1, s, p), ld(T.box, 2, s, p),
               ld(T.box, 3, s, p), ld(T.box, 4, s, p), ld(T.box, 5, s, p)),
         T.n_sph + p, t_best, pid);
  }
  for (int p = 0; p < T.n_tri; ++p) {
    const int s = T.t_stride;
    fold(tri_t(r, ld(T.tri, 0, s, p), ld(T.tri, 1, s, p), ld(T.tri, 2, s, p),
               ld(T.tri, 3, s, p), ld(T.tri, 4, s, p), ld(T.tri, 5, s, p),
               ld(T.tri, 6, s, p), ld(T.tri, 7, s, p), ld(T.tri, 8, s, p)),
         T.n_sph + T.n_box + p, t_best, pid);
  }
  t_out[i] = t_best;
  pid_out[i] = t_best < kInf ? pid : -1;
}

// Copy prims [k0, k0 + kTile) of a [rows, stride] table into tile[rows][kTile]
// (one prim per thread; columns past the count are left unread).
__device__ __forceinline__ void stage(float (*tile)[kTile], const float* tab,
                                      int rows, int stride, int count,
                                      int k0) {
  const int p = k0 + (int)threadIdx.x;
  if (threadIdx.x < kTile && p < count) {
    for (int row = 0; row < rows; ++row)
      tile[row][threadIdx.x] = ld(tab, row, stride, p);
  }
}

__global__ void __launch_bounds__(kBlock)
nh_dense_kernel(Tables T, const float* __restrict__ org,
                const float* __restrict__ dir, long long n,
                const int* __restrict__ n_live, float* __restrict__ t_out,
                int* __restrict__ pid_out) {
  __shared__ float tile[9][kTile];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long live = min(n, (long long)__ldg(n_live));
  // rows at or past n_live report a miss; a block wholly past it skips
  // the search (every thread of the block takes this branch together)
  if ((long long)blockIdx.x * blockDim.x >= live) {
    if (i < n) {
      t_out[i] = kInf;
      pid_out[i] = -1;
    }
    return;
  }
  // rows past n_live stay in the block only to help stage the tiles
  const bool active = i < live;
  const Ray r = load_ray(org, dir, active ? i : 0);
  float t_best = kInf;
  int pid = -1;

  for (int k0 = 0; k0 < T.n_sph; k0 += kTile) {
    __syncthreads();
    stage(tile, T.sph, 4, T.s_stride, T.n_sph, k0);
    __syncthreads();
    if (active) {
      const int m = min(kTile, T.n_sph - k0);
      for (int j = 0; j < m; ++j)
        fold(sphere_dense(r, tile[0][j], tile[1][j], tile[2][j], tile[3][j]),
             k0 + j, t_best, pid);
    }
  }
  for (int k0 = 0; k0 < T.n_box; k0 += kTile) {
    __syncthreads();
    stage(tile, T.box, 6, T.b_stride, T.n_box, k0);
    __syncthreads();
    if (active) {
      const int m = min(kTile, T.n_box - k0);
      for (int j = 0; j < m; ++j)
        fold(box_t(r, tile[0][j], tile[1][j], tile[2][j], tile[3][j],
                   tile[4][j], tile[5][j]),
             T.n_sph + k0 + j, t_best, pid);
    }
  }
  for (int k0 = 0; k0 < T.n_tri; k0 += kTile) {
    __syncthreads();
    stage(tile, T.tri, 9, T.t_stride, T.n_tri, k0);
    __syncthreads();
    if (active) {
      const int m = min(kTile, T.n_tri - k0);
      for (int j = 0; j < m; ++j)
        fold(tri_t(r, tile[0][j], tile[1][j], tile[2][j], tile[3][j],
                   tile[4][j], tile[5][j], tile[6][j], tile[7][j],
                   tile[8][j]),
             T.n_sph + T.n_box + k0 + j, t_best, pid);
    }
  }
  if (i < n) {
    t_out[i] = t_best;
    pid_out[i] = t_best < kInf ? pid : -1;
  }
}

Tables make_tables(const float* sph, int n_sph, int s_stride,
                   const float* box, int n_box, int b_stride,
                   const float* tri, int n_tri, int t_stride) {
  Tables T;
  T.sph = sph;
  T.box = box;
  T.tri = tri;
  T.n_sph = n_sph;
  T.n_box = n_box;
  T.n_tri = n_tri;
  T.s_stride = s_stride;
  T.b_stride = b_stride;
  T.t_stride = t_stride;
  return T;
}

}  // namespace

// ---- C entry points (loaded with ctypes by kernels/_build.py) --------------
// Each launches on the given stream, does not synchronize, and returns
// cudaGetLastError() (0 on success). The wrappers never call them with no
// rays or no prims: they answer those cases themselves.

extern "C" int rt_nearest_hit_scalar(const float* sph, int n_sph,
                                     int s_stride, const float* box,
                                     int n_box, int b_stride,
                                     const float* tri, int n_tri,
                                     int t_stride, const float* org,
                                     const float* dir, long long n,
                                     float* t_out, int* pid_out, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  const Tables T = make_tables(sph, n_sph, s_stride, box, n_box, b_stride,
                               tri, n_tri, t_stride);
  const int block = 256;
  const long long grid = (n + block - 1) / block;
  nh_scalar_kernel<<<(unsigned int)grid, block, 0, (cudaStream_t)stream>>>(
      T, org, dir, n, t_out, pid_out);
  return (int)cudaGetLastError();
}

extern "C" int rt_nearest_hit_dense(const float* sph, int n_sph, int s_stride,
                                    const float* box, int n_box, int b_stride,
                                    const float* tri, int n_tri, int t_stride,
                                    const float* org, const float* dir,
                                    long long n, const int* n_live,
                                    float* t_out, int* pid_out, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  const Tables T = make_tables(sph, n_sph, s_stride, box, n_box, b_stride,
                               tri, n_tri, t_stride);
  const long long grid = (n + kBlock - 1) / kBlock;
  nh_dense_kernel<<<(unsigned int)grid, kBlock, 0, (cudaStream_t)stream>>>(
      T, org, dir, n, n_live, t_out, pid_out);
  return (int)cudaGetLastError();
}
