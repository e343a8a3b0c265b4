// Nearest-hit search kernels for the PALLAS and TILED backends (Hopper,
// sm_90a). B6 (nh_listed_kernel) and B8 (nh_culled_kernel), the TILED sweep
// rounds' searches, are described beside their code below.
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

// ---- B6: the listed nearest hit ---------------------------------------------
// nh_listed_kernel -> _nearest_hit_kernel_listed (nearest_hit.py:155, entry
// nearest_hit_pallas(tile_ids=...) :898): one block of 128 threads per
// 128-ray list row, one thread per ray. The row's (super)tile ids are
// streamed in the given order (ascending t_lo); each 128-prim tile is staged
// in shared memory and tested by every ray of the block. Every kChunkT list
// slots the block takes its horizon, the largest over its rays of
// min(t_best, bbox-exit cap), and stops once the next slot's t_lo exceeds
// it: a tile whose t_lo lies past every ray's horizon cannot hold a nearer
// hit. A fan > 1 id covers `fan` consecutive 128-prim tiles. Boxes stream
// dense; spheres and triangles are listed when their lists are given, dense
// otherwise. A t tie goes to the first prim streamed (strict <).
//
// What bounds it: the sphere tests of the streamed tiles (~780 tiles of 128
// spheres per 128-ray block at config 4: ~12.8M tests a block, an IEEE sqrt
// each); the ids, t_lo and rays are a few KB a block. Design: the tile
// staging is the only shared-memory traffic, two barriers a tile and one
// block reduction a chunk; no double buffering yet.

constexpr int kChunkT = 16;       // list slots between early-exit checks

enum { K_SPH = 0, K_BOX = 1, K_TRI = 2 };

template <int Kind>
__device__ __forceinline__ float prim_t(const Ray& r,
                                        const float (*tile)[kTile], int j) {
  if (Kind == K_SPH)
    return sphere_dense(r, tile[0][j], tile[1][j], tile[2][j], tile[3][j]);
  if (Kind == K_BOX)
    return box_t(r, tile[0][j], tile[1][j], tile[2][j], tile[3][j],
                 tile[4][j], tile[5][j]);
  return tri_t(r, tile[0][j], tile[1][j], tile[2][j], tile[3][j], tile[4][j],
               tile[5][j], tile[6][j], tile[7][j], tile[8][j]);
}

// Stage prims [k0, k0 + kTile) of a table padded to whole tiles and fold all
// kTile of them into the running minimum (pids pid0 + k0 + j).
template <int Kind, int Rows>
__device__ __forceinline__ void listed_tile(float (*tile)[kTile],
                                            const float* tab, int stride,
                                            int k0, int pid0, bool active,
                                            const Ray& r, float& t_best,
                                            int& pid) {
  __syncthreads();
  for (int row = 0; row < Rows; ++row)
    tile[row][threadIdx.x] = ld(tab, row, stride, k0 + (int)threadIdx.x);
  __syncthreads();
  if (active) {
    for (int j = 0; j < kTile; ++j)
      fold(prim_t<Kind>(r, tile, j), pid0 + k0 + j, t_best, pid);
  }
}

// The dense scan of one class (B4's loop), prims [0, count).
template <int Kind, int Rows>
__device__ __forceinline__ void dense_class(float (*tile)[kTile],
                                            const float* tab, int stride,
                                            int count, int pid0, bool active,
                                            const Ray& r, float& t_best,
                                            int& pid) {
  for (int k0 = 0; k0 < count; k0 += kTile) {
    __syncthreads();
    stage(tile, tab, Rows, stride, count, k0);
    __syncthreads();
    if (active) {
      const int m = min(kTile, count - k0);
      for (int j = 0; j < m; ++j)
        fold(prim_t<Kind>(r, tile, j), pid0 + k0 + j, t_best, pid);
    }
  }
}

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < kBlock / 32; ++w) m = fmaxf(m, red[w]);
  return m;
}

struct List {
  const int* ids;      // [rows, cols] (super)tile ids, null when dense
  const float* tlo;    // [rows, cols] ascending entry bounds (+inf padding)
  int cols;            // a kChunkT multiple
  int fan;             // 128-prim tiles per id
};

// Stream one class's list for this block's row; returns the slots streamed.
template <int Kind, int Rows>
__device__ int listed_scan(float (*tile)[kTile], float* red, const List& L,
                           const float* tab, int stride, int pid0, int row,
                           bool active, const Ray& r, float t_cap,
                           float& t_best, int& pid) {
  const int* ids = L.ids + (size_t)row * L.cols;
  const float* tlo = L.tlo + (size_t)row * L.cols;
  float t_hi = block_max(active ? fminf(t_best, t_cap) : -kInf, red);
  int j = 0;
  for (; j < L.cols && __ldg(tlo + j) <= t_hi; j += kChunkT) {
    for (int k = 0; k < kChunkT; ++k) {
      const int id = __ldg(ids + j + k);
      for (int f = 0; f < L.fan; ++f)
        listed_tile<Kind, Rows>(tile, tab, stride, (id * L.fan + f) * kTile,
                                pid0, active, r, t_best, pid);
    }
    t_hi = block_max(active ? fminf(t_best, t_cap) : -kInf, red);
  }
  return j;
}

__global__ void __launch_bounds__(kBlock)
nh_listed_kernel(Tables T, const float* __restrict__ org,
                 const float* __restrict__ dir, long long n,
                 const int* __restrict__ n_live,
                 const float* __restrict__ bbox, List sph_list,
                 List tri_list, float* __restrict__ t_out,
                 int* __restrict__ pid_out, int* __restrict__ work) {
  __shared__ float tile[9][kTile];
  __shared__ float red[kBlock / 32];
  const int row = blockIdx.x;
  const long long i = (long long)row * kBlock + threadIdx.x;
  const long long live = min(n, (long long)__ldg(n_live));
  if ((long long)row * kBlock >= live) {
    if (i < n) {
      t_out[i] = kInf;
      pid_out[i] = -1;
    }
    return;
  }
  const bool active = i < live;
  const Ray r = load_ray(org, dir, active ? i : 0);
  // per-ray early-exit cap: the scene-bbox exit (every hit point lies in
  // the union of the prim AABBs)
  const float ex_x = fmaxf((__ldg(bbox + 0) - r.ox) * r.ix,
                           (__ldg(bbox + 3) - r.ox) * r.ix);
  const float ex_y = fmaxf((__ldg(bbox + 1) - r.oy) * r.iy,
                           (__ldg(bbox + 4) - r.oy) * r.iy);
  const float ex_z = fmaxf((__ldg(bbox + 2) - r.oz) * r.iz,
                           (__ldg(bbox + 5) - r.oz) * r.iz);
  const float t_exit = fminf(fminf(ex_x, ex_y), ex_z);
  const float t_cap = fmaxf(t_exit, 0.0f) * (1.0f + 1e-4f) + 1e-3f;
  float t_best = kInf;
  int pid = -1;
  int slots_s = 0, slots_t = 0;
  if (sph_list.ids != nullptr)
    slots_s = listed_scan<K_SPH, 4>(tile, red, sph_list, T.sph, T.s_stride,
                                    0, row, active, r, t_cap, t_best, pid);
  else
    dense_class<K_SPH, 4>(tile, T.sph, T.s_stride, T.n_sph, 0, active, r,
                          t_best, pid);
  dense_class<K_BOX, 6>(tile, T.box, T.b_stride, T.n_box, T.n_sph, active, r,
                        t_best, pid);
  if (tri_list.ids != nullptr)
    slots_t = listed_scan<K_TRI, 9>(tile, red, tri_list, T.tri, T.t_stride,
                                    T.n_sph + T.n_box, row, active, r, t_cap,
                                    t_best, pid);
  else
    dense_class<K_TRI, 9>(tile, T.tri, T.t_stride, T.n_tri,
                          T.n_sph + T.n_box, active, r, t_best, pid);
  if (work != nullptr && threadIdx.x == 0) {
    work[2 * row] = slots_s;
    work[2 * row + 1] = slots_t;
  }
  if (i < n) {
    t_out[i] = active ? t_best : kInf;
    pid_out[i] = active && t_best < kInf ? pid : -1;
  }
}

// ---- B8: the cone-culled dense nearest hit ---------------------------------
// nh_culled_kernel -> _nearest_hit_kernel_culled (nearest_hit.py:113, body
// _nearest_hit_block :236-267 and :415-431, entry
// nearest_hit_pallas(tile_bounds=...) :898): B4's block of 128 rays, which
// first bounds its live rays (the rows below min(n_live, n)) by an apex ball
// (o0 = their mean origin, ro = the largest distance from it) and a cone
// (axis = their normalized mean direction, cos_t = the worst alignment,
// d / sqrt(a)), then skips every 128-sphere tile whose bounding sphere
// (tb [T, 4]: center, radius) the ball-cone cannot reach; cos_t < 0.25
// keeps every tile. The skip is block-uniform: every thread evaluates the
// same predicate on the same values. Boxes and triangles stream dense. The
// cull is conservative, so the result is B4's.
//
// What bounds it: the sphere tests of the tiles kept (an IEEE sqrt each)
// plus the dense boxes and triangles; a per-tile predicate of ~25 float
// operations a thread. Design: B4's staging and fold; the block's sums are
// a shuffle-down tree per warp, then the four warp sums left to right (the
// plain version, nearest_hit_culled_plain, sums in the same order), so the
// predicate is bit-identical. No prefetch of the next kept tile yet.

__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = red[0];
  for (int w = 1; w < kBlock / 32; ++w) s = s + red[w];
  return s;
}

__device__ __forceinline__ float block_min(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < kBlock / 32; ++w) m = fminf(m, red[w]);
  return m;
}

__global__ void __launch_bounds__(kBlock)
nh_culled_kernel(Tables T, const float* __restrict__ org,
                 const float* __restrict__ dir, long long n,
                 const int* __restrict__ n_live,
                 const float* __restrict__ tb, float* __restrict__ t_out,
                 int* __restrict__ pid_out, int* __restrict__ work) {
  __shared__ float tile[9][kTile];
  __shared__ float red[kBlock / 32];
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  const long long live = min(n, (long long)__ldg(n_live));
  if ((long long)blockIdx.x * kBlock >= live) {
    if (i < n) {
      t_out[i] = kInf;
      pid_out[i] = -1;
    }
    if (work != nullptr && threadIdx.x == 0) work[blockIdx.x] = 0;
    return;
  }
  const bool active = i < live;
  const Ray r = load_ray(org, dir, active ? i : 0);

  // the block's cone over its live rays
  const float r_inv = 1.0f / fmaxf(block_sum(active ? 1.0f : 0.0f, red),
                                   1.0f);
  const float o0x = block_sum(active ? r.ox : 0.0f, red) * r_inv;
  const float o0y = block_sum(active ? r.oy : 0.0f, red) * r_inv;
  const float o0z = block_sum(active ? r.oz : 0.0f, red) * r_inv;
  const float ex = r.ox - o0x, ey = r.oy - o0y, ez = r.oz - o0z;
  const float ro =
      sqrtf(block_max(active ? ex * ex + ey * ey + ez * ez : 0.0f, red));
  float axm = block_sum(active ? r.dx : 0.0f, red) * r_inv;
  float aym = block_sum(active ? r.dy : 0.0f, red) * r_inv;
  float azm = block_sum(active ? r.dz : 0.0f, red) * r_inv;
  const float a_n =
      1.0f / sqrtf(fmaxf(axm * axm + aym * aym + azm * azm, 1e-20f));
  axm = axm * a_n;
  aym = aym * a_n;
  azm = azm * a_n;
  const float d_inv = 1.0f / sqrtf(r.a);
  const float cos_t = block_min(
      active ? (r.dx * axm + r.dy * aym + r.dz * azm) * d_inv : 1.0f, red);
  const bool use_cone = cos_t >= 0.25f;
  const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));

  float t_best = kInf;
  int pid = -1;
  int streamed = 0;
  for (int k0 = 0; k0 < T.n_sph; k0 += kTile) {
    const float* b = tb + 4 * (k0 / kTile);
    const float vx = __ldg(b + 0) - o0x;
    const float vy = __ldg(b + 1) - o0y;
    const float vz = __ldg(b + 2) - o0z;
    const float dist = sqrtf(vx * vx + vy * vy + vz * vz);
    const float rr = __ldg(b + 3) + ro;
    const bool inside = dist <= rr * 1.00001f + 1e-7f;
    const float sin_a = fminf(rr / fmaxf(dist, 1e-20f), 1.0f);
    const float cos_a = sqrtf(fmaxf(1.0f - sin_a * sin_a, 0.0f));
    const float cos_b = (vx * axm + vy * aym + vz * azm) / fmaxf(dist, 1e-20f);
    const bool include =
        inside || cos_b >= cos_a * cos_t - sin_a * sin_t - 1e-5f || !use_cone;
    if (!include) continue;          // block-uniform
    ++streamed;
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
  dense_class<K_BOX, 6>(tile, T.box, T.b_stride, T.n_box, T.n_sph, active, r,
                        t_best, pid);
  dense_class<K_TRI, 9>(tile, T.tri, T.t_stride, T.n_tri, T.n_sph + T.n_box,
                        active, r, t_best, pid);
  if (work != nullptr && threadIdx.x == 0) work[blockIdx.x] = streamed;
  if (i < n) {
    t_out[i] = active ? t_best : kInf;
    pid_out[i] = active && t_best < kInf ? pid : -1;
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

// B6. The sphere and triangle tables are padded to whole (super)tiles, the
// sphere padding poisoned (ccmr = +inf); a null ids pointer scans that class
// dense. The lists have at least ceil(n / 128) rows and a multiple of 16
// columns. `work` may be null; else it receives the list slots each block
// streamed, [rows, 2] (spheres, triangles).
extern "C" int rt_nearest_hit_listed(
    const float* sph, int n_sph, int s_stride, const float* box, int n_box,
    int b_stride, const float* tri, int n_tri, int t_stride,
    const float* org, const float* dir, long long n, const int* n_live,
    const float* bbox, const int* sph_ids, const float* sph_tlo, int s_cols,
    int sph_fan, const int* tri_ids, const float* tri_tlo, int t_cols,
    int tri_fan, float* t_out, int* pid_out, int* work, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  const Tables T = make_tables(sph, n_sph, s_stride, box, n_box, b_stride,
                               tri, n_tri, t_stride);
  List ls, lt;
  ls.ids = sph_ids;
  ls.tlo = sph_tlo;
  ls.cols = s_cols;
  ls.fan = sph_fan;
  lt.ids = tri_ids;
  lt.tlo = tri_tlo;
  lt.cols = t_cols;
  lt.fan = tri_fan;
  const long long grid = (n + kBlock - 1) / kBlock;
  nh_listed_kernel<<<(unsigned int)grid, kBlock, 0, (cudaStream_t)stream>>>(
      T, org, dir, n, n_live, bbox, ls, lt, t_out, pid_out, work);
  return (int)cudaGetLastError();
}

// B8. tb holds one row (cx, cy, cz, r) per 128-sphere tile of the sphere
// table, in its order. `work` may be null; else it receives the sphere
// tiles each block streamed, [ceil(n / 128)].
extern "C" int rt_nearest_hit_culled(const float* sph, int n_sph,
                                     int s_stride, const float* box,
                                     int n_box, int b_stride,
                                     const float* tri, int n_tri,
                                     int t_stride, const float* org,
                                     const float* dir, long long n,
                                     const int* n_live, const float* tb,
                                     float* t_out, int* pid_out, int* work,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  const Tables T = make_tables(sph, n_sph, s_stride, box, n_box, b_stride,
                               tri, n_tri, t_stride);
  const long long grid = (n + kBlock - 1) / kBlock;
  nh_culled_kernel<<<(unsigned int)grid, kBlock, 0, (cudaStream_t)stream>>>(
      T, org, dir, n, n_live, tb, t_out, pid_out, work);
  return (int)cudaGetLastError();
}
