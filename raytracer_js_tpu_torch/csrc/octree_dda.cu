// The OCTREE backend's nearest-hit search (Hopper, sm_90a): one launch
// carries the whole search, the coarse brute pass and the fine-grid DDA with
// empty-space skipping, for every ray.
//
// What it replaces: the reference package's nearest_hit_octree
// (raytracer_js_tpu/accel/octree.py:426), whose DDA is one
// jax.lax.while_loop (:530) that XLA keeps on the device. It is no Pallas
// kernel. Its plain PyTorch twin is accel/octree.nearest_hit_octree_plain,
// a host loop over the live rays: a step there is ~30 small launches and a
// torch.nonzero that waits for the device.
//
// What it computes, per ray: the nearest forward hit (t, pid) over the
// accel's coarse ids (every ray, in list order), then over the candidate
// ids of each finest cell the ray pierces, near to far; pid -1 and t = +inf
// on a miss. Each cell's ids are tested in CSR order and the first minimum
// wins (a strict <), as torch.min(dim) picks the first index; the cell's
// minimum replaces the best hit on a strict <. The walk derives the cell
// from p = o + (t_cur + eps_t) d, advances to max(the cell's exit, a jump
// of max(k - 2, 0) chessboard rings through proven-empty space, t_cur +
// eps_t), and stops once the best hit precedes the new position or the ray
// leaves the root, or after 3R + 2 steps. Besides (t, pid) it writes each
// ray's step count and candidate-test count (coarse ids >= 0 plus each
// step's cell count).
//
// What bounds it on this card: the gathers. Each step reads two CSR
// offsets and one skip byte at the ray's cell, and each candidate its id
// and its prim's row; a depth-8 grid's offsets alone are 67 MB, more than
// the 50 MB L2, and neighbouring rays share cells only while they stay
// together. Then divergence: a warp runs as long as its longest walk (at
// depth 8, 25.6 steps a ray on average at config 4's bounce 0, up to 770).
// The design: one thread per ray, all of its state in registers, one launch
// and no host round trip, each ray leaving at its own exit. Reordering the
// rays, persistent warps and compaction are later work.
//
// Precision: built with --fmad=false and without fast math, so every
// expression rounds once; `/` and sqrtf are IEEE. Every expression repeats
// the plain version's (accel/octree.prim_hit_t and the loop) in its order,
// with its Python scalars as the float32 constants that torch makes of them
// ((float)1e-12, (float)1e-4, MT_EPS (float)1e-9). torch.minimum, maximum,
// min(dim), max(dim) and clamp propagate NaN, so do their forms here
// (never fminf/fmaxf); a float is truncated to int32 by cvt.rzi (the
// conversion torch's .to(torch.int32) compiles to on the card) after floor.
// The plain loop also tests the slots at or past a cell's count, as pid
// -1 with t = +inf; this kernel skips them and the coarse list's -1
// padding: a primitive test never returns NaN (each of its results passes a
// >= 0 compare or is +inf), and +inf never wins a strict <.
//
// Tables (float32, row-major, as the Scene holds them): sphere centers
// [S, 3] and radii [S], box centers and half sizes [B, 3], triangle
// vertices v0, v1, v2 [T, 3]. The accel: root_lo [3], root_size [],
// coarse ids [Nc] i32, cell offsets [R^3 + 1] i32, cell ids [K] i32, skip
// distances [R^3] u8.

#include <cuda_runtime.h>
#include <math.h>

#include <limits>

namespace {

constexpr int kBlock = 128;
constexpr float kInf = std::numeric_limits<float>::infinity();
// Python's 1e-12 (the DDA's and the slab's |dir| floor, SLAB_DIR_EPS),
// 1e-4 (eps_t) and MT_EPS as torch converts them: the double rounded to
// float
constexpr float kDirEps = (float)1e-12;
constexpr float kEpsT = (float)1e-4;
constexpr float kMtEps = (float)1e-9;

struct Prims {
  const float* sph_c;
  const float* sph_r;
  const float* box_c;
  const float* box_h;
  const float* v0;
  const float* v1;
  const float* v2;
  int n_sph;
  int n_box;
  int n_tri;
};

struct Grid {
  const float* root_lo;
  const float* root_size;
  const int* coarse;
  const int* offsets;
  const int* ids;
  const unsigned char* skip;
  int n_coarse;
  int n_ids;
  int res;
  int max_per_cell;
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* p, int i) {
  return V3{__ldg(p + 3 * i), __ldg(p + 3 * i + 1), __ldg(p + 3 * i + 2)};
}

__device__ __forceinline__ V3 sub3(V3 a, V3 b) {
  return V3{a.x - b.x, a.y - b.y, a.z - b.z};
}

// ops/vecmath.dot: the products summed left to right
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// ops/vecmath.cross
__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}

// torch.minimum / torch.maximum: NaN if either is NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (b < a ? b : a));
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (b > a ? b : a));
}

// torch.clamp(x, min=0.0): NaN stays NaN
__device__ __forceinline__ float clamp_min0(float x) {
  return (x != x) ? x : (x < 0.f ? 0.f : x);
}

// the |dir| floor of the DDA's inverse and of ops/intersect._slab:
// 1.0 / where(|d| < 1e-12, where(d < 0, -1e-12, 1e-12), d)
__device__ __forceinline__ float safe_inv(float d) {
  const float ds = fabsf(d) < kDirEps ? (d < 0.f ? -kDirEps : kDirEps) : d;
  return 1.0f / ds;
}

// the finest cell along one axis: clamp(int32(floor((p - lo) / cell_sz)),
// 0, R - 1), the int32 cast as cvt.rzi (saturating, NaN -> 0)
__device__ __forceinline__ int cell_of(float p, float lo, float cell_sz,
                                       int R) {
  const int c = __float2int_rz(floorf((p - lo) / cell_sz));
  return c < 0 ? 0 : (c > R - 1 ? R - 1 : c);
}

// accel/octree.prim_hit_t for one (ray, prim), pid in [0, n_prims): the
// first forward hit parameter, +inf on a miss
__device__ float prim_hit_t(const Prims& P, V3 o, V3 d, int pid) {
  if (pid < P.n_sph) {
    const V3 c = load3(P.sph_c, pid);
    const float r = __ldg(P.sph_r + pid);
    const V3 oc = sub3(o, c);
    const float b_half = dot3(oc, d);
    const float a = dot3(d, d);
    const float cc = dot3(oc, oc) - r * r;
    const float disc = b_half * b_half - a * cc;
    const float sq = sqrtf(clamp_min0(disc));
    const float tn = (-b_half - sq) / a;
    const float tf = (-b_half + sq) / a;
    const float ts = tn >= 0.f ? tn : (tf >= 0.f ? tf : kInf);
    return disc >= 0.f ? ts : kInf;
  }
  if (pid < P.n_sph + P.n_box) {
    // ops/intersect._slab on lo = c - h, hi = c + h
    const int i = pid - P.n_sph;
    const V3 c = load3(P.box_c, i);
    const V3 h = load3(P.box_h, i);
    const float ix = safe_inv(d.x), iy = safe_inv(d.y), iz = safe_inv(d.z);
    const float tax = ((c.x - h.x) - o.x) * ix;
    const float tay = ((c.y - h.y) - o.y) * iy;
    const float taz = ((c.z - h.z) - o.z) * iz;
    const float tbx = ((c.x + h.x) - o.x) * ix;
    const float tby = ((c.y + h.y) - o.y) * iy;
    const float tbz = ((c.z + h.z) - o.z) * iz;
    const float te = nan_max(nan_max(nan_min(tax, tbx), nan_min(tay, tby)),
                             nan_min(taz, tbz));
    const float tx = nan_min(nan_min(nan_max(tax, tbx), nan_max(tay, tby)),
                             nan_max(taz, tbz));
    const float tb = te >= 0.f ? te : (tx >= 0.f ? tx : kInf);
    return te <= tx ? tb : kInf;
  }
  // Moeller-Trumbore
  const int i = pid - P.n_sph - P.n_box;
  const V3 v0 = load3(P.v0, i);
  const V3 e1 = sub3(load3(P.v1, i), v0);
  const V3 e2 = sub3(load3(P.v2, i), v0);
  const V3 pv = cross3(d, e2);
  const float det = dot3(e1, pv);
  const float adet = fabsf(det);
  const float inv = 1.0f / (adet < kMtEps ? kMtEps : det);
  const V3 sv = sub3(o, v0);
  const float u = dot3(sv, pv) * inv;
  const V3 qv = cross3(sv, e1);
  const float v = dot3(d, qv) * inv;
  const float tt = dot3(e2, qv) * inv;
  const bool ok = adet >= kMtEps && u >= 0.f && v >= 0.f && u + v <= 1.0f &&
                  tt >= 0.f;
  return ok ? tt : kInf;
}

__global__ void __launch_bounds__(kBlock)
    octree_dda_kernel(Prims P, Grid G, const float* __restrict__ org,
                      const float* __restrict__ dir, long long n,
                      float* __restrict__ t_out, int* __restrict__ pid_out,
                      int* __restrict__ steps_out,
                      int* __restrict__ tests_out) {
  const long long r = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (r >= n) return;
  const V3 o{org[3 * r], org[3 * r + 1], org[3 * r + 2]};
  const V3 d{dir[3 * r], dir[3 * r + 1], dir[3 * r + 2]};

  // --- coarse brute pass: every ray, the list in order -------------------
  float t_best = kInf;
  int pid_best = -1;
  int tests = 0;
  for (int c = 0; c < G.n_coarse; ++c) {
    const int id = __ldg(G.coarse + c);
    if (id < 0) continue;  // padding
    ++tests;
    const float t = prim_hit_t(P, o, d, id);
    if (t < t_best) {
      t_best = t;
      pid_best = id;
    }
  }

  // --- fine-grid DDA with empty-space skipping --------------------------
  int steps = 0;
  if (G.n_ids > 0) {
    const int R = G.res;
    const float rs = __ldg(G.root_size);
    // root_size / R: torch multiplies by the float 1/R, the same float for
    // a power of two R
    const float cell_sz = rs / (float)R;
    const V3 lo = load3(G.root_lo, 0);
    const V3 hi{lo.x + rs, lo.y + rs, lo.z + rs};
    const float ix = safe_inv(d.x), iy = safe_inv(d.y), iz = safe_inv(d.z);
    const float tax = (lo.x - o.x) * ix, tbx = (hi.x - o.x) * ix;
    const float tay = (lo.y - o.y) * iy, tby = (hi.y - o.y) * iy;
    const float taz = (lo.z - o.z) * iz, tbz = (hi.z - o.z) * iz;
    const float t_enter = nan_max(
        nan_max(nan_min(tax, tbx), nan_min(tay, tby)), nan_min(taz, tbz));
    const float t_exit = nan_min(
        nan_min(nan_max(tax, tbx), nan_max(tay, tby)), nan_max(taz, tbz));
    float t_cur = clamp_min0(t_enter);
    const float spx = d.x >= 0.f ? 1.f : 0.f;
    const float spy = d.y >= 0.f ? 1.f : 0.f;
    const float spz = d.z >= 0.f ? 1.f : 0.f;
    // time to cross one chessboard ring of cells (max-axis speed)
    const float dt_cheb =
        cell_sz / nan_max(nan_max(fabsf(d.x), fabsf(d.y)), fabsf(d.z));
    const float eps_t = kEpsT * dt_cheb;
    const int K = G.max_per_cell;
    const int max_steps = 3 * R + 2;
    bool live = t_cur <= t_exit;
    while (live && steps < max_steps) {
      ++steps;
      // position-based stepping: the cell from the current param
      const float s = t_cur + eps_t;
      const int cx = cell_of(o.x + s * d.x, lo.x, cell_sz, R);
      const int cy = cell_of(o.y + s * d.y, lo.y, cell_sz, R);
      const int cz = cell_of(o.z + s * d.z, lo.z, cell_sz, R);
      const int lin = (cx * R + cy) * R + cz;
      const int base = __ldg(G.offsets + lin);
      const int cnt = __ldg(G.offsets + lin + 1) - base;
      const int m = cnt < K ? cnt : K;
      float t_min = kInf;
      int p_min = -1;
      for (int j = 0; j < m; ++j) {
        const int id = __ldg(G.ids + base + j);
        const float t = prim_hit_t(P, o, d, id);
        if (t < t_min) {
          t_min = t;
          p_min = id;
        }
      }
      tests += m;
      if (t_min < t_best) {
        t_best = t_min;
        pid_best = p_min;
      }
      // advance at least to the cell's exit; through empty space jump k - 2
      // rings (the skip field proves no occupied cell within k - 1 rings)
      const float nbx = lo.x + ((float)cx + spx) * cell_sz;
      const float nby = lo.y + ((float)cy + spy) * cell_sz;
      const float nbz = lo.z + ((float)cz + spz) * cell_sz;
      const float t_exit_cell =
          nan_min(nan_min((nbx - o.x) * ix, (nby - o.y) * iy),
                  (nbz - o.z) * iz);
      const float k = (float)__ldg(G.skip + lin);
      const float t_jump = t_cur + clamp_min0(k - 2.0f) * dt_cheb;
      const float t_new = nan_max(nan_max(t_exit_cell, t_jump), t_cur + eps_t);
      // torch: (~isinf(t_best) & (t_best <= t_new)) | (t_new > t_exit)
      live = !((fabsf(t_best) != kInf && t_best <= t_new) || t_new > t_exit);
      t_cur = t_new;
    }
  }
  t_out[r] = t_best;
  pid_out[r] = fabsf(t_best) < kInf ? pid_best : -1;  // isfinite
  steps_out[r] = steps;
  tests_out[r] = tests;
}

}  // namespace

// One launch for the whole search of n rays (org, dir [n, 3] f32) ->
// t_out [n] f32, pid_out [n] i32 and each ray's steps_out and tests_out
// [n] i32, on `stream`; returns the launch's CUDA error (0 on success).
extern "C" int rt_octree_dda(
    const float* sph_c, const float* sph_r, int n_sph, const float* box_c,
    const float* box_h, int n_box, const float* v0, const float* v1,
    const float* v2, int n_tri, const float* root_lo, const float* root_size,
    const int* coarse, int n_coarse, const int* offsets, const int* ids,
    int n_ids, const unsigned char* skip, int res, int max_per_cell,
    const float* org, const float* dir, long long n, float* t_out,
    int* pid_out, int* steps_out, int* tests_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  if (res < 1 || max_per_cell < 1) return (int)cudaErrorInvalidValue;
  const Prims P{sph_c, sph_r, box_c, box_h, v0, v1, v2, n_sph, n_box, n_tri};
  const Grid G{root_lo, root_size, coarse, offsets, ids, skip,
               n_coarse, n_ids, res, max_per_cell};
  const long long grid = (n + kBlock - 1) / kBlock;
  octree_dda_kernel<<<(unsigned int)grid, kBlock, 0, (cudaStream_t)stream>>>(
      P, G, org, dir, n, t_out, pid_out, steps_out, tests_out);
  return (int)cudaGetLastError();
}
