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
// step's cell count). A ray that the optional live mask marks dead takes
// no walk: t = +inf, pid -1, 0 steps and 0 tests.
//
// What bounds it on this card: each step's dependent chain (the cell from
// the position, its skip byte, and in an occupied cell the offsets, ids and
// rows, then the advance) and the spread of the walks' lengths, not the
// bytes. At depth 8 (config 4, 100k prims) a walk takes 25.6 steps on
// average and up to 310 at bounce 0 and 313 at bounce 1 (the cap is 3R + 2
// = 770); 74% of bounce 0's steps cross empty cells. The CSR offsets
// [R^3 + 1] i32 are 67 MB, more than the 50 MB L2; the skip field [R^3] u8
// is 16.7 MB and stays in L2. Camera rays are coherent: neighbouring
// threads read the same cells (on an H100 a thread-a-ray search took 2.6x
// as long on the same rays shuffled), so a ray's place in its warp matters
// too.
//
// The design, for that:
// - Empty cells read only the skip byte. The build makes the skip field
//   from the counts (accel/octree.build_octree: occ = diff(offsets) > 0,
//   skip = min(chessboard distance to an occupied cell, 255), at least 1 off
//   the occupied cells, the NumPy fallback's too), so skip[c] == 0 exactly
//   where cell c lists an id. A step reads skip[c] first and reads the two
//   offsets only when it is 0; a cell with skip > 0 has count 0, so it
//   tests the same ids (none) without them.
// - Finished rays take no walk: a ray the live mask marks dead reads its
//   mask byte and writes its miss, nothing else.
// - A sphere test computes a root only where it is the answer (the near
//   root where the discriminant is >= 0, the far one where the near is
//   behind): the same value, fewer IEEE divisions and square roots.
// - One thread a ray, launched in ray order, so that a warp's camera rays
//   walk the same cells together; every function inlined, no stack frame.
//   Persistent warps refilling their lanes from a ray queue (Aila and
//   Laine, "Understanding the Efficiency of Ray Traversal on GPUs", HPG
//   2009) were tried: on an H100 they ran 7% slower on camera rays and
//   took a stack frame, and saved 0.2 ms on a frame's second bounce, whose
//   live rays lie scattered among dead ones; a frame that waits on its
//   host launches does not show it (PERF.md).
// - Every ray's arithmetic, and the order of its candidate tests, is the
//   loop's: which thread runs a ray changes nothing in its result.
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
// distances [R^3] u8. The live mask [N] u8 (torch.bool) or null.

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
__device__ __forceinline__ float prim_hit_t(const Prims& P, V3 o, V3 d, int pid) {
  if (pid < P.n_sph) {
    const V3 c = load3(P.sph_c, pid);
    const float r = __ldg(P.sph_r + pid);
    const V3 oc = sub3(o, c);
    const float b_half = dot3(oc, d);
    const float a = dot3(d, d);
    const float cc = dot3(oc, oc) - r * r;
    const float disc = b_half * b_half - a * cc;
    // disc >= 0 ? (tn >= 0 ? tn : (tf >= 0 ? tf : inf)) : inf, each root
    // computed only where it is the answer
    if (!(disc >= 0.f)) return kInf;
    const float sq = sqrtf(clamp_min0(disc));
    const float tn = (-b_half - sq) / a;
    if (tn >= 0.f) return tn;
    const float tf = (-b_half + sq) / a;
    return tf >= 0.f ? tf : kInf;
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

// One ray's search state, held in registers by the thread that runs it
struct Ray {
  V3 o, d;
  float ix, iy, iz;  // the |dir|-floored inverse direction
  float t_cur, t_exit, dt_cheb, eps_t;
  float t_best;
  int pid_best, steps, tests;
  long long r;
};

// The grid's constants, the same for every ray
struct Walk {
  V3 lo;
  float cell_sz;
  int R, K, max_steps;
};

// The coarse brute pass of ray `ray.r` (every ray, the list in order) and
// its walk's set-up; returns whether the ray walks the grid.
__device__ __forceinline__ bool start_ray(const Prims& P, const Grid& G,
                                          const Walk& W,
                                          const float* __restrict__ org,
                                          const float* __restrict__ dir,
                                          Ray& ray) {
  const long long r = ray.r;
  const V3 o{org[3 * r], org[3 * r + 1], org[3 * r + 2]};
  const V3 d{dir[3 * r], dir[3 * r + 1], dir[3 * r + 2]};
  ray.o = o;
  ray.d = d;
  ray.t_best = kInf;
  ray.pid_best = -1;
  ray.tests = 0;
  ray.steps = 0;
  for (int c = 0; c < G.n_coarse; ++c) {
    const int id = __ldg(G.coarse + c);
    if (id < 0) continue;  // padding
    ++ray.tests;
    const float t = prim_hit_t(P, o, d, id);
    if (t < ray.t_best) {
      ray.t_best = t;
      ray.pid_best = id;
    }
  }
  if (G.n_ids <= 0) return false;
  const V3 lo = W.lo;
  const float rs = __ldg(G.root_size);
  const V3 hi{lo.x + rs, lo.y + rs, lo.z + rs};
  const float ix = safe_inv(d.x), iy = safe_inv(d.y), iz = safe_inv(d.z);
  const float tax = (lo.x - o.x) * ix, tbx = (hi.x - o.x) * ix;
  const float tay = (lo.y - o.y) * iy, tby = (hi.y - o.y) * iy;
  const float taz = (lo.z - o.z) * iz, tbz = (hi.z - o.z) * iz;
  const float t_enter = nan_max(
      nan_max(nan_min(tax, tbx), nan_min(tay, tby)), nan_min(taz, tbz));
  ray.t_exit = nan_min(
      nan_min(nan_max(tax, tbx), nan_max(tay, tby)), nan_max(taz, tbz));
  ray.t_cur = clamp_min0(t_enter);
  ray.ix = ix;
  ray.iy = iy;
  ray.iz = iz;
  // time to cross one chessboard ring of cells (max-axis speed)
  ray.dt_cheb =
      W.cell_sz / nan_max(nan_max(fabsf(d.x), fabsf(d.y)), fabsf(d.z));
  ray.eps_t = kEpsT * ray.dt_cheb;
  return ray.t_cur <= ray.t_exit;
}

// One DDA step of a walking ray; returns whether it walks on.
__device__ __forceinline__ bool step_ray(const Prims& P, const Grid& G,
                                         const Walk& W, Ray& ray) {
  ++ray.steps;
  const V3 o = ray.o, d = ray.d, lo = W.lo;
  const float cell_sz = W.cell_sz;
  const int R = W.R;
  const float t_cur = ray.t_cur;
  // position-based stepping: the cell from the current param
  const float s = t_cur + ray.eps_t;
  const int cx = cell_of(o.x + s * d.x, lo.x, cell_sz, R);
  const int cy = cell_of(o.y + s * d.y, lo.y, cell_sz, R);
  const int cz = cell_of(o.z + s * d.z, lo.z, cell_sz, R);
  const int lin = (cx * R + cy) * R + cz;
  // the skip byte first: 0 exactly where the cell lists an id
  const unsigned skip = __ldg(G.skip + lin);
  if (skip == 0u) {
    const int base = __ldg(G.offsets + lin);
    const int cnt = __ldg(G.offsets + lin + 1) - base;
    const int m = cnt < W.K ? cnt : W.K;
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
    ray.tests += m;
    if (t_min < ray.t_best) {
      ray.t_best = t_min;
      ray.pid_best = p_min;
    }
  }
  // advance at least to the cell's exit; through empty space jump k - 2
  // rings (the skip field proves no occupied cell within k - 1 rings)
  const float nbx = lo.x + ((float)cx + (d.x >= 0.f ? 1.f : 0.f)) * cell_sz;
  const float nby = lo.y + ((float)cy + (d.y >= 0.f ? 1.f : 0.f)) * cell_sz;
  const float nbz = lo.z + ((float)cz + (d.z >= 0.f ? 1.f : 0.f)) * cell_sz;
  const float t_exit_cell = nan_min(
      nan_min((nbx - o.x) * ray.ix, (nby - o.y) * ray.iy),
      (nbz - o.z) * ray.iz);
  const float k = (float)skip;
  const float t_jump = t_cur + clamp_min0(k - 2.0f) * ray.dt_cheb;
  const float t_new =
      nan_max(nan_max(t_exit_cell, t_jump), t_cur + ray.eps_t);
  ray.t_cur = t_new;
  // torch: (~isinf(t_best) & (t_best <= t_new)) | (t_new > t_exit)
  const float tb = ray.t_best;
  const bool done = (fabsf(tb) != kInf && tb <= t_new) || t_new > ray.t_exit;
  return !done && ray.steps < W.max_steps;
}

__device__ __forceinline__ void finish(const Ray& ray,
                                       float* __restrict__ t_out,
                                       int* __restrict__ pid_out,
                                       int* __restrict__ steps_out,
                                       int* __restrict__ tests_out) {
  const long long r = ray.r;
  t_out[r] = ray.t_best;
  pid_out[r] = fabsf(ray.t_best) < kInf ? ray.pid_best : -1;  // isfinite
  steps_out[r] = ray.steps;
  tests_out[r] = ray.tests;
}

__global__ void __launch_bounds__(kBlock)
    octree_dda_kernel(Prims P, Grid G, const float* __restrict__ org,
                      const float* __restrict__ dir,
                      const unsigned char* __restrict__ live, long long n,
                      float* __restrict__ t_out, int* __restrict__ pid_out,
                      int* __restrict__ steps_out,
                      int* __restrict__ tests_out) {
  Ray ray;
  ray.r = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (ray.r >= n) return;
  Walk W;
  W.lo = load3(G.root_lo, 0);
  W.R = G.res;
  // root_size / R: torch multiplies by the float 1/R, the same float for a
  // power of two R
  W.cell_sz = __ldg(G.root_size) / (float)G.res;
  W.K = G.max_per_cell;
  W.max_steps = 3 * G.res + 2;
  if (live != nullptr && live[ray.r] == 0) {
    ray.t_best = kInf;  // a dead ray: no walk, a miss
    ray.pid_best = -1;
    ray.steps = 0;
    ray.tests = 0;
  } else if (start_ray(P, G, W, org, dir, ray)) {
    while (step_ray(P, G, W, ray)) {
    }
  }
  finish(ray, t_out, pid_out, steps_out, tests_out);
}

}  // namespace

// One launch for the whole search of n rays (org, dir [n, 3] f32; live [n]
// u8 or null, a dead ray taking no walk) -> t_out [n] f32, pid_out [n] i32
// and each ray's steps_out and tests_out [n] i32, on `stream`; returns the
// launch's CUDA error (0 on success).
extern "C" int rt_octree_dda(
    const float* sph_c, const float* sph_r, int n_sph, const float* box_c,
    const float* box_h, int n_box, const float* v0, const float* v1,
    const float* v2, int n_tri, const float* root_lo, const float* root_size,
    const int* coarse, int n_coarse, const int* offsets, const int* ids,
    int n_ids, const unsigned char* skip, int res, int max_per_cell,
    const float* org, const float* dir, const unsigned char* live,
    long long n, float* t_out, int* pid_out, int* steps_out, int* tests_out,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  if (res < 1 || max_per_cell < 1) return (int)cudaErrorInvalidValue;
  const Prims P{sph_c, sph_r, box_c, box_h, v0, v1, v2, n_sph, n_box, n_tri};
  const Grid G{root_lo, root_size, coarse, offsets, ids, skip,
               n_coarse, n_ids, res, max_per_cell};
  const long long grid = (n + kBlock - 1) / kBlock;
  octree_dda_kernel<<<(unsigned int)grid, kBlock, 0, (cudaStream_t)stream>>>(
      P, G, org, dir, live, n, t_out, pid_out, steps_out, tests_out);
  return (int)cudaGetLastError();
}
