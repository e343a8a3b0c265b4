// The wavefront shade of one bounce (Hopper, sm_90a): everything that
// ops/trace._shade does with a bounce's winners, in one launch.
//
// What it replaces: ops/trace._shade and, on a trace's last bounce, the
// epilogue of ops/trace.trace_rays (its plain twin, which stays the path
// of CPU tensors and of everything outside this kernel's class). In the
// reference package that glue is XLA-fused elementwise code around the
// search (raytracer_js_tpu/ops/trace.py); it has no Pallas kernel. On the
// card the plain twin is ~240 PyTorch launches a bounce: the surface
// recompute of every class on every ray, the material and texture gathers,
// the scatter, the sky and the torch.where selects, each a pass over the
// wavefront.
//
// What it computes, per ray (one thread a ray, in ray order): a ray that is
// not ALIVE passes through unchanged (TILED's capped status among them). An
// ALIVE ray with a winner (pid >= 0) recomputes the winner's surface (t,
// point, normal: ops/intersect.sphere_surface, box_surface, tri_surface),
// multiplies its color by the winner's solid texture, adds t to its path,
// and then ends LIGHT on an emitter, continues along the mirror reflection
// (with the counter-RNG rough scatter where the scene is rough), advanced
// by EPS_ADVANCE along the new direction, or ends KEEP. An ALIVE ray
// without a winner multiplies its color by the solid sky and ends MISS.
// With `last` set the same pass applies trace_rays's epilogue to every ray:
// ALIVE -> EXHAUST and black, LIGHT -> the inverse-square law. It also
// writes the next bounce's ALIVE mask, which the next search takes as its
// live mask.
//
// The class: solid textures, an equirect sky (solid, so a constant), no
// transmission (and so no BOTH). The substance never changes in this class,
// so refr is not an output: the caller keeps the input's.
//
// What bounds it on this card: bytes. A ray reads 48 B (org, dir, color,
// path, status, pid) and writes 45 (org, dir, color, path, status, alive);
// the prim and material tables are read at the winners and stay in L2.
//
// Precision: built with --fmad=false and without fast math, so every
// expression rounds once, in the order of the plain twin (ops/intersect,
// ops/vecmath.reflect, ops/sampling.scatter_direction_xyz), with its Python
// scalars as the float32 constants torch makes of them. Division and square
// root are IEEE (__fdiv_rn, __fsqrt_rn); `1.0 / x` in torch is the IEEE
// reciprocal times 1. torch's rsqrt on the card is ::rsqrt, which rsqrtf
// is; exp, log, cos and sin are the accurate library functions, as
// PyTorch's. torch.minimum and maximum propagate NaN, and max(dim) and
// min(dim) return the first NaN, else the first extremum: so do the forms
// here. Values the plain twin computes and never reads in this class (a
// winner's uv) are skipped.
//
// Tables (as the Scene holds them): sphere centers [S, 3] and radii [S],
// box centers and half sizes [B, 3], triangle vertices [T, 3] each; the
// prims' material and texture ids [P] i32; the materials' response [M] i32,
// light and mirror [M] u8 and roughness [M] f32; the textures' solid colors
// [X, 3] f32 and the sky's row in it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { ALIVE = 0, LIGHT = 1, KEEP = 2, MISS = 3, EXHAUST = 4 };
enum { REFLECTION = 0 };

constexpr int kBlock = 256;
constexpr float kSlabEps = 1e-12f;    // intersect.SLAB_DIR_EPS
constexpr float kRadiusEps = 1e-12f;  // sphere_surface's r_safe
constexpr float kMtEps = 1e-9f;       // intersect.MT_EPS
// tri_surface's normalize(eps=1e-20): eps * eps in double, then a float
constexpr float kNormEps2 = (float)(1e-20 * 1e-20);
constexpr float kEpsAdvance = 1e-3f;  // config.EPS_ADVANCE
constexpr float kJsEpsilon = 0x1p-52f;
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979323846);
constexpr uint32_t kSaltZ = 0x9E3779B9u, kSaltPhi = 0x85EBCA6Bu,
                   kSaltR = 0xC2B2AE35u;

struct Tables {
  const float* sph_c;
  const float* sph_r;
  const float* box_c;
  const float* box_h;
  const float* v0;
  const float* v1;
  const float* v2;
  int n_sph, n_box, n_tri;
  const int* prim_mat;
  const int* prim_tex;
  const int* response;
  const unsigned char* light;
  const unsigned char* mirror;
  const float* roughness;
  const float* solid_rgb;
  int sky_row;
};

struct Rays {
  const float* org;
  const float* dir;
  const float* color;
  const float* path;
  const int* status;
  const int* pid;
  const int* bounce;   // [n] or null: every ray at bounce0
  const int* rid;      // [n], read only where the scene is rough
  long long n;
  int bounce0;
  int has_rough;
  uint32_t seed;
  int last;
  float atten;
  float* org_out;
  float* dir_out;
  float* color_out;
  float* path_out;
  int* status_out;
  unsigned char* alive_out;
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* p, long long i) {
  return V3{__ldg(p + 3 * i), __ldg(p + 3 * i + 1), __ldg(p + 3 * i + 2)};
}

__device__ __forceinline__ void store3(float* p, long long i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

// vecmath.dot: the products summed left to right
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return V3{a.x - b.x, a.y - b.y, a.z - b.z};
}

// vecmath.cross
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}

// org + t * dir
__device__ __forceinline__ V3 along(V3 o, float t, V3 d) {
  return V3{o.x + t * d.x, o.y + t * d.y, o.z + t * d.z};
}

__device__ __forceinline__ V3 neg(V3 a) { return V3{-a.x, -a.y, -a.z}; }

// torch.where(dot(dir, n) > 0, -n, n)
__device__ __forceinline__ V3 against(V3 d, V3 n) {
  return dot(d, n) > 0.0f ? neg(n) : n;
}

// torch.minimum / maximum: NaN propagates
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? (a != a ? a : b) : (b < a ? b : a);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? (a != a ? a : b) : (b > a ? b : a);
}

// torch.clamp(x, min=lo): NaN propagates
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : (x < lo ? lo : x);
}

// the reciprocal torch takes for `1.0 / x`
__device__ __forceinline__ float recip(float x) {
  return __fdiv_rn(1.0f, x);
}

struct Surface {
  float t;
  V3 point, normal;
};

// intersect.sphere_surface
__device__ __forceinline__ Surface sphere_surface(V3 o, V3 d, V3 c, float r) {
  const V3 oc = sub(o, c);
  const float b_half = dot(oc, d);
  const float a = dot(d, d);
  const float cc = dot(oc, oc) - r * r;
  const float disc = b_half * b_half - a * cc;
  const float sq = disc > 0.0f ? __fsqrt_rn(disc) : 0.0f;
  const float t_near = __fdiv_rn(-b_half - sq, a);
  const float t_far = __fdiv_rn(-b_half + sq, a);
  Surface s;
  s.t = t_near >= 0.0f ? t_near : t_far;
  s.point = along(o, s.t, d);
  const float r_safe = fabsf(r) < kRadiusEps ? kRadiusEps : r;
  const V3 rel = sub(s.point, c);
  s.normal = against(d, V3{__fdiv_rn(rel.x, r_safe), __fdiv_rn(rel.y, r_safe),
                           __fdiv_rn(rel.z, r_safe)});
  return s;
}

// intersect._slab's clamped inverse direction, one axis
__device__ __forceinline__ float slab_inv(float d) {
  return recip(fabsf(d) < kSlabEps ? (d < 0.0f ? -kSlabEps : kSlabEps) : d) *
         1.0f;
}

// one step of torch.max(dim) (MIN: min(dim)) over a row: the first NaN
// stays, else a strictly larger (smaller) value takes the place
template <bool MIN>
__device__ __forceinline__ void take_extreme(float v, int j, float& best,
                                             int& k) {
  if (best != best) return;
  if (v != v || (MIN ? v < best : v > best)) {
    best = v;
    k = j;
  }
}

// torch.max(dim) (MIN: min(dim)) over three values -> the index: the first
// NaN, else the first extremum
template <bool MIN>
__device__ __forceinline__ int arg_extreme(float v0, float v1, float v2,
                                           float& best) {
  int k = 0;
  best = v0;
  take_extreme<MIN>(v1, 1, best, k);
  take_extreme<MIN>(v2, 2, best, k);
  return k;
}

// intersect.box_surface (its uv skipped)
__device__ __forceinline__ Surface box_surface(V3 o, V3 d, V3 c, V3 h) {
  const V3 lo{c.x - h.x, c.y - h.y, c.z - h.z};
  const V3 hi{c.x + h.x, c.y + h.y, c.z + h.z};
  const V3 inv{slab_inv(d.x), slab_inv(d.y), slab_inv(d.z)};
  const V3 ta{(lo.x - o.x) * inv.x, (lo.y - o.y) * inv.y,
              (lo.z - o.z) * inv.z};
  const V3 tb{(hi.x - o.x) * inv.x, (hi.y - o.y) * inv.y,
              (hi.z - o.z) * inv.z};
  float t_enter, t_exit;
  const int enter_axis =
      arg_extreme<false>(nan_min(ta.x, tb.x), nan_min(ta.y, tb.y),
                         nan_min(ta.z, tb.z), t_enter);
  const int exit_axis =
      arg_extreme<true>(nan_max(ta.x, tb.x), nan_max(ta.y, tb.y),
                        nan_max(ta.z, tb.z), t_exit);
  const bool entering = t_enter >= 0.0f;
  Surface s;
  s.t = entering ? t_enter : t_exit;
  const int axis = entering ? enter_axis : exit_axis;
  s.point = along(o, s.t, d);
  const V3 one{axis == 0 ? 1.0f : 0.0f, axis == 1 ? 1.0f : 0.0f,
               axis == 2 ? 1.0f : 0.0f};
  // -sign * onehot: the zero components keep the sign the product gives
  const float m = -(dot(d, one) < 0.0f ? -1.0f : 1.0f);
  s.normal = V3{m * one.x, m * one.y, m * one.z};
  return s;
}

// intersect.tri_surface (its uv skipped)
__device__ __forceinline__ Surface tri_surface(V3 o, V3 d, V3 v0, V3 v1,
                                               V3 v2) {
  const V3 e1 = sub(v1, v0);
  const V3 e2 = sub(v2, v0);
  const V3 p = cross(d, e2);
  const float det = dot(e1, p);
  const float inv_det = recip(fabsf(det) < kMtEps ? kMtEps : det) * 1.0f;
  const V3 q = cross(sub(o, v0), e1);
  Surface s;
  s.t = dot(e2, q) * inv_det;
  s.point = along(o, s.t, d);
  const V3 g = cross(e1, e2);
  const float k = rsqrtf(dot(g, g) + kNormEps2);
  s.normal = against(d, V3{g.x * k, g.y * k, g.z * k});
  return s;
}

// ---- counter RNG (ops/sampling.py) ----------------------------------------
__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float ray_uniform(uint32_t seed, uint32_t rid,
                                             uint32_t bounce, uint32_t salt) {
  uint32_t h = lowbias32(rid ^ seed);
  h = lowbias32(h + bounce * 0x68BC21EBu);
  h = lowbias32(h ^ salt);
  return (float)(int)(h >> 8) * (1.0f / 16777216.0f);
}

// sampling.scatter_direction_xyz: the reflection r lerped toward a ball
// sample in the normal's hemisphere; roughness 0 (or NaN) keeps r
__device__ __forceinline__ V3 scatter(uint32_t seed, uint32_t rid,
                                      uint32_t bounce, V3 r, V3 n,
                                      float rho) {
  if (!(rho > 0.0f)) return r;
  const float z = 1.0f - 2.0f * ray_uniform(seed, rid, bounce, kSaltZ);
  const float phi = kTwoPi * ray_uniform(seed, rid, bounce, kSaltPhi);
  const float u_r = ray_uniform(seed, rid, bounce, kSaltR);
  const float s = __fsqrt_rn(clamp_min(1.0f - z * z, 0.0f));
  const float rr = expf(logf(clamp_min(u_r, 0x1p-25f)) * (1.0f / 3.0f));
  const float rs = rr * s;
  V3 b{rs * cosf(phi), rs * sinf(phi), rr * z};
  const float flip = dot(b, n) < 0.0f ? -1.0f : 1.0f;
  b = V3{b.x * flip, b.y * flip, b.z * flip};
  const float k = 1.0f - rho;
  const V3 m{k * r.x + rho * b.x, k * r.y + rho * b.y, k * r.z + rho * b.z};
  const float inv =
      recip(__fsqrt_rn(clamp_min(dot(m, m), 1e-20f))) * 1.0f;
  return V3{m.x * inv, m.y * inv, m.z * inv};
}

__global__ void __launch_bounds__(kBlock)
    shade_bounce_kernel(Tables T, Rays R) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (i >= R.n) return;
  V3 o = load3(R.org, i);
  V3 d = load3(R.dir, i);
  V3 c = load3(R.color, i);
  float path = __ldg(R.path + i);
  int status = __ldg(R.status + i);

  if (status == ALIVE) {
    const int n_prims = T.n_sph + T.n_box + T.n_tri;
    const int pid = __ldg(R.pid + i);
    if (pid < 0 || n_prims == 0) {
      // miss: color times the sky (raytracer.ts:267-271)
      const float* sky = T.solid_rgb + 3 * T.sky_row;
      c = V3{c.x * __ldg(sky), c.y * __ldg(sky + 1), c.z * __ldg(sky + 2)};
      status = MISS;
    } else {
      const int p = min(pid, n_prims - 1);
      Surface s;
      if (p < T.n_sph) {
        s = sphere_surface(o, d, load3(T.sph_c, p), __ldg(T.sph_r + p));
      } else if (p < T.n_sph + T.n_box) {
        const int b = p - T.n_sph;
        s = box_surface(o, d, load3(T.box_c, b), load3(T.box_h, b));
      } else {
        const int t = p - T.n_sph - T.n_box;
        s = tri_surface(o, d, load3(T.v0, t), load3(T.v1, t),
                        load3(T.v2, t));
      }
      // alter_ray: color *= texture (material_solid.ts:30-36)
      const V3 tex = load3(T.solid_rgb, __ldg(T.prim_tex + p));
      c = V3{c.x * tex.x, c.y * tex.y, c.z * tex.z};
      path = path + s.t;
      const int m = __ldg(T.prim_mat + p);
      if (__ldg(T.light + m)) {
        status = LIGHT;
      } else if (__ldg(T.response + m) == REFLECTION && __ldg(T.mirror + m)) {
        // mirror: reflect, scatter, eps-advance along the NEW direction
        const float k2 = 2.0f * dot(d, s.normal);
        V3 r{d.x - k2 * s.normal.x, d.y - k2 * s.normal.y,
             d.z - k2 * s.normal.z};
        if (R.has_rough) {
          const uint32_t bounce =
              (uint32_t)(R.bounce ? __ldg(R.bounce + i) : R.bounce0);
          r = scatter(R.seed, (uint32_t)__ldg(R.rid + i), bounce, r,
                      s.normal, __ldg(T.roughness + m));
        }
        o = V3{s.point.x + kEpsAdvance * r.x, s.point.y + kEpsAdvance * r.y,
               s.point.z + kEpsAdvance * r.z};
        d = r;
      } else {
        status = KEEP;
      }
    }
  }

  if (R.last) {
    if (status == ALIVE) {  // bounce budget spent -> black
      c = V3{0.0f, 0.0f, 0.0f};
      status = EXHAUST;
    }
    if (status == LIGHT) {  // inverse-square law (raytracer.ts:273-275)
      const float pa = path * R.atten;
      const float isl = recip(kJsEpsilon + pa * pa) * 1.0f;
      c = V3{c.x * isl, c.y * isl, c.z * isl};
    }
  }
  store3(R.org_out, i, o);
  store3(R.dir_out, i, d);
  store3(R.color_out, i, c);
  R.path_out[i] = path;
  R.status_out[i] = status;
  R.alive_out[i] = status == ALIVE;
}

}  // namespace

// One bounce's shade of n rays on `stream`; returns the launch's CUDA error
// (0 on success). org, dir, color [n, 3] and path [n] f32, status and pid
// [n] i32; bounce [n] i32 or null (every ray at bounce0); rid [n] i32, read
// only with has_rough; seed the RNG's uint32 seed. Writes org_out, dir_out,
// color_out [n, 3], path_out [n] f32, status_out [n] i32 and alive_out [n]
// u8 (status_out == ALIVE); with `last`, after trace_rays's epilogue.
extern "C" int rt_shade_bounce(
    const float* sph_c, const float* sph_r, int n_sph, const float* box_c,
    const float* box_h, int n_box, const float* v0, const float* v1,
    const float* v2, int n_tri, const int* prim_mat, const int* prim_tex,
    const int* response, const unsigned char* light,
    const unsigned char* mirror, const float* roughness,
    const float* solid_rgb, int sky_row, const float* org, const float* dir,
    const float* color, const float* path, const int* status, const int* pid,
    const int* bounce, int bounce0, const int* rid, int has_rough,
    unsigned int seed, int last, float atten, long long n, float* org_out,
    float* dir_out, float* color_out, float* path_out, int* status_out,
    unsigned char* alive_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  const Tables T{sph_c,    sph_r,    box_c,     box_h,    v0,
                 v1,       v2,       n_sph,     n_box,    n_tri,
                 prim_mat, prim_tex, response,  light,    mirror,
                 roughness, solid_rgb, sky_row};
  const Rays R{org,     dir,     color,     path,     status,    pid,
               bounce,  rid,     n,         bounce0,  has_rough, seed,
               last,    atten,   org_out,   dir_out,  color_out, path_out,
               status_out, alive_out};
  const long long grid = (n + kBlock - 1) / kBlock;
  shade_bounce_kernel<<<(unsigned int)grid, kBlock, 0,
                        (cudaStream_t)stream>>>(T, R);
  return (int)cudaGetLastError();
}
