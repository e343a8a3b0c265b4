// Fused whole-trace kernels for the headline frame (Hopper, sm_90a).
//
// What they replace (the reference package's TPU kernels, one shared body
// `_trace_core` at raytracer_js_tpu/kernels/trace_fused.py:105-633):
//   trace_frame_kernel -> _trace_frame_kernel (trace_fused.py:678), entry
//                         trace_frame_fused: camera rays are built in the
//                         kernel from the pose, then all bounces run.
//   trace_rays_kernel  -> _trace_kernel (trace_fused.py:636), entry
//                         trace_rays_fused: the same bounce loop over an
//                         arbitrary ray wavefront with per-ray RNG ids.
// Both call one device function, trace_core, whose plain PyTorch twin is
// kernels/trace_fused.trace_core_plain.
//
// What bounds it on this card: per-pixel ALU work and registers. Each
// thread tests every primitive (52 on the headline scene) per bounce: an
// IEEE sqrt per sphere candidate, a slab test per box, a Moeller-Trumbore
// test per triangle. The primitive tables are a few KB of structure-of-arrays
// floats that every thread reads in the same order, so they stay in L1 and
// broadcast; no ray state ever leaves registers. Device-memory traffic is
// the output image (16 bytes a pixel) and nothing else.
//
// What this first design does about it: one thread per pixel (2-D blocks of
// 32x8 pixels, so a warp covers a row strip and shares a narrow cone of
// directions), the tables read with __ldg, the whole bounce loop in
// registers, and a dead ray leaves the loop at once. The reference's
// per-tile sphere shortlist and dead-tile skip are not ported yet; both are
// exact culls that leave the result unchanged (ROADMAP B1 perf items).
//
// Precision: built with --fmad=false and without fast math, so every
// expression rounds operation for operation like the plain PyTorch version;
// sqrtf and division are IEEE, and cosf/sinf/expf/logf are the accurate
// library functions. The expression order below mirrors trace_core_plain.
//
// Tables (row-major [rows, count] float32, one per primitive class; the row
// indices are mirrored in kernels/trace_fused.py):
//   spheres   cx cy cz ccmr inv_r r g b mode c0 rough refr vol
//   boxes     cx cy cz hx hy hz r g b mode rough refr vol
//   triangles v0(3) v1(3) v2(3) gn(3) r g b mode rough
// mode: 0 keep, 1 mirror continues, 2 emissive, 3 transmission continues.

#include <cuda_runtime.h>
#include <stdint.h>

#include <limits>

namespace {

enum { S_CX = 0, S_CY, S_CZ, S_CCMR, S_INVR, S_R, S_G, S_B, S_MODE, S_C0,
       S_ROUGH, S_REFR, S_VOL, S_ROWS };
enum { B_CX = 0, B_CY, B_CZ, B_HX, B_HY, B_HZ, B_R, B_G, B_B, B_MODE,
       B_ROUGH, B_REFR, B_VOL, B_ROWS };
enum { T_V0X = 0, T_V0Y, T_V0Z, T_V1X, T_V1Y, T_V1Z, T_V2X, T_V2Y, T_V2Z,
       T_GX, T_GY, T_GZ, T_R, T_G, T_B, T_MODE, T_ROUGH, T_ROWS };

enum { ALIVE = 0, LIGHT = 1, KEEP = 2, MISS = 3, EXHAUST = 4 };

constexpr float kInf = std::numeric_limits<float>::infinity();
constexpr float kSlabEps = 1e-12f;
constexpr float kMtEps = 1e-9f;
constexpr float kEpsAdvance = 1e-3f;
constexpr float kJsEpsilon = 0x1p-52f;
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979323846);
constexpr uint32_t kSaltZ = 0x9E3779B9u, kSaltPhi = 0x85EBCA6Bu,
                   kSaltR = 0xC2B2AE35u;

struct Params {
  const float* sph;
  const float* box;
  const float* tri;
  const float* sky;    // [3]
  const float* refr;   // [2]: start substance index, scene default
  int n_sph, n_box, n_tri;
  int refmax;
  float atten;
  int has_rough, has_trans;
  uint32_t seed;
  float* rgb;          // [n_rays, 3]
  int* status;         // [n_rays]
  int* rec_pid;        // optional [refmax, n_rays]: winner pid per bounce
  long long n_rays;
};

__device__ __forceinline__ float ld(const float* tab, int row, int n, int p) {
  return __ldg(tab + (long long)row * n + p);
}

__device__ __forceinline__ float safe_inv(float d) {
  float ds = fabsf(d) < kSlabEps ? (d < 0.0f ? -kSlabEps : kSlabEps) : d;
  return 1.0f / ds;
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

// Roughness-lerped scatter (sampling.scatter_direction_xyz); rho > 0.
__device__ void scatter(uint32_t seed, uint32_t rid, uint32_t bounce,
                        float& rx, float& ry, float& rz,
                        float nx, float ny, float nz, float rho) {
  float z = 1.0f - 2.0f * ray_uniform(seed, rid, bounce, kSaltZ);
  float phi = kTwoPi * ray_uniform(seed, rid, bounce, kSaltPhi);
  float u_r = ray_uniform(seed, rid, bounce, kSaltR);
  float s = sqrtf(fmaxf(1.0f - z * z, 0.0f));
  float r = expf(logf(fmaxf(u_r, 0x1p-25f)) * (1.0f / 3.0f));
  float rs = r * s;
  float bx = rs * cosf(phi), by = rs * sinf(phi), bz = r * z;
  float flip = (bx * nx + by * ny + bz * nz < 0.0f) ? -1.0f : 1.0f;
  bx = bx * flip;
  by = by * flip;
  bz = bz * flip;
  float k = 1.0f - rho;
  float mx = k * rx + rho * bx;
  float my = k * ry + rho * by;
  float mz = k * rz + rho * bz;
  float inv = 1.0f / sqrtf(fmaxf(mx * mx + my * my + mz * mz, 1e-20f));
  rx = mx * inv;
  ry = my * inv;
  rz = mz * inv;
}

// The bounce loop for one ray. UNIT_D: every direction is unit (camera
// rays, reflections), so the |d|^2 terms drop out of the sphere quadratic.
// HAS_C0: bounce 0 shares the camera origin, whose sphere constant
// c0 = o.o - 2 o.c + (c.c - r^2) was folded on the host.
template <bool UNIT_D, bool HAS_C0>
__device__ void trace_core(const Params& P, long long ray, uint32_t rid,
                           float ox, float oy, float oz,
                           float dx, float dy, float dz) {
  const int S = P.n_sph, B = P.n_box, T = P.n_tri;
  float cr = 1.0f, cg = 1.0f, cb = 1.0f, path = 0.0f;
  int status = ALIVE;
  float refr = __ldg(P.refr);

  for (int bounce = 0; bounce < P.refmax; ++bounce) {
    if (status != ALIVE) {
      if (P.rec_pid) P.rec_pid[bounce * P.n_rays + ray] = -1;
      continue;
    }
    float a = 1.0f, inv_a = 1.0f;
    if (!UNIT_D) {
      a = dx * dx + dy * dy + dz * dz;
      inv_a = 1.0f / a;
    }
    const float o_dot_d = ox * dx + oy * dy + oz * dz;
    const float o_dot_o = ox * ox + oy * oy + oz * oz;
    const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
    const bool use_c0 = HAS_C0 && bounce == 0;

    // ---- hit search: first forward t, strict < so the lowest pid wins ties
    float best = kInf;
    int pid = -1;
    for (int p = 0; p < S; ++p) {
      float cx = ld(P.sph, S_CX, S, p), cy = ld(P.sph, S_CY, S, p),
            cz = ld(P.sph, S_CZ, S, p);
      float b_half = o_dot_d - (dx * cx + dy * cy + dz * cz);
      float c = use_c0 ? ld(P.sph, S_C0, S, p)
                       : o_dot_o - 2.0f * (ox * cx + oy * cy + oz * cz)
                             + ld(P.sph, S_CCMR, S, p);
      float disc = b_half * b_half - (UNIT_D ? c : a * c);
      float sq = sqrtf(fmaxf(disc, 0.0f));
      float t_near, t_far;
      if (UNIT_D) {
        t_near = -b_half - sq;
        t_far = sq - b_half;
      } else {
        t_near = (-b_half - sq) * inv_a;
        t_far = (-b_half + sq) * inv_a;
      }
      float t = t_near >= 0.0f ? t_near : t_far;
      if (t < best && disc >= 0.0f && t >= 0.0f) {
        best = t;
        pid = p;
      }
    }
    for (int p = 0; p < B; ++p) {
      float cx = ld(P.box, B_CX, B, p), cy = ld(P.box, B_CY, B, p),
            cz = ld(P.box, B_CZ, B, p);
      float hx = ld(P.box, B_HX, B, p), hy = ld(P.box, B_HY, B, p),
            hz = ld(P.box, B_HZ, B, p);
      float tax = (cx - hx - ox) * ix, tbx = (cx + hx - ox) * ix;
      float tay = (cy - hy - oy) * iy, tby = (cy + hy - oy) * iy;
      float taz = (cz - hz - oz) * iz, tbz = (cz + hz - oz) * iz;
      float t_enter = fmaxf(fmaxf(fminf(tax, tbx), fminf(tay, tby)),
                            fminf(taz, tbz));
      float t_exit = fminf(fminf(fmaxf(tax, tbx), fmaxf(tay, tby)),
                           fmaxf(taz, tbz));
      float t = t_enter >= 0.0f ? t_enter : t_exit;
      if (t < best && t_enter <= t_exit && t >= 0.0f) {
        best = t;
        pid = S + p;
      }
    }
    for (int p = 0; p < T; ++p) {
      float v0x = ld(P.tri, T_V0X, T, p), v0y = ld(P.tri, T_V0Y, T, p),
            v0z = ld(P.tri, T_V0Z, T, p);
      float e1x = ld(P.tri, T_V1X, T, p) - v0x,
            e1y = ld(P.tri, T_V1Y, T, p) - v0y,
            e1z = ld(P.tri, T_V1Z, T, p) - v0z;
      float e2x = ld(P.tri, T_V2X, T, p) - v0x,
            e2y = ld(P.tri, T_V2Y, T, p) - v0y,
            e2z = ld(P.tri, T_V2Z, T, p) - v0z;
      float px = dy * e2z - dz * e2y;
      float py = dz * e2x - dx * e2z;
      float pz = dx * e2y - dy * e2x;
      float det = e1x * px + e1y * py + e1z * pz;
      float inv_det = 1.0f / (fabsf(det) < kMtEps ? kMtEps : det);
      float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
      float u = (sx * px + sy * py + sz * pz) * inv_det;
      float qx = sy * e1z - sz * e1y;
      float qy = sz * e1x - sx * e1z;
      float qz = sx * e1y - sy * e1x;
      float v = (dx * qx + dy * qy + dz * qz) * inv_det;
      float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
      bool ok = fabsf(det) >= kMtEps && u >= 0.0f && v >= 0.0f &&
                u + v <= 1.0f && t >= 0.0f;
      if (t < best && ok) {
        best = t;
        pid = S + B + p;
      }
    }
    if (P.rec_pid) P.rec_pid[bounce * P.n_rays + ray] = pid;

    if (pid < 0) {  // miss: color times sky (raytracer.ts:267-271)
      cr = cr * __ldg(P.sky + 0);
      cg = cg * __ldg(P.sky + 1);
      cb = cb * __ldg(P.sky + 2);
      status = MISS;
      continue;
    }

    // ---- winner: attributes and one normal --------------------------------
    const float hx = ox + best * dx, hy = oy + best * dy, hz = oz + best * dz;
    float wr, wg, wb, mode, rough, nx, ny, nz;
    bool flip_n = true;
    if (pid < S) {
      const int p = pid;
      float ir = ld(P.sph, S_INVR, S, p);
      nx = (hx - ld(P.sph, S_CX, S, p)) * ir;
      ny = (hy - ld(P.sph, S_CY, S, p)) * ir;
      nz = (hz - ld(P.sph, S_CZ, S, p)) * ir;
      wr = ld(P.sph, S_R, S, p);
      wg = ld(P.sph, S_G, S, p);
      wb = ld(P.sph, S_B, S, p);
      mode = ld(P.sph, S_MODE, S, p);
      rough = ld(P.sph, S_ROUGH, S, p);
    } else if (pid < S + B) {
      const int p = pid - S;
      float cx = ld(P.box, B_CX, B, p), cy = ld(P.box, B_CY, B, p),
            cz = ld(P.box, B_CZ, B, p);
      float bhx = ld(P.box, B_HX, B, p), bhy = ld(P.box, B_HY, B, p),
            bhz = ld(P.box, B_HZ, B, p);
      float tax = (cx - bhx - ox) * ix, tbx = (cx + bhx - ox) * ix;
      float tay = (cy - bhy - oy) * iy, tby = (cy + bhy - oy) * iy;
      float taz = (cz - bhz - oz) * iz, tbz = (cz + bhz - oz) * iz;
      float t0x = fminf(tax, tbx), t1x = fmaxf(tax, tbx);
      float t0y = fminf(tay, tby), t1y = fmaxf(tay, tby);
      float t0z = fminf(taz, tbz), t1z = fmaxf(taz, tbz);
      float t_enter = fmaxf(fmaxf(t0x, t0y), t0z);
      float t_exit = fminf(fminf(t1x, t1y), t1z);
      // winning slab axis, tie order x > y > z; the face normal already
      // faces against the ray
      bool entering = t_enter >= 0.0f;
      bool wx = entering ? t0x == t_enter : t1x == t_exit;
      bool wy = !wx && (entering ? t0y == t_enter : t1y == t_exit);
      bool wz = !wx && !wy;
      nx = wx ? (dx < 0.0f ? 1.0f : -1.0f) : 0.0f;
      ny = wy ? (dy < 0.0f ? 1.0f : -1.0f) : 0.0f;
      nz = wz ? (dz < 0.0f ? 1.0f : -1.0f) : 0.0f;
      wr = ld(P.box, B_R, B, p);
      wg = ld(P.box, B_G, B, p);
      wb = ld(P.box, B_B, B, p);
      mode = ld(P.box, B_MODE, B, p);
      rough = ld(P.box, B_ROUGH, B, p);
      flip_n = false;
    } else {
      const int p = pid - S - B;
      nx = ld(P.tri, T_GX, T, p);
      ny = ld(P.tri, T_GY, T, p);
      nz = ld(P.tri, T_GZ, T, p);
      wr = ld(P.tri, T_R, T, p);
      wg = ld(P.tri, T_G, T, p);
      wb = ld(P.tri, T_B, T, p);
      mode = ld(P.tri, T_MODE, T, p);
      rough = ld(P.tri, T_ROUGH, T, p);
    }
    if (flip_n && dx * nx + dy * ny + dz * nz > 0.0f) {
      nx = -nx;
      ny = -ny;
      nz = -nz;
    }
    const float n_inv =
        1.0f / sqrtf(fmaxf(nx * nx + ny * ny + nz * nz, 1e-20f));
    nx = nx * n_inv;
    ny = ny * n_inv;
    nz = nz * n_inv;

    // ---- shade ------------------------------------------------------------
    cr = cr * wr;
    cg = cg * wg;
    cb = cb * wb;
    path = path + best;
    const bool lit = mode > 1.5f && mode < 2.5f;
    const bool cont_m = mode > 0.5f && mode < 1.5f;
    const bool cont_t = P.has_trans && mode > 2.5f;
    if (lit) {
      status = LIGHT;
      continue;
    }
    if (!cont_m && !cont_t) {
      status = KEEP;
      continue;
    }
    const float d_dot_n = dx * nx + dy * ny + dz * nz;
    float rdx = dx - 2.0f * d_dot_n * nx;
    float rdy = dy - 2.0f * d_dot_n * ny;
    float rdz = dz - 2.0f * d_dot_n * nz;
    if (cont_m) {
      // mirror: reflect, scatter, eps-advance along the NEW direction
      if (P.has_rough && rough > 0.0f)
        scatter(P.seed, rid, (uint32_t)bounce, rdx, rdy, rdz, nx, ny, nz,
                rough);
      ox = hx + kEpsAdvance * rdx;
      oy = hy + kEpsAdvance * rdy;
      oz = hz + kEpsAdvance * rdz;
      dx = rdx;
      dy = rdy;
      dz = rdz;
      continue;
    }
    // transmission: eps-advance along the OLD direction, then the
    // innermost containing entity's substance (strict < on volume: the
    // first prim wins a tie); undefined substance keeps the current index
    const float ax = hx + kEpsAdvance * dx, ay = hy + kEpsAdvance * dy,
                az = hz + kEpsAdvance * dz;
    const float a_dot_a = ax * ax + ay * ay + az * az;
    float vol_min = kInf, refr_sel = 0.0f;
    bool any_in = false;
    for (int p = 0; p < S; ++p) {
      float q = a_dot_a - 2.0f * (ax * ld(P.sph, S_CX, S, p) +
                                  ay * ld(P.sph, S_CY, S, p) +
                                  az * ld(P.sph, S_CZ, S, p))
                + ld(P.sph, S_CCMR, S, p);
      bool inside = q <= 0.0f;
      float vol = ld(P.sph, S_VOL, S, p);
      if (inside && vol < vol_min) {
        vol_min = vol;
        refr_sel = ld(P.sph, S_REFR, S, p);
      }
      any_in = any_in || inside;
    }
    for (int p = 0; p < B; ++p) {
      bool inside =
          fabsf(ax - ld(P.box, B_CX, B, p)) <= ld(P.box, B_HX, B, p) &&
          fabsf(ay - ld(P.box, B_CY, B, p)) <= ld(P.box, B_HY, B, p) &&
          fabsf(az - ld(P.box, B_CZ, B, p)) <= ld(P.box, B_HZ, B, p);
      float vol = ld(P.box, B_VOL, B, p);
      if (inside && vol < vol_min) {
        vol_min = vol;
        refr_sel = ld(P.box, B_REFR, B, p);
      }
      any_in = any_in || inside;
    }
    const bool defined = refr_sel >= 0.0f;
    if (!any_in || defined) {
      const float target = any_in ? refr_sel : __ldg(P.refr + 1);
      // Snell + TIR (ops/vecmath.refract); TIR reflects the unscattered
      // direction
      const float eta = refr / fmaxf(target, 1e-6f);
      const float c1 = -(dx * nx + dy * ny + dz * nz);
      const float s2 = eta * eta * (1.0f - c1 * c1);
      const float inside = fmaxf(1.0f - s2, 0.0f);
      const float c2 = inside > 0.0f ? sqrtf(inside) : 0.0f;
      const float k = eta * c1 - c2;
      if (s2 > 1.0f) {
        dx = rdx;
        dy = rdy;
        dz = rdz;
      } else {
        const float tdx = eta * dx + k * nx;
        const float tdy = eta * dy + k * ny;
        const float tdz = eta * dz + k * nz;
        dx = tdx;
        dy = tdy;
        dz = tdz;
      }
      refr = target;
    }
    ox = ax;
    oy = ay;
    oz = az;
  }

  if (status == ALIVE) {  // bounce budget spent -> black
    cr = 0.0f;
    cg = 0.0f;
    cb = 0.0f;
    status = EXHAUST;
  }
  if (status == LIGHT) {  // inverse-square law (raytracer.ts:273-275)
    const float pa = path * P.atten;
    const float isl = 1.0f / (kJsEpsilon + pa * pa);
    cr = cr * isl;
    cg = cg * isl;
    cb = cb * isl;
  }
  P.rgb[3 * ray + 0] = cr;
  P.rgb[3 * ray + 1] = cg;
  P.rgb[3 * ray + 2] = cb;
  P.status[ray] = status;
}

// cam: pos(3) front(3) left(3) up(3) step_h step_v off_h off_v
__global__ void trace_frame_kernel(Params P, const float* __restrict__ cam,
                                   int w, int h, int spp, int sample) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const float th_h = ((float)x - __ldg(cam + 14)) * __ldg(cam + 12);
  const float th_v = ((float)y - __ldg(cam + 15)) * __ldg(cam + 13);
  const float ch = cosf(th_h), sh = sinf(th_h);
  const float cv = cosf(th_v), sv = sinf(th_v);
  const float a1 = ch * cv, a2 = ch * sv;
  const float dx = a1 * __ldg(cam + 3) + a2 * __ldg(cam + 9) + sh * __ldg(cam + 6);
  const float dy = a1 * __ldg(cam + 4) + a2 * __ldg(cam + 10) + sh * __ldg(cam + 7);
  const float dz = a1 * __ldg(cam + 5) + a2 * __ldg(cam + 11) + sh * __ldg(cam + 8);
  const long long ray = (long long)y * w + x;
  // RNG stream coordinate = pixel id * spp + sample (render.render_rays)
  const uint32_t rid = (uint32_t)((y * w + x) * spp + sample);
  trace_core<true, true>(P, ray, rid, __ldg(cam + 0), __ldg(cam + 1),
                         __ldg(cam + 2), dx, dy, dz);
}

__global__ void trace_rays_kernel(Params P, const float* __restrict__ org,
                                  const float* __restrict__ dir,
                                  const int* __restrict__ rid) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.n_rays) return;
  trace_core<false, false>(P, i, (uint32_t)__ldg(rid + i),
                           __ldg(org + 3 * i), __ldg(org + 3 * i + 1),
                           __ldg(org + 3 * i + 2), __ldg(dir + 3 * i),
                           __ldg(dir + 3 * i + 1), __ldg(dir + 3 * i + 2));
}

Params make_params(const float* sph, int n_sph, const float* box, int n_box,
                   const float* tri, int n_tri, const float* sky,
                   const float* refr, int refmax, float atten, int has_rough,
                   int has_trans, uint32_t seed, float* rgb, int* status,
                   int* rec_pid, long long n_rays) {
  Params P;
  P.sph = sph;
  P.box = box;
  P.tri = tri;
  P.sky = sky;
  P.refr = refr;
  P.n_sph = n_sph;
  P.n_box = n_box;
  P.n_tri = n_tri;
  P.refmax = refmax;
  P.atten = atten;
  P.has_rough = has_rough;
  P.has_trans = has_trans;
  P.seed = seed;
  P.rgb = rgb;
  P.status = status;
  P.rec_pid = rec_pid;
  P.n_rays = n_rays;
  return P;
}

}  // namespace

// ---- C entry points (loaded with ctypes by kernels/_build.py) --------------
// Each launches on the given stream, does not synchronize, and returns
// cudaGetLastError() (0 on success).

extern "C" int rt_trace_frame(const float* sph, int n_sph, const float* box,
                              int n_box, const float* tri, int n_tri,
                              const float* sky, const float* cam, int w,
                              int h, int refmax, float atten, int has_rough,
                              int has_trans, unsigned int seed, int spp,
                              int sample, float* rgb, int* status,
                              int* rec_pid, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (w <= 0 || h <= 0) return 0;
  // cam[16:18] = (start substance index, scene default)
  Params P = make_params(sph, n_sph, box, n_box, tri, n_tri, sky, cam + 16,
                         refmax, atten, has_rough, has_trans, seed, rgb,
                         status, rec_pid, (long long)w * h);
  dim3 block(32, 8);
  dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y);
  trace_frame_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(P, cam, w, h,
                                                               spp, sample);
  return (int)cudaGetLastError();
}

extern "C" int rt_trace_rays(const float* sph, int n_sph, const float* box,
                             int n_box, const float* tri, int n_tri,
                             const float* sky, const float* refr,
                             const float* org, const float* dir,
                             const int* rid, long long n, int refmax,
                             float atten, int has_rough, int has_trans,
                             unsigned int seed, float* rgb, int* status,
                             int* rec_pid, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  Params P = make_params(sph, n_sph, box, n_box, tri, n_tri, sky, refr,
                         refmax, atten, has_rough, has_trans, seed, rgb,
                         status, rec_pid, n);
  const int block = 256;
  const long long grid = (n + block - 1) / block;
  trace_rays_kernel<<<(unsigned int)grid, block, 0, (cudaStream_t)stream>>>(
      P, org, dir, rid);
  return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
