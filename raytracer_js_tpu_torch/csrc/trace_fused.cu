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
// What bounds them on this card: the tests the rays need. Testing every
// sphere at every bounce (an IEEE sqrt each), the first design took 0.2771
// ms for the headline frame (1920x1088, 51 spheres and the ground box,
// refmax 2) against 0.0506 ms for all those tests at the card's float32
// peak (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py --frame-times), though
// a warp's 32 rays are a thin bundle that most spheres miss: each ray needs
// about one sphere test a bounce, and then the 16 bytes a pixel written set
// the bound.
//
// Design (trace_core):
//  - One thread a ray, the whole bounce loop in registers. B1's blocks are
//    32x8 pixels, so a warp is a strip of 32 pixels of one row; B2's are
//    256 consecutive rays, a warp 32 of them.
//  - Per-warp sphere cull: before each bounce's sphere scan the warp bounds
//    its live rays by the ball-cone of cull.cuh (B3's and B8's predicate)
//    and votes 32 spheres at a time against each sphere's own ball (lane l
//    on sphere v0 + l, one __ballot_sync a window of 32); it tests only the
//    kept spheres, in pid order. A sphere left out misses every live lane,
//    so it would fold +inf: t and pid are the dense loop's, bit for bit.
//    cos_t < 0.25 keeps every sphere.
//  - The sqrt and the tail of a kept sphere's test are skipped when no live
//    lane has disc >= 0 (__any_sync): a negative or NaN discriminant folds
//    nothing either way.
//  - Shared-memory tables: each block stages the spheres as an array of
//    structs (cx cy cz ccmr, one 16-byte broadcast a test), their balls
//    (cx cy cz r) and, for B1, bounce 0's constant c0 = o.o - 2 o.c + ccmr
//    of the camera origin (computed here in the plain version's order), in
//    windows of kWin spheres: a scene of at most kWin spheres is staged
//    once, before the first bounce; a larger one window by window at every
//    bounce, between two __syncthreads. Staging once is what B2 gains by:
//    restaging the headline's 51 spheres at every bounce took it 0.0905 and
//    0.0917 ms alone at refmax 2 against 0.0876 and 0.0878 (B1 within 1%;
//    NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py --frame-times, the two
//    builds in turns in one run). Boxes and triangles stay dense, read
//    with __ldg broadcasts; the winner's shading attributes are read once a
//    ray after the search.
//  - Warp-collective control: pixels outside the image (B1's edge blocks)
//    and rays past n (B2's last block) run the loop as dead lanes, as do
//    rays that ended; dead lanes join every vote and shuffle but take no
//    part in the cone and write nothing. A warp with no live ray skips the
//    bounce (the reference's dead-tile skip, per warp); with windows the
//    whole block decides (__syncthreads_or), since every thread must reach
//    the staging barriers.
//  - `work` (may be null) receives the spheres each warp tested at each
//    bounce, [refmax, n_warps]; the plain form is trace_fused.cull_counts.
// On the headline a bounce-0 warp keeps 0.34 spheres of 51, and the frame
// kernel takes 0.0893 ms (0.2773 for the first design in the same run;
// same card, chip_smoke.py --frame-times): the camera trig, the cone
// set-up, the box test and the shading are what is left. Bounce 1 is 14%
// of it, so live rays are not compacted across warps.
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
// and the spheres' search and cull rows as arrays of structs [S, 4]:
// sph4 (cx cy cz ccmr) and balls (cx cy cz r). The table's c0 row is the
// plain version's; the kernels compute c0 themselves.
// mode: 0 keep, 1 mirror continues, 2 emissive, 3 transmission continues.

#include <cuda_runtime.h>
#include <stdint.h>

#include <limits>

namespace {

#include "stream.cuh"
#include "cull.cuh"

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

constexpr int kWin = 256;           // spheres in a shared-memory window
constexpr int kFrameBx = 32;        // B1's block: 32 x 8 pixels
constexpr int kFrameBy = 8;
constexpr int kRaysBlock = 256;     // B2's block: 256 rays

struct Params {
  const float* sph;      // [13, S]: the winner's attributes, substances
  const float4* sph4;    // [S] cx cy cz ccmr: the search
  const float4* balls;   // [S] cx cy cz r: the cull
  const float* box;
  const float* tri;
  const float* sky;      // [3]
  const float* refr0;    // []: start substance index
  const float* refr_def; // []: the scene's default
  int n_sph, n_box, n_tri;
  int refmax;
  float atten;
  int has_rough, has_trans;
  uint32_t seed;
  float* rgb;            // [n_rays, 3]
  int* status;           // [n_rays]
  int* rec_pid;          // optional [refmax, n_rays]: winner pid per bounce
  int* work;             // optional [refmax, n_warps]: spheres tested
  long long n_rays, n_warps;
};

// One block's window of spheres.
struct Window {
  float4 sph[kWin];
  float4 ball[kWin];
  float c0[kWin];
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

// Stage spheres [w0, w0 + m) into the block's window; with HAS_C0 also
// their constant c0 for the origin (px, py, pz), in pack_tables' order.
// Every thread of the block calls it.
template <bool HAS_C0>
__device__ __forceinline__ void stage(Window& W, const Params& P, int w0,
                                      int m, float px, float py, float pz) {
  const int nt = blockDim.x * blockDim.y;
  const float p_dot_p = px * px + py * py + pz * pz;
  for (int k = threadIdx.y * blockDim.x + threadIdx.x; k < m; k += nt) {
    const float4 s = __ldg(P.sph4 + w0 + k);
    W.sph[k] = s;
    W.ball[k] = __ldg(P.balls + w0 + k);
    if (HAS_C0)
      W.c0[k] = p_dot_p - 2.0f * (s.x * px + s.y * py + s.z * pz) + s.w;
  }
}

// The bounce loop for one ray. Every thread of the block calls it; lanes
// with in_range false (no ray) run it as dead lanes. UNIT_D: every
// direction is unit (camera rays, reflections), so the |d|^2 terms drop out
// of the sphere quadratic. HAS_C0: bounce 0 shares the camera origin
// (ox, oy, oz), and its sphere constant c0 is staged with the window.
// `warp` is this lane's warp's index in `work`.
template <bool UNIT_D, bool HAS_C0>
__device__ void trace_core(const Params& P, Window& W, bool in_range,
                           long long ray, long long warp, uint32_t rid,
                           float ox, float oy, float oz,
                           float dx, float dy, float dz) {
  const int S = P.n_sph, B = P.n_box, T = P.n_tri;
  const bool resident = S <= kWin;    // block-uniform
  const float px = ox, py = oy, pz = oz;
  if (resident) {
    stage<HAS_C0>(W, P, 0, S, px, py, pz);
    __syncthreads();
  }
  const int lane = lane_id();
  const bool has_work = P.work != nullptr && lane == 0 && warp < P.n_warps;
  float cr = 1.0f, cg = 1.0f, cb = 1.0f, path = 0.0f;
  int status = in_range ? ALIVE : EXHAUST;
  float refr = __ldg(P.refr0);

  for (int bounce = 0; bounce < P.refmax; ++bounce) {
    const bool alive = status == ALIVE;
    if (!alive && in_range && P.rec_pid)
      P.rec_pid[bounce * P.n_rays + ray] = -1;
    const bool warp_live = __any_sync(kFull, alive);
    if (resident ? !warp_live : !__syncthreads_or(alive)) {
      if (has_work) P.work[bounce * P.n_warps + warp] = 0;
      continue;
    }
    float a = 1.0f, inv_a = 1.0f;
    if (!UNIT_D) {
      a = dx * dx + dy * dy + dz * dz;
      inv_a = 1.0f / a;
    }
    const float o_dot_d = ox * dx + oy * dy + oz * dz;
    const float o_dot_o = ox * ox + oy * oy + oz * oz;
    const bool use_c0 = HAS_C0 && bounce == 0;

    // ---- spheres: the kept ones of each window, in pid order; the first
    // forward t with a strict < so the lowest pid wins ties
    float best = kInf;
    int pid = -1, tested = 0;
    Cone cone;
    if (warp_live)
      cone = warp_cone(ox, oy, oz, dx, dy, dz,
                       UNIT_D ? dx * dx + dy * dy + dz * dz : a, alive);
    for (int w0 = 0; w0 < S; w0 += kWin) {
      const int m = min(kWin, S - w0);
      if (!resident) {
        __syncthreads();      // the last window's readers are done
        stage<HAS_C0>(W, P, w0, m, px, py, pz);
        __syncthreads();
      }
      if (!warp_live) continue;
      for (int v0 = 0; v0 < m; v0 += 32) {
        bool keep = false;
        if (v0 + lane < m) {
          const float4 b = W.ball[v0 + lane];
          keep = cone.reaches(b.x, b.y, b.z, b.w);
        }
        unsigned kept = __ballot_sync(kFull, keep);
        tested += __popc(kept);
        while (kept) {                   // warp-uniform
          const int j = v0 + __ffs(kept) - 1;
          kept &= kept - 1;
          const float4 s = W.sph[j];
          const float b_half = o_dot_d - (dx * s.x + dy * s.y + dz * s.z);
          const float c =
              use_c0 ? W.c0[j]
                     : o_dot_o - 2.0f * (ox * s.x + oy * s.y + oz * s.z) + s.w;
          const float disc = b_half * b_half - (UNIT_D ? c : a * c);
          if (!__any_sync(kFull, alive && disc >= 0.0f)) continue;
          const float sq = sqrtf(fmaxf(disc, 0.0f));
          float t_near, t_far;
          if (UNIT_D) {
            t_near = -b_half - sq;
            t_far = sq - b_half;
          } else {
            t_near = (-b_half - sq) * inv_a;
            t_far = (-b_half + sq) * inv_a;
          }
          const float t = t_near >= 0.0f ? t_near : t_far;
          if (t < best && disc >= 0.0f && t >= 0.0f) {
            best = t;
            pid = w0 + j;
          }
        }
      }
    }
    if (has_work) P.work[bounce * P.n_warps + warp] = tested;
    if (!alive) continue;

    // ---- boxes and triangles, dense
    const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
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
      float px_ = dy * e2z - dz * e2y;
      float py_ = dz * e2x - dx * e2z;
      float pz_ = dx * e2y - dy * e2x;
      float det = e1x * px_ + e1y * py_ + e1z * pz_;
      float inv_det = 1.0f / (fabsf(det) < kMtEps ? kMtEps : det);
      float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
      float u = (sx * px_ + sy * py_ + sz * pz_) * inv_det;
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
      const float target = any_in ? refr_sel : __ldg(P.refr_def);
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

  if (!in_range) return;
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

// The camera: pose vectors on the device ([3] each), the angle steps and
// center offsets by value (models/camera.angle_steps), the frame's size
// and its sample.
struct Cam {
  const float* pos;
  const float* front;
  const float* left;
  const float* up;
  float step_h, step_v, off_h, off_v;
  int w, h, spp, sample;
};

__global__ void __launch_bounds__(kFrameBx * kFrameBy)
trace_frame_kernel(Params P, Cam C) {
  __shared__ Window W;
  const int x = blockIdx.x * kFrameBx + threadIdx.x;
  const int y = blockIdx.y * kFrameBy + threadIdx.y;
  const bool in_range = x < C.w && y < C.h;
  const float th_h = ((float)x - C.off_h) * C.step_h;
  const float th_v = ((float)y - C.off_v) * C.step_v;
  const float ch = cosf(th_h), sh = sinf(th_h);
  const float cv = cosf(th_v), sv = sinf(th_v);
  const float a1 = ch * cv, a2 = ch * sv;
  const float dx = a1 * __ldg(C.front + 0) + a2 * __ldg(C.up + 0) +
                   sh * __ldg(C.left + 0);
  const float dy = a1 * __ldg(C.front + 1) + a2 * __ldg(C.up + 1) +
                   sh * __ldg(C.left + 1);
  const float dz = a1 * __ldg(C.front + 2) + a2 * __ldg(C.up + 2) +
                   sh * __ldg(C.left + 2);
  const long long ray = in_range ? (long long)y * C.w + x : 0;
  // one warp per 32-pixel strip of a row: row y, column block blockIdx.x
  const long long warp = (long long)y * gridDim.x + blockIdx.x;
  // RNG stream coordinate = pixel id * spp + sample (render.render_rays)
  const uint32_t rid = (uint32_t)((y * C.w + x) * C.spp + C.sample);
  trace_core<true, true>(P, W, in_range, ray, warp, rid, __ldg(C.pos + 0),
                         __ldg(C.pos + 1), __ldg(C.pos + 2), dx, dy, dz);
}

__global__ void __launch_bounds__(kRaysBlock)
trace_rays_kernel(Params P, const float* __restrict__ org,
                  const float* __restrict__ dir,
                  const int* __restrict__ rid) {
  __shared__ Window W;
  const long long i = (long long)blockIdx.x * kRaysBlock + threadIdx.x;
  const bool in_range = i < P.n_rays;
  const long long j = in_range ? i : 0;   // a dead lane reads ray 0
  trace_core<false, false>(P, W, in_range, j, i >> 5, (uint32_t)__ldg(rid + j),
                           __ldg(org + 3 * j), __ldg(org + 3 * j + 1),
                           __ldg(org + 3 * j + 2), __ldg(dir + 3 * j),
                           __ldg(dir + 3 * j + 1), __ldg(dir + 3 * j + 2));
}

Params make_params(const float* sph, int n_sph, const float* box, int n_box,
                   const float* tri, int n_tri, const float* sky,
                   const float* sph4, const float* balls, const float* refr0,
                   const float* refr_def, int refmax, float atten,
                   int has_rough, int has_trans, uint32_t seed, float* rgb,
                   int* status, int* rec_pid, int* work, long long n_rays,
                   long long n_warps) {
  Params P;
  P.sph = sph;
  P.sph4 = reinterpret_cast<const float4*>(sph4);
  P.balls = reinterpret_cast<const float4*>(balls);
  P.box = box;
  P.tri = tri;
  P.sky = sky;
  P.refr0 = refr0;
  P.refr_def = refr_def;
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
  P.work = work;
  P.n_rays = n_rays;
  P.n_warps = n_warps;
  return P;
}

}  // namespace

// ---- C entry points (loaded with ctypes by kernels/_build.py) --------------
// Each launches on the given stream, does not synchronize, and returns
// cudaGetLastError() (0 on success). Tables: sph [13, n_sph], box
// [13, n_box], tri [17, n_tri], sky [3], sph4 and balls [n_sph, 4] (16-byte
// aligned); refr0 and refr_def one float each. rec_pid and work may be
// null; work receives [refmax, n_warps] (B1: n_warps = h * ceil(w / 32),
// warp y * ceil(w / 32) + x / 32; B2: ceil(n / 32)).

extern "C" int rt_trace_frame(const float* sph, int n_sph, const float* box,
                              int n_box, const float* tri, int n_tri,
                              const float* sky, const float* sph4,
                              const float* balls, const float* refr0,
                              const float* refr_def, const float* pos,
                              const float* front, const float* left,
                              const float* up, float step_h, float step_v,
                              int off_h, int off_v, int w, int h, int refmax,
                              float atten, int has_rough, int has_trans,
                              unsigned int seed, int spp, int sample,
                              float* rgb, int* status, int* rec_pid,
                              int* work, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (w <= 0 || h <= 0) return 0;
  const dim3 grid((w + kFrameBx - 1) / kFrameBx, (h + kFrameBy - 1) / kFrameBy);
  const Params P = make_params(
      sph, n_sph, box, n_box, tri, n_tri, sky, sph4, balls, refr0, refr_def,
      refmax, atten, has_rough, has_trans, seed, rgb, status, rec_pid, work,
      (long long)w * h, (long long)h * grid.x);
  Cam C;
  C.pos = pos;
  C.front = front;
  C.left = left;
  C.up = up;
  C.step_h = step_h;
  C.step_v = step_v;
  C.off_h = (float)off_h;
  C.off_v = (float)off_v;
  C.w = w;
  C.h = h;
  C.spp = spp;
  C.sample = sample;
  trace_frame_kernel<<<grid, dim3(kFrameBx, kFrameBy), 0,
                       (cudaStream_t)stream>>>(P, C);
  return (int)cudaGetLastError();
}

extern "C" int rt_trace_rays(const float* sph, int n_sph, const float* box,
                             int n_box, const float* tri, int n_tri,
                             const float* sky, const float* sph4,
                             const float* balls, const float* refr0,
                             const float* refr_def, const float* org,
                             const float* dir, const int* rid, long long n,
                             int refmax, float atten, int has_rough,
                             int has_trans, unsigned int seed, float* rgb,
                             int* status, int* rec_pid, int* work,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  const Params P = make_params(
      sph, n_sph, box, n_box, tri, n_tri, sky, sph4, balls, refr0, refr_def,
      refmax, atten, has_rough, has_trans, seed, rgb, status, rec_pid, work,
      n, (n + 31) / 32);
  const long long grid = (n + kRaysBlock - 1) / kRaysBlock;
  trace_rays_kernel<<<(unsigned int)grid, kRaysBlock, 0,
                      (cudaStream_t)stream>>>(P, org, dir, rid);
  return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
