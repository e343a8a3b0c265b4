// Tiled candidate-list bounce kernels, frame and wavefront entries (B7-frame
// and B7-wave; Hopper, sm_90a).
//
// What they replace (the reference package's TPU kernels):
//   tiled_frame_kernel -> _frame_kernel (raytracer_js_tpu/kernels/
//       trace_tiled.py:468, body _bounce_tile :85, entry frame_bounce0
//       :661): bounce 0 of the TILED big-scene path. Rays are built in the
//       kernel from the camera pose; each 32x128-ray tile scans its own
//       candidate table (accel/candidates.frame_candidates: the exact
//       conservative set of primitives the tile's rays can hit,
//       type-segregated, each segment sorted by a lower-bound entry distance
//       t_lo) with a chunked early exit, extracts the winner, takes its
//       normal (and uv), shades, and respawns mirror continuations.
//   tiled_wave_kernel -> _wave_kernel (trace_tiled.py:518, entry
//       wave_bounce :680): the same bounce for a packetized wavefront of
//       divergent rays (the packet rounds of render_tiled). The 11 state
//       planes come in from device memory; packet p (wave_sub rows of 128
//       rays) scans its own table, built for its rays' bounding cone
//       (accel/candidates.packet_candidates_grid), whose t_safe is finite
//       when the table was truncated: a ray is resolved only if its hit
//       precedes t_safe - d_c or it leaves the scene bounds first, and an
//       unresolved ray passes through unchanged. Cell-grid tables put the
//       box and triangle segments at fixed rows (static bases).
// Their plain PyTorch twin is kernels/trace_tiled.bounce_tile_plain
// (entries frame_bounce0_plain and wave_bounce_plain), which runs the same
// expressions in the same order.
//
// What bounds it on this card: per-ray ALU work over the scanned candidates
// (an IEEE sqrt per sphere candidate, a slab test per box, a Moeller-Trumbore
// test with an IEEE divide per triangle). A tile's table is c_max x 80 bytes
// (hundreds of KB at 100k prims), far past shared memory, but a tile stops
// after the few chunks its rays need; device-memory traffic is the scanned
// rows plus 15 (or 18) output planes of 4 bytes a ray. The wavefront entry
// adds 11 input planes a ray; its packets of divergent rays scan more of
// their tables than camera tiles do, so it is ALU-bound too.
//
// What this first design does about it: one thread per ray, ray state in
// registers. A 4096-ray tile is served by 16 blocks of 2 rows x 128 rays,
// each of which streams CHUNK-row slices (16 x 80 bytes) of the tile's table
// through shared memory and takes the early exit on its own 256 rays with
// __syncthreads_and: the exit test is conservative, so a smaller group only
// stops where the rest of the scan could not change its rays (the plain
// version exits per the same groups). The winner's attributes are a direct
// read of its table row (the reference's chunked "pick by index match"
// becomes one load). No wgmma, no TMA, no prefetch of the next chunk yet.
// The wavefront entry runs the same blocks over packets: a packet of
// wave_sub rows is served by wave_sub / 2 blocks of 256 rays, or by
// wave_sub blocks of 128 rays when wave_sub is odd (the reference's
// one-row straggler packets), so an exit group never spans two packets.
//
// Precision: built with --fmad=false and without fast math, so every
// expression rounds operation for operation like the plain version; sqrtf,
// division, cosf/sinf and atan2f are the accurate library functions.
//
// Table layout ([tiles * c_max, 20] float32; a tile's rows are contiguous):
//   0 t_lo, 1 pid (as float), 2-4 center / center / v0,
//   5 c.c - r^2 / hx / e1x, 6 1/r / hy / e1y, 7 - / hz / e1z, 8-10 - / - / e2,
//   11-13 tri normal, 14-16 rgb, 17 mode (2 light, 1 mirror, 3 transmission)
// Segments: spheres at row 0, boxes at pad16(cnt_s), triangles after
// pad16(cnt_b). cnts [tiles, 8]: cnt_s cnt_b cnt_t t_safe o0x o0y o0z ro.
// Camera array [28]: pos front left up, step_h step_v off_h off_v, sky rgb,
//   w h, scene bbox lo (3) hi (3), spare.
// Output: [n_out, h_pad, w_pad] float32 planes ox oy oz dx dy dz cr cg cb
//   path status t pid u v (+ nx ny nz); status and pid hold int32 bits.
// Wavefront input: [11, rows, 128] float32 planes ox .. path status (status
//   as int32 bits); output [n_out, rows, 128] as above.

#include <cuda_runtime.h>
#include <stdint.h>

#include <limits>

namespace {

constexpr float kInf = std::numeric_limits<float>::infinity();
constexpr float kSlabEps = 1e-12f;
constexpr float kMtEps = 1e-9f;
constexpr float kEpsAdvance = 1e-3f;
constexpr float kEpsUv = 2.220446049250313e-16f;    // 2^-52
// f32 reciprocals of 2 pi, pi and 6 (the plain version multiplies by the
// same: PyTorch's CUDA division by a Python scalar multiplies by its
// reciprocal)
constexpr float kInvTwoPi = 0x1.45f306p-3f;
constexpr float kInvPi = 0x1.45f306p-2f;
constexpr float kInvSix = 0x1.555556p-3f;
constexpr float kClipHi = 1.0f - 1.1920928955078125e-07f;  // 1 - 2^-23

constexpr int kLane = 128;
constexpr int kTileSub = 32;
constexpr int kChunk = 16;
constexpr int kAttr = 20;
constexpr int kGroupSub = 2;                        // rows per block
constexpr int kBlock = kGroupSub * kLane;           // 256 threads
constexpr int kGroups = kTileSub / kGroupSub;       // blocks per tile

enum { ALIVE = 0, LIGHT = 1, KEEP = 2, MISS = 3 };
enum { SEG_SPH = 0, SEG_BOX = 1, SEG_TRI = 2 };

struct Flags {
  bool want_uv, sky_solid, has_trans, want_normal;
};

struct Ray {
  float ox, oy, oz, dx, dy, dz, cr, cg, cb, path;
  int status;
};

__device__ __forceinline__ float safe_inv(float d) {
  float ds = fabsf(d) < kSlabEps ? (d < 0.0f ? -kSlabEps : kSlabEps) : d;
  return 1.0f / ds;
}

// Chunked early-exit scan of candidate rows [base, base + cnt) of one
// tile's table (base a kChunk multiple). Every thread of the block calls it.
template <int Seg>
__device__ void scan_segment(const float* __restrict__ tab, int c_max,
                             int base, int cnt, bool any_alive, bool alive,
                             const Ray& r, float ix, float iy, float iz,
                             float o_dot_o, float o_dot_d, float t_exit_bb,
                             float d_c, float& t_best, int& jwin,
                             float (*chunk)[kAttr], int& chunks) {
  const int end = base + cnt;
  bool open = cnt > 0 && any_alive;
  for (int ci = 0; open; ++ci) {
    const int j0 = base + ci * kChunk;
    __syncthreads();
    for (int e = threadIdx.x; e < kChunk * kAttr; e += blockDim.x)
      (&chunk[0][0])[e] = __ldg(tab + (size_t)j0 * kAttr + e);
    __syncthreads();
    for (int k = 0; k < kChunk; ++k) {
      const float* c = chunk[k];
      float t;
      bool valid;
      if (Seg == SEG_SPH) {
        const float cx = c[2], cy = c[3], cz = c[4], ccmr = c[5];
        const float b_half = o_dot_d - (r.dx * cx + r.dy * cy + r.dz * cz);
        const float cc =
            o_dot_o - 2.0f * (r.ox * cx + r.oy * cy + r.oz * cz) + ccmr;
        const float disc = b_half * b_half - cc;
        const float sq = sqrtf(fmaxf(disc, 0.0f));
        t = -b_half - sq >= 0.0f ? -b_half - sq : sq - b_half;
        valid = disc >= 0.0f && t >= 0.0f;
      } else if (Seg == SEG_BOX) {
        const float cx = c[2], cy = c[3], cz = c[4];
        const float hx = c[5], hy = c[6], hz = c[7];
        const float tax = (cx - hx - r.ox) * ix;
        const float tbx = (cx + hx - r.ox) * ix;
        const float tay = (cy - hy - r.oy) * iy;
        const float tby = (cy + hy - r.oy) * iy;
        const float taz = (cz - hz - r.oz) * iz;
        const float tbz = (cz + hz - r.oz) * iz;
        const float t_en = fmaxf(fmaxf(fminf(tax, tbx), fminf(tay, tby)),
                                 fminf(taz, tbz));
        const float t_ex = fminf(fminf(fmaxf(tax, tbx), fmaxf(tay, tby)),
                                 fmaxf(taz, tbz));
        t = t_en >= 0.0f ? t_en : t_ex;
        valid = t_en <= t_ex && t >= 0.0f;
      } else {
        const float v0x = c[2], v0y = c[3], v0z = c[4];
        const float e1x = c[5], e1y = c[6], e1z = c[7];
        const float e2x = c[8], e2y = c[9], e2z = c[10];
        const float px = r.dy * e2z - r.dz * e2y;
        const float py = r.dz * e2x - r.dx * e2z;
        const float pz = r.dx * e2y - r.dy * e2x;
        const float det = e1x * px + e1y * py + e1z * pz;
        const float inv_det = 1.0f / (fabsf(det) < kMtEps ? kMtEps : det);
        const float sx = r.ox - v0x, sy = r.oy - v0y, sz = r.oz - v0z;
        const float u = (sx * px + sy * py + sz * pz) * inv_det;
        const float qx = sy * e1z - sz * e1y;
        const float qy = sz * e1x - sx * e1z;
        const float qz = sx * e1y - sy * e1x;
        const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
        t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
        valid = fabsf(det) >= kMtEps && u >= 0.0f && v >= 0.0f &&
                u + v <= 1.0f && t >= 0.0f;
      }
      const int j = j0 + k;
      if (t < t_best && valid && j < end) {
        t_best = t;
        jwin = j;
      }
    }
    ++chunks;
    const int nxt = base + (ci + 1) * kChunk;
    const float next_tlo = __ldg(tab + (size_t)min(nxt, c_max - 1) * kAttr);
    const bool mine = !alive || (fminf(t_best, t_exit_bb) + d_c <= next_tlo);
    const bool done = __syncthreads_and(mine);
    open = !done && nxt < end;
  }
}

// One traverse -> intersect -> shade -> respawn pass for this thread's ray
// against its tile's table (the reference's _bounce_tile). Writes the
// outputs of pixel `pix` and, if `work`, the block's chunk counts. The box
// and triangle segments start at rows sb_b and sb_t, or (-1) after the
// padded counts.
__device__ void bounce_tile(const float* __restrict__ tab, int c_max,
                            const float* __restrict__ cnt_row,
                            const float* __restrict__ cam, Flags f, Ray r,
                            int sb_b, int sb_t, float* __restrict__ out,
                            size_t plane, size_t pix,
                            int* __restrict__ work) {
  __shared__ float chunk[kChunk][kAttr];
  const int cnt_s = (int)__ldg(cnt_row + 0);
  const int cnt_b = (int)__ldg(cnt_row + 1);
  const int cnt_t = (int)__ldg(cnt_row + 2);
  const float t_safe = __ldg(cnt_row + 3);
  const float o0x = __ldg(cnt_row + 4), o0y = __ldg(cnt_row + 5),
              o0z = __ldg(cnt_row + 6);

  const bool alive = r.status == ALIVE;
  const bool any_alive = __syncthreads_or(alive);
  const float o_dot_d = r.ox * r.dx + r.oy * r.dy + r.oz * r.dz;
  const float o_dot_o = r.ox * r.ox + r.oy * r.oy + r.oz * r.oz;
  const float ix = safe_inv(r.dx), iy = safe_inv(r.dy), iz = safe_inv(r.dz);
  const float dcx = r.ox - o0x, dcy = r.oy - o0y, dcz = r.oz - o0z;
  const float d_c = sqrtf(dcx * dcx + dcy * dcy + dcz * dcz);
  const float ex_x = fmaxf((__ldg(cam + 21) - r.ox) * ix,
                           (__ldg(cam + 24) - r.ox) * ix);
  const float ex_y = fmaxf((__ldg(cam + 22) - r.oy) * iy,
                           (__ldg(cam + 25) - r.oy) * iy);
  const float ex_z = fmaxf((__ldg(cam + 23) - r.oz) * iz,
                           (__ldg(cam + 26) - r.oz) * iz);
  const float t_exit_bb = fminf(fminf(ex_x, ex_y), ex_z);

  const int base_b =
      sb_b >= 0 ? sb_b : (cnt_s + kChunk - 1) / kChunk * kChunk;
  const int base_t =
      sb_t >= 0 ? sb_t : base_b + (cnt_b + kChunk - 1) / kChunk * kChunk;
  float t_best = kInf;
  int jwin = -1;
  int chunks[3] = {0, 0, 0};
  scan_segment<SEG_SPH>(tab, c_max, 0, cnt_s, any_alive, alive, r, ix, iy,
                        iz, o_dot_o, o_dot_d, t_exit_bb, d_c, t_best, jwin,
                        chunk, chunks[0]);
  scan_segment<SEG_BOX>(tab, c_max, base_b, cnt_b, any_alive, alive, r, ix,
                        iy, iz, o_dot_o, o_dot_d, t_exit_bb, d_c, t_best,
                        jwin, chunk, chunks[1]);
  scan_segment<SEG_TRI>(tab, c_max, base_t, cnt_t, any_alive, alive, r, ix,
                        iy, iz, o_dot_o, o_dot_d, t_exit_bb, d_c, t_best,
                        jwin, chunk, chunks[2]);
  if (work != nullptr && threadIdx.x == 0) {
    for (int s = 0; s < 3; ++s) work[3 * blockIdx.x + s] = chunks[s];
  }

  // ---- winner attributes: row jwin of the tile's table --------------------
  const bool win = jwin >= 0;
  const bool is_sph = win && jwin < base_b;
  const bool is_box = jwin >= base_b && jwin < base_t;
  const bool is_tri = jwin >= base_t;
  const float* row = tab + (size_t)(win ? jwin : 0) * kAttr;
  float wr = 1.0f, wg = 1.0f, wb = 1.0f, w_mode = 0.0f;
  int pid = -1;
  float g[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (win) {
    wr = __ldg(row + 14);
    wg = __ldg(row + 15);
    wb = __ldg(row + 16);
    w_mode = __ldg(row + 17);
    pid = (int)__ldg(row + 1);
    const int n_geo = is_sph ? 4 : (is_box ? 6 : 9);
    for (int k = 0; k < n_geo; ++k) g[k] = __ldg(row + 2 + k);
    if (is_sph) g[3] = __ldg(row + 6);
  }

  // ---- winner normal (+ uv) ------------------------------------------------
  const float t_fin = t_best < kInf ? t_best : 0.0f;
  const float hx = r.ox + t_fin * r.dx;
  const float hy = r.oy + t_fin * r.dy;
  const float hz = r.oz + t_fin * r.dz;
  float nx = (hx - g[0]) * g[3];
  float ny = (hy - g[1]) * g[3];
  float nz = (hz - g[2]) * g[3];
  float u_out = 0.0f, v_out = 0.0f;
  if (f.want_uv) {
    u_out = atan2f(ny, nx) * kInvTwoPi + 0.5f - kEpsUv;
    v_out = atan2f(nz, sqrtf(nx * nx + ny * ny)) * kInvPi + 0.5f - kEpsUv;
  }
  if (is_box) {
    const float bcx = g[0], bcy = g[1], bcz = g[2];
    const float bhx = g[3], bhy = g[4], bhz = g[5];
    const float tax = (bcx - bhx - r.ox) * ix;
    const float tbx = (bcx + bhx - r.ox) * ix;
    const float tay = (bcy - bhy - r.oy) * iy;
    const float tby = (bcy + bhy - r.oy) * iy;
    const float taz = (bcz - bhz - r.oz) * iz;
    const float tbz = (bcz + bhz - r.oz) * iz;
    const float t0x = fminf(tax, tbx), t1x = fmaxf(tax, tbx);
    const float t0y = fminf(tay, tby), t1y = fmaxf(tay, tby);
    const float t0z = fminf(taz, tbz), t1z = fmaxf(taz, tbz);
    const float t_en = fmaxf(fmaxf(t0x, t0y), t0z);
    const float t_ex = fminf(fminf(t1x, t1y), t1z);
    const bool entering = t_en >= 0.0f;
    const bool wx = entering ? t0x == t_en : t1x == t_ex;
    const bool wy = !wx && (entering ? t0y == t_en : t1y == t_ex);
    const bool wz = !wx && !wy;
    const float sxn = r.dx < 0.0f ? 1.0f : -1.0f;
    const float syn = r.dy < 0.0f ? 1.0f : -1.0f;
    const float szn = r.dz < 0.0f ? 1.0f : -1.0f;
    nx = wx ? sxn : 0.0f;
    ny = wy ? syn : 0.0f;
    nz = wz ? szn : 0.0f;
    if (f.want_uv) {
      const int axis = wx ? 0 : (wy ? 1 : 2);
      const float sgn = wx ? sxn : (wy ? syn : szn);
      const float outward = entering ? sgn : -sgn;
      const float face = (float)(axis * 2 + (outward > 0.0f ? 1 : 0));
      const float rx =
          fminf(fmaxf((hx - (bcx - bhx)) / (2.0f * bhx), 0.0f), kClipHi);
      const float ry =
          fminf(fmaxf((hy - (bcy - bhy)) / (2.0f * bhy), 0.0f), kClipHi);
      const float rz =
          fminf(fmaxf((hz - (bcz - bhz)) / (2.0f * bhz), 0.0f), kClipHi);
      const float u_loc = axis == 0 ? ry : rx;
      const float v_loc = axis == 2 ? ry : rz;
      u_out = (face + u_loc) * kInvSix;
      v_out = v_loc;
    }
  }
  if (is_tri) {
    const float e1x = g[3], e1y = g[4], e1z = g[5];
    const float e2x = g[6], e2y = g[7], e2z = g[8];
    const float gx = e1y * e2z - e1z * e2y;
    const float gy = e1z * e2x - e1x * e2z;
    const float gz = e1x * e2y - e1y * e2x;
    const float g_inv = 1.0f / sqrtf(fmaxf(gx * gx + gy * gy + gz * gz,
                                           1e-40f));
    nx = gx * g_inv;
    ny = gy * g_inv;
    nz = gz * g_inv;
    if (f.want_uv) {
      const float px = r.dy * e2z - r.dz * e2y;
      const float py = r.dz * e2x - r.dx * e2z;
      const float pz = r.dx * e2y - r.dy * e2x;
      const float det = e1x * px + e1y * py + e1z * pz;
      const float inv_det = 1.0f / (fabsf(det) < kMtEps ? kMtEps : det);
      const float sx = r.ox - g[0], sy = r.oy - g[1], sz = r.oz - g[2];
      u_out = (sx * px + sy * py + sz * pz) * inv_det;
      const float qx = sy * e1z - sz * e1y;
      const float qy = sz * e1x - sx * e1z;
      const float qz = sx * e1y - sy * e1x;
      v_out = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
    }
  }
  const float flip =
      (is_sph || is_tri) && (r.dx * nx + r.dy * ny + r.dz * nz > 0.0f)
          ? -1.0f : 1.0f;
  nx = nx * flip;
  ny = ny * flip;
  nz = nz * flip;
  const float n_inv = 1.0f / sqrtf(fmaxf(nx * nx + ny * ny + nz * nz, 1e-20f));
  nx = nx * n_inv;
  ny = ny * n_inv;
  nz = nz * n_inv;

  // ---- resolution, shading and respawn ------------------------------------
  const float t_safe_ray = t_safe - d_c;
  const bool hit = alive && win && t_best <= t_safe_ray;
  const bool lit = hit && w_mode > 1.5f && w_mode < 2.5f;
  const bool cont = hit && w_mode > 0.5f && w_mode < 1.5f;
  const bool cont_t = f.has_trans && hit && w_mode > 2.5f;
  const bool keep = hit && !lit && !cont && !cont_t;
  const bool miss = alive && !win && t_safe_ray > t_exit_bb;
  float cr = r.cr, cg = r.cg, cb = r.cb;
  if (hit) {
    cr = cr * wr;
    cg = cg * wg;
    cb = cb * wb;
  } else if (miss && f.sky_solid) {
    cr = cr * __ldg(cam + 16);
    cg = cg * __ldg(cam + 17);
    cb = cb * __ldg(cam + 18);
  }
  const float path = hit ? r.path + t_best : r.path;
  const int status = lit ? LIGHT : (keep ? KEEP : (miss ? MISS : r.status));
  const float d_dot_n = r.dx * nx + r.dy * ny + r.dz * nz;
  const float rdx = r.dx - 2.0f * d_dot_n * nx;
  const float rdy = r.dy - 2.0f * d_dot_n * ny;
  const float rdz = r.dz - 2.0f * d_dot_n * nz;
  float* o = out + pix;
  o[0 * plane] = cont ? hx + kEpsAdvance * rdx : r.ox;
  o[1 * plane] = cont ? hy + kEpsAdvance * rdy : r.oy;
  o[2 * plane] = cont ? hz + kEpsAdvance * rdz : r.oz;
  o[3 * plane] = cont ? rdx : r.dx;
  o[4 * plane] = cont ? rdy : r.dy;
  o[5 * plane] = cont ? rdz : r.dz;
  o[6 * plane] = cr;
  o[7 * plane] = cg;
  o[8 * plane] = cb;
  o[9 * plane] = path;
  o[10 * plane] = __int_as_float(status);
  o[11 * plane] = t_best;
  o[12 * plane] = __int_as_float(hit ? pid : -1);
  o[13 * plane] = u_out;
  o[14 * plane] = v_out;
  if (f.want_normal) {
    o[15 * plane] = nx;
    o[16 * plane] = ny;
    o[17 * plane] = nz;
  }
}

__global__ void __launch_bounds__(kBlock)
tiled_frame_kernel(const float* __restrict__ tab, int c_max,
                   const float* __restrict__ cnts,
                   const float* __restrict__ cam, int nbx, int w_pad,
                   size_t plane, Flags f, float* __restrict__ out,
                   int* __restrict__ work) {
  const int tile = blockIdx.x / kGroups;
  const int gi = blockIdx.x % kGroups;
  const int by = tile / nbx, bx = tile % nbx;
  const int sub = gi * kGroupSub + (int)threadIdx.x / kLane;
  const int lane = (int)threadIdx.x % kLane;
  const int px = bx * kLane + lane, py = by * kTileSub + sub;
  const float x = (float)px, y = (float)py;
  // the closed form of models/camera.pixel_rays (as trace_fused.cu builds)
  const float th_h = (x - __ldg(cam + 14)) * __ldg(cam + 12);
  const float th_v = (y - __ldg(cam + 15)) * __ldg(cam + 13);
  const float ch = cosf(th_h), sh = sinf(th_h);
  const float cv = cosf(th_v), sv = sinf(th_v);
  const float a1 = ch * cv, a2 = ch * sv;
  Ray r;
  r.dx = a1 * __ldg(cam + 3) + a2 * __ldg(cam + 9) + sh * __ldg(cam + 6);
  r.dy = a1 * __ldg(cam + 4) + a2 * __ldg(cam + 10) + sh * __ldg(cam + 7);
  r.dz = a1 * __ldg(cam + 5) + a2 * __ldg(cam + 11) + sh * __ldg(cam + 8);
  r.ox = __ldg(cam + 0);
  r.oy = __ldg(cam + 1);
  r.oz = __ldg(cam + 2);
  r.cr = r.cg = r.cb = 1.0f;
  r.path = 0.0f;
  // padding pixels of partial edge tiles start as MISS
  r.status = (x >= __ldg(cam + 19) || y >= __ldg(cam + 20)) ? MISS : ALIVE;
  bounce_tile(tab + (size_t)tile * c_max * kAttr, c_max, cnts + 8 * tile,
              cam, f, r, -1, -1, out, plane, (size_t)py * w_pad + px, work);
}

// One bounce of a packetized wavefront: block b serves rays
// [b * blockDim.x, (b + 1) * blockDim.x) of the [rows, 128] planes, a group
// of blockDim.x / 128 rows inside packet b / groups_per_packet.
__global__ void __launch_bounds__(kBlock)
tiled_wave_kernel(const float* __restrict__ tab, int c_max,
                  const float* __restrict__ cnts,
                  const float* __restrict__ cam,
                  const float* __restrict__ in, size_t plane,
                  int groups_per_packet, int sb_b, int sb_t, Flags f,
                  float* __restrict__ out, int* __restrict__ work) {
  const int packet = blockIdx.x / groups_per_packet;
  const size_t pix = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  Ray r;
  r.ox = __ldg(in + 0 * plane + pix);
  r.oy = __ldg(in + 1 * plane + pix);
  r.oz = __ldg(in + 2 * plane + pix);
  r.dx = __ldg(in + 3 * plane + pix);
  r.dy = __ldg(in + 4 * plane + pix);
  r.dz = __ldg(in + 5 * plane + pix);
  r.cr = __ldg(in + 6 * plane + pix);
  r.cg = __ldg(in + 7 * plane + pix);
  r.cb = __ldg(in + 8 * plane + pix);
  r.path = __ldg(in + 9 * plane + pix);
  r.status = __float_as_int(__ldg(in + 10 * plane + pix));
  bounce_tile(tab + (size_t)packet * c_max * kAttr, c_max, cnts + 8 * packet,
              cam, f, r, sb_b, sb_t, out, plane, pix, work);
}

}  // namespace

// ---- C entry point (loaded with ctypes by kernels/_build.py) --------------
// Launches on the given stream, does not synchronize, and returns
// cudaGetLastError() (0 on success). `work` may be null; else it receives
// the chunks each block scanned per class, [blocks, 3].
extern "C" int rt_tiled_frame(const float* tab, int c_max, const float* cnts,
                              const float* cam, int nby, int nbx, int want_uv,
                              int sky_solid, int has_trans, int want_normal,
                              float* out, int* work, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nby <= 0 || nbx <= 0) return 0;
  Flags f;
  f.want_uv = want_uv != 0;
  f.sky_solid = sky_solid != 0;
  f.has_trans = has_trans != 0;
  f.want_normal = want_normal != 0;
  const int w_pad = nbx * kLane;
  const size_t plane = (size_t)nby * kTileSub * w_pad;
  const long long blocks = (long long)nby * nbx * kGroups;
  tiled_frame_kernel<<<(unsigned int)blocks, kBlock, 0,
                       (cudaStream_t)stream>>>(tab, c_max, cnts, cam, nbx,
                                               w_pad, plane, f, out, work);
  return (int)cudaGetLastError();
}

// The wavefront entry: `in` holds the 11 state planes [11, rows, 128], tab
// and cnts one table and one counts row per packet of wave_sub rows,
// served by blocks of group_rows rows (group_rows divides wave_sub).
// sb_b/sb_t are the static segment bases, -1 to follow the counts. `work`
// may be null; else it receives the chunks each block scanned per class,
// [rows / group_rows, 3].
extern "C" int rt_tiled_wave(const float* tab, int c_max, const float* cnts,
                             const float* cam, const float* in, int rows,
                             int wave_sub, int group_rows, int sb_b, int sb_t,
                             int want_uv, int sky_solid, int has_trans,
                             int want_normal, float* out, int* work,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows <= 0) return 0;
  if (group_rows <= 0 || group_rows * kLane > kBlock ||
      wave_sub % group_rows != 0 || rows % wave_sub != 0)
    return (int)cudaErrorInvalidValue;
  Flags f;
  f.want_uv = want_uv != 0;
  f.sky_solid = sky_solid != 0;
  f.has_trans = has_trans != 0;
  f.want_normal = want_normal != 0;
  const size_t plane = (size_t)rows * kLane;
  tiled_wave_kernel<<<(unsigned int)(rows / group_rows), group_rows * kLane,
                      0, (cudaStream_t)stream>>>(
      tab, c_max, cnts, cam, in, plane, wave_sub / group_rows, sb_b, sb_t, f,
      out, work);
  return (int)cudaGetLastError();
}
