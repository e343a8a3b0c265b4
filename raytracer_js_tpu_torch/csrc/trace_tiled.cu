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
// expressions in the same order, with the exit group as its `group`
// argument (32 rays here).
//
// What bounds them on this card: per-ray ALU work over the scanned
// candidates (an IEEE sqrt per sphere candidate, a slab test per box, a
// Moeller-Trumbore test with an IEEE divide per triangle). A table is
// c_max x 80 bytes (hundreds of KB at 100k prims), far past shared memory,
// but an exit group stops after the few chunks its rays need; device-memory
// traffic is the scanned rows plus 15 (or 18) output planes of 4 bytes a
// ray, and, for the wavefront, 11 input planes.
//
// Design (both entries share bounce_tile and its scan):
//  - The exit group is one warp of 32 rays: a warp stops a segment once
//    every live lane's min(t_best, scene-bbox exit) + d_c is at or below
//    the next chunk's t_lo (__all_sync). That t_lo arrives with the chunk
//    (one more 4-byte copy into the stage) and is read as a shared-memory
//    broadcast: a read of it from the table would wait on L2 once a chunk
//    of 16 tests. The test is conservative (each segment is
//    sorted by t_lo, a lower bound of any hit's distance from the table's
//    apex, and every fold is a strict < in row order), so a warp stops only
//    where the rest of the segment holds no strictly nearer hit for its
//    live rays: their t and winner are those of any coarser group, such as
//    the first design's 256-ray blocks. Rays that are not alive fold
//    nothing (t = +inf, no winner), so no plane depends on the group.
//  - Each warp stages its chunks into its own two-stage ring of shared
//    memory with cp.async, copying chunk k+1 while it tests chunk k (and
//    only while some live lane's horizon still exceeds its t_lo: horizons
//    only shrink, so a chunk refused then is never scanned);
//    synchronization is cp.async.wait_group and __syncwarp only, no
//    __syncthreads. Only the columns the segment's test reads are staged:
//    spheres cols 2-5 as one 16-byte entry (a broadcast float4 load),
//    boxes cols 2-7, triangles cols 2-10. The rows are 80 bytes apart and
//    col 2 sits 8 bytes into a 16-byte unit, so the copies are 8-byte
//    pieces (and one 4-byte piece a triangle). The winner's attributes
//    stay one direct read of its row after the scan.
//  - The sphere test skips its IEEE sqrt and tail when no live lane of the
//    warp has disc >= 0 (__any_sync): such a lane never folds, so the
//    result is bit-identical. It takes four discriminants before their
//    votes and roots: the profiler's kernel times on config 4's packet
//    rounds showed a warp waiting on each test's chain in turn (a launch
//    of 800 scanning warps took over half the time of one of 4,096).
//  - Blocks are one row of 128 rays (four independent warps): the frame's
//    32x128 tile is 32 blocks, a packet of wave_sub rows wave_sub blocks,
//    so a warp never spans two tables. `work` receives the chunks each
//    warp scanned per class. ptxas (sm_90a): the wave kernel 64 registers
//    (capped, below), the frame kernel 70, no spills; 5.1 KB of rings a
//    block.
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

#include "stream.cuh"

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
constexpr int kBlock = kLane;                       // one row of rays
constexpr int kWarps = kBlock / 32;

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

// A staged chunk: kChunk entries of the columns a segment's test reads,
// kEntry floats apart, copied as kPieces pieces a row (8 bytes each from
// col 2 on; a triangle's col 10 is a 4-byte piece).
template <int Seg>
struct Staged;
template <>
struct Staged<SEG_SPH> {    // cx cy cz ccmr: one float4
  static constexpr int kEntry = 4, kPieces = 2;
};
template <>
struct Staged<SEG_BOX> {    // cx cy cz hx hy hz
  static constexpr int kEntry = 6, kPieces = 3;
};
template <>
struct Staged<SEG_TRI> {    // v0, e1, e2 and a pad
  static constexpr int kEntry = 10, kPieces = 5;
};
// A stage: the widest chunk's entries, then the next chunk's first t_lo
// (slot kTlo), padded to 16 bytes.
constexpr int kTlo = kChunk * Staged<SEG_TRI>::kEntry;
constexpr int kStage = kTlo + 4;                  // floats a stage

// Copy rows [j0, j0 + kChunk) of a table into a stage (one warp), and the
// t_lo of row j0 + kChunk when it lies before `end`.
template <int Seg>
__device__ __forceinline__ void fetch_chunk(float* dst,
                                            const float* __restrict__ tab,
                                            int j0, int end) {
  constexpr int kE = Staged<Seg>::kEntry, kP = Staged<Seg>::kPieces;
  for (int p = lane_id(); p < kChunk * kP; p += 32) {
    const int row = p / kP, part = p % kP;
    const float* src = tab + (size_t)(j0 + row) * kAttr + 2 + 2 * part;
    float* d = dst + row * kE + 2 * part;
    if (Seg == SEG_TRI && part == 4)
      cp_async4(d, src);
    else
      cp_async8(d, src);
  }
  if (lane_id() == 0 && j0 + kChunk < end)
    cp_async4(dst + kTlo, tab + (size_t)(j0 + kChunk) * kAttr);
}

// The ray terms a scan reads.
struct ScanRay {
  Ray r;
  float ix, iy, iz, o_dot_o, o_dot_d;
  bool alive;
};

// Test the m (<= kChunk) staged rows of rows [j0, j0 + m) and fold each
// valid hit of a live ray with a strict < in row order.
template <int Seg>
__device__ __forceinline__ void test_chunk(const float* st, int j0, int m,
                                           const ScanRay& s, float& t_best,
                                           int& jwin) {
  const Ray& r = s.r;
  if constexpr (Seg == SEG_SPH) {
    // Four discriminants in straight-line code before their votes and
    // roots, so that a warp overlaps four independent chains; the folds
    // keep their row order. Rows [m, kChunk) are staged but never fold.
    constexpr int kQuad = 4;
    const float4* sp = reinterpret_cast<const float4*>(st);
    for (int k0 = 0; k0 < m; k0 += kQuad) {
      float b_half[kQuad], disc[kQuad];
      bool any[kQuad];
#pragma unroll
      for (int q = 0; q < kQuad; ++q) {
        const float4 c = sp[k0 + q];
        b_half[q] = s.o_dot_d - (r.dx * c.x + r.dy * c.y + r.dz * c.z);
        const float cc =
            s.o_dot_o - 2.0f * (r.ox * c.x + r.oy * c.y + r.oz * c.z) + c.w;
        disc[q] = b_half[q] * b_half[q] - cc;
        any[q] = __any_sync(kFull, s.alive && k0 + q < m && disc[q] >= 0.0f);
      }
#pragma unroll
      for (int q = 0; q < kQuad; ++q) {
        if (!any[q]) continue;
        const float sq = sqrtf(fmaxf(disc[q], 0.0f));
        const float t = -b_half[q] - sq >= 0.0f ? -b_half[q] - sq
                                                : sq - b_half[q];
        if (s.alive && disc[q] >= 0.0f && t >= 0.0f && t < t_best) {
          t_best = t;
          jwin = j0 + k0 + q;
        }
      }
    }
    return;
  }
#pragma unroll 2
  for (int k = 0; k < m; ++k) {
    const int j = j0 + k;
    if constexpr (Seg == SEG_BOX) {
      const float2* e = reinterpret_cast<const float2*>(st + 6 * k);
      const float2 a = e[0], b = e[1], c = e[2];
      const float cx = a.x, cy = a.y, cz = b.x;
      const float hx = b.y, hy = c.x, hz = c.y;
      const float tax = (cx - hx - r.ox) * s.ix;
      const float tbx = (cx + hx - r.ox) * s.ix;
      const float tay = (cy - hy - r.oy) * s.iy;
      const float tby = (cy + hy - r.oy) * s.iy;
      const float taz = (cz - hz - r.oz) * s.iz;
      const float tbz = (cz + hz - r.oz) * s.iz;
      const float t_en = fmaxf(fmaxf(fminf(tax, tbx), fminf(tay, tby)),
                               fminf(taz, tbz));
      const float t_ex = fminf(fminf(fmaxf(tax, tbx), fmaxf(tay, tby)),
                               fmaxf(taz, tbz));
      const float t = t_en >= 0.0f ? t_en : t_ex;
      if (s.alive && t_en <= t_ex && t >= 0.0f && t < t_best) {
        t_best = t;
        jwin = j;
      }
    } else {
      const float2* e = reinterpret_cast<const float2*>(st + 10 * k);
      const float2 a = e[0], b = e[1], c = e[2], d = e[3];
      const float v0x = a.x, v0y = a.y, v0z = b.x;
      const float e1x = b.y, e1y = c.x, e1z = c.y;
      const float e2x = d.x, e2y = d.y, e2z = st[10 * k + 8];
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
      const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
      if (s.alive && fabsf(det) >= kMtEps && u >= 0.0f && v >= 0.0f &&
          u + v <= 1.0f && t >= 0.0f && t < t_best) {
        t_best = t;
        jwin = j;
      }
    }
  }
}

// One warp's chunked early-exit scan of candidate rows [base, base + cnt)
// of its table (base a kChunk multiple) through its two-stage ring. Every
// lane of the warp calls it (every branch below is warp-uniform). Returns
// the chunks scanned.
template <int Seg>
__device__ int scan_segment(const float* __restrict__ tab, int base, int cnt,
                            bool any_alive, const ScanRay& s,
                            float t_exit_bb, float d_c, float* ring,
                            float& t_best, int& jwin) {
  if (cnt <= 0 || !any_alive) return 0;
  const int end = base + cnt;
  fetch_chunk<Seg>(ring, tab, base, end);
  cp_async_commit();
  int chunks = 0, st = 0;
  for (int j0 = base;; j0 += kChunk) {
    const int nxt = j0 + kChunk;
    const bool more = nxt < end;
    cp_async_wait<0>();       // this lane's copies of chunk j0 have landed
    __syncwarp();             // ... and every lane's
    const float* stage = ring + st * kStage;
    const float next_tlo = more ? stage[kTlo] : 0.0f;
    // copy the next chunk ahead unless every live lane's horizon is already
    // at or below its t_lo (horizons only shrink: such a chunk is never
    // scanned)
    if (more && !__all_sync(kFull, !s.alive || fminf(t_best, t_exit_bb) +
                                                      d_c <= next_tlo))
      fetch_chunk<Seg>(ring + (st ^ 1) * kStage, tab, nxt, end);
    cp_async_commit();
    test_chunk<Seg>(stage, j0, min(kChunk, end - j0), s, t_best, jwin);
    ++chunks;
    __syncwarp();             // stage st is read before it is refilled
    if (!more || __all_sync(kFull, !s.alive || fminf(t_best, t_exit_bb) +
                                                       d_c <= next_tlo))
      break;
    st ^= 1;
  }
  cp_async_wait<0>();         // drain a copy the scan did not use
  __syncwarp();
  return chunks;
}

// One traverse -> intersect -> shade -> respawn pass for this thread's ray
// against its warp's table (the reference's _bounce_tile). Writes the
// outputs of pixel `pix` and, if `work`, the warp's chunk counts per class
// (work[0..2]). The box and triangle segments start at rows sb_b and sb_t,
// or (-1) after the padded counts. `ring` is the warp's staging ring.
__device__ void bounce_tile(const float* __restrict__ tab,
                            const float* __restrict__ cnt_row,
                            const float* __restrict__ cam, Flags f, Ray r,
                            int sb_b, int sb_t, float* __restrict__ out,
                            size_t plane, size_t pix, float* ring,
                            int* __restrict__ work) {
  const int cnt_s = (int)__ldg(cnt_row + 0);
  const int cnt_b = (int)__ldg(cnt_row + 1);
  const int cnt_t = (int)__ldg(cnt_row + 2);
  const float t_safe = __ldg(cnt_row + 3);
  const float o0x = __ldg(cnt_row + 4), o0y = __ldg(cnt_row + 5),
              o0z = __ldg(cnt_row + 6);

  const bool alive = r.status == ALIVE;
  const bool any_alive = __any_sync(kFull, alive);
  ScanRay s;
  s.r = r;
  s.alive = alive;
  s.o_dot_d = r.ox * r.dx + r.oy * r.dy + r.oz * r.dz;
  s.o_dot_o = r.ox * r.ox + r.oy * r.oy + r.oz * r.oz;
  const float ix = safe_inv(r.dx), iy = safe_inv(r.dy), iz = safe_inv(r.dz);
  s.ix = ix;
  s.iy = iy;
  s.iz = iz;
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
  const int ch_s = scan_segment<SEG_SPH>(tab, 0, cnt_s, any_alive, s,
                                         t_exit_bb, d_c, ring, t_best, jwin);
  const int ch_b = scan_segment<SEG_BOX>(tab, base_b, cnt_b, any_alive, s,
                                         t_exit_bb, d_c, ring, t_best, jwin);
  const int ch_t = scan_segment<SEG_TRI>(tab, base_t, cnt_t, any_alive, s,
                                         t_exit_bb, d_c, ring, t_best, jwin);
  if (work != nullptr && lane_id() == 0) {
    work[0] = ch_s;
    work[1] = ch_b;
    work[2] = ch_t;
  }

// ---- winner attributes: row jwin of the warp's table --------------------
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

// Bounce 0 over the frame: block b serves row b % 32 of tile b / 32.
__global__ void __launch_bounds__(kBlock)
tiled_frame_kernel(const float* __restrict__ tab, int c_max,
                   const float* __restrict__ cnts,
                   const float* __restrict__ cam, int nbx, int w_pad,
                   size_t plane, Flags f, float* __restrict__ out,
                   int* __restrict__ work) {
  __shared__ __align__(16) float rings[kWarps][2 * kStage];
  const int tile = blockIdx.x / kTileSub;
  const int sub = blockIdx.x % kTileSub;
  const int by = tile / nbx, bx = tile % nbx;
  const int warp = (int)threadIdx.x >> 5;
  const int px = bx * kLane + (int)threadIdx.x, py = by * kTileSub + sub;
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
  bounce_tile(tab + (size_t)tile * c_max * kAttr, cnts + 8 * tile, cam, f, r,
              -1, -1, out, plane, (size_t)py * w_pad + px, rings[warp],
              work == nullptr ? nullptr
                              : work + 3 * ((size_t)blockIdx.x * kWarps +
                                            warp));
}

// One bounce of a packetized wavefront: block b serves row b of the
// [rows, 128] planes, in packet b / wave_sub. A launch is one segment of
// 1024 rows, whose warps all scan about as long (their chunks' max over
// mean is 1.00-1.07 on config 4's packet rounds): at 66 registers a thread
// 7 blocks fit an SM, 924 on the card, and the last 100 rows ran as a
// second wave; capped at 64 registers, 8 fit, 1056, one wave.
__global__ void __launch_bounds__(kBlock, 8)
tiled_wave_kernel(const float* __restrict__ tab, int c_max,
                  const float* __restrict__ cnts,
                  const float* __restrict__ cam,
                  const float* __restrict__ in, size_t plane, int wave_sub,
                  int sb_b, int sb_t, Flags f, float* __restrict__ out,
                  int* __restrict__ work) {
  __shared__ __align__(16) float rings[kWarps][2 * kStage];
  const int packet = blockIdx.x / wave_sub;
  const int warp = (int)threadIdx.x >> 5;
  const size_t pix = (size_t)blockIdx.x * kBlock + threadIdx.x;
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
  bounce_tile(tab + (size_t)packet * c_max * kAttr, cnts + 8 * packet, cam,
              f, r, sb_b, sb_t, out, plane, pix, rings[warp],
              work == nullptr ? nullptr
                              : work + 3 * ((size_t)blockIdx.x * kWarps +
                                            warp));
}

}  // namespace

// ---- C entry points (loaded with ctypes by kernels/_build.py) --------------
// Each launches on the given stream, does not synchronize, and returns
// cudaGetLastError() (0 on success). The table must start on a 16-byte
// boundary (the scans copy 8-byte pieces of its rows). `work` may be null;
// else it receives the chunks each warp scanned per class, [warps, 3], in
// launch order (block-major, four warps a block).
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
  const long long blocks = (long long)nby * nbx * kTileSub;
  tiled_frame_kernel<<<(unsigned int)blocks, kBlock, 0,
                       (cudaStream_t)stream>>>(tab, c_max, cnts, cam, nbx,
                                               w_pad, plane, f, out, work);
  return (int)cudaGetLastError();
}

// The wavefront entry: `in` holds the 11 state planes [11, rows, 128], tab
// and cnts one table and one counts row per packet of wave_sub rows.
// sb_b/sb_t are the static segment bases, -1 to follow the counts.
extern "C" int rt_tiled_wave(const float* tab, int c_max, const float* cnts,
                             const float* cam, const float* in, int rows,
                             int wave_sub, int sb_b, int sb_t, int want_uv,
                             int sky_solid, int has_trans, int want_normal,
                             float* out, int* work, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows <= 0) return 0;
  if (wave_sub <= 0 || rows % wave_sub != 0)
    return (int)cudaErrorInvalidValue;
  Flags f;
  f.want_uv = want_uv != 0;
  f.sky_solid = sky_solid != 0;
  f.has_trans = has_trans != 0;
  f.want_normal = want_normal != 0;
  const size_t plane = (size_t)rows * kLane;
  tiled_wave_kernel<<<(unsigned int)rows, kBlock, 0, (cudaStream_t)stream>>>(
      tab, c_max, cnts, cam, in, plane, wave_sub, sb_b, sb_t, f, out, work);
  return (int)cudaGetLastError();
}
