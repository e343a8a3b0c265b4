// Path-replay forward and backward kernels (B5) for the gradient path
// (Hopper, sm_90a).
//
// What they replace (the reference package's TPU kernels):
//   replay_fwd_kernel -> _fwd_kernel (raytracer_js_tpu/kernels/replay_grad.py
//       :399, call :760): the replay of supplied winners (pid_seq), colors out.
//   replay_bwd_kernel -> _bwd_kernel (replay_grad.py:592, call :790): the
//       forward re-run in registers, then the hand-derived reverse of each
//       bounce (_reverse_bounce, :428-582) walked backwards: per-ray
//       cotangents of origin and direction, per-prim cotangents (center,
//       radius or half size, rgb) and the sky's.
// Their plain PyTorch twins are kernels/replay_grad.replay_fwd_plain and
// replay_bwd_plain, which run the same expressions in the same order: colors
// and per-ray cotangents agree bit for bit. The class is the reference's:
// solid textures and sky, REFLECTION only (mode = 2 * light + continues),
// spheres and boxes, refmax <= 4.
//
// What bounds them on this card. The forward is a few hundred flops a ray
// and 44 bytes of traffic: it runs at 87% of its bytes bound (0.0316 ms a
// headline view against 0.0274, NVIDIA H100 80GB HBM3, 700 W). The
// backward moves 68 bytes a ray (0.0424 ms a view), but a first design
// issued ~1,500 warp instructions per 32 rays and took 0.1006 ms plus
// 0.0052 of a second reduction launch (chip_smoke.py --frame-times), and
// its wrapper zero-filled 2 x 25 MB the kernel overwrites: the instruction
// stream, not the bytes, set its time. Each of 2,088,960 rays x 2 bounces lands up to 9
// cotangents on one of 52 prims, most on the ground box; global atomics on
// a few addresses would serialize, so the per-prim reduction is what the
// design is about. The backward:
//   - groups a warp's lanes by winner (ballot + shuffle; a warp whose live
//     lanes share one winner, as most of the headline's do, takes one pass
//     and no selects) and sums each group by a reduce-scatter over the xor
//     butterfly's tree (Scatter): values 0-7 halve at levels 16, 8, 4 and
//     the 9th takes the plain butterfly, 14 shuffles for 45, and 9 lanes
//     add the 9 sums to the warp's own shared-memory row at once (lane 0
//     did 9 read-modify-writes). Every sum is the full butterfly's, bit for
//     bit: the same tree of commutative adds. The sky's 3 sums take 6
//     shuffles for 15, only at a bounce where some lane sees sky;
//   - runs a resident grid (kernels/replay_grad.bwd_grid: the occupancy
//     times the SMs; 117 registers and no spills keep each bounce's entry
//     State in registers, 4 blocks an SM): each block loops over ray
//     groups of 128 and writes one partial row (its warps in warp order);
//   - hides the latency that set its time with 16 warps an SM: each group
//     prefetches the next group's rays into L2 and loads its cotangents
//     first, and the reverse takes each bounce's roots and reciprocals
//     (Roots: a sphere's sqrt and two divides, a box's three) from the
//     forward instead of recomputing them. Capping the registers for 5 or
//     6 blocks an SM was slower (spills, and no gain in latency hiding);
//   - reduces the partial rows in the same launch: a cooperative launch
//     (every block resident), the grid barrier of cooperative groups
//     (this_grid().sync(), its state per launch), then
//     warp c of the grid sums column c in the former replay_reduce_kernel's
//     order (lane y adds rows y, y + 32, ... in turn; a shuffle-down tree)
//     and writes it straight into the output layout (spheres [S, 7], boxes
//     [B, 9], sky [3]), so the wrapper neither gathers nor concatenates.
//   The order is fixed by the grid, so two launches agree bit for bit;
//   kernels/replay_grad.bwd_sums_model is the same order in float32 (the
//   card holds the kernel to it bit for bit), and its rounding stays below
//   1e-5 of the sum of the terms' magnitudes.
//   - Above 192 prims (the listed class, up to 16384 spheres) the sphere
//     slots do not fit shared memory: spheres then take one global
//     atomicAdd per warp group and slot into the output (order across
//     warps varies, so those sums are not bit-reproducible); boxes (at most
//     192) and the sky keep the deterministic path.
// A thread skips the bounces of a dead ray (the per-thread form of the
// reference's whole-tile liveness conds), but joins every warp collective
// with zero contributions. The reference's TPU machinery (pid-match pick
// scans, lane partials, tile padding, per-tile id lists) is not carried
// over: a thread reads its winner's row by index.
//
// Precision: built with --fmad=false and without fast math, so every
// expression rounds once, as in PyTorch; sqrtf and division are IEEE.
//
// Tables (row-major float32, one row per prim):
//   spheres cx cy cz r tr tg tb mode           [S, 8]
//   boxes   cx cy cz hx hy hz tr tg tb mode    [B, 10]
//   sky     r g b                              [3]

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEpsAdvance = 1e-3f;
constexpr float kJsEpsilon = 0x1p-52f;
constexpr float kSlabEps = 1e-12f;
constexpr int kAlive = 0, kLight = 1, kKeep = 2, kMiss = 3;
constexpr int kBlock = 128;   // threads per backward block (BWD_BLOCK)
constexpr int kWarps = kBlock / 32;
constexpr int kSlot = 9;      // center (3), radius or half (3), rgb (3)
constexpr int kSphSlots = 7;  // a sphere's output slots: center, radius, rgb
constexpr unsigned kFull = 0xffffffffu;

struct Tabs {
  const float* sph;
  const float* box;
  const float* sky;
  int n_sph, n_box;
};

struct State {
  float ox, oy, oz, dx, dy, dz, cr, cg, cb, path;
  int status;
};

// The winner's row, read by index (a sphere's hy, hz are unused).
struct Prim {
  bool is_s;
  int pidc;
  float cx, cy, cz, r, hy, hz, tr, tg, tb, mode;
};

struct SphereFwd {
  float ocx, ocy, ocz, bh, a, c, posf, sq_inner, inv_a, t_near, t_far, nf,
      t, r_okf, inv_rs, fs, nx, ny, nz;
};

struct BoxFwd {
  float ivx, ivy, ivz, t, wxf, wyf, wzf, sgn_x, sgn_y, sgn_z, dokf_x, dokf_y,
      dokf_z, nx, ny, nz;
};

// The selected surface of one replayed hit.
struct Geom {
  SphereFwd sf;   // valid for a sphere
  BoxFwd bf;      // valid for a box
  float t, px, py, pz, nx, ny, nz;
};

// A bounce's roots and reciprocals, computed by the forward and kept for
// its reverse (the same values, so the reverse's results do not change):
// a sphere's sq_inner, inv_a, inv_rs; a box's ivx, ivy, ivz.
struct Roots {
  float a, b, c;
};

__device__ __forceinline__ Prim load_prim(const Tabs& T, int pid) {
  Prim P;
  const int pidc = min(max(pid, 0), T.n_sph + T.n_box - 1);
  P.pidc = pidc;
  P.is_s = pidc < T.n_sph;
  if (P.is_s) {
    const float* s = T.sph + 8 * (long long)pidc;
    P.cx = __ldg(s);
    P.cy = __ldg(s + 1);
    P.cz = __ldg(s + 2);
    P.r = __ldg(s + 3);
    P.hy = 0.0f;
    P.hz = 0.0f;
    P.tr = __ldg(s + 4);
    P.tg = __ldg(s + 5);
    P.tb = __ldg(s + 6);
    P.mode = __ldg(s + 7);
  } else {
    const float* b = T.box + 10 * (long long)(pidc - T.n_sph);
    P.cx = __ldg(b);
    P.cy = __ldg(b + 1);
    P.cz = __ldg(b + 2);
    P.r = __ldg(b + 3);
    P.hy = __ldg(b + 4);
    P.hz = __ldg(b + 5);
    P.tr = __ldg(b + 6);
    P.tg = __ldg(b + 7);
    P.tb = __ldg(b + 8);
    P.mode = __ldg(b + 9);
  }
  return P;
}

__device__ __forceinline__ float mask(bool b) { return b ? 1.0f : 0.0f; }

__device__ __forceinline__ float safe_inv(float d) {
  float ds = fabsf(d) < kSlabEps ? (d < 0.0f ? -kSlabEps : kSlabEps) : d;
  return 1.0f / ds;
}

// replay_grad.py _sphere_fwd: the plane form with inv_a = 1/a. kGiven: the
// roots come from `k` (the forward's), else they are computed into it.
template <bool kGiven>
__device__ __forceinline__ SphereFwd sphere_fwd(const State& s,
                                                const Prim& P, Roots& k) {
  SphereFwd f;
  const float ox = s.ox, oy = s.oy, oz = s.oz, dx = s.dx, dy = s.dy,
              dz = s.dz, r = P.r;
  f.ocx = ox - P.cx;
  f.ocy = oy - P.cy;
  f.ocz = oz - P.cz;
  f.bh = f.ocx * dx + f.ocy * dy + f.ocz * dz;
  f.a = dx * dx + dy * dy + dz * dz;
  f.c = f.ocx * f.ocx + f.ocy * f.ocy + f.ocz * f.ocz - r * r;
  const float disc = f.bh * f.bh - f.a * f.c;
  const bool pos = disc > 0.0f;
  f.posf = mask(pos);
  f.sq_inner = kGiven ? k.a : sqrtf(pos ? disc : 1.0f);
  const float sq = f.sq_inner * f.posf;
  f.inv_a = kGiven ? k.b : 1.0f / f.a;
  f.t_near = (-f.bh - sq) * f.inv_a;
  f.t_far = (-f.bh + sq) * f.inv_a;
  const bool near_fwd = f.t_near >= 0.0f;
  f.nf = mask(near_fwd);
  f.t = near_fwd ? f.t_near : f.t_far;
  const float px = ox + f.t * dx, py = oy + f.t * dy, pz = oz + f.t * dz;
  const bool r_guard = fabsf(r) < 1e-12f;
  f.r_okf = mask(!r_guard);
  f.inv_rs = kGiven ? k.c : 1.0f / (r_guard ? 1e-12f : r);
  if (!kGiven) k = Roots{f.sq_inner, f.inv_a, f.inv_rs};
  const float n0x = (px - P.cx) * f.inv_rs, n0y = (py - P.cy) * f.inv_rs,
              n0z = (pz - P.cz) * f.inv_rs;
  f.fs = dx * n0x + dy * n0y + dz * n0z > 0.0f ? -1.0f : 1.0f;
  f.nx = n0x * f.fs;
  f.ny = n0y * f.fs;
  f.nz = n0z * f.fs;
  return f;
}

// replay_grad.py _box_fwd: the lo slab wins a tie in t, the winning axis a
// tie in x > y > z order.
template <bool kGiven>
__device__ __forceinline__ BoxFwd box_fwd(const State& s, const Prim& P,
                                          Roots& k) {
  BoxFwd f;
  const float ox = s.ox, oy = s.oy, oz = s.oz, dx = s.dx, dy = s.dy,
              dz = s.dz;
  const float hx = P.r, hy = P.hy, hz = P.hz;
  f.ivx = kGiven ? k.a : safe_inv(dx);
  f.ivy = kGiven ? k.b : safe_inv(dy);
  f.ivz = kGiven ? k.c : safe_inv(dz);
  if (!kGiven) k = Roots{f.ivx, f.ivy, f.ivz};
  const float tax = (P.cx - hx - ox) * f.ivx, tbx = (P.cx + hx - ox) * f.ivx;
  const float tay = (P.cy - hy - oy) * f.ivy, tby = (P.cy + hy - oy) * f.ivy;
  const float taz = (P.cz - hz - oz) * f.ivz, tbz = (P.cz + hz - oz) * f.ivz;
  const bool lo_x = tax <= tbx, lo_y = tay <= tby, lo_z = taz <= tbz;
  const float t0x = lo_x ? tax : tbx, t0y = lo_y ? tay : tby,
              t0z = lo_z ? taz : tbz;
  const float t1x = lo_x ? tbx : tax, t1y = lo_y ? tby : tay,
              t1z = lo_z ? tbz : taz;
  const float t_enter = fmaxf(fmaxf(t0x, t0y), t0z);
  const float t_exit = fminf(fminf(t1x, t1y), t1z);
  const bool entering = t_enter >= 0.0f, ne = !entering;
  f.t = entering ? t_enter : t_exit;
  const bool wex = t0x == t_enter;
  const bool wey = (t0y == t_enter) && !wex;
  const bool wxx = t1x == t_exit;
  const bool wxy = (t1y == t_exit) && !wxx;
  const bool wx = (entering && wex) || (ne && wxx);
  const bool wy = (entering && wey) || (ne && wxy);
  const bool wz = !wx && !wy;
  f.wxf = mask(wx);
  f.wyf = mask(wy);
  f.wzf = mask(wz);
  f.sgn_x = (entering && lo_x) || (ne && !lo_x) ? -1.0f : 1.0f;
  f.sgn_y = (entering && lo_y) || (ne && !lo_y) ? -1.0f : 1.0f;
  f.sgn_z = (entering && lo_z) || (ne && !lo_z) ? -1.0f : 1.0f;
  f.dokf_x = mask(fabsf(dx) >= kSlabEps);
  f.dokf_y = mask(fabsf(dy) >= kSlabEps);
  f.dokf_z = mask(fabsf(dz) >= kSlabEps);
  f.nx = f.wxf * (dx < 0.0f ? 1.0f : -1.0f);
  f.ny = f.wyf * (dy < 0.0f ? 1.0f : -1.0f);
  f.nz = f.wzf * (dz < 0.0f ? 1.0f : -1.0f);
  return f;
}

template <bool kGiven>
__device__ __forceinline__ Geom geom(const State& s, const Prim& P,
                                     Roots& k) {
  Geom G;
  if (P.is_s) {
    G.sf = sphere_fwd<kGiven>(s, P, k);
    G.t = G.sf.t;
    G.nx = G.sf.nx;
    G.ny = G.sf.ny;
    G.nz = G.sf.nz;
  } else {
    G.bf = box_fwd<kGiven>(s, P, k);
    G.t = G.bf.t;
    G.nx = G.bf.nx;
    G.ny = G.bf.ny;
    G.nz = G.bf.nz;
  }
  G.px = s.ox + G.t * s.dx;
  G.py = s.oy + G.t * s.dy;
  G.pz = s.oz + G.t * s.dz;
  return G;
}

__device__ __forceinline__ State start(const float* __restrict__ org,
                                       const float* __restrict__ dir,
                                       long long i) {
  State s;
  s.ox = __ldg(org + 3 * i);
  s.oy = __ldg(org + 3 * i + 1);
  s.oz = __ldg(org + 3 * i + 2);
  s.dx = __ldg(dir + 3 * i);
  s.dy = __ldg(dir + 3 * i + 1);
  s.dz = __ldg(dir + 3 * i + 2);
  s.cr = 1.0f;
  s.cg = 1.0f;
  s.cb = 1.0f;
  s.path = 0.0f;
  s.status = kAlive;
  return s;
}

// One replayed bounce of an alive ray (replay_grad.py _bounce_fwd); `k`
// receives its roots.
__device__ __forceinline__ void step(const Tabs& T, State& s, int pid,
                                     Roots& k) {
  if (pid < 0) {
    s.cr = s.cr * __ldg(T.sky);
    s.cg = s.cg * __ldg(T.sky + 1);
    s.cb = s.cb * __ldg(T.sky + 2);
    s.status = kMiss;
    return;
  }
  const Prim P = load_prim(T, pid);
  const Geom G = geom<false>(s, P, k);
  const bool lit = P.mode > 1.5f;
  const bool cont = P.mode > 0.5f && P.mode < 1.5f;
  s.cr = s.cr * P.tr;
  s.cg = s.cg * P.tg;
  s.cb = s.cb * P.tb;
  s.path = s.path + G.t;
  s.status = lit ? kLight : (!cont ? kKeep : s.status);
  if (cont) {
    const float d_dot_n = s.dx * G.nx + s.dy * G.ny + s.dz * G.nz;
    const float rdx = s.dx - 2.0f * d_dot_n * G.nx;
    const float rdy = s.dy - 2.0f * d_dot_n * G.ny;
    const float rdz = s.dz - 2.0f * d_dot_n * G.nz;
    s.ox = G.px + kEpsAdvance * rdx;
    s.oy = G.py + kEpsAdvance * rdy;
    s.oz = G.pz + kEpsAdvance * rdz;
    s.dx = rdx;
    s.dy = rdy;
    s.dz = rdz;
  }
}

template <int R>
__global__ void replay_fwd_kernel(Tabs T, const float* __restrict__ org,
                                  const float* __restrict__ dir,
                                  const int* __restrict__ pid_seq,
                                  long long n, float atten,
                                  float* __restrict__ color) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  State s = start(org, dir, i);
  Roots k;
#pragma unroll
  for (int b = 0; b < R; ++b)
    if (s.status == kAlive) step(T, s, __ldg(pid_seq + i * R + b), k);
  const bool exhausted = s.status == kAlive;
  const float pr = exhausted ? 0.0f : s.cr, pg = exhausted ? 0.0f : s.cg,
              pb = exhausted ? 0.0f : s.cb;
  const float pa = s.path * atten;
  const float isl = 1.0f / (kJsEpsilon + pa * pa);
  const bool lit_fin = s.status == kLight;
  color[3 * i] = lit_fin ? pr * isl : pr;
  color[3 * i + 1] = lit_fin ? pg * isl : pg;
  color[3 * i + 2] = lit_fin ? pb * isl : pb;
}

// Sum N values (N a power of two) over the warp's 32 lanes in the
// xor-butterfly tree (partners 16, 8, 4, 2, 1), each sum landing on some
// lanes only: a level with more than one value left keeps half of them,
// the half its lane bit names, and sends the other half to its partner.
// Value q ends on the lanes whose top bits (4, 3, ...) spell q; q is set to
// the lane's. Each sum is the full butterfly's, bit for bit: the same tree,
// and an add does not depend on which partner computes it.
template <int N, int Off>
struct Scatter {
  static __device__ __forceinline__ float run(float* v, int lane, int& q) {
    const bool up = (lane & Off) != 0;
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
      const float send = up ? v[j] : v[j + N / 2];
      const float keep = up ? v[j + N / 2] : v[j];
      v[j] = keep + __shfl_xor_sync(kFull, send, Off);
    }
    q = 2 * q + (up ? 1 : 0);
    return Scatter<N / 2, Off / 2>::run(v, lane, q);
  }
};

template <int Off>
struct Scatter<1, Off> {
  static __device__ __forceinline__ float run(float* v, int, int&) {
    float s = v[0];
#pragma unroll
    for (int o = Off; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    return s;
  }
};

// Add one winner's warp sums of v[0..8] (its lanes' rows; zero on the
// other lanes) to its 9 slots: `slot` in the warp's shared-memory row, or,
// for a sphere summed globally (slot null), its 7 output slots `glob` by
// atomics. Values 0-7 reduce-scatter onto lanes 4q, value 8 onto every
// lane by the butterfly: 14 shuffles, and 9 lanes write at once.
__device__ __forceinline__ void add_sums(float (&v)[kSlot], int lane,
                                         float* slot, float* glob) {
  int q = 0;
  const float s = Scatter<8, 16>::run(v, lane, q);
  float s8 = v[8];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s8 += __shfl_xor_sync(kFull, s8, o);
  const int dq = (lane & 3) == 0 ? q : (lane == 1 ? 8 : -1);
  const float val = lane == 1 ? s8 : s;
  if (dq < 0) return;
  if (slot != nullptr)
    slot[dq] += val;
  else if (dq != 4 && dq != 5)   // a sphere has no slots 4, 5
    atomicAdd(glob + (dq < 4 ? dq : dq - 2), val);
}

// Sum the warp's rows per winner (lanes with key < 0 hold zero rows) onto
// the winners' slots: the warp's shared-memory row for prims >= n_glob,
// global atomics for spheres below it. Winners go in the order of their
// first lane; a warp whose live lanes share one winner takes one pass and
// no selects. `row` is consumed.
__device__ __forceinline__ void reduce_rows(int key, float (&row)[kSlot],
                                            int n_glob, float* my_slots,
                                            float* g_sph, int lane) {
  unsigned pending = __ballot_sync(kFull, key >= 0);
  if (pending == 0u) return;
  int p = __shfl_sync(kFull, key, __ffs(pending) - 1);
  if (__all_sync(kFull, key < 0 || key == p)) {
    add_sums(row, lane, p >= n_glob ? my_slots + (p - n_glob) * kSlot
                                    : nullptr,
             g_sph + (long long)p * kSphSlots);
    return;
  }
  for (;;) {
    const bool mine = key == p;
    float v[kSlot];
#pragma unroll
    for (int q = 0; q < kSlot; ++q) v[q] = mine ? row[q] : 0.0f;
    add_sums(v, lane, p >= n_glob ? my_slots + (p - n_glob) * kSlot
                                  : nullptr,
             g_sph + (long long)p * kSphSlots);
    pending &= ~__ballot_sync(kFull, mine);
    if (pending == 0u) return;
    p = __shfl_sync(kFull, key, __ffs(pending) - 1);
  }
}

// The sky's three sums (zero on lanes that saw no sky) onto `slot`:
// reduce-scattered as four values (the fourth zero), 6 shuffles; lanes 0,
// 8 and 16 write.
__device__ __forceinline__ void add_sky(float (&gsky)[4], int lane,
                                        float* slot) {
  int q = 0;
  const float s = Scatter<4, 16>::run(gsky, lane, q);
  if ((lane & 7) == 0 && q < 3) slot[q] += s;
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// The output slot of reduced column c (-1: none): the slot prims' 9
// columns each (from prim n_glob), then the sky's 3; out holds spheres
// [S, 7] (slots 0-3, 6-8), boxes [B, 9], sky [3].
__device__ __forceinline__ int out_index(int c, int n_glob, int n_sph,
                                         int n_box, int n_slots) {
  if (c >= n_slots * kSlot) return n_sph * kSphSlots + n_box * kSlot +
                                   (c - n_slots * kSlot);
  const int p = n_glob + c / kSlot, q = c % kSlot;
  if (p >= n_sph) return n_sph * kSphSlots + (p - n_sph) * kSlot + q;
  if (q == 4 || q == 5) return -1;
  return p * kSphSlots + (q < 4 ? q : q - 2);
}

template <int R>
__global__ void __launch_bounds__(kBlock)
replay_bwd_kernel(Tabs T, const float* __restrict__ org,
                  const float* __restrict__ dir,
                  const int* __restrict__ pid_seq, long long n, float atten,
                  float atten2, const float* __restrict__ g_color,
                  int n_glob, float* __restrict__ g_org,
                  float* __restrict__ g_dir, float* __restrict__ out,
                  float* __restrict__ partial) {
  // [kWarps][cols]: each warp's per-prim slots, then its 3 sky sums
  extern __shared__ float acc[];
  const int n_slots = T.n_sph + T.n_box - n_glob;
  const int cols = n_slots * kSlot + 3;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int k = threadIdx.x; k < kWarps * cols; k += kBlock) acc[k] = 0.0f;
  __syncthreads();
  float* my = acc + warp * cols;
  const float sky_r = __ldg(T.sky), sky_g = __ldg(T.sky + 1),
              sky_b = __ldg(T.sky + 2);

  for (long long base = (long long)blockIdx.x * kBlock; base < n;
       base += (long long)gridDim.x * kBlock) {
    const long long i = base + threadIdx.x;
    const bool active = i < n;
    // the next group's rays into L2 while this one computes
    const long long i_next = i + (long long)gridDim.x * kBlock;
    if (i_next < n) {
      prefetch_l2(org + 3 * i_next);
      prefetch_l2(dir + 3 * i_next);
      prefetch_l2(g_color + 3 * i_next);
      prefetch_l2(pid_seq + i_next * R);
    }
    const float g_r = active ? __ldg(g_color + 3 * i) : 0.0f;
    const float g_g = active ? __ldg(g_color + 3 * i + 1) : 0.0f;
    const float g_b = active ? __ldg(g_color + 3 * i + 2) : 0.0f;
    // ---- forward, keeping each bounce's entry state ----------------------
    State st[R];
    int pids[R];
    Roots roots[R];
    State s;
    if (active) {
      s = start(org, dir, i);
    } else {
      s = start(org, dir, 0);
      s.status = kKeep;   // a padding lane: every bounce is skipped
    }
#pragma unroll
    for (int b = 0; b < R; ++b) {
      st[b] = s;
      pids[b] = active ? __ldg(pid_seq + i * R + b) : -1;
      if (s.status == kAlive) step(T, s, pids[b], roots[b]);
    }
    // ---- the loss-side epilogue reversed ---------------------------------
    const bool exhausted = s.status == kAlive;
    const float pr = exhausted ? 0.0f : s.cr, pg = exhausted ? 0.0f : s.cg,
                pb = exhausted ? 0.0f : s.cb;
    const float pa = s.path * atten;
    const float isl = 1.0f / (kJsEpsilon + pa * pa);
    const bool lit_fin = s.status == kLight;
    const float gpr = lit_fin ? g_r * isl : g_r;
    const float gpg = lit_fin ? g_g * isl : g_g;
    const float gpb = lit_fin ? g_b * isl : g_b;
    const float pre_dot_g = pr * g_r + pg * g_g + pb * g_b;
    const float disl = -2.0f * s.path * atten2 * isl * isl;
    const float g_path = lit_fin ? pre_dot_g * disl : 0.0f;
    float gox = 0.0f, goy = 0.0f, goz = 0.0f, gdx = 0.0f, gdy = 0.0f,
          gdz = 0.0f;
    float gcr = exhausted ? 0.0f : gpr, gcg = exhausted ? 0.0f : gpg,
          gcb = exhausted ? 0.0f : gpb;

    // ---- the bounces reversed --------------------------------------------
#pragma unroll
    for (int b = R - 1; b >= 0; --b) {
      const State& e = st[b];
      float row[kSlot];
#pragma unroll
      for (int q = 0; q < kSlot; ++q) row[q] = 0.0f;
      float gsky[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      int key = -1;
      if (e.status == kAlive && pids[b] < 0) {
        gsky[0] = gcr * e.cr;
        gsky[1] = gcg * e.cg;
        gsky[2] = gcb * e.cb;
        gcr = gcr * sky_r;
        gcg = gcg * sky_g;
        gcb = gcb * sky_b;
      } else if (e.status == kAlive) {
        const Prim P = load_prim(T, pids[b]);
        const Geom G = geom<true>(e, P, roots[b]);
        const bool cont = P.mode > 0.5f && P.mode < 1.5f;
        key = P.pidc;
        row[6] = gcr * e.cr;
        row[7] = gcg * e.cg;
        row[8] = gcb * e.cb;
        const float gch_r = gcr * P.tr, gch_g = gcg * P.tg,
                    gch_b = gcb * P.tb;
        float g_t = g_path;
        // continuation: org' = point + EPS * refl, dir' = refl
        float gpx = 0.0f, gpy = 0.0f, gpz = 0.0f;
        float grdx = 0.0f, grdy = 0.0f, grdz = 0.0f;
        float ghox = gox, ghoy = goy, ghoz = goz;
        float ghdx = gdx, ghdy = gdy, ghdz = gdz;
        if (cont) {
          gpx = gox;
          gpy = goy;
          gpz = goz;
          grdx = kEpsAdvance * gox + gdx;
          grdy = kEpsAdvance * goy + gdy;
          grdz = kEpsAdvance * goz + gdz;
          ghox = 0.0f;
          ghoy = 0.0f;
          ghoz = 0.0f;
          ghdx = 0.0f;
          ghdy = 0.0f;
          ghdz = 0.0f;
        }
        // refl = d - 2 (d.n) n
        const float dxb = e.dx, dyb = e.dy, dzb = e.dz;
        const float nx = G.nx, ny = G.ny, nz = G.nz;
        const float n_dot_gr = nx * grdx + ny * grdy + nz * grdz;
        ghdx = ghdx + grdx - 2.0f * nx * n_dot_gr;
        ghdy = ghdy + grdy - 2.0f * ny * n_dot_gr;
        ghdz = ghdz + grdz - 2.0f * nz * n_dot_gr;
        const float ddn = dxb * nx + dyb * ny + dzb * nz;
        const float g_nx = -2.0f * (ddn * grdx + n_dot_gr * dxb);
        const float g_ny = -2.0f * (ddn * grdy + n_dot_gr * dyb);
        const float g_nz = -2.0f * (ddn * grdz + n_dot_gr * dzb);
        // point = o + t d
        const float t = G.t;
        ghox = ghox + gpx;
        ghoy = ghoy + gpy;
        ghoz = ghoz + gpz;
        ghdx = ghdx + t * gpx;
        ghdy = ghdy + t * gpy;
        ghdz = ghdz + t * gpz;
        g_t = g_t + gpx * dxb + gpy * dyb + gpz * dzb;
        if (P.is_s) {
          // sphere surface reverse (replay_grad.py _reverse_sphere)
          const SphereFwd& sf = G.sf;
          const float g_n0x = sf.fs * g_nx, g_n0y = sf.fs * g_ny,
                      g_n0z = sf.fs * g_nz;
          const float g_psx = g_n0x * sf.inv_rs, g_psy = g_n0y * sf.inv_rs,
                      g_psz = g_n0z * sf.inv_rs;
          float g_scx = -g_psx, g_scy = -g_psy, g_scz = -g_psz;
          const float pmcx = G.px - P.cx, pmcy = G.py - P.cy,
                      pmcz = G.pz - P.cz;
          float g_sr = -sf.r_okf * (g_n0x * pmcx + g_n0y * pmcy +
                                    g_n0z * pmcz) *
                       sf.inv_rs * sf.inv_rs;
          float g_ox = ghox + g_psx, g_oy = ghoy + g_psy, g_oz = ghoz + g_psz;
          float g_dx = ghdx + t * g_psx, g_dy = ghdy + t * g_psy,
                g_dz = ghdz + t * g_psz;
          const float g_ts = g_t + g_psx * dxb + g_psy * dyb + g_psz * dzb;
          const float g_tn = sf.nf * g_ts;
          const float g_tf = (1.0f - sf.nf) * g_ts;
          float g_bh = -(g_tn + g_tf) * sf.inv_a;
          const float g_sq = (g_tf - g_tn) * sf.inv_a;
          float g_a = -(sf.t_near * g_tn + sf.t_far * g_tf) * sf.inv_a;
          const float g_disc = sf.posf * g_sq * 0.5f / sf.sq_inner;
          g_bh = g_bh + 2.0f * sf.bh * g_disc;
          g_a = g_a - sf.c * g_disc;
          const float g_cq = -sf.a * g_disc;
          float g_ocx = 2.0f * g_cq * sf.ocx;
          float g_ocy = 2.0f * g_cq * sf.ocy;
          float g_ocz = 2.0f * g_cq * sf.ocz;
          g_sr = g_sr - 2.0f * P.r * g_cq;
          g_dx = g_dx + 2.0f * g_a * dxb;
          g_dy = g_dy + 2.0f * g_a * dyb;
          g_dz = g_dz + 2.0f * g_a * dzb;
          g_ocx = g_ocx + g_bh * dxb;
          g_ocy = g_ocy + g_bh * dyb;
          g_ocz = g_ocz + g_bh * dzb;
          g_dx = g_dx + g_bh * sf.ocx;
          g_dy = g_dy + g_bh * sf.ocy;
          g_dz = g_dz + g_bh * sf.ocz;
          gox = g_ox + g_ocx;
          goy = g_oy + g_ocy;
          goz = g_oz + g_ocz;
          gdx = g_dx;
          gdy = g_dy;
          gdz = g_dz;
          g_scx = g_scx - g_ocx;
          g_scy = g_scy - g_ocy;
          g_scz = g_scz - g_ocz;
          row[0] = g_scx;
          row[1] = g_scy;
          row[2] = g_scz;
          row[3] = g_sr;
        } else {
          // box slab reverse (replay_grad.py _reverse_box); the face normal
          // is piecewise constant and takes no cotangent
          const BoxFwd& bf = G.bf;
          const float gw_x = g_t * bf.wxf, gw_y = g_t * bf.wyf,
                      gw_z = g_t * bf.wzf;
          row[0] = gw_x * bf.ivx;
          row[1] = gw_y * bf.ivy;
          row[2] = gw_z * bf.ivz;
          row[3] = gw_x * bf.ivx * bf.sgn_x;
          row[4] = gw_y * bf.ivy * bf.sgn_y;
          row[5] = gw_z * bf.ivz * bf.sgn_z;
          gox = ghox - gw_x * bf.ivx;
          goy = ghoy - gw_y * bf.ivy;
          goz = ghoz - gw_z * bf.ivz;
          gdx = ghdx - bf.dokf_x * gw_x * bf.ivx * bf.t;
          gdy = ghdy - bf.dokf_y * gw_y * bf.ivy * bf.t;
          gdz = ghdz - bf.dokf_z * gw_z * bf.ivz * bf.t;
        }
        gcr = gch_r;
        gcg = gch_g;
        gcb = gch_b;
      }
      // ---- per-prim and sky sums (every lane joins) ----------------------
      reduce_rows(key, row, n_glob, my, out, lane);
      if (__any_sync(kFull, gsky[0] != 0.0f || gsky[1] != 0.0f ||
                                gsky[2] != 0.0f))
        add_sky(gsky, lane, my + n_slots * kSlot);
    }
    if (active) {
      g_org[3 * i] = gox;
      g_org[3 * i + 1] = goy;
      g_org[3 * i + 2] = goz;
      g_dir[3 * i] = gdx;
      g_dir[3 * i + 1] = gdy;
      g_dir[3 * i + 2] = gdz;
    }
  }
  // ---- this block's partial row: its warps summed in warp order ----------
  __syncthreads();
  for (int k = threadIdx.x; k < cols; k += kBlock) {
    float v = acc[k];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += acc[w * cols + k];
    partial[(long long)blockIdx.x * cols + k] = v;
  }
  // ---- every partial row written before any is read: the grid barrier
  // (a cooperative launch, so every block is resident; the barrier orders
  // the writes before it for every block after it) -------------------------
  cooperative_groups::this_grid().sync();
  // ---- column c = sum over the partial rows, by warp c mod the grid's
  // warps, in a fixed order: lane y adds rows y, y + 32, ... in turn (read
  // 8 at a time; a row past the grid adds +0, which changes no bit of a sum
  // that starts at +0), then a shuffle-down tree over the lanes ------------
  const int rows = gridDim.x;
  for (int c = blockIdx.x * kWarps + warp; c < cols;
       c += gridDim.x * kWarps) {
    float v = 0.0f;
    for (int r0 = lane; r0 < rows; r0 += 32 * 8) {
      float x[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int r = r0 + 32 * k;
        x[k] = r < rows ? __ldcg(partial + (long long)r * cols + c) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) v += x[k];
    }
#pragma unroll
    for (int h = 16; h > 0; h >>= 1) v += __shfl_down_sync(kFull, v, h);
    const int dst = out_index(c, n_glob, T.n_sph, T.n_box, n_slots);
    if (lane == 0 && dst >= 0) out[dst] = v;
  }
}

Tabs make_tabs(const float* sph, int n_sph, const float* box, int n_box,
               const float* sky) {
  Tabs T;
  T.sph = sph;
  T.box = box;
  T.sky = sky;
  T.n_sph = n_sph;
  T.n_box = n_box;
  return T;
}

template <int R>
void launch_fwd(const Tabs& T, const float* org, const float* dir,
                const int* pid_seq, long long n, float atten, float* color,
                cudaStream_t stream) {
  const int block = 128;
  const long long grid = (n + block - 1) / block;
  replay_fwd_kernel<R><<<(unsigned int)grid, block, 0, stream>>>(
      T, org, dir, pid_seq, n, atten, color);
}

template <int R>
int bwd_blocks_per_sm(size_t smem) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, replay_bwd_kernel<R>, kBlock, smem);
  return err != cudaSuccess ? -(int)err : blocks;
}

template <int R>
cudaError_t launch_bwd(Tabs T, const float* org, const float* dir,
                       const int* pid_seq, long long n, float atten,
                       float atten2, const float* g_color, int n_glob,
                       float* g_org, float* g_dir, float* out,
                       float* partial, int blocks, size_t smem,
                       cudaStream_t stream) {
  void* args[] = {&T,      &org,     &dir,  &pid_seq, &n,
                  &atten,  &atten2,  &g_color, &n_glob, &g_org,
                  &g_dir,  &out,     &partial};
  return cudaLaunchCooperativeKernel((const void*)replay_bwd_kernel<R>,
                                     dim3(blocks), dim3(kBlock), args, smem,
                                     stream);
}

size_t bwd_smem(int cols) { return sizeof(float) * kWarps * (size_t)cols; }

}  // namespace

// ---- C entry points (loaded with ctypes by kernels/_build.py) --------------
// Each launches on the given stream, does not synchronize, and returns
// cudaGetLastError() (0 on success). The wrappers check shapes and never call
// them with no prims; refmax is 1..4.

extern "C" int rt_replay_fwd(const float* sph, int n_sph, const float* box,
                             int n_box, const float* sky, const float* org,
                             const float* dir, const int* pid_seq,
                             long long n, int refmax, float atten,
                             float* color, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  const Tabs T = make_tabs(sph, n_sph, box, n_box, sky);
  cudaStream_t s = (cudaStream_t)stream;
  switch (refmax) {
    case 1: launch_fwd<1>(T, org, dir, pid_seq, n, atten, color, s); break;
    case 2: launch_fwd<2>(T, org, dir, pid_seq, n, atten, color, s); break;
    case 3: launch_fwd<3>(T, org, dir, pid_seq, n, atten, color, s); break;
    case 4: launch_fwd<4>(T, org, dir, pid_seq, n, atten, color, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The backward's resident blocks per SM at `cols` = (n_sph + n_box -
// n_glob) * 9 + 3 columns (its occupancy; the grid may not exceed it times
// the SMs); negative: a CUDA error.
extern "C" int rt_replay_bwd_blocks_per_sm(int refmax, int cols,
                                           int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  const size_t smem = bwd_smem(cols);
  switch (refmax) {
    case 1: return bwd_blocks_per_sm<1>(smem);
    case 2: return bwd_blocks_per_sm<2>(smem);
    case 3: return bwd_blocks_per_sm<3>(smem);
    case 4: return bwd_blocks_per_sm<4>(smem);
    default: return -(int)cudaErrorInvalidValue;
  }
}

// One cooperative launch of `blocks` (at most the resident blocks) blocks.
// partial is [blocks, cols] scratch, cols = (n_sph + n_box - n_glob) * 9 +
// 3; out is [n_sph * 7 + n_box * 9 + 3] (spheres' center, radius, rgb;
// boxes' center, half size, rgb; the sky's rgb), its first n_glob * 7
// zeroed by the caller (those spheres sum by atomics).
extern "C" int rt_replay_bwd(const float* sph, int n_sph, const float* box,
                             int n_box, const float* sky, const float* org,
                             const float* dir, const int* pid_seq,
                             long long n, int refmax, float atten,
                             float atten2, const float* g_color, int n_glob,
                             float* g_org, float* g_dir, float* out,
                             float* partial, int blocks, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || blocks <= 0) return 0;
  const Tabs T = make_tabs(sph, n_sph, box, n_box, sky);
  const size_t smem = bwd_smem((n_sph + n_box - n_glob) * kSlot + 3);
  cudaStream_t s = (cudaStream_t)stream;
  switch (refmax) {
    case 1:
      err = launch_bwd<1>(T, org, dir, pid_seq, n, atten, atten2, g_color,
                          n_glob, g_org, g_dir, out, partial, blocks, smem, s);
      break;
    case 2:
      err = launch_bwd<2>(T, org, dir, pid_seq, n, atten, atten2, g_color,
                          n_glob, g_org, g_dir, out, partial, blocks, smem, s);
      break;
    case 3:
      err = launch_bwd<3>(T, org, dir, pid_seq, n, atten, atten2, g_color,
                          n_glob, g_org, g_dir, out, partial, blocks, smem, s);
      break;
    case 4:
      err = launch_bwd<4>(T, org, dir, pid_seq, n, atten, atten2, g_color,
                          n_glob, g_org, g_dir, out, partial, blocks, smem, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
