// Nearest-hit search kernels for the PALLAS and TILED backends (Hopper,
// sm_90a). B4 (nh_dense_kernel), B6 (nh_listed_kernel) and B8
// (nh_culled_kernel) stream tiles through shared memory and are described
// beside their code below.
//
// What they replace (the reference package's TPU kernels):
//   nh_scalar_kernel (B3) -> _nh_scalar_kernel
//       (raytracer_js_tpu/kernels/nearest_hit.py:702, call :834, entry
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
// What bounds them on this card: per-ray ALU work, the tests. B4 tests
// every primitive: an IEEE sqrt per sphere, a slab test per box, and a
// Moeller-Trumbore test with an IEEE divide per triangle (config 3: 5124
// prims, 5120 of them triangles, for each of 262,144 rays per bounce).
// Device-memory traffic is 24 bytes of ray in and 8 bytes of result out per
// ray; the tables are at most a few hundred KB and stay in L1/L2.
//
// B3: one thread per ray, no ray state outside registers. Testing every
// prim (the headline: 51 spheres and the ground box for each of 2,088,960
// rays a bounce) it took 0.2395 ms against an all-tests bound of 0.0472
// (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py --frame-times), though a
// warp's 32 rays are a thin bundle that most spheres miss. So each warp
// culls the spheres by B8's ball-cone, one sphere at a time, and skips the
// sqrt of a sphere no lane can hit (described beside its code below); the
// tests the rays need set its bound (chip_smoke.py phase 10).
//
// Precision: built with --fmad=false and without fast math, so every
// expression rounds once, as in PyTorch; sqrtf and division are IEEE. The
// sphere dots are products summed left to right (never a matmul).
//
// Tables (row-major float32):
//   B3: one [rows, stride] table per class: spheres cx cy cz ccmr (ccmr =
//     c.c - r^2, packed on the host), boxes cx cy cz hx hy hz, triangles
//     v0(3) v1(3) v2(3); and the sphere bounds [S, 4] cx cy cz r.
//   B4, B6, B8 (kernels/nearest_hit.StreamTables): spheres as the
//     array-of-structs [S', 4], triangles as edges [9, T'] = v0(3),
//     e1 = v1 - v0 (3), e2 = v2 - v0 (3), both padded to whole 128-prim
//     (super)tiles; boxes as for B3. The edges are subtracted on the device
//     in float32, each rounded once, as the vertex-form test subtracts them,
//     so the test's values do not change (tests/test_torch_nearest_hit.py
//     holds the two forms equal bit for bit).

#include <cuda_runtime.h>
#include <stdint.h>

#include <limits>

namespace {

#include "stream.cuh"
#include "cull.cuh"

constexpr float kInf = std::numeric_limits<float>::infinity();
constexpr float kSlabEps = 1e-12f;
constexpr float kMtEps = 1e-9f;
constexpr int kTile = 128;        // prims per shared-memory tile
constexpr int kBlock = 128;       // rays per block (four warps)
constexpr int kScalarBlock = 128; // B3's threads per block

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
// explicit disc >= 0 mask, in two parts so that B3 can skip the root for a
// warp that misses (a negative or NaN disc gives +inf either way).
__device__ __forceinline__ float scalar_disc(const Ray& r, float4 s,
                                             float& b_half) {
  b_half = r.o_dot_d - (r.dx * s.x + r.dy * s.y + r.dz * s.z);
  float c = r.o_dot_o - 2.0f * (r.ox * s.x + r.oy * s.y + r.oz * s.z) + s.w;
  return b_half * b_half - r.a * c;
}

__device__ __forceinline__ float scalar_root(const Ray& r, float b_half,
                                             float disc) {
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float t_near = (-b_half - sq) * r.inv_a;
  float t_far = (-b_half + sq) * r.inv_a;
  float t = t_near >= 0.0f ? t_near : (t_far >= 0.0f ? t_far : kInf);
  return disc >= 0.0f ? t : kInf;
}

// B4's sphere test (nearest_hit.py:289-303): the factored form; a negative
// discriminant makes sq NaN, every compare on it false, and t = +inf. Split
// in two so that B4, B6 and B8 can skip the root for a warp that misses.
__device__ __forceinline__ float sphere_disc(const Ray& r, float cx,
                                             float cy, float cz, float ccmr,
                                             float& d_dot_c) {
  d_dot_c = r.dx * cx + r.dy * cy + r.dz * cz;
  float o_dot_c = r.ox * cx + r.oy * cy + r.oz * cz;
  float b_half = r.o_dot_d - d_dot_c;
  float c = r.o_dot_o - 2.0f * o_dot_c + ccmr;
  return b_half * b_half - r.a * c;
}

__device__ __forceinline__ float sphere_root(const Ray& r, float d_dot_c,
                                             float disc) {
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

// Whether a Moeller-Trumbore test certainly fails, from its determinant
// and the numerator u_num = s.p of its u = u_num * (1 / det), under IEEE
// rounding (the streaming kernels skip 1 / det and the tail for a warp
// whose every lane certainly fails; such a lane yields +inf either way):
//  - |det| < 1e-9, or det NaN: `fabsf(det) >= kMtEps` is false.
//  - u_num and det of opposite signs, |u_num| >= |det| * 2^-64 (so u_num is
//    not zero): 1 / det (det finite and nonzero) has det's sign and
//    |1 / det| >= 2^-129, so |u| >= 2^-67 before rounding, and u rounds to
//    a negative number, never to -0: `u >= 0` is false. (det = +-inf:
//    |u_num| = inf, u = inf * 0 = NaN, also false.)
//  - the same signs and |u_num| >= fl(|det| * (1 + 2^-20)): with the
//    roundings of the product, of 1 / det (relative 2^-24, or 2^-22 when
//    it is subnormal) and of u, u > 1, so for v >= 0, u + v >= u > 1 and
//    `u + v <= 1` is false; v < 0 or NaN fails `v >= 0`. An overflowed
//    bound (inf) holds only for |u_num| = inf: u = +inf or NaN, both fail.
// tests/test_torch_nearest_hit.py holds the plain form of this predicate
// (kernels/nearest_hit.tri_certain_miss) to never reject a hit.
__device__ __forceinline__ bool tri_certain_miss(float det, float u_num) {
  const float ad = fabsf(det), au = fabsf(u_num);
  if (!(ad >= kMtEps)) return true;
  return (u_num < 0.0f) != (det < 0.0f) ? au >= ad * 0x1p-64f
                                         : au >= ad * (1.0f + 0x1p-20f);
}

// Moeller-Trumbore with the 1e-9 determinant floor, from v0 and the edges
// e1 = v1 - v0, e2 = v2 - v0. kWarpSkip: every lane of the warp calls it
// and the warp returns +inf at once when each lane certainly fails.
template <bool kWarpSkip = false>
__device__ __forceinline__ float tri_t(const Ray& r, float v0x, float v0y,
                                       float v0z, float e1x, float e1y,
                                       float e1z, float e2x, float e2y,
                                       float e2z) {
  float px = r.dy * e2z - r.dz * e2y;
  float py = r.dz * e2x - r.dx * e2z;
  float pz = r.dx * e2y - r.dy * e2x;
  float det = e1x * px + e1y * py + e1z * pz;
  float sx = r.ox - v0x, sy = r.oy - v0y, sz = r.oz - v0z;
  float u_num = sx * px + sy * py + sz * pz;
  if (kWarpSkip && __all_sync(kFull, tri_certain_miss(det, u_num)))
    return kInf;
  float inv_det = 1.0f / (fabsf(det) < kMtEps ? kMtEps : det);
  float u = u_num * inv_det;
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

// ---- B4, B6 and B8: the streaming searches --------------------------------
// nh_dense_kernel (B4): every tile of every class, as described above.
// nh_listed_kernel (B6) -> _nearest_hit_kernel_listed (nearest_hit.py:155,
// entry nearest_hit_pallas(tile_ids=...) :898): the nearest hit over each
// 128-ray block's list row of (super)tile ids, near to far (ascending t_lo).
// nh_culled_kernel (B8) -> _nearest_hit_kernel_culled (nearest_hit.py:113,
// body _nearest_hit_block :236-267 and :415-431, entry
// nearest_hit_pallas(tile_bounds=...) :898): B4 with a cone cull of the
// 128-sphere tiles. All three fold every prim with a strict < in stream
// order, so a t tie goes to the prim streamed first (B4 and B8 stream in
// pid order, so a tie goes to the lowest pid); the plain versions are
// kernels/nearest_hit.nearest_hit_pallas_plain, nearest_hit_listed_plain
// and culled_plain, the last two with their exit group as their `group`
// argument (32 here).
//
// What bounds them: the tests of the tiles streamed (config 4's sweep
// round: some 2.4e10 sphere tests, most of them misses; config 3's dense
// search: 262,144 rays x 5120 triangles, an IEEE divide each). The tables
// (1.6 MB at 100k spheres, 18 MB at 1.1M), lists and rays stay in the
// 50 MB L2; the bytes are a few percent of the time.
//
// B4 and B8 are one body (search_all) with the sphere cursor as its
// template parameter: AllCursor streams every tile (B4), ConeCursor the
// tiles the warp's cone reaches (B8); boxes and triangles are dense in
// both. A dense scan has no early exit, so the four warps of a B4 block
// stream the same tiles; one ring shared by the block (one __syncthreads a
// tile) was measured against the per-warp rings on the main paths' shapes
// and was within 1% of them either way, so B4 takes the per-warp rings as
// B8 does.
//
// Design. The exit group is one warp of 32 rays, not the block:
//  - B6: each warp streams its block's list row chunk by chunk (kChunkT
//    slots) and stops on its own once the next chunk's t_lo exceeds the
//    warp's horizon, the largest over its live lanes of min(t_best,
//    bbox-exit cap) (a __shfl_xor max). The row is conservative for all
//    128 rays, hence for any 32 of them, so the finer exit skips only slots
//    that cannot hold a strictly nearer prim: t and pid are those of the
//    block rule.
//  - B8: each warp bounds its own live rays by an apex ball (o0 = the mean
//    origin, ro = the largest distance from it) and a cone (axis = the
//    normalized mean direction, cos_t = the worst alignment, d / sqrt(a);
//    cos_t < 0.25 keeps every tile), the sums one shuffle-down tree in a
//    fixed order. 32 lanes evaluate the tile predicate for 32 tiles at
//    once (__ballot_sync), which also tells the warp its next kept tile.
//  - Tile delivery: each warp stages its tiles into a private two-stage
//    ring in dynamic shared memory with cp.async 16-byte copies, copying
//    tile k+1 while it tests tile k; synchronization is
//    cp.async.wait_group and __syncwarp only, and no warp waits on
//    another (no __syncthreads). The four warps of a block read the same
//    list row, so a tile they share comes from L1 or L2. Spheres stage
//    from an array-of-structs copy of the table ([S, 4]: cx cy cz ccmr), so
//    a sphere is one 16-byte shared load broadcast to the warp; triangles
//    stage as 9 rows of 128 floats. Both tables are padded to whole
//    (super)tiles, padded spheres poisoned (ccmr = +inf) and padded
//    triangles all-zero, so a padded prim never folds. Boxes (the ground
//    plane or a few walls in the sweep scenes) stage by plain loads.
//  - Test cost: the sphere test skips its IEEE sqrt and tail when no lane
//    of the warp has disc >= 0 (__any_sync): a negative or NaN
//    discriminant yields +inf either way, so the result is bit-identical.
//    Built with --fmad=false: a fused multiply-add counts as two of the
//    67 TFLOP/s peak's operations, so this kernel can reach at most half
//    of an operations bound taken at that peak.
// Shape: <<<ceil(n / 128), 128>>>, four independent warps a block, one list
// row a block (B6), 4 KB of dynamic shared memory a warp (a ring of two
// sphere tiles; the box staging fits in it), 9 KB with triangles. Rays at
// or past n_live report (+inf, -1) and take no part in a horizon or cone; a
// warp with no live ray exits at once. Why 128-thread blocks and not
// one-warp blocks: ptxas (sm_90a, nvcc -Xptxas -v) gives B6 64 registers
// a thread (8 blocks, 32 warps an SM by its 65,536 registers) and B8 56
// (8 bytes spilled; 9 blocks, 36 warps); one-warp blocks would stop at 32
// warps (32 resident blocks an SM), no more for B6 and fewer for B8, and
// lose the four warps' sharing of one list row in L1. B4: 48 registers,
// no spills (with triangles, 36 KB of rings limit it to 6 blocks an SM);
// nh_merge_kernel 27.

constexpr int kWarps = kBlock / 32;
constexpr int kChunkT = 16;       // list slots between early-exit checks

enum { K_SPH, K_TRI };

template <int Kind>
struct TileKind;

// A warp fills its own ring: lane l copies every 32nd 16-byte piece of a
// tile from piece l.

// 128 spheres from the array-of-structs table [rows, 4]: 2048 bytes, 128
// 16-byte pieces.
template <>
struct TileKind<K_SPH> {
  static constexpr int kFloats = 4 * kTile;
  static __device__ __forceinline__ void fetch(float* dst, const float* tab,
                                               int, int k0) {
    const float4* src = reinterpret_cast<const float4*>(tab) + k0;
    float4* d = reinterpret_cast<float4*>(dst);
    const int l = lane_id();
#pragma unroll
    for (int c = 0; c < kTile / 32; ++c)
      cp_async16(d + l + 32 * c, src + l + 32 * c);
  }
  static __device__ __forceinline__ void test(const float* src, int pid0,
                                              const Ray& r, float& t_best,
                                              int& pid) {
    const float4* sp = reinterpret_cast<const float4*>(src);
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float4 c = sp[j];
      float d_dot_c;
      const float disc = sphere_disc(r, c.x, c.y, c.z, c.w, d_dot_c);
      if (__any_sync(kFull, disc >= 0.0f))
        fold(sphere_root(r, d_dot_c, disc), pid0 + j, t_best, pid);
    }
  }
};

// 128 triangles from the structure-of-arrays edge table [9, stride] (v0,
// e1, e2; stride and k0 multiples of kTile): a 512-byte segment of each
// row, 32 16-byte pieces a row.
template <>
struct TileKind<K_TRI> {
  static constexpr int kFloats = 9 * kTile;
  static __device__ __forceinline__ void fetch(float* dst, const float* tab,
                                               int stride, int k0) {
#pragma unroll
    for (int p = lane_id(); p < 9 * (kTile / 4); p += 32) {
      const int row = p / (kTile / 4), q = 4 * (p % (kTile / 4));
      cp_async16(dst + row * kTile + q, tab + (size_t)row * stride + k0 + q);
    }
  }
  static __device__ __forceinline__ void test(const float* t, int pid0,
                                              const Ray& r, float& t_best,
                                              int& pid) {
#pragma unroll 2
    for (int j = 0; j < kTile; ++j)
      fold(tri_t<true>(r, t[j], t[kTile + j], t[2 * kTile + j],
                       t[3 * kTile + j], t[4 * kTile + j], t[5 * kTile + j],
                       t[6 * kTile + j], t[7 * kTile + j], t[8 * kTile + j]),
           pid0 + j, t_best, pid);
  }
};

// Stream the 128-prim tiles a cursor yields (prim offsets in stream order)
// through the warp's two-stage ring, folding each into (t_best, pid): the
// copy of the next tile is in flight while this one is tested. A cursor
// has first(t_best) -> the first offset or -1; ahead() -> the offset after
// the current one, as far as it can tell yet (-1: none); advance(t_best)
// -> whether that tile is streamed, now that the current one is folded.
// Every call is warp-uniform. Returns the tiles tested.
template <int Kind, class Cursor>
__device__ __forceinline__ int stream_tiles(float* ring, const float* tab,
                                            int stride, int pid0, Cursor& cur,
                                            const Ray& r, float& t_best,
                                            int& pid) {
  using TK = TileKind<Kind>;
  constexpr int kF = TK::kFloats;
  int k = cur.first(t_best);
  if (k < 0) return 0;
  TK::fetch(ring, tab, stride, k);
  cp_async_commit();
  int s = 0, tested = 0;
  for (;;) {
    const int next = cur.ahead();
    if (next >= 0) TK::fetch(ring + (s ^ 1) * kF, tab, stride, next);
    cp_async_commit();
    cp_async_wait<1>();       // this lane's copies of tile k have landed
    __syncwarp();             // ... and every lane's
    TK::test(ring + s * kF, pid0 + k, r, t_best, pid);
    ++tested;
    __syncwarp();             // stage s is read before it is refilled
    if (!cur.advance(t_best)) break;
    k = next;
    s ^= 1;
  }
  cp_async_wait<0>();         // drain a copy the stream did not use
  __syncwarp();
  return tested;
}

// Tiles [k0, k1) of a class padded to whole tiles, in order.
struct AllCursor {
  int k0, k1, k;
  __device__ int first(float) {
    k = k0;
    return k0 < k1 ? k0 * kTile : -1;
  }
  __device__ int ahead() const { return k + 1 < k1 ? (k + 1) * kTile : -1; }
  __device__ bool advance(float) { return ++k < k1; }
};

struct List {
  const int* ids;      // [rows, cols] (super)tile ids, null when dense
  const float* tlo;    // [rows, cols] ascending entry bounds (+inf padding)
  int cols;            // a kChunkT multiple
  int fan;             // 128-prim tiles per id
};

// B6: one list row, streamed chunk by chunk while the next chunk's t_lo
// lies within the warp's horizon. j counts the slots streamed.
struct ListCursor {
  const int* ids;
  const float* tlo;
  int cols, fan;
  bool active;
  float t_cap;
  int j = 0;       // the current chunk's first slot
  int q = 0;       // the current tile within the chunk
  float t_hi = 0;  // the warp's horizon when the chunk started

  __device__ int tile(int jj, int qq) const {
    return (__ldg(ids + jj + qq / fan) * fan + qq % fan) * kTile;
  }
  __device__ float horizon(float t_best) const {
    return warp_max(active ? fminf(t_best, t_cap) : -kInf);
  }
  __device__ int first(float t_best) {
    t_hi = horizon(t_best);
    return cols > 0 && __ldg(tlo) <= t_hi ? tile(0, 0) : -1;
  }
  __device__ int ahead() const {
    if (q + 1 < kChunkT * fan) return tile(j, q + 1);
    // the next chunk's first tile, copied ahead while its t_lo lies within
    // the current horizon: the horizon only shrinks, so a chunk past it
    // now is never streamed
    return j + kChunkT < cols && __ldg(tlo + j + kChunkT) <= t_hi
               ? tile(j + kChunkT, 0)
               : -1;
  }
  __device__ bool advance(float t_best) {
    if (++q < kChunkT * fan) return true;
    j += kChunkT;
    q = 0;
    t_hi = horizon(t_best);
    return j < cols && __ldg(tlo + j) <= t_hi;
  }
};

// B8: the sphere tiles the warp's ball-cone (cull.cuh) can reach, 32
// predicates at a time (lane l tests tile w0 + l); `mask` holds the
// window's kept tiles not yet handed out.
struct ConeCursor {
  const float* tb;     // [n_t, 4] tile bounds: center, radius
  int n_t;
  Cone cone;
  int w0 = 0;
  unsigned mask = 0;
  int pending = -1;

  __device__ unsigned window(int w) const {
    const int k = w + lane_id();
    bool include = false;
    if (k < n_t) {
      const float* b = tb + 4 * k;
      include = cone.reaches(__ldg(b + 0), __ldg(b + 1), __ldg(b + 2),
                             __ldg(b + 3));
    }
    return __ballot_sync(kFull, include);
  }
  __device__ int pop() {
    while (mask == 0) {
      w0 += 32;
      if (w0 >= n_t) return -1;
      mask = window(w0);
    }
    const int b = __ffs(mask) - 1;
    mask &= mask - 1;
    return (w0 + b) * kTile;
  }
  __device__ int first(float) {
    w0 = 0;
    mask = n_t > 0 ? window(0) : 0u;
    return pop();
  }
  __device__ int ahead() {
    pending = pop();
    return pending;
  }
  __device__ bool advance(float) const { return pending >= 0; }
};

// The dense scan of the boxes (an unpadded [6, stride] table) through the
// warp's staging area.
__device__ __forceinline__ void box_scan(float* buf, const Tables& T,
                                         const Ray& r, float& t_best,
                                         int& pid) {
  for (int k0 = 0; k0 < T.n_box; k0 += kTile) {
    const int m = min(kTile, T.n_box - k0);
    for (int p = lane_id(); p < m; p += 32)
      for (int row = 0; row < 6; ++row)
        buf[row * kTile + p] = ld(T.box, row, T.b_stride, k0 + p);
    __syncwarp();
    for (int j = 0; j < m; ++j)
      fold(box_t(r, buf[j], buf[kTile + j], buf[2 * kTile + j],
                 buf[3 * kTile + j], buf[4 * kTile + j], buf[5 * kTile + j]),
           T.n_sph + k0 + j, t_best, pid);
    __syncwarp();
  }
}

__device__ __forceinline__ int tiles_of(int count) {
  return (count + kTile - 1) / kTile;
}

// Tables of B4, B6 and B8: T.sph is the array-of-structs sphere table
// [S', 4] and T.tri the [9, T'] triangle edge table, both padded to whole
// (super)tiles (S', T' their strides); boxes as in B3.
__global__ void __launch_bounds__(kBlock)
nh_listed_kernel(Tables T, const float* __restrict__ org,
                 const float* __restrict__ dir, long long n,
                 const int* __restrict__ n_live,
                 const float* __restrict__ bbox, List sph_list,
                 List tri_list, int warp_floats, float* __restrict__ t_out,
                 int* __restrict__ pid_out, int* __restrict__ work) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5;
  float* ring = reinterpret_cast<float*>(smem4) + warp * warp_floats;
  const int row = blockIdx.x;
  const long long i = (long long)row * kBlock + threadIdx.x;
  const long long live = min(n, (long long)__ldg(n_live));
  int* wk = work == nullptr ? nullptr : work + 2 * (row * kWarps + warp);
  if (i - lane_id() >= live) {      // no live ray in this warp
    if (i < n) {
      t_out[i] = kInf;
      pid_out[i] = -1;
    }
    if (wk != nullptr && lane_id() == 0) wk[0] = wk[1] = 0;
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
  if (sph_list.ids != nullptr) {
    ListCursor c{sph_list.ids + (size_t)row * sph_list.cols,
                 sph_list.tlo + (size_t)row * sph_list.cols, sph_list.cols,
                 sph_list.fan, active, t_cap};
    stream_tiles<K_SPH>(ring, T.sph, T.s_stride, 0, c, r, t_best, pid);
    slots_s = c.j;
  } else {
    AllCursor c{0, tiles_of(T.n_sph), 0};
    stream_tiles<K_SPH>(ring, T.sph, T.s_stride, 0, c, r, t_best, pid);
  }
  box_scan(ring, T, r, t_best, pid);
  const int tri0 = T.n_sph + T.n_box;
  if (tri_list.ids != nullptr) {
    ListCursor c{tri_list.ids + (size_t)row * tri_list.cols,
                 tri_list.tlo + (size_t)row * tri_list.cols, tri_list.cols,
                 tri_list.fan, active, t_cap};
    stream_tiles<K_TRI>(ring, T.tri, T.t_stride, tri0, c, r, t_best, pid);
    slots_t = c.j;
  } else {
    AllCursor c{0, tiles_of(T.n_tri), 0};
    stream_tiles<K_TRI>(ring, T.tri, T.t_stride, tri0, c, r, t_best, pid);
  }
  if (wk != nullptr && lane_id() == 0) {
    wk[0] = slots_s;
    wk[1] = slots_t;
  }
  if (i < n) {
    t_out[i] = active ? t_best : kInf;
    pid_out[i] = active && t_best < kInf ? pid : -1;
  }
}

// Split y of a dense scan's gridDim.y splits: its share [k0, k1) of a
// class's n_t tiles (all of them with one split).
__device__ __forceinline__ AllCursor split_range(int n_t) {
  return AllCursor{(int)((long long)n_t * blockIdx.y / gridDim.y),
                   (int)((long long)n_t * (blockIdx.y + 1) / gridDim.y), 0};
}

// The sphere cursor of each search: B4 streams every tile; B8 the tiles the
// warp's ball-cone over its live rays reaches (tb: one row (cx, cy, cz, r)
// per 128-sphere tile).
__device__ __forceinline__ AllCursor sphere_cursor(AllCursor*,
                                                   const Tables& T,
                                                   const float*, const Ray&,
                                                   bool) {
  return split_range(tiles_of(T.n_sph));
}

// The ball-cone of the warp's live rays (the lanes with `active`) over the
// n_t balls tb [n_t, 4] (center, radius): B8's 128-sphere tiles, B3's
// spheres.
__device__ __forceinline__ ConeCursor warp_cone(const float* tb, int n_t,
                                                const Ray& r, bool active) {
  ConeCursor c;
  c.tb = tb;
  c.n_t = n_t;
  c.cone = warp_cone(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, r.a, active);
  return c;
}

__device__ __forceinline__ ConeCursor sphere_cursor(ConeCursor*,
                                                    const Tables& T,
                                                    const float* tb,
                                                    const Ray& r,
                                                    bool active) {
  return warp_cone(tb, tiles_of(T.n_sph), r, active);
}

// The body of B4 and B8: spheres through the cursor, boxes, then every
// triangle tile. `ring` holds warp_floats floats a warp, and a warp with
// no live ray exits at once. B4 may split its scan over gridDim.y
// (split_range; the boxes go to split 0): split y writes its (t, pid) to
// row y of t_out / pid_out [splits, n]. `work` (B8; may be null) receives
// the sphere tiles each warp streamed, [blocks, 4].
template <class Cursor>
__device__ __forceinline__ void search_all(
    const Tables& T, const float* __restrict__ org,
    const float* __restrict__ dir, long long n,
    const int* __restrict__ n_live, const float* __restrict__ tb,
    int warp_floats, float* __restrict__ t_out, int* __restrict__ pid_out,
    int* __restrict__ work) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5;
  float* ring = reinterpret_cast<float*>(smem4) + warp * warp_floats;
  t_out += (size_t)blockIdx.y * n;
  pid_out += (size_t)blockIdx.y * n;
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  const long long live = min(n, (long long)__ldg(n_live));
  int* wk = work == nullptr ? nullptr : work + blockIdx.x * kWarps + warp;
  if (i - lane_id() >= live) {      // no live ray in this warp
    if (i < n) {
      t_out[i] = kInf;
      pid_out[i] = -1;
    }
    if (wk != nullptr && lane_id() == 0) *wk = 0;
    return;
  }
  const bool active = i < live;
  const Ray r = load_ray(org, dir, active ? i : 0);
  float t_best = kInf;
  int pid = -1;
  Cursor c = sphere_cursor(static_cast<Cursor*>(nullptr), T, tb, r, active);
  const int streamed =
      stream_tiles<K_SPH>(ring, T.sph, T.s_stride, 0, c, r, t_best, pid);
  if (blockIdx.y == 0) box_scan(ring, T, r, t_best, pid);
  AllCursor all = split_range(tiles_of(T.n_tri));
  stream_tiles<K_TRI>(ring, T.tri, T.t_stride, T.n_sph + T.n_box, all, r,
                      t_best, pid);
  if (wk != nullptr && lane_id() == 0) *wk = streamed;
  if (i < n) {
    t_out[i] = active ? t_best : kInf;
    pid_out[i] = active && t_best < kInf ? pid : -1;
  }
}

__global__ void __launch_bounds__(kBlock)
nh_dense_kernel(Tables T, const float* __restrict__ org,
                const float* __restrict__ dir, long long n,
                const int* __restrict__ n_live, int warp_floats,
                float* __restrict__ t_out, int* __restrict__ pid_out) {
  search_all<AllCursor>(T, org, dir, n, n_live, nullptr, warp_floats, t_out,
                        pid_out, nullptr);
}

// B4's merge of its splits' (t, pid) [splits, n]: the least t, a tie to
// the lowest pid. Each split folded its prims in pid order with a strict <,
// so its result is its first prim at its least t; the lexicographic
// minimum over the splits is the first prim at the least t over all of
// them: the unsplit scan's t and pid, bit for bit.
__global__ void nh_merge_kernel(const float* __restrict__ t_part,
                                const int* __restrict__ pid_part, int splits,
                                long long n, float* __restrict__ t_out,
                                int* __restrict__ pid_out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t = kInf;
  int pid = -1;
  for (int s = 0; s < splits; ++s) {
    const float ts = t_part[(size_t)s * n + i];
    const int ps = pid_part[(size_t)s * n + i];
    if (ps >= 0 && (pid < 0 || ts < t || (ts == t && ps < pid))) {
      t = ts;
      pid = ps;
    }
  }
  t_out[i] = t;
  pid_out[i] = pid;
}

__global__ void __launch_bounds__(kBlock)
nh_culled_kernel(Tables T, const float* __restrict__ org,
                 const float* __restrict__ dir, long long n,
                 const int* __restrict__ n_live,
                 const float* __restrict__ tb, int warp_floats,
                 float* __restrict__ t_out, int* __restrict__ pid_out,
                 int* __restrict__ work) {
  search_all<ConeCursor>(T, org, dir, n, n_live, tb, warp_floats, t_out,
                         pid_out, work);
}

// ---- B3: the scalar search ---------------------------------------------------
// nh_scalar_kernel (B3): one thread a ray, for scenes of at most 384 prims
// (the note at the top of this file). Each warp of 32 rays
//  - bounds its live rays by B8's ball-cone (warp_cone) and evaluates the
//    cone predicate for 32 spheres at once, lane l on sphere w0 + l's own
//    ball (`bounds`: cx cy cz r, one row a sphere), one __ballot_sync a
//    window; it tests only the kept spheres, in pid order. A sphere left
//    out misses every lane (the predicate is conservative, as B8's for its
//    tiles), so it would fold +inf: t and pid are the dense loop's, bit for
//    bit. cos_t < 0.25 (an incoherent warp, such as many a bounce-1 mirror
//    warp) keeps every sphere;
//  - skips the sqrt and the tail of a kept sphere's test when no lane has
//    disc >= 0 (__any_sync): a negative or NaN discriminant gives +inf
//    either way;
//  - reads the sphere table from shared memory, staged once per block as
//    an array of structs (one 16-byte broadcast a sphere, 6 KB at 384
//    spheres); boxes (the headline's ground) and triangles stay dense,
//    read with __ldg broadcasts.
// Lanes at or past n join the warp's votes but take no part in its cone and
// write nothing; a warp with no ray exits after the staging. `work` (may be
// null) receives the spheres each warp tested, [ceil(n / 32)]. On the
// headline's bounce 0 a warp tests 0.34 spheres on average and the kernel
// takes 0.0528 ms against a bound of 0.0200 set by its bytes (H100 80GB
// HBM3, 700 W; chip_smoke.py): the per-warp cone set-up, the box test and
// the ray loads are what is left. Blocks of 128 (kScalarBlock) measured
// best of 64, 128, 256 and 512 (PERF.md).
__global__ void __launch_bounds__(kScalarBlock)
nh_scalar_kernel(Tables T, const float* __restrict__ bounds,
                 const float* __restrict__ org, const float* __restrict__ dir,
                 long long n, float* __restrict__ t_out,
                 int* __restrict__ pid_out, int* __restrict__ work) {
  extern __shared__ float4 sph_aos[];    // [n_sph] cx cy cz ccmr
  for (int k = threadIdx.x; k < T.n_sph; k += blockDim.x)
    sph_aos[k] = make_float4(ld(T.sph, 0, T.s_stride, k),
                             ld(T.sph, 1, T.s_stride, k),
                             ld(T.sph, 2, T.s_stride, k),
                             ld(T.sph, 3, T.s_stride, k));
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i - lane_id() >= n) return;        // no ray in this warp
  const bool active = i < n;
  const Ray r = load_ray(org, dir, active ? i : 0);
  float t_best = kInf;
  int pid = -1, tested = 0;
  if (T.n_sph > 0) {
    const ConeCursor cone = warp_cone(bounds, T.n_sph, r, active);
    for (int w0 = 0; w0 < T.n_sph; w0 += 32) {
      unsigned kept = cone.window(w0);
      tested += __popc(kept);
      while (kept) {                     // warp-uniform
        const int p = w0 + __ffs(kept) - 1;
        kept &= kept - 1;
        float b_half;
        const float disc = scalar_disc(r, sph_aos[p], b_half);
        if (__any_sync(kFull, disc >= 0.0f))
          fold(scalar_root(r, b_half, disc), p, t_best, pid);
      }
    }
  }
  for (int p = 0; p < T.n_box; ++p) {
    const int s = T.b_stride;
    fold(box_t(r, ld(T.box, 0, s, p), ld(T.box, 1, s, p), ld(T.box, 2, s, p),
               ld(T.box, 3, s, p), ld(T.box, 4, s, p), ld(T.box, 5, s, p)),
         T.n_sph + p, t_best, pid);
  }
  for (int p = 0; p < T.n_tri; ++p) {
    const int s = T.t_stride;
    const float v0x = ld(T.tri, 0, s, p), v0y = ld(T.tri, 1, s, p),
                v0z = ld(T.tri, 2, s, p);
    fold(tri_t(r, v0x, v0y, v0z, ld(T.tri, 3, s, p) - v0x,
               ld(T.tri, 4, s, p) - v0y, ld(T.tri, 5, s, p) - v0z,
               ld(T.tri, 6, s, p) - v0x, ld(T.tri, 7, s, p) - v0y,
               ld(T.tri, 8, s, p) - v0z),
         T.n_sph + T.n_box + p, t_best, pid);
  }
  if (work != nullptr && lane_id() == 0) work[i >> 5] = tested;
  if (active) {
    t_out[i] = t_best;
    pid_out[i] = t_best < kInf ? pid : -1;
  }
}

// Floats of one warp's staging area: a ring of two tiles of the widest
// class streamed (the box staging, 6 x 128 floats, fits in two sphere
// tiles).
int warp_floats_for(int n_tri) {
  return 2 * (n_tri > 0 ? TileKind<K_TRI>::kFloats
                        : TileKind<K_SPH>::kFloats);
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

// B3. Tables as B3's (structure of arrays); `bounds` [max(n_sph, 1), 4]
// holds each sphere's center and radius. `work` may be null; else it
// receives the spheres each warp tested, [ceil(n / 32)].
extern "C" int rt_nearest_hit_scalar(const float* sph, int n_sph,
                                     int s_stride, const float* box,
                                     int n_box, int b_stride,
                                     const float* tri, int n_tri,
                                     int t_stride, const float* bounds,
                                     const float* org, const float* dir,
                                     long long n, float* t_out,
                                     int* pid_out, int* work, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  const Tables T = make_tables(sph, n_sph, s_stride, box, n_box, b_stride,
                               tri, n_tri, t_stride);
  const long long grid = (n + kScalarBlock - 1) / kScalarBlock;
  nh_scalar_kernel<<<(unsigned int)grid, kScalarBlock,
                     sizeof(float4) * n_sph, (cudaStream_t)stream>>>(
      T, bounds, org, dir, n, t_out, pid_out, work);
  return (int)cudaGetLastError();
}

// B4. Tables as for B6 and B8 (padded to whole tiles, 16-byte aligned).
// splits > 1 divides each class's tiles among that many blocks per 128
// rays (t_part / pid_part [splits, n] receive their results, which
// nh_merge_kernel folds into t_out / pid_out); else t_part and pid_part
// are unused.
extern "C" int rt_nearest_hit_dense(const float* sph, int n_sph, int s_stride,
                                    const float* box, int n_box, int b_stride,
                                    const float* tri, int n_tri, int t_stride,
                                    const float* org, const float* dir,
                                    long long n, const int* n_live,
                                    int splits, float* t_part, int* pid_part,
                                    float* t_out, int* pid_out, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  if (splits < 1 || splits > 65535) return (int)cudaErrorInvalidValue;
  const Tables T = make_tables(sph, n_sph, s_stride, box, n_box, b_stride,
                               tri, n_tri, t_stride);
  const int wf = warp_floats_for(n_tri);
  const dim3 grid((unsigned)((n + kBlock - 1) / kBlock), (unsigned)splits);
  float* td = splits > 1 ? t_part : t_out;
  int* pd = splits > 1 ? pid_part : pid_out;
  cudaStream_t st = (cudaStream_t)stream;
  nh_dense_kernel<<<grid, kBlock, (size_t)kWarps * wf * sizeof(float), st>>>(
      T, org, dir, n, n_live, wf, td, pd);
  if (splits > 1) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    nh_merge_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        t_part, pid_part, splits, n, t_out, pid_out);
  }
  return (int)cudaGetLastError();
}

// B6. `sph` is the array-of-structs sphere table [s_stride, 4] and `tri`
// the triangle table [9, t_stride], both padded to whole (super)tiles (16-byte
// aligned), the sphere padding poisoned (ccmr = +inf); a null ids pointer
// scans that class dense. The lists have at least ceil(n / 128) rows and a
// multiple of 16 columns. `work` may be null; else it receives the list
// slots each warp streamed, [rows, 4, 2] (spheres, triangles).
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
  const int wf = warp_floats_for(n_tri);
  const size_t smem = (size_t)kWarps * wf * sizeof(float);
  const long long grid = (n + kBlock - 1) / kBlock;
  nh_listed_kernel<<<(unsigned int)grid, kBlock, smem,
                     (cudaStream_t)stream>>>(T, org, dir, n, n_live, bbox, ls,
                                             lt, wf, t_out, pid_out, work);
  return (int)cudaGetLastError();
}

// B8. Tables as for B6 (padded to whole tiles); tb holds one row (cx, cy,
// cz, r) per 128-sphere tile, in the table's order. `work` may be null;
// else it receives the sphere tiles each warp streamed, [ceil(n / 128), 4].
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
  const int wf = warp_floats_for(n_tri);
  const size_t smem = (size_t)kWarps * wf * sizeof(float);
  const long long grid = (n + kBlock - 1) / kBlock;
  nh_culled_kernel<<<(unsigned int)grid, kBlock, smem,
                     (cudaStream_t)stream>>>(T, org, dir, n, n_live, tb, wf,
                                             t_out, pid_out, work);
  return (int)cudaGetLastError();
}
