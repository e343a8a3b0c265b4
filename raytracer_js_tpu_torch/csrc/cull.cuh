// The per-warp ball-cone cull shared by B8 (nh_culled_kernel: 128-sphere
// tiles), B3 (nh_scalar_kernel) and B1/B2 (trace_frame_kernel,
// trace_rays_kernel: single spheres). Included inside each source's
// anonymous namespace after stream.cuh. Its plain form is
// kernels/nearest_hit.cone_include, which runs the same expressions in the
// same order, so a kernel's per-warp counts of kept balls equal the plain
// cull's bit for bit.
//
// The warp bounds its live rays by an apex ball (o0 = the mean origin, ro =
// the largest distance from it) and a cone (axis = the normalized mean
// direction, cos_t = the worst alignment d / sqrt(a) with it); the sums are
// one shuffle-down tree in a fixed order. A ball (c, rad) is kept when o0
// lies inside the ball grown by ro, or when the cone of directions from o0
// that meet the grown ball (half-angle asin((rad + ro) / |c - o0|)) meets
// the warp's cone: cos of the angle between the axis and c - o0 at least
// cos(alpha + theta_t), loosened by 1e-5 (and the inside test by a relative
// 1e-5 plus 1e-7) against the rounding of these terms and of the ray's own
// test. A ray from o (|o - o0| <= ro) that hits the sphere has a point
// within rad of c, so the ray from o0 along its direction passes within
// rad + ro of c: a ball left out misses every live lane, and the search
// that skips it folds the same t and pid. cos_t < 0.25 (an incoherent
// warp) keeps every ball. tests/test_torch_nearest_hit.py and
// tests/test_torch_fused_cull.py hold the plain form to never drop a ball
// that a live ray of its warp hits.
#pragma once

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Lane 0's shuffle-down tree (lane i adds lane i + o), broadcast to the
// warp: the order of the plain version's _group_sum.
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return __shfl_sync(kFull, v, 0);
}

struct Cone {
  float o0x, o0y, o0z, ro, axm, aym, azm, cos_t, sin_t;
  bool use_cone;

  // Whether the warp's rays can reach the ball (cx, cy, cz, rad).
  __device__ __forceinline__ bool reaches(float cx, float cy, float cz,
                                          float rad) const {
    const float vx = cx - o0x;
    const float vy = cy - o0y;
    const float vz = cz - o0z;
    const float dist = sqrtf(vx * vx + vy * vy + vz * vz);
    const float rr = rad + ro;
    const bool inside = dist <= rr * 1.00001f + 1e-7f;
    const float sin_a = fminf(rr / fmaxf(dist, 1e-20f), 1.0f);
    const float cos_a = sqrtf(fmaxf(1.0f - sin_a * sin_a, 0.0f));
    const float cos_b =
        (vx * axm + vy * aym + vz * azm) / fmaxf(dist, 1e-20f);
    return inside || cos_b >= cos_a * cos_t - sin_a * sin_t - 1e-5f ||
           !use_cone;
  }
};

// The ball-cone of the warp's live rays (the lanes with `active`; every
// lane of the warp calls it): origin (ox, oy, oz), direction (dx, dy, dz),
// a = d.d.
__device__ __forceinline__ Cone warp_cone(float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float a, bool active) {
  const float r_inv = 1.0f / fmaxf(warp_sum(active ? 1.0f : 0.0f), 1.0f);
  Cone c;
  c.o0x = warp_sum(active ? ox : 0.0f) * r_inv;
  c.o0y = warp_sum(active ? oy : 0.0f) * r_inv;
  c.o0z = warp_sum(active ? oz : 0.0f) * r_inv;
  const float ex = ox - c.o0x, ey = oy - c.o0y, ez = oz - c.o0z;
  c.ro = sqrtf(warp_max(active ? ex * ex + ey * ey + ez * ez : 0.0f));
  float axm = warp_sum(active ? dx : 0.0f) * r_inv;
  float aym = warp_sum(active ? dy : 0.0f) * r_inv;
  float azm = warp_sum(active ? dz : 0.0f) * r_inv;
  const float a_n =
      1.0f / sqrtf(fmaxf(axm * axm + aym * aym + azm * azm, 1e-20f));
  c.axm = axm * a_n;
  c.aym = aym * a_n;
  c.azm = azm * a_n;
  const float d_inv = 1.0f / sqrtf(a);
  c.cos_t = warp_min(
      active ? (dx * c.axm + dy * c.aym + dz * c.azm) * d_inv : 1.0f);
  c.use_cone = c.cos_t >= 0.25f;
  c.sin_t = sqrtf(fmaxf(1.0f - c.cos_t * c.cos_t, 0.0f));
  return c;
}
