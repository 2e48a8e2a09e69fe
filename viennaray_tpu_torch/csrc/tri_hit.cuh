// Ray/triangle hit test, shared by every kernel that intersects triangles,
// and the triangle kind of the search (prim_search.cuh).
//
// One triangle is 12 floats: vertex v0 (ax ay az), edges e1 = v1 - v0 and
// e2 = v2 - v0, and the STORED unit normal (which may oppose cross(e1, e2)),
// the row layout that ops/nearest_hit.py:pack_triangle_prims writes. The
// test is the double-sided Moller-Trumbore test of the TPU kernel
// (viennaray_tpu/ops/pallas_intersect.py:_tri_kernel): |det| >= 1e-9,
// u >= 0, v >= 0, u + v <= 1, t > t_near. The normal takes no part in it.
//
// Numbers: every product, sum, difference and quotient goes through the
// round-to-nearest intrinsics, which nvcc never contracts into fused
// multiply-adds, three products are summed as (a + b) + c, and the three
// quotients are IEEE divisions (the TPU kernel multiplies by an approximate
// reciprocal with one Newton step). So the test computes bit for bit what
// ops/nearest_hit.py:triangle_nearest_hit_ref computes with one eager
// PyTorch op per operation, and (t, prim, hit) compare for equality. That
// matters more than for disks: neighbouring triangles share edges, and a ray
// through an edge has u = 0 or u + v = 1 on both with the same t.
//
// 45 float32 arithmetic operations a pair: two cross products (9 each), three
// dot products (5 each), the offset s (3), three quotients, and u + v.
#pragma once

// (ax*bx + ay*by) + az*bz
__device__ __forceinline__ float tri_dot(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

// a*b - c*d
__device__ __forceinline__ float tri_det2(float a, float b, float c, float d) {
  return __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}

// The division-free reject of the closest-hit search (prim_search.cuh with
// kReject; the bounce kernel does not use it): Moller-Trumbore with the three
// quotients left undivided. It computes det, U = s.h, V = d.q and T = e2.q
// (u = U / det, v = V / det, t = T / det in TriKind::hit) with FMAs, and
// drops a pair only when TriKind::hit's result cannot be selected:
//
//   |det| < 1e-9 - m_det, or det = 0 and e2 = 0  (|det| < 1e-9 there too)
//   and, where |det| > m_det (so both tests' det have one sign, g):
//   g U < -m_b,  g V < -m_b                    (u < 0 or v < 0)
//   g (U + V) - |det| > 2 m_U + m_det + 2^-18 |det|       (u + v > 1)
//   g T + m_T <= t_near (|det| - m_det) (1 - 2^-18)       (t <= t_near)
//   g T - m_T >= tmin (|det| + m_det) (1 + 2^-18)         (t >= tmin)
//
// The margins bound how far each of the two tests' det, U, V and T can lie
// from the exact value (u = 2^-24). In the infinity norm, with L the chunk
// box's largest extent (>= every edge's |e_i|), S = |o|_inf + B (B the box's
// largest |coordinate|, so |s_i| <= S) and D = |d|_inf: a three-term dot
// product of two cross-product components, in any order, FMA or not, is off
// by at most 6 u (3 + 3) sums of |x| |y| |z| terms, six of them: det by
// 36 u L^2 D, U and V by 36 u S L D plus 6 u S L D from the rounding of s,
// T by 42 u S L^2. The two tests' values are thus within 72 u L^2 D and
// 84 u S L D and 84 u S L^2 of each other; the margins are 2^-16 = 256 u
// times those products: m_det = 2^-16 L^2 D, m_U = 2^-16 S L D,
// m_T = 2^-16 S L^2. The 2^-18 = 64 u relative terms cover the rounding of
// TriKind::hit's quotients and of u + v (4 u) and of the comparisons here
// (4 u of the larger side); m_b = m_U + 2^-100 |det| keeps a dropped u or
// v at least 2^-101 below 0, so its quotient cannot round to -0 (which
// would pass u >= 0). A NaN makes every comparison false, and an
// overflow to inf in tmin's product keeps the pair: it is kept. A triangle
// whose e2 is zero (the padding's) has h = d x e2 = 0 in both tests, so
// TriKind::hit's det is exactly 0 and it is dropped.
//
// 39 float32 operations a pair (h 6, det 3, s 3, U 3, q 6, V 3, T 3, the
// sign 4, the bounds 9; the zero-edge test only where |det| <= m_det),
// no division.
struct TriReject {
  float ox, oy, oz, dx, dy, dz;
  float t_near;
  float so, dm;  // |o|_inf, |d|_inf
  float m_det, m_u, m_t, lim;  // of the current chunk; lim = 1e-9 - m_det

  __device__ __forceinline__ TriReject(float ox_, float oy_, float oz_,
                                       float dx_, float dy_, float dz_,
                                       float t_near_)
      : ox(ox_), oy(oy_), oz(oz_), dx(dx_), dy(dy_), dz(dz_),
        t_near(t_near_) {
    so = fmaxf(fmaxf(fabsf(ox), fabsf(oy)), fabsf(oz));
    dm = fmaxf(fmaxf(fabsf(dx), fabsf(dy)), fabsf(dz));
    m_det = m_u = m_t = lim = 0.0f;
  }

  // bb: the chunk's box [lo_x lo_y lo_z hi_x hi_y hi_z . .]
  __device__ __forceinline__ void chunk(const float* __restrict__ bb) {
    const float b = fmaxf(
        fmaxf(fmaxf(fabsf(bb[0]), fabsf(bb[1])), fmaxf(fabsf(bb[2]),
                                                       fabsf(bb[3]))),
        fmaxf(fabsf(bb[4]), fabsf(bb[5])));
    const float l =
        fmaxf(fmaxf(bb[3] - bb[0], bb[4] - bb[1]), bb[5] - bb[2]);
    const float sl = 0x1p-16f * (so + b) * l;
    m_det = 0x1p-16f * l * l * dm;
    m_u = sl * dm;
    m_t = sl * l;
    lim = 1e-9f - m_det;
  }

  // What drop reads of lane g into a staged triangle's places: v0, e1 and
  // e2, without the normal (a survivor is staged whole for TriKind::hit).
  static __device__ __forceinline__ void stage(float4* s,
                                               const float* __restrict__ prims,
                                               int npad, int g) {
    s[0] = make_float4(prims[g], prims[npad + g], prims[2 * npad + g],
                       prims[3 * npad + g]);
    s[1] = make_float4(prims[4 * npad + g], prims[5 * npad + g],
                       prims[6 * npad + g], prims[7 * npad + g]);
    s[2] = make_float4(prims[8 * npad + g], 0.0f, 0.0f, 0.0f);
  }

  // s: a staged triangle [ax ay az e1x] [e1y e1z e2x e2y] [e2z nx ny nz]
  __device__ __forceinline__ bool drop(const float4* s, float tmin) const {
    const float4 a = s[0];
    const float4 c = s[1];
    const float e2z = s[2].x;
    const float e1x = a.w, e1y = c.x, e1z = c.y, e2x = c.z, e2y = c.w;
    // h = d x e2
    const float hx = fmaf(dy, e2z, -(dz * e2y));
    const float hy = fmaf(dz, e2x, -(dx * e2z));
    const float hz = fmaf(dx, e2y, -(dy * e2x));
    const float det = fmaf(hx, e1x, fmaf(hy, e1y, hz * e1z));
    const float sx = ox - a.x, sy = oy - a.y, sz = oz - a.z;
    const float uu = fmaf(sx, hx, fmaf(sy, hy, sz * hz));
    // q = s x e1
    const float qx = fmaf(sy, e1z, -(sz * e1y));
    const float qy = fmaf(sz, e1x, -(sx * e1z));
    const float qz = fmaf(sx, e1y, -(sy * e1x));
    const float vv = fmaf(qx, dx, fmaf(qy, dy, qz * dz));
    const float tt = fmaf(qx, e2x, fmaf(qy, e2y, qz * e2z));
    const float ad = fabsf(det);
    if (ad < lim) return true;
    // zero edges (padding): TriKind::hit's det is exactly 0 too
    if (!(ad > m_det)) {
      return ad == 0.0f && e2x == 0.0f && e2y == 0.0f && e2z == 0.0f;
    }
    const float g = det < 0.0f ? -1.0f : 1.0f;
    const float gu = g * uu, gv = g * vv, gt = g * tt;
    const float mb = fmaf(0x1p-100f, ad, m_u);
    return gu < -mb || gv < -mb ||
           (gu + gv) - ad > fmaf(0x1p-18f, ad, fmaf(2.0f, m_u, m_det)) ||
           gt + m_t <= t_near * (ad - m_det) * (1.0f - 0x1p-18f) ||
           gt - m_t >= tmin * (ad + m_det) * (1.0f + 0x1p-18f);
  }
};

// The triangle kind of prim_search.cuh: a staged triangle is three float4
// [ax ay az e1x] [e1y e1z e2x e2y] [e2z nx ny nz]; the stored normal sits in
// SoA rows 9-11; a hit from behind always kills (the bounce kernel's rule).
// Padding triangles have zero edges, so det is 0 and they are never valid.
struct TriKind {
  static constexpr int kVec = 3;
  static constexpr int kNormalRow = 9;
  static constexpr bool kBackfacePasses = false;
  static constexpr bool kNeighborDeposit = false;
  static constexpr bool kWindowDeposit = false;
  using Reject = TriReject;

  static __device__ __forceinline__ void stage(float4* s,
                                               const float* __restrict__ prims,
                                               int npad, int g) {
    s[0] = make_float4(prims[g], prims[npad + g], prims[2 * npad + g],
                       prims[3 * npad + g]);
    s[1] = make_float4(prims[4 * npad + g], prims[5 * npad + g],
                       prims[6 * npad + g], prims[7 * npad + g]);
    s[2] = make_float4(prims[8 * npad + g], prims[9 * npad + g],
                       prims[10 * npad + g], prims[11 * npad + g]);
  }

  // The stored normal of sorted lane `lane`.
  static __device__ __forceinline__ void normal(
      const float* __restrict__ prims, int npad, int lane, float& nx,
      float& ny, float& nz) {
    nx = prims[(kNormalRow + 0) * npad + lane];
    ny = prims[(kNormalRow + 1) * npad + lane];
    nz = prims[(kNormalRow + 2) * npad + lane];
  }

  // Returns whether the ray (o, d) hits the triangle beyond t_near; t_out
  // gets the plane-crossing time either way.
  static __device__ __forceinline__ bool hit(const float4* s, float ox,
                                             float oy, float oz, float dx,
                                             float dy, float dz, float t_near,
                                             float& t_out) {
    const float4 a = s[0];
    const float4 b = s[1];
    const float e2z = s[2].x;
    const float ax = a.x, ay = a.y, az = a.z;
    const float e1x = a.w, e1y = b.x, e1z = b.y;
    const float e2x = b.z, e2y = b.w;
    // h = d x e2
    const float hx = tri_det2(dy, e2z, dz, e2y);
    const float hy = tri_det2(dz, e2x, dx, e2z);
    const float hz = tri_det2(dx, e2y, dy, e2x);
    const float det = tri_dot(hx, hy, hz, e1x, e1y, e1z);
    const bool ok = fabsf(det) >= 1e-9f;
    const float dsafe = ok ? det : 1e-30f;
    const float sx = __fsub_rn(ox, ax);
    const float sy = __fsub_rn(oy, ay);
    const float sz = __fsub_rn(oz, az);
    const float u = __fdiv_rn(tri_dot(sx, sy, sz, hx, hy, hz), dsafe);
    // q = s x e1
    const float qx = tri_det2(sy, e1z, sz, e1y);
    const float qy = tri_det2(sz, e1x, sx, e1z);
    const float qz = tri_det2(sx, e1y, sy, e1x);
    const float v = __fdiv_rn(tri_dot(qx, qy, qz, dx, dy, dz), dsafe);
    const float t = __fdiv_rn(tri_dot(qx, qy, qz, e2x, e2y, e2z), dsafe);
    t_out = t;
    return ok && u >= 0.0f && v >= 0.0f && __fadd_rn(u, v) <= 1.0f &&
           t > t_near;
  }
};
