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
