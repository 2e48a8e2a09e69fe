// Ray/segment hit test in 2D, shared by every kernel that intersects line
// segments, and the line kind of the search (prim_search.cuh).
//
// One segment is 6 floats: start point (p0x p0y), direction to its end
// (lx ly) and the stored unit normal (nx ny), the row layout that
// ops/nearest_hit.py:pack_line_prims writes; z plays no part. The test is the
// cross-product test of the TPU kernel's line branch
// (viennaray_tpu/ops/pallas_bounce.py:_line_chunk, after
// GeneralPipelineLine.cu:19-49): denom = dx*ly - dy*lx,
// t = (wx*ly - wy*lx) / denom, s = (wx*dy - wy*dx) / denom with w = p0 - o,
// valid when denom != 0, t > t_near and 1e-5 < s < 1 - 1e-5. The clip of s
// means that a ray through the 2e-5 of a segment's length around a node
// misses both segments that share the node and flies on, as in the
// reference. The normal takes no part in the test.
//
// Numbers: every product, difference and quotient goes through the
// round-to-nearest intrinsics, which nvcc never contracts into fused
// multiply-adds, and the two quotients are IEEE divisions (the TPU kernel
// multiplies by an approximate reciprocal with one Newton step). So the test
// computes bit for bit what ops/nearest_hit.py:line_nearest_hit_ref computes
// with one eager PyTorch op per operation, and (t, prim, hit) compare for
// equality. The upper end of the clip is the float32 value
// float32(1) - float32(1e-5) = 0x3f7fff58 on both sides (the double
// 1 - 1e-5 rounds to the same bits).
//
// 13 float32 arithmetic operations a pair: the two offsets (2), three
// two-by-two determinants (3 each) and two quotients.
#pragma once

// a*b - c*d
__device__ __forceinline__ float line_det2(float a, float b, float c,
                                           float d) {
  return __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}

// The reject of the closest-hit search (prim_search.cuh with kReject) for
// segments: it keeps every pair, so the line search runs the exact test on
// every lane it visits, as before. 13 operations with two divisions leave a
// cheaper test little to save.
struct LineReject {
  __device__ __forceinline__ LineReject(float, float, float, float, float,
                                        float, float) {}
  __device__ __forceinline__ void chunk(const float* __restrict__) {}
  static __device__ __forceinline__ void stage(float4*, const float*, int,
                                               int) {}
  __device__ __forceinline__ bool drop(const float4*, float) const {
    return false;
  }
};

// The line kind of prim_search.cuh: a staged segment is one float4
// [p0x p0y lx ly] (the normal is not part of the test; the bounce kernel
// reads the winning lane's from the SoA); the stored normal sits in SoA rows
// 4-5 and its z is 0; a hit from behind always kills and the single closest
// hit takes the deposit (the bounce kernel's rules, as for triangles).
// Padding segments have a zero direction, so denom is 0 and they are never
// valid.
//
// The search's slab test in z: a 2D ray has dz = 0, which prim_search turns
// into the finite reciprocal 1e30, and pack_line_prims inflates every chunk
// box to z in [-1, 1]. With oz = 0 strictly inside, the two z bounds are
// -1e30 and +1e30 (or +inf for a padding chunk's 1e18), never 0 * inf, so
// the z slab is the whole line and no NaN arises.
struct LineKind {
  static constexpr int kVec = 1;
  static constexpr bool kBackfacePasses = false;
  static constexpr bool kNeighborDeposit = false;
  static constexpr bool kWindowDeposit = false;
  using Reject = LineReject;

  static __device__ __forceinline__ void stage(float4* s,
                                               const float* __restrict__ prims,
                                               int npad, int g) {
    s[0] = make_float4(prims[g], prims[npad + g], prims[2 * npad + g],
                       prims[3 * npad + g]);
  }

  // The stored normal of sorted lane `lane`.
  static __device__ __forceinline__ void normal(
      const float* __restrict__ prims, int npad, int lane, float& nx,
      float& ny, float& nz) {
    nx = prims[4 * npad + lane];
    ny = prims[5 * npad + lane];
    nz = 0.0f;
  }

  // Returns whether the ray (o, d) hits the segment beyond t_near; t_out
  // gets the crossing time of the segment's line either way.
  static __device__ __forceinline__ bool hit(const float4* s, float ox,
                                             float oy, float oz, float dx,
                                             float dy, float dz, float t_near,
                                             float& t_out) {
    const float4 a = s[0];
    const float lx = a.z, ly = a.w;
    const float denom = line_det2(dx, ly, dy, lx);
    const float dsafe = denom != 0.0f ? denom : 1e-30f;
    const float wx = __fsub_rn(a.x, ox);
    const float wy = __fsub_rn(a.y, oy);
    const float t = __fdiv_rn(line_det2(wx, ly, wy, lx), dsafe);
    const float sp = __fdiv_rn(line_det2(wx, dy, wy, dx), dsafe);
    t_out = t;
    // 1 - 1e-5 in float32: 0x3f7fff58
    return denom != 0.0f && t > t_near && sp > 1e-5f &&
           sp < __uint_as_float(0x3f7fff58u);
  }
};
