// Ray/disk hit test, shared by every kernel that intersects disks, and the
// disk kind of the search (prim_search.cuh).
//
// One oriented disk is 8 floats: centre (cx cy cz), unit normal (nx ny nz),
// squared radius r2 and the plane offset ndc = n.c, the row layout that
// ops/nearest_hit.py:pack_disk_prims writes.
//
// Numbers: every product, sum and quotient goes through the round-to-nearest
// intrinsics (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn). nvcc never
// contracts those into fused multiply-adds, whatever -fmad says, so the test
// computes bit for bit what ops/nearest_hit.py:disk_nearest_hit_ref computes
// with one eager PyTorch op per operation, in the same order. The quotient is
// an IEEE division. That makes (t, prim, hit) comparable for equality with
// the plain version, not within a tolerance.
#pragma once

struct DiskPrim {
  float cx, cy, cz, nx, ny, nz, r2, ndc;
};

// Returns whether the ray (o, d) hits the disk beyond t_near; t_out gets the
// plane-crossing time either way. Padding disks have a zero normal, so denom
// is 0 and they are never valid.
__device__ __forceinline__ bool disk_hit(float ox, float oy, float oz,
                                         float dx, float dy, float dz,
                                         const DiskPrim& p, float t_near,
                                         float& t_out) {
  const float denom = __fadd_rn(
      __fadd_rn(__fmul_rn(dx, p.nx), __fmul_rn(dy, p.ny)), __fmul_rn(dz, p.nz));
  const float ndo = __fadd_rn(
      __fadd_rn(__fmul_rn(ox, p.nx), __fmul_rn(oy, p.ny)), __fmul_rn(oz, p.nz));
  const float dsafe = denom == 0.0f ? 1e-30f : denom;
  const float t = __fdiv_rn(__fsub_rn(p.ndc, ndo), dsafe);
  const float hx = __fsub_rn(__fadd_rn(ox, __fmul_rn(t, dx)), p.cx);
  const float hy = __fsub_rn(__fadd_rn(oy, __fmul_rn(t, dy)), p.cy);
  const float hz = __fsub_rn(__fadd_rn(oz, __fmul_rn(t, dz)), p.cz);
  const float dist2 = __fadd_rn(
      __fadd_rn(__fmul_rn(hx, hx), __fmul_rn(hy, hy)), __fmul_rn(hz, hz));
  t_out = t;
  return denom != 0.0f && t > t_near && dist2 < p.r2;
}

// The disk kind of prim_search.cuh: a staged disk is two float4
// [cx cy cz nx] [ny nz r2 ndc]; the unit normal sits in SoA rows 3-5; a
// disk's first hit from behind passes through (the bounce kernel's rule).
struct DiskKind {
  static constexpr int kVec = 2;
  static constexpr int kNormalRow = 3;
  static constexpr bool kBackfacePasses = true;
  static constexpr bool kNeighborDeposit = true;
  static constexpr bool kWindowDeposit = false;

  static __device__ __forceinline__ void stage(float4* s,
                                               const float* __restrict__ prims,
                                               int npad, int g) {
    s[0] = make_float4(prims[g], prims[npad + g], prims[2 * npad + g],
                       prims[3 * npad + g]);
    s[1] = make_float4(prims[4 * npad + g], prims[5 * npad + g],
                       prims[6 * npad + g], prims[7 * npad + g]);
  }

  // The stored normal of sorted lane `lane`.
  static __device__ __forceinline__ void normal(
      const float* __restrict__ prims, int npad, int lane, float& nx,
      float& ny, float& nz) {
    nx = prims[(kNormalRow + 0) * npad + lane];
    ny = prims[(kNormalRow + 1) * npad + lane];
    nz = prims[(kNormalRow + 2) * npad + lane];
  }

  static __device__ __forceinline__ bool hit(const float4* s, float ox,
                                             float oy, float oz, float dx,
                                             float dy, float dz, float t_near,
                                             float& t_out) {
    const float4 a = s[0];
    const float4 b = s[1];
    const DiskPrim p{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    return disk_hit(ox, oy, oz, dx, dy, dz, p, t_near, t_out);
  }
};

// Disks under the window flux model (the GPU candidate-window contract): the
// same search, hit test and backface rule; a colliding ray deposits on every
// disk of the hit disk's window list (the hit disk itself included) that it
// crosses with t_near < t <= t_hit + tau, with no facing test. The list's
// records are SoA columns, so disk_hit re-tests them with the search's bits.
struct DiskWindowKind : DiskKind {
  static constexpr bool kNeighborDeposit = false;
  static constexpr bool kWindowDeposit = true;
};
