// Ray/disk hit test, shared by every kernel that intersects disks.
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
