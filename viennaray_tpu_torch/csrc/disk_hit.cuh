// Ray/disk hit test, shared by every kernel that intersects disks, and the
// disk kind of the search (prim_search.cuh).
//
// One oriented disk is 8 floats: centre (cx cy cz), unit normal (nx ny nz),
// squared radius r2 and the plane offset ndc = n.c, the row layout that
// ops/nearest_hit.py:pack_disk_prims writes.
//
// Numbers: every product, sum and quotient goes through the round-to-nearest
// intrinsics (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn; in float64 their
// __d* twins, scalar.cuh). nvcc never contracts those into fused
// multiply-adds, whatever -fmad says, so the test computes bit for bit what
// ops/nearest_hit.py:disk_nearest_hit_ref computes with one eager PyTorch op
// per operation, in the same order, in either type. The quotient is an IEEE
// division. That makes (t, prim, hit) comparable for equality with the plain
// version, not within a tolerance.
#pragma once

#include "prim_search.cuh"
#include "scalar.cuh"

template <class T>
struct DiskPrimT {
  T cx, cy, cz, nx, ny, nz, r2, ndc;
};
using DiskPrim = DiskPrimT<float>;

// Returns whether the ray (o, d) hits the disk beyond t_near; t_out gets the
// plane-crossing time either way. Padding disks have a zero normal, so denom
// is 0 and they are never valid. T: float, or double in the float64 form.
template <class T>
__device__ __forceinline__ bool disk_hit(T ox, T oy, T oz, T dx, T dy, T dz,
                                         const DiskPrimT<T>& p, T t_near,
                                         T& t_out) {
  const T denom = add_rn(add_rn(mul_rn(dx, p.nx), mul_rn(dy, p.ny)),
                         mul_rn(dz, p.nz));
  const T ndo = add_rn(add_rn(mul_rn(ox, p.nx), mul_rn(oy, p.ny)),
                       mul_rn(oz, p.nz));
  const T dsafe = denom == T(0) ? Const<T>::tiny() : denom;
  const T t = div_rn(sub_rn(p.ndc, ndo), dsafe);
  const T hx = sub_rn(add_rn(ox, mul_rn(t, dx)), p.cx);
  const T hy = sub_rn(add_rn(oy, mul_rn(t, dy)), p.cy);
  const T hz = sub_rn(add_rn(oz, mul_rn(t, dz)), p.cz);
  const T dist2 = add_rn(add_rn(mul_rn(hx, hx), mul_rn(hy, hy)),
                         mul_rn(hz, hz));
  t_out = t;
  return denom != T(0) && t > t_near && dist2 < p.r2;
}

// The division-free reject of the closest-hit search (prim_search.cuh with
// kReject; the bounce kernel does not use it): a cheap test, run before
// disk_hit on every (ray, disk) pair, that drops a pair only when disk_hit's
// result cannot be selected, because it misses or because its t is not below
// the running best tmin. With w = c - o and the disk's circle of radius r:
//
//   miss:   the ray's line passes farther than R from c,  |w x d|^2 > thr
//   behind: the whole ball of radius R about c lies before t_near along d,
//           e = t_near |d|^2 - w.d > 0 and e^2 > thr
//   beyond: the ball lies at or after tmin, f = w.d - tmin |d|^2 > 0 and
//           f^2 > thr
//
// with thr = r^2 |d|^2 (1 + 2^-9) + |d|^2 eps^2 2^12, which bounds
// (r + eps)^2 |d|^2 from above (2 r eps <= 2^-10 r^2 + 2^10 eps^2), and
// eps = 2^-16 S, S = |o|_inf + B, B the largest |coordinate| of the chunk's
// box (the box holds c +- r, so |c_i| + r <= B).
//
// Why the margin covers the rounding of both tests (u = 2^-24):
// - disk_hit computes h = (o + t d) - c for ITS t, rounded or not: the exact
//   point p = o + t d lies on the ray's line whatever t is. Each component of
//   h is off from p - c by at most u (3 |t d_i| + 2 |o_i| + |c_i|), and a
//   selected pair has |p - c| < r + that, so |t d| <= r + |o| + |c|: h is
//   off by at most 27 u S in length. dist2 < r^2 is three roundings of a sum
//   of squares, so a selected pair has |p - c| < r (1 + 2u) + 27 u S.
// - A selected pair then has a point of its line within that distance of c,
//   so the line's distance from c is below it; and since p - c is that short
//   and t > t_near, t < tmin, the projection t |d|^2 - w.d lies within
//   (r (1 + 2u) + 27 u S) |d| of 0: e and f are below that bound.
// - This test computes w, w x d, |w x d|^2, w.d, e and f with FMAs: each
//   is off from its exact value by at most 13 u S |d| (w x d), 7 u S |d|
//   (w.d) and a further 3 u S |d| in e and f (where f > 0, tmin |d|^2 < w.d
//   <= |w| |d|), and thr by 4 u relative.
// - So a dropped pair has line distance, or e, or f, above
//   (r (1 + 2u) + 50 u S) |d| < (r + eps) |d| (eps = 256 u S), and disk_hit
//   would not select it. A NaN anywhere makes every comparison false: the
//   pair is kept. Padding disks (centre 1e18, r^2 = 0) are dropped by the
//   miss test or kept and then refused by disk_hit; either way never hit.
//
// 27 float32 operations a pair (w 3, w x d 6, |w x d|^2 3, w.d 3, thr 1,
// e 1, f 1, e^2 f^2 2, comparisons 7), no division.
struct DiskReject {
  float ox, oy, oz, dx, dy, dz;
  float dd;   // |d|^2
  float tnd;  // t_near |d|^2
  float so;   // |o|_inf
  float kr, ke;  // of the current chunk: thr = r^2 kr + ke

  __device__ __forceinline__ DiskReject(float ox_, float oy_, float oz_,
                                        float dx_, float dy_, float dz_,
                                        float t_near)
      : ox(ox_), oy(oy_), oz(oz_), dx(dx_), dy(dy_), dz(dz_) {
    dd = fmaf(dx, dx, fmaf(dy, dy, dz * dz));
    tnd = t_near * dd;
    so = fmaxf(fmaxf(fabsf(ox), fabsf(oy)), fabsf(oz));
    kr = ke = 0.0f;
  }

  // bb: the chunk's box [lo_x lo_y lo_z hi_x hi_y hi_z . .]
  __device__ __forceinline__ void chunk(const float* __restrict__ bb) {
    const float b = fmaxf(
        fmaxf(fmaxf(fabsf(bb[0]), fabsf(bb[1])), fmaxf(fabsf(bb[2]),
                                                       fabsf(bb[3]))),
        fmaxf(fabsf(bb[4]), fabsf(bb[5])));
    const float eps = 0x1p-16f * (so + b);
    kr = dd * (1.0f + 0x1p-9f);
    ke = dd * (eps * eps * 4096.0f);
  }

  // What drop reads of lane g into a staged disk's places: c and r2 (half
  // of the disk's 32 bytes; a survivor is staged whole for disk_hit).
  static __device__ __forceinline__ void stage(float4* s,
                                               const float* __restrict__ prims,
                                               int npad, int g) {
    s[0] = make_float4(prims[g], prims[npad + g], prims[2 * npad + g], 0.0f);
    s[1] = make_float4(0.0f, 0.0f, prims[6 * npad + g], 0.0f);
  }

  // s: a staged disk [cx cy cz nx] [ny nz r2 ndc]
  __device__ __forceinline__ bool drop(const float4* s, float tmin) const {
    const float wx = s[0].x - ox, wy = s[0].y - oy, wz = s[0].z - oz;
    const float kx = fmaf(wy, dz, -(wz * dy));
    const float ky = fmaf(wz, dx, -(wx * dz));
    const float kz = fmaf(wx, dy, -(wy * dx));
    const float cross2 = fmaf(kx, kx, fmaf(ky, ky, kz * kz));
    const float b = fmaf(wx, dx, fmaf(wy, dy, wz * dz));
    const float thr = fmaf(s[1].z, kr, ke);
    const float e = tnd - b;
    const float f = fmaf(-tmin, dd, b);
    return cross2 > thr || (e > 0.0f && e * e > thr) ||
           (f > 0.0f && f * f > thr);
  }
};

// The disk kind of prim_search.cuh: a staged disk is two float4
// [cx cy cz nx] [ny nz r2 ndc]; the unit normal sits in SoA rows 3-5; a
// disk's first hit from behind passes through (the bounce kernel's rule).
struct DiskKind {
  using Scalar = float;
  using Staged = float4;
  static constexpr int kVec = 2;
  static constexpr int kNormalRow = 3;
  static constexpr bool kBackfacePasses = true;
  static constexpr bool kNeighborDeposit = true;
  static constexpr bool kWindowDeposit = false;
  using Reject = DiskReject;

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

// The float64 form's disk kind (the float64 closest-hit kernel,
// nearest_hit.cu): a staged disk is two Double4 [cx cy cz nx] [ny nz r2 ndc]
// of the float64 SoA and its test is disk_hit<double>. No reject: DiskReject's
// margins are float32 rounding bounds, so every pair of a visited chunk takes
// the exact test.
struct DiskKindF64 {
  using Scalar = double;
  using Staged = Double4;
  static constexpr int kVec = 2;
  using Reject = KeepAll<double>;

  static __device__ __forceinline__ void stage(Double4* s,
                                               const double* __restrict__ prims,
                                               int npad, int g) {
    s[0] = Double4{prims[g], prims[npad + g], prims[2 * npad + g],
                   prims[3 * npad + g]};
    s[1] = Double4{prims[4 * npad + g], prims[5 * npad + g],
                   prims[6 * npad + g], prims[7 * npad + g]};
  }

  static __device__ __forceinline__ bool hit(const Double4* s, double ox,
                                             double oy, double oz, double dx,
                                             double dy, double dz,
                                             double t_near, double& t_out) {
    const Double4 a = s[0];
    const Double4 b = s[1];
    const DiskPrimT<double> p{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    return disk_hit(ox, oy, oz, dx, dy, dz, p, t_near, t_out);
  }
};
