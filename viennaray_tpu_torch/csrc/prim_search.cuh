// Closest hit of one ray below a bound, on a packed geometry of one primitive
// kind; shared by every kernel that searches (nearest_hit.cu, bounce.cu).
//
// The primitive kind is a template parameter (DiskKind of disk_hit.cuh,
// TriKind of tri_hit.cuh, LineKind of line_hit.cuh): it says how many float4
// one staged primitive takes (kVec: 2 for a disk's 8 rows, 3 for a
// triangle's 12, 1 for the 4 rows of a line's test), how to stage one lane
// of the SoA into them, and the hit test on the staged values.
//
// prim_search: one thread per ray; the whole block calls it together (it
// holds block-wide barriers), lanes without a ray pass live = false. A block
// stages kSearchTile lanes of the SoA into shared memory at a time, and
// every thread walks them with broadcast loads, so a primitive costs the
// block one global read instead of one per ray. A chunk wider than a tile
// (1,024 or 2,048 lanes) is staged tile by tile. A warp skips a chunk when
// none of its rays can enter the chunk's bounding box nearer than its
// current best (slab test on a box widened by a margin far above rounding),
// and a block skips staging a chunk no warp needs. A skipped chunk holds no
// nearer hit, so the result does not depend on the skip.
//
// prim_search_group: G threads search for one ray (G a power of two, 2 to
// 32, the G lanes of a warp from a multiple of G on). Every thread of the
// group holds the same ray and the same bound, so the chunk skip is one
// decision for the one ray and needs no vote. Thread l of the group tests
// the lanes c_lo + l, c_lo + l + G, ... of each chunk it must visit, read
// straight from the SoA (consecutive threads read consecutive lanes of a
// row; the tables stay in L1 and L2), so no shared memory and no barrier.
// After each visited chunk the group takes the lexicographic minimum of
// (t, sorted lane) over its threads with __shfl_xor_sync, and every thread
// goes on with it as the bound.
//
// kReject (prim_search_group only; the closest-hit kernel sets it, the
// bounce kernel leaves it off): before the exact test of each pair, the
// kind's division-free reject (Kind::Reject: DiskReject of disk_hit.cuh,
// TriReject of tri_hit.cuh, LineReject of line_hit.cuh, which keeps every
// pair) drops pairs that the exact test would not select below the thread's
// own running best in the chunk. A dropped pair would not have moved
// (t, lane), so the result does not depend on the reject, and the walk's
// strict < still picks it. A thread reads only the reject's rows of a lane
// (Kind::Reject::stage) and the whole lane only when it survives: the SoA
// reads through L1 are what the group search spends most on.
//
// The scalar type: prim_search is float32 only (the bounce kernel's G = 1).
// prim_search_group runs in the kind's Scalar, float32, or float64 for the
// float64 kinds of the closest-hit kernel's float64 form (DiskKindF64,
// TriKindF64, LineKindF64), whose rays, SoA and chunk boxes are doubles; a
// kind's Staged is its float4, or Double4 of scalar.cuh.
//
// Selection is the lowest t, then the lowest sorted lane, in both: lanes are
// walked in ascending order with a strict <, whatever chunks are skipped,
// and the group's minimum over (t, lane) picks what that walk picks, ties
// included. Both start every chunk from the same bound (the best t so far),
// so they visit the same chunks and return the same (t, lane).
#pragma once

#include "scalar.cuh"

constexpr int kSearchBlock = 256;  // threads of a block that calls prim_search
constexpr int kSearchTile = 512;   // lanes staged at a time

template <class T>
__device__ __forceinline__ T safe_inv(T d) {
  return T(1) / (d == T(0) ? Const<T>::tiny() : d);
}

// Whether a ray can enter chunk c's bounding box nearer than tmin (slab
// test). The box is widened by a margin (1e-4 relative and absolute) orders
// above the rounding of the slab arithmetic in either type, so a chunk that
// holds a hit below tmin always passes.
template <class T>
__device__ __forceinline__ bool chunk_needed(
    const T* __restrict__ chunk_bbs, int c, T ox, T oy, T oz, T ix, T iy,
    T iz, T tmin) {
  const T* bb = chunk_bbs + 8 * c;
  const T m = Const<T>::box_margin();
  const T lx = bb[0] - m * (T(1) + vabs(bb[0]));
  const T ly = bb[1] - m * (T(1) + vabs(bb[1]));
  const T lz = bb[2] - m * (T(1) + vabs(bb[2]));
  const T hx = bb[3] + m * (T(1) + vabs(bb[3]));
  const T hy = bb[4] + m * (T(1) + vabs(bb[4]));
  const T hz = bb[5] + m * (T(1) + vabs(bb[5]));
  const T t0x = (lx - ox) * ix, t1x = (hx - ox) * ix;
  const T t0y = (ly - oy) * iy, t1y = (hy - oy) * iy;
  const T t0z = (lz - oz) * iz, t1z = (hz - oz) * iz;
  const T tlo = vmax(vmax(vmin(t0x, t1x), vmin(t0y, t1y)), vmin(t0z, t1z));
  const T thi = vmin(vmin(vmax(t0x, t1x), vmax(t0y, t1y)), vmax(t0z, t1z));
  return (thi >= tlo) && (thi > T(0)) && (tlo < tmin);
}

// The reject of a kind that has none (the float64 kinds): it keeps every
// pair. prim_search_group constructs it and, with kReject off, calls nothing
// else of it.
template <class T>
struct KeepAll {
  __device__ __forceinline__ KeepAll(T, T, T, T, T, T, T) {}
  __device__ __forceinline__ void chunk(const T* __restrict__) {}
};

// s_prim: Kind::kVec * kSearchTile float4 of shared memory. prims:
// (4 * Kind::kVec, npad) SoA; chunk_bbs: (npad / pt, 8). On entry tmin is the
// search bound; on return it is the closest hit's t and idx its sorted lane,
// or tmin is unchanged and idx is -1 when nothing is hit below the bound.
// woken: the chunks the calling thread's warp walked (the same on every
// thread of the warp).
template <class Kind>
__device__ __forceinline__ void prim_search(
    float4* s_prim, float ox, float oy, float oz, float dx, float dy, float dz,
    const float* __restrict__ prims, const float* __restrict__ chunk_bbs,
    int npad, int pt, float t_near, bool live, float& tmin, int& idx,
    int& woken) {
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  idx = -1;
  woken = 0;
  const int n_chunks = npad / pt;
  for (int c = 0; c < n_chunks; ++c) {
    const bool need =
        live && chunk_needed(chunk_bbs, c, ox, oy, oz, ix, iy, iz, tmin);
    const bool warp_need = __any_sync(0xffffffffu, need);
    if (!__syncthreads_or(warp_need)) continue;  // uniform across the block
    woken += warp_need ? 1 : 0;

    const int c_lo = c * pt;
    const int c_hi = c_lo + pt;
    for (int base = c_lo; base < c_hi; base += kSearchTile) {
      const int cnt = min(kSearchTile, c_hi - base);
      __syncthreads();  // the previous tile has been read by every warp
      for (int i = threadIdx.x; i < cnt; i += kSearchBlock) {
        Kind::stage(s_prim + Kind::kVec * i, prims, npad, base + i);
      }
      __syncthreads();
      if (!warp_need) continue;
#pragma unroll 4
      for (int j = 0; j < cnt; ++j) {
        float t;
        if (Kind::hit(s_prim + Kind::kVec * j, ox, oy, oz, dx, dy, dz, t_near,
                      t) &&
            t < tmin) {
          tmin = t;
          idx = base + j;
        }
      }
    }
  }
}

// The G threads of one ray's group: their bits in a warp's lane mask.
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (G == 32) {
    return 0xffffffffu;
  } else {
    return ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  }
}

// Every thread of a group calls it with the same ray and bound; gl is the
// thread's place in the group (0 to G - 1). prims and chunk_bbs as for
// prim_search, in the kind's Scalar. On return every thread of the group
// holds the same (tmin, idx): the closest hit below the bound, or tmin
// unchanged and idx -1. woken: the chunks the group walked.
template <class Kind, int G, bool kReject = false>
__device__ __forceinline__ void prim_search_group(
    typename Kind::Scalar ox, typename Kind::Scalar oy,
    typename Kind::Scalar oz, typename Kind::Scalar dx,
    typename Kind::Scalar dy, typename Kind::Scalar dz,
    const typename Kind::Scalar* __restrict__ prims,
    const typename Kind::Scalar* __restrict__ chunk_bbs, int npad, int pt,
    typename Kind::Scalar t_near, int gl, typename Kind::Scalar& tmin,
    int& idx, int& woken) {
  using T = typename Kind::Scalar;
  const unsigned mask = group_mask<G>();
  const T ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  typename Kind::Reject rj(ox, oy, oz, dx, dy, dz, t_near);
  idx = -1;
  woken = 0;
  const int n_chunks = npad / pt;
  for (int c = 0; c < n_chunks; ++c) {
    if (!chunk_needed(chunk_bbs, c, ox, oy, oz, ix, iy, iz, tmin)) continue;
    ++woken;
    if constexpr (kReject) rj.chunk(chunk_bbs + 8 * c);
    T tl = tmin;
    int il = -1;
    const int c_hi = (c + 1) * pt;
#pragma unroll 2
    for (int j = c * pt + gl; j < c_hi; j += G) {
      typename Kind::Staged s[Kind::kVec];
      if constexpr (kReject) {
        // the reject's rows first; the rest only for a survivor
        Kind::Reject::stage(s, prims, npad, j);
        if (rj.drop(s, tl)) continue;
      }
      Kind::stage(s, prims, npad, j);
      T t;
      if (Kind::hit(s, ox, oy, oz, dx, dy, dz, t_near, t) && t < tl) {
        tl = t;
        il = j;
      }
    }
    // a thread with a hit has tl < tmin, one without tl == tmin and il == -1,
    // so equal t means both hit (lower lane wins) or neither (nothing moves)
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) {
      const T to = __shfl_xor_sync(mask, tl, o);
      const int io = __shfl_xor_sync(mask, il, o);
      if (to < tl || (to == tl && io < il)) {
        tl = to;
        il = io;
      }
    }
    if (il >= 0) {
      tmin = tl;
      idx = il;
    }
  }
}
