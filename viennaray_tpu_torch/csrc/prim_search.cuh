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
// Selection is the lowest t, then the lowest sorted lane, in both: lanes are
// walked in ascending order with a strict <, whatever chunks are skipped,
// and the group's minimum over (t, lane) picks what that walk picks, ties
// included. Both start every chunk from the same bound (the best t so far),
// so they visit the same chunks and return the same (t, lane).
#pragma once

constexpr int kSearchBlock = 256;  // threads of a block that calls prim_search
constexpr int kSearchTile = 512;   // lanes staged at a time

__device__ __forceinline__ float safe_inv(float d) {
  return 1.0f / (d == 0.0f ? 1e-30f : d);
}

// Whether a ray can enter chunk c's bounding box nearer than tmin (slab
// test). The box is widened by a margin (1e-4 relative and absolute) orders
// above float32 rounding in the slab arithmetic, so a chunk that holds a hit
// below tmin always passes.
__device__ __forceinline__ bool chunk_needed(
    const float* __restrict__ chunk_bbs, int c, float ox, float oy, float oz,
    float ix, float iy, float iz, float tmin) {
  const float* bb = chunk_bbs + 8 * c;
  const float lx = bb[0] - 1e-4f * (1.0f + fabsf(bb[0]));
  const float ly = bb[1] - 1e-4f * (1.0f + fabsf(bb[1]));
  const float lz = bb[2] - 1e-4f * (1.0f + fabsf(bb[2]));
  const float hx = bb[3] + 1e-4f * (1.0f + fabsf(bb[3]));
  const float hy = bb[4] + 1e-4f * (1.0f + fabsf(bb[4]));
  const float hz = bb[5] + 1e-4f * (1.0f + fabsf(bb[5]));
  const float t0x = (lx - ox) * ix, t1x = (hx - ox) * ix;
  const float t0y = (ly - oy) * iy, t1y = (hy - oy) * iy;
  const float t0z = (lz - oz) * iz, t1z = (hz - oz) * iz;
  const float tlo = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                          fminf(t0z, t1z));
  const float thi = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                          fmaxf(t0z, t1z));
  return (thi >= tlo) && (thi > 0.0f) && (tlo < tmin);
}

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
// prim_search. On return every thread of the group holds the same (tmin,
// idx): the closest hit below the bound, or tmin unchanged and idx -1.
// woken: the chunks the group walked.
template <class Kind, int G, bool kReject = false>
__device__ __forceinline__ void prim_search_group(
    float ox, float oy, float oz, float dx, float dy, float dz,
    const float* __restrict__ prims, const float* __restrict__ chunk_bbs,
    int npad, int pt, float t_near, int gl, float& tmin, int& idx,
    int& woken) {
  const unsigned mask = group_mask<G>();
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  typename Kind::Reject rj(ox, oy, oz, dx, dy, dz, t_near);
  idx = -1;
  woken = 0;
  const int n_chunks = npad / pt;
  for (int c = 0; c < n_chunks; ++c) {
    if (!chunk_needed(chunk_bbs, c, ox, oy, oz, ix, iy, iz, tmin)) continue;
    ++woken;
    if constexpr (kReject) rj.chunk(chunk_bbs + 8 * c);
    float tl = tmin;
    int il = -1;
    const int c_hi = (c + 1) * pt;
#pragma unroll 2
    for (int j = c * pt + gl; j < c_hi; j += G) {
      float4 s[Kind::kVec];
      if constexpr (kReject) {
        // the reject's rows first; the rest only for a survivor
        Kind::Reject::stage(s, prims, npad, j);
        if (rj.drop(s, tl)) continue;
      }
      Kind::stage(s, prims, npad, j);
      float t;
      if (Kind::hit(s, ox, oy, oz, dx, dy, dz, t_near, t) && t < tl) {
        tl = t;
        il = j;
      }
    }
    // a thread with a hit has tl < tmin, one without tl == tmin and il == -1,
    // so equal t means both hit (lower lane wins) or neither (nothing moves)
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) {
      const float to = __shfl_xor_sync(mask, tl, o);
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
