// Closest hit of one ray below a bound, on a packed geometry of one primitive
// kind; shared by every kernel that searches (nearest_hit.cu, bounce.cu).
//
// The primitive kind is a template parameter (DiskKind of disk_hit.cuh,
// TriKind of tri_hit.cuh, LineKind of line_hit.cuh): it says how many float4
// one staged primitive takes (kVec: 2 for a disk's 8 rows, 3 for a
// triangle's 12, 1 for the 4 rows of a line's test), how to stage one lane
// of the SoA into them, and the hit test on the staged values.
//
// One thread per ray; the whole block calls prim_search together (it holds
// block-wide barriers), lanes without a ray pass live = false. A block
// stages kSearchTile lanes of the SoA into shared memory at a time, and
// every thread walks them with broadcast loads, so a primitive costs the
// block one global read instead of one per ray. A chunk wider than a tile
// (1,024 or 2,048 lanes) is staged tile by tile. A warp skips a chunk when
// none of its rays can enter the chunk's bounding box nearer than its
// current best (slab test on a box widened by a margin far above rounding),
// and a block skips staging a chunk no warp needs. A skipped chunk holds no
// nearer hit, so the result does not depend on the skip.
//
// Selection is the lowest t, then the lowest sorted lane: lanes are walked
// in ascending order with a strict <, whatever chunks are skipped.
#pragma once

constexpr int kSearchBlock = 256;  // threads of a block that calls prim_search
constexpr int kSearchTile = 512;   // lanes staged at a time

__device__ __forceinline__ float safe_inv(float d) {
  return 1.0f / (d == 0.0f ? 1e-30f : d);
}

// s_prim: Kind::kVec * kSearchTile float4 of shared memory. prims:
// (4 * Kind::kVec, npad) SoA; chunk_bbs: (npad / pt, 8). On entry tmin is the
// search bound; on return it is the closest hit's t and idx its sorted lane,
// or tmin is unchanged and idx is -1 when nothing is hit below the bound.
template <class Kind>
__device__ __forceinline__ void prim_search(
    float4* s_prim, float ox, float oy, float oz, float dx, float dy, float dz,
    const float* __restrict__ prims, const float* __restrict__ chunk_bbs,
    int npad, int pt, float t_near, bool live, float& tmin, int& idx) {
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  idx = -1;
  const int n_chunks = npad / pt;
  for (int c = 0; c < n_chunks; ++c) {
    bool need = false;
    if (live) {
      const float* bb = chunk_bbs + 8 * c;
      // widen the box: the margin (1e-4 relative and absolute) is orders
      // above float32 rounding in the slab arithmetic
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
      need = (thi >= tlo) && (thi > 0.0f) && (tlo < tmin);
    }
    const bool warp_need = __any_sync(0xffffffffu, need);
    if (!__syncthreads_or(warp_need)) continue;  // uniform across the block

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
