// Closest disk hit of one ray below a bound, shared by every kernel that
// searches the packed disk cloud (nearest_hit.cu, bounce.cu).
//
// One thread per ray; the whole block calls disk_search together (it holds
// block-wide barriers), lanes without a ray pass live = false. A block
// stages kTile lanes of the SoA into shared memory at a time, as two float4
// per disk, and every thread walks them with broadcast loads, so a disk
// costs the block one global read instead of one per ray. A warp skips a
// chunk when none of its rays can enter the chunk's bounding box nearer than
// its current best (slab test on a box widened by a margin far above
// rounding), and a block skips staging a chunk no warp needs. A skipped
// chunk holds no nearer hit, so the result does not depend on the skip.
//
// Selection is the lowest t, then the lowest sorted lane: lanes are walked
// in ascending order with a strict <, whatever chunks are skipped. The hit
// test itself is disk_hit.cuh.
#pragma once

#include "disk_hit.cuh"

constexpr int kSearchBlock = 256;  // threads of a block that calls disk_search
constexpr int kSearchTile = 512;   // lanes staged at a time

__device__ __forceinline__ float safe_inv(float d) {
  return 1.0f / (d == 0.0f ? 1e-30f : d);
}

// s_prim: 2 * kSearchTile float4 of shared memory. prims: (8, npad) SoA;
// chunk_bbs: (npad / pt, 8). On entry tmin is the search bound; on return it
// is the closest hit's t and idx its sorted lane, or tmin is unchanged and
// idx is -1 when no disk is hit below the bound.
__device__ __forceinline__ void disk_search(
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
        const int g = base + i;
        s_prim[2 * i] = make_float4(prims[g], prims[npad + g],
                                    prims[2 * npad + g], prims[3 * npad + g]);
        s_prim[2 * i + 1] =
            make_float4(prims[4 * npad + g], prims[5 * npad + g],
                        prims[6 * npad + g], prims[7 * npad + g]);
      }
      __syncthreads();
      if (!warp_need) continue;
#pragma unroll 4
      for (int j = 0; j < cnt; ++j) {
        const float4 a = s_prim[2 * j];
        const float4 b = s_prim[2 * j + 1];
        const DiskPrim p{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
        float t;
        if (disk_hit(ox, oy, oz, dx, dy, dz, p, t_near, t) && t < tmin) {
          tmin = t;
          idx = base + j;
        }
      }
    }
  }
}
