// Closest disk hit per ray.
//
// Replaces the TPU kernel viennaray_tpu/ops/pallas_intersect.py:_kernel
// (launched by disk_nearest_hit_pallas).
//
// What bounds it on an H100: operations. Every ray tests every disk of every
// chunk it cannot rule out, about 30 float32 operations a pair, while the
// bytes are tiny: 24 per ray in, 9 out, and the whole geometry (32 bytes a
// disk) stays in L2. At the 3D trench's 2^20 rays by 3,072 lanes that is
// 1e11 operations against 35 MB.
//
// What the design does about it:
//  - one thread per ray keeps the ray, the running minimum and its lane in
//    registers; the ragged edge (R not a multiple of the block) is masked;
//  - a block stages 512 lanes of the SoA into shared memory at a time, as two
//    float4 per disk, and every thread walks them with broadcast loads, so a
//    disk costs the block one global read instead of one per ray;
//  - a warp skips a chunk when none of its rays can enter the chunk's
//    bounding box nearer than its current best (slab test on a box widened
//    by a margin far above rounding), and a block skips staging a chunk no
//    warp needs. A skipped chunk holds no nearer hit, so the result does not
//    depend on the skip;
//  - selection is the lowest t, then the lowest sorted lane: lanes are walked
//    in ascending order with a strict <, whatever chunks are skipped.
// The hit test itself is csrc/disk_hit.cuh (no fused multiply-add, IEEE
// division), which is why the result equals the plain version's exactly.
#include <cuda_runtime.h>

#include "disk_hit.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kTile = 512;
constexpr float kBig = 3.4e38f;

__device__ __forceinline__ float safe_inv(float d) {
  return 1.0f / (d == 0.0f ? 1e-30f : d);
}

__global__ void __launch_bounds__(kBlock)
disk_nearest_hit_kernel(const float* __restrict__ org,
                        const float* __restrict__ dir,
                        const float* __restrict__ prims,
                        const float* __restrict__ chunk_bbs,
                        const int* __restrict__ perm, int n_rays, int npad,
                        int pt, float t_near, float* __restrict__ t_out,
                        int* __restrict__ prim_out,
                        unsigned char* __restrict__ hit_out) {
  __shared__ float4 s_prim[2 * kTile];

  const int r = blockIdx.x * kBlock + threadIdx.x;
  const bool live = r < n_rays;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  if (live) {
    ox = org[3 * r + 0];
    oy = org[3 * r + 1];
    oz = org[3 * r + 2];
    dx = dir[3 * r + 0];
    dy = dir[3 * r + 1];
    dz = dir[3 * r + 2];
  }
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);

  float tmin = kBig;
  int idx = 0;
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
    for (int base = c_lo; base < c_hi; base += kTile) {
      const int cnt = min(kTile, c_hi - base);
      __syncthreads();  // the previous tile has been read by every warp
      for (int i = threadIdx.x; i < cnt; i += kBlock) {
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
  if (live) {
    t_out[r] = tmin;
    prim_out[r] = perm[idx];
    hit_out[r] = tmin < kBig ? 1 : 0;
  }
}

}  // namespace

// org, dir: (n_rays, 3) float32; prims: (8, npad) float32; chunk_bbs:
// (npad / pt, 8) float32; perm: (npad,) int32 sorted lane -> original id.
// Outputs: t (n_rays,) float32, prim (n_rays,) int32 in the original
// numbering, hit (n_rays,) bytes 0/1. Launches on `stream`, allocates
// nothing, does not synchronise; returns cudaGetLastError().
extern "C" int vr_disk_nearest_hit(const float* org, const float* dir,
                                   const float* prims, const float* chunk_bbs,
                                   const int* perm, int n_rays, int npad,
                                   int pt, float t_near, float* t_out,
                                   int* prim_out, unsigned char* hit_out,
                                   void* stream) {
  if (n_rays > 0) {
    const int grid = (n_rays + kBlock - 1) / kBlock;
    disk_nearest_hit_kernel<<<grid, kBlock, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        org, dir, prims, chunk_bbs, perm, n_rays, npad, pt, t_near, t_out,
        prim_out, hit_out);
  }
  return static_cast<int>(cudaGetLastError());
}
