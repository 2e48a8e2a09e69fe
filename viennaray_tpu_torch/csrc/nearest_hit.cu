// Closest disk, triangle or 2D line-segment hit per ray: one kernel template,
// instantiated for the three primitive kinds.
//
// Replaces the TPU kernels viennaray_tpu/ops/pallas_intersect.py:_kernel
// (launched by disk_nearest_hit_pallas) and :_tri_kernel (launched by
// triangle_nearest_hit_pallas). The line instantiation has no TPU kernel
// behind it: the JAX package searches lines in XLA
// (viennaray_tpu/ops/intersect.py:line_nearest_hit); here it is one more
// instantiation, 13 operations a (ray, segment) pair with two divisions.
//
// What bounds it on an H100: operations. Every ray tests every primitive of
// every chunk it cannot rule out, about 30 float32 operations a (ray, disk)
// pair and about 50 a (ray, triangle) pair with its three divisions, while
// the bytes are tiny: 24 per ray in, 9 out, and the whole geometry (32 bytes
// a disk, 48 a triangle) stays in L2. At the 3D trench's 2^20 rays by 3,072
// disk lanes that is 1e11 operations against 35 MB; by 6,144 triangle lanes
// 3e11.
//
// What the design does about it: one thread per ray keeps the ray, the
// running minimum and its lane in registers; the ragged edge (R not a
// multiple of the block) is masked; the search itself, with its staging of
// the SoA through shared memory, its per-warp chunk skip and its tie rule, is
// csrc/prim_search.cuh, shared with the bounce kernel. The hit tests are
// csrc/disk_hit.cuh, csrc/tri_hit.cuh and csrc/line_hit.cuh (no fused
// multiply-add, IEEE division), which is why the results equal the plain
// versions' exactly.
#include <cuda_runtime.h>

#include "disk_hit.cuh"
#include "line_hit.cuh"
#include "prim_search.cuh"
#include "tri_hit.cuh"

namespace {

constexpr float kBig = 3.4e38f;

template <class Kind>
__global__ void __launch_bounds__(kSearchBlock)
nearest_hit_kernel(const float* __restrict__ org,
                   const float* __restrict__ dir,
                   const float* __restrict__ prims,
                   const float* __restrict__ chunk_bbs,
                   const int* __restrict__ perm, int n_rays, int npad, int pt,
                   float t_near, float* __restrict__ t_out,
                   int* __restrict__ prim_out,
                   unsigned char* __restrict__ hit_out) {
  __shared__ float4 s_prim[Kind::kVec * kSearchTile];

  const int r = blockIdx.x * kSearchBlock + threadIdx.x;
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
  float tmin = kBig;
  int idx, woken;
  prim_search<Kind>(s_prim, ox, oy, oz, dx, dy, dz, prims, chunk_bbs, npad,
                    pt, t_near, live, tmin, idx, woken);
  if (live) {
    t_out[r] = tmin;
    prim_out[r] = perm[idx < 0 ? 0 : idx];
    hit_out[r] = idx < 0 ? 0 : 1;
  }
}

template <class Kind>
int launch_nearest_hit(const float* org, const float* dir, const float* prims,
                       const float* chunk_bbs, const int* perm, int n_rays,
                       int npad, int pt, float t_near, float* t_out,
                       int* prim_out, unsigned char* hit_out, void* stream) {
  if (n_rays > 0) {
    const int grid = (n_rays + kSearchBlock - 1) / kSearchBlock;
    nearest_hit_kernel<Kind><<<grid, kSearchBlock, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        org, dir, prims, chunk_bbs, perm, n_rays, npad, pt, t_near, t_out,
        prim_out, hit_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// org, dir: (n_rays, 3) float32; prims: (8, npad) float32 for disks, (12,
// npad) for triangles, (6, npad) for lines; chunk_bbs: (npad / pt, 8) float32; perm: (npad,) int32
// sorted lane -> original id. Outputs: t (n_rays,) float32, prim (n_rays,)
// int32 in the original numbering, hit (n_rays,) bytes 0/1. Launches on
// `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError().
extern "C" int vr_disk_nearest_hit(const float* org, const float* dir,
                                   const float* prims, const float* chunk_bbs,
                                   const int* perm, int n_rays, int npad,
                                   int pt, float t_near, float* t_out,
                                   int* prim_out, unsigned char* hit_out,
                                   void* stream) {
  return launch_nearest_hit<DiskKind>(org, dir, prims, chunk_bbs, perm, n_rays,
                                      npad, pt, t_near, t_out, prim_out,
                                      hit_out, stream);
}

extern "C" int vr_triangle_nearest_hit(const float* org, const float* dir,
                                       const float* prims,
                                       const float* chunk_bbs, const int* perm,
                                       int n_rays, int npad, int pt,
                                       float t_near, float* t_out,
                                       int* prim_out, unsigned char* hit_out,
                                       void* stream) {
  return launch_nearest_hit<TriKind>(org, dir, prims, chunk_bbs, perm, n_rays,
                                     npad, pt, t_near, t_out, prim_out,
                                     hit_out, stream);
}

extern "C" int vr_line_nearest_hit(const float* org, const float* dir,
                                   const float* prims, const float* chunk_bbs,
                                   const int* perm, int n_rays, int npad,
                                   int pt, float t_near, float* t_out,
                                   int* prim_out, unsigned char* hit_out,
                                   void* stream) {
  return launch_nearest_hit<LineKind>(org, dir, prims, chunk_bbs, perm, n_rays,
                                      npad, pt, t_near, t_out, prim_out,
                                      hit_out, stream);
}
