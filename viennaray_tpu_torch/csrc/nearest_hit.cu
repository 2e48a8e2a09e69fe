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
// What bounds it on an H100: operations, at every width. Every ray tests
// every primitive of every chunk it cannot rule out, while the bytes are tiny
// (24 per ray in, 9 out; the whole geometry, 32 bytes a disk and 48 a
// triangle, stays in L2). The bound counts the exact test: 26 float32
// operations a (ray, disk) pair and 45 a triangle at 67 TFLOP/s. That rate
// counts an FMA as two operations, and the exact test (disk_hit.cuh,
// tri_hit.cuh) issues none: its round-to-nearest intrinsics never fuse, and
// each IEEE division (one a disk, three a triangle) is a sequence of several
// instructions with a slow-path branch. So the exact test alone can never
// pass half the rate the bound assumes.
//
// What the design does about it:
// - A division-free reject before the exact test (kReject of
//   prim_search.cuh; DiskReject, TriReject): about 27 (disks) or 39
//   (triangles) operations, most of them FMAs, and no division. Almost every
//   pair misses by far: the ray's line passes farther than r from a disk's
//   centre, or a barycentric coordinate is negative. Only the survivors pay
//   for the exact test, which is unchanged, so (t, prim, hit) stay bit for
//   bit what the plain versions give. The margin argument is written beside
//   each reject: its margins (2^-9 relative on r^2, 2^-16 of the coordinates'
//   magnitude absolute, since o + t d - c and o - v0 cancel) are several
//   times the rounding of both tests, so a dropped pair is one the exact
//   test would not have selected below the running best. Lines keep every
//   pair (LineReject).
// - A warp per ray (ops/nearest_hit.py:GROUP = 32), at every width.
//   prim_search_group: thread l of the warp tests lanes l, l + 32, ... of a
//   chunk read straight from the SoA, then the warp takes the lexicographic
//   minimum of (t, lane). A 512-ray launch, the unfused body's narrowest,
//   runs 16,384 threads over all 132 SMs, and the chunk skip is decided for
//   the one ray. One thread per ray, the kernel's first design (a block
//   staging each needed chunk through shared memory, each thread walking it
//   lane by lane), measured on an H100 slower at every width of the
//   unfused ladder, with the same reject: 1.1x at 2^20 rays on the 6-chunk
//   disks, up to 40x at 512 rays on the triangles (PERF.md §6). The bounce
//   kernel keeps a rule by width (ops/bounce.py:group_for): its per-ray
//   state and physics weigh on G = 32's registers at the wide widths.
// - Neither tensor cores nor asynchronous copies. Hopper has no full-float32
//   matrix product, and TF32 would break the bitwise contract with the plain
//   versions. The warp reads each lane of a visited chunk once, straight
//   from the SoA through L1 (the whole geometry stays in L2), and runs 27 to
//   39 operations on it; staging a 512-lane tile through shared memory, as
//   the first design did, cost 16 loads a thread against about 512 pair
//   tests, under 1 % of the tile's work, so cp.async or TMA would have
//   nothing to hide.
//
// The search itself, with its per-ray chunk skip and its tie rule, is
// prim_search_group of csrc/prim_search.cuh, shared with the bounce kernel
// (which instantiates it without the reject).
#include <cuda_runtime.h>

#include "disk_hit.cuh"
#include "line_hit.cuh"
#include "prim_search.cuh"
#include "tri_hit.cuh"

namespace {

constexpr float kBig = 3.4e38f;

constexpr int kGroup = 32;   // threads that search for one ray: a warp
constexpr int kBlock = 128;  // four rays a block: a narrow launch spreads
                             // over as many SMs as it has rays / 4

// The warp of ray r = thread / kGroup (gl = the thread's place in it) runs
// the group search, with no barrier; every thread of the warp ends with the
// same (t, lane), and its first thread writes it. The thread index is 64-bit:
// n_rays * kGroup passes 2^31 from 2^26 rays on.
template <class Kind>
__global__ void __launch_bounds__(kBlock)
nearest_hit_kernel(const float* __restrict__ org,
                   const float* __restrict__ dir,
                   const float* __restrict__ prims,
                   const float* __restrict__ chunk_bbs,
                   const int* __restrict__ perm, int n_rays, int npad, int pt,
                   float t_near, float* __restrict__ t_out,
                   int* __restrict__ prim_out,
                   unsigned char* __restrict__ hit_out) {
  const long long thread = (long long)blockIdx.x * kBlock + threadIdx.x;
  const long long r = thread / kGroup;
  const int gl = (int)threadIdx.x & (kGroup - 1);
  if (r >= n_rays) return;  // whole warps: a warp's threads are one ray
  const float ox = org[3 * r + 0], oy = org[3 * r + 1], oz = org[3 * r + 2];
  const float dx = dir[3 * r + 0], dy = dir[3 * r + 1], dz = dir[3 * r + 2];
  float tmin = kBig;
  int idx, woken;
  prim_search_group<Kind, kGroup, true>(ox, oy, oz, dx, dy, dz, prims,
                                        chunk_bbs, npad, pt, t_near, gl, tmin,
                                        idx, woken);
  if (gl == 0) {
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
    const long long threads = (long long)n_rays * kGroup;
    const unsigned grid = (unsigned)((threads + kBlock - 1) / kBlock);
    nearest_hit_kernel<Kind><<<grid, kBlock, 0,
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
// int32 in the original numbering, hit (n_rays,) bytes 0/1.
// Launches on `stream`, allocates nothing, does not synchronise; returns
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
