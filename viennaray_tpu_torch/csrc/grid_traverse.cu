// Closest disk or triangle hit per ray by a walk of the uniform grid (the
// grid DDA): one kernel template, instantiated for disks and triangles in
// float32 and float64.
//
// Replaces viennaray_tpu/ops/grid_traverse.py:64 (grid_nearest_hit, with
// disk_grid_nearest_hit and triangle_grid_nearest_hit): the JAX package
// runs the DDA in XLA, not in a Pallas kernel, in the trace's float type.
// What it computes is the closest-hit kernel's (nearest_hit.cu) bit for bit:
// the same exact test (DiskKind, TriKind and their float64 kinds) and the
// same selection, the lowest t and then the lowest sorted lane; the search
// is csrc/grid_search.cuh, which says why the walk finds what the chunk
// search finds.
//
// Mapping: a warp per ray (the closest-hit kernel's), blocks of four rays.
// The warp walks 32 cells a round (grid_search.cuh): each thread finds one
// cell of the round in registers and reads its entries of the compact table,
// then the warp tests the round's (cell, slot) pairs 32 at a time and finds
// by prefix minimum and ballot the cell where the sequential walk stops.
//
// Bound: operations or bytes, whichever is larger. A ray tests the slots of
// the cells it walks through, 26 float32 operations a (ray, disk) pair and
// 45 a triangle (the exact tests, disk_hit.cuh and tri_hit.cuh), tens of
// pairs a ray where the chunk search tests thousands; the bytes are the
// rays in and out, the SoA and the compact table read once each. The walk
// itself is bound by the latency of its dependent reads: a round costs
// three (the starts, the entries, the SoA lanes) for up to 32 cells, on a
// table that fits in L2 at 704,250 disks.
#include <cuda_runtime.h>

#include "disk_hit.cuh"
#include "grid_search.cuh"
#include "tri_hit.cuh"

namespace {

constexpr int kGroup = 32;   // threads that walk for one ray: a warp
constexpr int kBlock = 128;  // four rays a block

template <class Kind, class T = typename Kind::Scalar>
__global__ void __launch_bounds__(kBlock)
grid_hit_kernel(const T* __restrict__ org, const T* __restrict__ dir,
                const T* __restrict__ prims, const int* __restrict__ perm,
                const GridWalk<T> g, int n_rays, int npad, T t_near,
                T* __restrict__ t_out, int* __restrict__ prim_out,
                unsigned char* __restrict__ hit_out,
                unsigned long long* __restrict__ walk_counts) {
  const long long thread = (long long)blockIdx.x * kBlock + threadIdx.x;
  const long long r = thread / kGroup;
  const int gl = (int)threadIdx.x & (kGroup - 1);
  if (r >= n_rays) return;  // whole warps: a warp's threads are one ray
  const T ox = org[3 * r + 0], oy = org[3 * r + 1], oz = org[3 * r + 2];
  const T dx = dir[3 * r + 0], dy = dir[3 * r + 1], dz = dir[3 * r + 2];
  T tmin = Const<T>::big();
  int idx;
  WalkCounts counts;
  grid_search_group<Kind, kGroup>(ox, oy, oz, dx, dy, dz, prims, npad, g,
                                  t_near, gl, tmin, idx, counts);
  if (gl == 0) {
    t_out[r] = tmin;
    prim_out[r] = perm[idx < 0 ? 0 : idx];
    hit_out[r] = idx < 0 ? 0 : 1;
    if (walk_counts != nullptr) {
      atomicAdd(&walk_counts[0], (unsigned long long)counts.visited);
      atomicAdd(&walk_counts[1], (unsigned long long)counts.tested);
      atomicAdd(&walk_counts[2], (unsigned long long)counts.wasted);
    }
  }
}

template <class Kind, class T = typename Kind::Scalar>
int launch_grid_hit(const T* org, const T* dir, const T* prims,
                    const int* perm, const int* start, const int* lanes,
                    int nx, int ny, int nz, T gx, T gy, T gz, T cs,
                    int n_rays, int npad, T t_near, T* t_out, int* prim_out,
                    unsigned char* hit_out, unsigned long long* walk_counts,
                    void* stream) {
  if (n_rays > 0) {
    const GridWalk<T> g{start, lanes, nx, ny, nz, gx, gy, gz, cs};
    const long long threads = (long long)n_rays * kGroup;
    const unsigned grid = (unsigned)((threads + kBlock - 1) / kBlock);
    grid_hit_kernel<Kind, T><<<grid, kBlock, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        org, dir, prims, perm, g, n_rays, npad, t_near, t_out, prim_out,
        hit_out, walk_counts);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// org, dir: (n_rays, 3) float32; prims: (8, npad) float32 for disks, (12,
// npad) for triangles; perm: (npad,) int32 sorted lane -> original id;
// start, lanes: the walk's compact table (start (nx ny nz + 1,) int32, cell
// c's sorted lanes at lanes[start[c]:start[c + 1]]) on the grid of
// nx x ny x nz cells of size cs from (gx, gy, gz) (nz = 1: the 2D grid).
// Outputs: t (n_rays,) float32, prim (n_rays,) int32 in the original
// numbering, hit (n_rays,) bytes 0/1; walk_counts: null, or 3 64-bit words
// to which the launch adds the cells its walks visited, the pairs of those
// cells and the pairs tested past the stopping cells. Launches on `stream`,
// allocates nothing, does not synchronise; returns cudaGetLastError().
#define VR_GRID_HIT(NAME, KIND, T)                                          \
  extern "C" int NAME(const T* org, const T* dir, const T* prims,           \
                      const int* perm, const int* start, const int* lanes,  \
                      int nx, int ny, int nz, T gx, T gy, T gz, T cs,       \
                      int n_rays, int npad, T t_near, T* t_out,             \
                      int* prim_out, unsigned char* hit_out,                \
                      unsigned long long* walk_counts, void* stream) {      \
    return launch_grid_hit<KIND>(org, dir, prims, perm, start, lanes, nx,   \
                                 ny, nz, gx, gy, gz, cs, n_rays, npad,      \
                                 t_near, t_out, prim_out, hit_out,          \
                                 walk_counts, stream);                      \
  }

VR_GRID_HIT(vr_disk_grid_nearest_hit, DiskKind, float)
VR_GRID_HIT(vr_tri_grid_nearest_hit, TriKind, float)
// the float64 forms: org, dir, prims, the grid's corner and cell size,
// t_near and t_out doubles, the rest as above
VR_GRID_HIT(vr_disk_grid_nearest_hit_f64, DiskKindF64, double)
VR_GRID_HIT(vr_tri_grid_nearest_hit_f64, TriKindF64, double)
