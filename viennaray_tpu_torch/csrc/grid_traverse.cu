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
// In each cell the warp's 32 threads test the cell's slots side by side
// (two passes at 42 slots) and take one __shfl_xor_sync minimum of
// (t, lane); the walk is the same on every thread of the warp.
//
// Bound: operations. A ray tests the slots of the cells it walks through,
// 26 float32 operations a (ray, disk) pair and 45 a triangle (the exact
// tests, disk_hit.cuh and tri_hit.cuh), a few hundred pairs a ray where the
// chunk search tests thousands; the bytes are the lane table's rows and the
// SoA lanes they name, which stay in L2 at 18,180 disks and are read from
// HBM at 704,250 (a 313 MB table).
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
                unsigned char* __restrict__ hit_out) {
  const long long thread = (long long)blockIdx.x * kBlock + threadIdx.x;
  const long long r = thread / kGroup;
  const int gl = (int)threadIdx.x & (kGroup - 1);
  if (r >= n_rays) return;  // whole warps: a warp's threads are one ray
  const T ox = org[3 * r + 0], oy = org[3 * r + 1], oz = org[3 * r + 2];
  const T dx = dir[3 * r + 0], dy = dir[3 * r + 1], dz = dir[3 * r + 2];
  T tmin = Const<T>::big();
  int idx, visited;
  grid_search_group<Kind, kGroup>(ox, oy, oz, dx, dy, dz, prims, npad, g,
                                  t_near, gl, tmin, idx, visited);
  if (gl == 0) {
    t_out[r] = tmin;
    prim_out[r] = perm[idx < 0 ? 0 : idx];
    hit_out[r] = idx < 0 ? 0 : 1;
  }
}

template <class Kind, class T = typename Kind::Scalar>
int launch_grid_hit(const T* org, const T* dir, const T* prims,
                    const int* perm, const int* lanes, int k, int nx, int ny,
                    int nz, T gx, T gy, T gz, T cs, int n_rays, int npad,
                    T t_near, T* t_out, int* prim_out, unsigned char* hit_out,
                    void* stream) {
  if (n_rays > 0) {
    const GridWalk<T> g{lanes, k, nx, ny, nz, gx, gy, gz, cs};
    const long long threads = (long long)n_rays * kGroup;
    const unsigned grid = (unsigned)((threads + kBlock - 1) / kBlock);
    grid_hit_kernel<Kind, T><<<grid, kBlock, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        org, dir, prims, perm, g, n_rays, npad, t_near, t_out, prim_out,
        hit_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// org, dir: (n_rays, 3) float32; prims: (8, npad) float32 for disks, (12,
// npad) for triangles; perm: (npad,) int32 sorted lane -> original id;
// lanes: (nx ny nz, k) int32, the walk's table of sorted lanes (-1 after a
// row's lanes) on the grid of nx x ny x nz cells of size cs from (gx, gy,
// gz) (nz = 1: the 2D grid). Outputs: t (n_rays,) float32, prim (n_rays,)
// int32 in the original numbering, hit (n_rays,) bytes 0/1. Launches on
// `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError().
extern "C" int vr_disk_grid_nearest_hit(
    const float* org, const float* dir, const float* prims, const int* perm,
    const int* lanes, int k, int nx, int ny, int nz, float gx, float gy,
    float gz, float cs, int n_rays, int npad, float t_near, float* t_out,
    int* prim_out, unsigned char* hit_out, void* stream) {
  return launch_grid_hit<DiskKind>(org, dir, prims, perm, lanes, k, nx, ny,
                                   nz, gx, gy, gz, cs, n_rays, npad, t_near,
                                   t_out, prim_out, hit_out, stream);
}

extern "C" int vr_tri_grid_nearest_hit(
    const float* org, const float* dir, const float* prims, const int* perm,
    const int* lanes, int k, int nx, int ny, int nz, float gx, float gy,
    float gz, float cs, int n_rays, int npad, float t_near, float* t_out,
    int* prim_out, unsigned char* hit_out, void* stream) {
  return launch_grid_hit<TriKind>(org, dir, prims, perm, lanes, k, nx, ny,
                                  nz, gx, gy, gz, cs, n_rays, npad, t_near,
                                  t_out, prim_out, hit_out, stream);
}

// The float64 forms: org, dir, prims, the grid's corner and cell size,
// t_near and t_out doubles, the rest as above.
extern "C" int vr_disk_grid_nearest_hit_f64(
    const double* org, const double* dir, const double* prims,
    const int* perm, const int* lanes, int k, int nx, int ny, int nz,
    double gx, double gy, double gz, double cs, int n_rays, int npad,
    double t_near, double* t_out, int* prim_out, unsigned char* hit_out,
    void* stream) {
  return launch_grid_hit<DiskKindF64>(org, dir, prims, perm, lanes, k, nx,
                                      ny, nz, gx, gy, gz, cs, n_rays, npad,
                                      t_near, t_out, prim_out, hit_out,
                                      stream);
}

extern "C" int vr_tri_grid_nearest_hit_f64(
    const double* org, const double* dir, const double* prims,
    const int* perm, const int* lanes, int k, int nx, int ny, int nz,
    double gx, double gy, double gz, double cs, int n_rays, int npad,
    double t_near, double* t_out, int* prim_out, unsigned char* hit_out,
    void* stream) {
  return launch_grid_hit<TriKindF64>(org, dir, prims, perm, lanes, k, nx, ny,
                                     nz, gx, gy, gz, cs, n_rays, npad, t_near,
                                     t_out, prim_out, hit_out, stream);
}
