// The point neighborhood on the card: all pairs within a distance as the
// padded (n, k) int32 table of DiskGeometry.neighbors, the compiled host
// helper's table (native/host_accel.cpp, vr_build_neighborhood) bit for bit.
// neighborhood.cuh holds the per-point work; the wrapper is
// geometry/neighborhood.py:build_neighborhood_cuda.
//
// Replaces no Pallas kernel: the JAX package builds the table on the host
// (viennaray_tpu/geometry/neighborhood.py, its native/host_accel.cpp). Here
// the host helper's single-threaded double pass over every point and its 27
// cells, through a dense table of every cell of the bounding box (19.6 M at
// 704,250 disks, so most lookups miss the cache), took most of a geometry
// build (PERF.md §5) while the card waited.
//
// The build: the minima (a reduction in the wrapper); vr_neighborhood_cells,
// a point a thread, the cell coordinates in float64; the largest coordinate
// of each axis (a reduction); vr_neighborhood_ids, a point a thread, the
// int64 linear ids, and one thread the grid (strides, cell count, offsets);
// a stable sort of the ids (the wrapper's torch.sort), which orders the
// points by cell and then by index, as the helper's counting sort does; then
// vr_neighborhood_rows twice, a point a thread in sorted order so that a
// warp's points share cells: the first counts each point's neighbors, the
// wrapper reads the largest count (the build's one blocking read), the
// second writes the rows, padding each with -1. A cell's members are found
// by a binary search of the sorted ids, not through a table of every cell:
// such a table grows with the bounding box, not with the points.
//
// Bound: the latency of dependent reads. A point searches the sorted ids
// (8 bytes a point; 5.6 MB at 704,250 points, in L2) for the runs of cells
// around its own, nine searches in 3D where three cells of a row follow one
// another, and reads a member's point and cell coordinates (36 bytes) for
// each pair tested, about 30 pairs a point on a trench cloud.
#include <cuda_runtime.h>

#include "neighborhood.cuh"

namespace {

constexpr int kThreads = 256;

int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

template <class T>
__global__ void __launch_bounds__(kThreads)
cells_kernel(const T* __restrict__ pts, long long n, int cols, int dim,
             const T* __restrict__ lo, double inv_cell,
             long long* __restrict__ cx) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  for (int d = 0; d < 3; ++d) {
    cx[i * 3 + d] = d < dim ? nbr_cell(pts[i * cols + d], lo[d], inv_cell) : 0;
  }
}

__global__ void __launch_bounds__(kThreads)
ids_kernel(const long long* __restrict__ cx, long long n, int dim,
           const long long* __restrict__ maxc, long long* __restrict__ ids,
           NbrGrid* __restrict__ grid) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i == 0) nbr_grid(maxc, dim, grid);
  if (i < n) ids[i] = nbr_id(cx + i * 3, maxc, dim);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const T* __restrict__ pts, long long n, int cols, int dim,
            const long long* __restrict__ cx, const long long* __restrict__ ids,
            const long long* __restrict__ order,
            const NbrGrid* __restrict__ grid, double distance, double dist2,
            int* __restrict__ counts, int* __restrict__ neighbors, int k) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n) return;
  const long long i = order[t];
  int* row = neighbors == nullptr ? nullptr : neighbors + i * k;
  const int count = nbr_row<T>(
      i, ids[t], pts, cols, dim, cx, ids, order, n, grid, distance, dist2,
      [=](int c, long long j) {
        if (row != nullptr && c < k) row[c] = (int)j;
      });
  if (row == nullptr) {
    counts[i] = count;
  } else {
    for (int c = count; c < k; ++c) row[c] = -1;
  }
}

template <class T>
int launch_cells(const T* pts, long long n, int cols, int dim, const T* lo,
                 double inv_cell, long long* cx, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (dim < 2 || dim > 3 || cols < dim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cells_kernel<T><<<blocks_for(n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(pts, n, cols, dim,
                                                         lo, inv_cell, cx);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_rows(const T* pts, long long n, int cols, int dim,
                const long long* cx, const long long* ids,
                const long long* order, const void* grid, double distance,
                double dist2, int* counts, int* neighbors, int k,
                void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (dim < 2 || dim > 3 || cols < dim || (neighbors != nullptr && k < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  rows_kernel<T><<<blocks_for(n), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      pts, n, cols, dim, cx, ids, order, static_cast<const NbrGrid*>(grid),
      distance, dist2, counts, neighbors, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The cell coordinates of n points: cx (n, 3) int64, floor((p - lo) *
// inv_cell) on the first dim axes in float64, 0 on the others. pts: (n,
// cols) row-major; lo: dim minima on the device. Launches on `stream`,
// allocates nothing, does not synchronise; returns cudaGetLastError().
extern "C" int vr_neighborhood_cells(const float* pts, long long n, int cols,
                                     int dim, const float* lo,
                                     double inv_cell, long long* cx,
                                     void* stream) {
  return launch_cells<float>(pts, n, cols, dim, lo, inv_cell, cx, stream);
}

extern "C" int vr_neighborhood_cells_f64(const double* pts, long long n,
                                         int cols, int dim, const double* lo,
                                         double inv_cell, long long* cx,
                                         void* stream) {
  return launch_cells<double>(pts, n, cols, dim, lo, inv_cell, cx, stream);
}

// The linear ids (n,) int64 from cx and maxc (each axis's largest cell
// coordinate, on the device), and the grid (32 int64 words, NbrGrid).
// Launches on `stream` (one launch, at least one block, so the grid is
// written for n = 0 too); returns cudaGetLastError().
extern "C" int vr_neighborhood_ids(const long long* cx, long long n, int dim,
                                   const long long* maxc, long long* ids,
                                   void* grid, void* stream) {
  if (dim < 2 || dim > 3) return static_cast<int>(cudaErrorInvalidValue);
  ids_kernel<<<n > 0 ? blocks_for(n) : 1, kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      cx, n, dim, maxc, ids, static_cast<NbrGrid*>(grid));
  return static_cast<int>(cudaGetLastError());
}

// One pass over the n points in sorted order (ids / order: the stable sort
// of the linear ids). neighbors null: counts[i] gets point i's neighbor
// count. Else neighbors (n, k) int32 gets each row, its first k neighbors
// (k at least the largest count) and -1 after them; counts is not read.
// Launches on `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError().
extern "C" int vr_neighborhood_rows(const float* pts, long long n, int cols,
                                    int dim, const long long* cx,
                                    const long long* ids,
                                    const long long* order, const void* grid,
                                    double distance, double dist2, int* counts,
                                    int* neighbors, int k, void* stream) {
  return launch_rows<float>(pts, n, cols, dim, cx, ids, order, grid, distance,
                            dist2, counts, neighbors, k, stream);
}

extern "C" int vr_neighborhood_rows_f64(const double* pts, long long n,
                                        int cols, int dim,
                                        const long long* cx,
                                        const long long* ids,
                                        const long long* order,
                                        const void* grid, double distance,
                                        double dist2, int* counts,
                                        int* neighbors, int k, void* stream) {
  return launch_rows<double>(pts, n, cols, dim, cx, ids, order, grid,
                             distance, dist2, counts, neighbors, k, stream);
}
