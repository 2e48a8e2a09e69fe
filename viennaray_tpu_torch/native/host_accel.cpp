// Native host-side geometry preprocessing.
//
// The port's own copy of viennaray_tpu/native/host_accel.cpp, the counterpart
// of the reference's C++ host structures: the point neighborhood build
// (rayPointNeighborhood.hpp: median-split / hash grid) and the
// acceleration-grid insertion. The neighborhood is an O(N) pass that
// dominates geometry setup for large level-set clouds, so like the reference
// it runs in native code; the numpy implementation stays as the fallback and
// the tests' yardstick (geometry/neighborhood.py:build_neighborhood_numpy),
// and both give the same table, counts and row order.
//
// Exposed via ctypes (viennaray_tpu_torch/utils/native.py); plain C ABI:
// vr_build_neighborhood (build_neighborhood_native) and vr_build_grid
// (build_grid_native), the cell insertion of the uniform grid that the grid
// DDA walks (viennaray_tpu_torch/geometry/grid_accel.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Neighborhood: all pairs within `distance` (inclusive), per-axis prefilter
// then squared-norm test over the first `dim` coordinates — the reference's
// membership predicate (rayPointNeighborhood.hpp:287-298).
//
// Two-phase: count degrees, then fill a padded (n, k_max) matrix (-1 padded).
// Returns k_max; counts must hold n entries. If neighbors==nullptr only the
// counting pass runs (caller then allocates n*k_max and calls again).
// ---------------------------------------------------------------------------
int64_t vr_build_neighborhood(
    const double* points,  // (n, 3) row-major
    int64_t n,
    int32_t dim,
    double distance,
    int32_t* counts,      // (n,) out
    int32_t* neighbors,   // (n, k_max) out, or nullptr for counting pass
    int64_t k_max_in) {
  if (n == 0 || distance <= 0) return 0;
  const double dist2 = distance * distance;
  const double inv_cell = 1.0 / distance;

  // cell coordinates
  double mins[3] = {1e300, 1e300, 1e300};
  for (int64_t i = 0; i < n; ++i)
    for (int d = 0; d < dim; ++d)
      if (points[i * 3 + d] < mins[d]) mins[d] = points[i * 3 + d];

  std::vector<int64_t> cell(n);
  int64_t span[3] = {1, 1, 1};
  std::vector<int64_t> cx(n * dim);
  int64_t maxc[3] = {0, 0, 0};
  for (int64_t i = 0; i < n; ++i)
    for (int d = 0; d < dim; ++d) {
      int64_t c = (int64_t)std::floor((points[i * 3 + d] - mins[d]) * inv_cell);
      cx[i * dim + d] = c;
      if (c > maxc[d]) maxc[d] = c;
    }
  for (int d = 0; d < dim; ++d) span[d] = maxc[d] + 1;
  int64_t stride[3] = {1, 1, 1};
  for (int d = dim - 2; d >= 0; --d) stride[d] = stride[d + 1] * span[d + 1];
  for (int64_t i = 0; i < n; ++i) {
    int64_t lin = 0;
    for (int d = 0; d < dim; ++d) lin += cx[i * dim + d] * stride[d];
    cell[i] = lin;
  }

  // counting sort by cell
  const int64_t n_cells = stride[0] * span[0];
  std::vector<int64_t> cell_start(n_cells + 1, 0);
  for (int64_t i = 0; i < n; ++i) cell_start[cell[i] + 1]++;
  for (int64_t c = 0; c < n_cells; ++c) cell_start[c + 1] += cell_start[c];
  std::vector<int64_t> order(n);
  {
    std::vector<int64_t> cur(cell_start.begin(), cell_start.end() - 1);
    for (int64_t i = 0; i < n; ++i) order[cur[cell[i]]++] = i;
  }

  std::memset(counts, 0, sizeof(int32_t) * n);
  const bool fill = neighbors != nullptr;
  if (fill)
    for (int64_t i = 0; i < n * k_max_in; ++i) neighbors[i] = -1;

  // neighbor cell offsets (3^dim). When an axis span collapses to 1 (flat
  // geometry), distinct (a,b,c) tuples alias to the SAME linear cell; visiting
  // it repeatedly would duplicate every neighbor pair — dedupe the offsets.
  int64_t offs[27];
  int n_offs = 0;
  if (dim == 2) {
    for (int a = -1; a <= 1; ++a)
      for (int b = -1; b <= 1; ++b) offs[n_offs++] = a * stride[0] + b;
  } else {
    for (int a = -1; a <= 1; ++a)
      for (int b = -1; b <= 1; ++b)
        for (int c = -1; c <= 1; ++c)
          offs[n_offs++] = a * stride[0] + b * stride[1] + c;
  }
  std::sort(offs, offs + n_offs);
  n_offs = (int)(std::unique(offs, offs + n_offs) - offs);

  int64_t k_max = 0;
  for (int64_t i = 0; i < n; ++i) {
    const double* pi = points + i * 3;
    const int64_t ci = cell[i];
    for (int o = 0; o < n_offs; ++o) {
      const int64_t cj = ci + offs[o];
      if (cj < 0 || cj >= n_cells) continue;
      // offset wrap guard: verify per-axis adjacency
      // (linear offsets can wrap rows; recompute per-axis distance)
      for (int64_t s = cell_start[cj]; s < cell_start[cj + 1]; ++s) {
        const int64_t j = order[s];
        if (j == i) continue;
        const double* pj = points + j * 3;
        bool ok = true;
        double d2 = 0;
        for (int d = 0; d < dim; ++d) {
          const double diff = pi[d] - pj[d];
          if (std::fabs(diff) > distance) { ok = false; break; }
          d2 += diff * diff;
        }
        if (!ok || d2 > dist2) continue;
        // also confirm the cells really are axis-adjacent (wrap guard)
        bool adj = true;
        for (int d = 0; d < dim; ++d) {
          int64_t dd = cx[i * dim + d] - cx[j * dim + d];
          if (dd < -1 || dd > 1) { adj = false; break; }
        }
        if (!adj) continue;
        const int32_t ki = counts[i]++;
        if (fill && ki < k_max_in) neighbors[i * k_max_in + ki] = (int32_t)j;
        if (counts[i] > k_max) k_max = counts[i];
      }
    }
  }
  return k_max;
}

// ---------------------------------------------------------------------------
// Uniform-grid insertion: prims into all overlapped cells.
// Phase 1 (cells==nullptr): fill cell_counts, return max per cell.
// Phase 2: fill padded (n_cells, k) matrix with -1 padding.
// ---------------------------------------------------------------------------
int64_t vr_build_grid(
    const double* prim_lo,  // (n, 3)
    const double* prim_hi,  // (n, 3)
    int64_t n,
    int32_t dim,
    const double* origin,  // (3,)
    double cell_size,
    const int64_t* dims,  // (3,)
    int32_t* cell_counts,  // (n_cells,) out
    int32_t* cells,        // (n_cells, k) out or nullptr
    int64_t k_in) {
  const int64_t nx = dims[0], ny = dims[1], nz = dims[2];
  const int64_t n_cells = nx * ny * nz;
  const double inv = 1.0 / cell_size;
  const bool fill = cells != nullptr;
  std::memset(cell_counts, 0, sizeof(int32_t) * n_cells);
  if (fill)
    for (int64_t i = 0; i < n_cells * k_in; ++i) cells[i] = -1;

  int64_t k_max = 0;
  for (int64_t p = 0; p < n; ++p) {
    int64_t lo[3] = {0, 0, 0}, hi[3] = {0, 0, 0};
    for (int d = 0; d < 3; ++d) {
      if (d == 2 && dim == 2) { lo[2] = hi[2] = 0; continue; }
      int64_t cl = (int64_t)std::floor((prim_lo[p * 3 + d] - origin[d]) * inv);
      int64_t ch = (int64_t)std::floor((prim_hi[p * 3 + d] - origin[d]) * inv);
      const int64_t dmax = (d == 0 ? nx : d == 1 ? ny : nz) - 1;
      lo[d] = cl < 0 ? 0 : (cl > dmax ? dmax : cl);
      hi[d] = ch < 0 ? 0 : (ch > dmax ? dmax : ch);
    }
    for (int64_t x = lo[0]; x <= hi[0]; ++x)
      for (int64_t y = lo[1]; y <= hi[1]; ++y)
        for (int64_t z = lo[2]; z <= hi[2]; ++z) {
          const int64_t c = x * ny * nz + y * nz + z;
          const int32_t k = cell_counts[c]++;
          if (fill && k < k_in) cells[c * k_in + k] = (int32_t)p;
          if (cell_counts[c] > k_max) k_max = cell_counts[c];
        }
  }
  return k_max;
}

}  // extern "C"
