// The point neighborhood's per-point work: a point's cell coordinates, the
// grid of cells and its neighbor offsets, and the pair test over the cells
// around a point. neighborhood.cu launches them; the tests compile this
// header for the host as well (tests/test_torch_neighborhood.py), so the
// kernels' logic is checked without a card.
//
// Every step is the compiled host helper's (native/host_accel.cpp,
// vr_build_neighborhood), operation by operation, so the table is its table
// bit for bit: float64 arithmetic on the widened points through the
// round-to-nearest intrinsics (the helper is built with -ffp-contract=off,
// and nvcc would otherwise contract d2 + diff * diff into a fused
// multiply-add), the same cells, int64 linear ids and offsets, and the
// members of each cell visited in the order of a stable sort of the ids.
#pragma once

// The cells of a build: linear id = sum over the first dim axes of c[d]
// stride[d]; offs[0 .. n_offs) are the 3^dim linear offsets of the cells
// around a cell, ascending and distinct (where an axis spans one or two
// cells, distinct per-axis offsets alias to one linear offset, whose cell,
// visited twice, would list its members twice; as the helper's, the
// offsets are deduplicated, though nbr_row's search, which starts past the
// cells already visited, would find such a cell empty the second time).
// 32 words, as the wrapper allocates.
struct NbrGrid {
  long long stride[3];
  long long n_cells;
  long long offs[27];
  long long n_offs;
};

// One axis's cell coordinate: floor((p - lo) / distance), as the helper
// computes it, (p - lo) * (1 / distance) in float64.
template <class T>
__device__ __forceinline__ long long nbr_cell(T p, T lo, double inv_cell) {
  return (long long)floor(
      __dmul_rn(__dsub_rn((double)p, (double)lo), inv_cell));
}

// The grid from the largest cell coordinate of each axis (maxc): spans
// maxc + 1, strides (the last axis 1), the cell count, and the offsets
// sorted and deduplicated.
__device__ __forceinline__ void nbr_grid(const long long* maxc, int dim,
                                         NbrGrid* g) {
  long long stride[3] = {1, 1, 1};
  for (int d = dim - 2; d >= 0; --d) {
    stride[d] = stride[d + 1] * (maxc[d + 1] + 1);
  }
  for (int d = 0; d < 3; ++d) g->stride[d] = stride[d];
  g->n_cells = stride[0] * (maxc[0] + 1);
  int n = 0;
  const int combos = dim == 2 ? 9 : 27;
  for (int c = 0; c < combos; ++c) {
    long long off = 0;
    int rest = c;
    for (int d = dim - 1; d >= 0; --d) {  // axis dim - 1 varies fastest
      off += (rest % 3 - 1) * stride[d];
      rest /= 3;
    }
    int at = n;  // insertion into the sorted, distinct prefix
    while (at > 0 && g->offs[at - 1] > off) --at;
    if (at > 0 && g->offs[at - 1] == off) continue;
    for (int k = n; k > at; --k) g->offs[k] = g->offs[k - 1];
    g->offs[at] = off;
    ++n;
  }
  g->n_offs = n;
}

// The linear id of cell coordinates c (3 words, the first dim used), with
// the strides the grid takes from maxc.
__device__ __forceinline__ long long nbr_id(const long long* c,
                                            const long long* maxc, int dim) {
  long long stride = 1, id = 0;
  for (int d = dim - 1; d >= 0; --d) {
    id += c[d] * stride;
    stride *= maxc[d] + 1;
  }
  return id;
}

// The first position in ids[lo, n) whose id is not below `key` (n if none).
__device__ __forceinline__ long long nbr_lower_bound(const long long* ids,
                                                     long long lo, long long n,
                                                     long long key) {
  long long hi = n;
  while (lo < hi) {
    const long long mid = lo + (hi - lo) / 2;
    if (ids[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Point i's neighbors, in the helper's order: every j != i in the cells
// around i's (cell ci), cell by cell in ascending linear id and each cell's
// members in sorted order, with |p_i - p_j| <= distance on every axis,
// d2 = sum of diff^2 in axis order <= dist2, and cells adjacent on every
// axis (a linear offset can wrap into another row of cells). pts: (n, cols)
// of T, read at the first dim columns; cx: (n, 3) cell coordinates;
// ids / order: the stable sort of the linear ids and its permutation.
// emit(c, j) takes the c-th neighbor; returns the count.
template <class T, class Emit>
__device__ __forceinline__ int nbr_row(
    long long i, long long ci, const T* __restrict__ pts, int cols, int dim,
    const long long* __restrict__ cx, const long long* __restrict__ ids,
    const long long* __restrict__ order, long long n, const NbrGrid* g,
    double distance, double dist2, Emit emit) {
  double pi[3];
  for (int d = 0; d < dim; ++d) pi[d] = (double)pts[i * cols + d];
  const long long n_cells = g->n_cells;
  const int n_offs = (int)g->n_offs;
  int count = 0;
  // every id before `from` lies below the cells still to visit; a cell
  // right after the last one scanned starts at `from` without a search
  long long from = 0, next_cell = -1;
  for (int o = 0; o < n_offs; ++o) {
    const long long cj = ci + g->offs[o];
    if (cj < 0 || cj >= n_cells) continue;
    long long s = cj == next_cell ? from : nbr_lower_bound(ids, from, n, cj);
    for (; s < n && ids[s] == cj; ++s) {
      const long long j = order[s];
      if (j == i) continue;
      bool ok = true;
      double d2 = 0.0;
      for (int d = 0; d < dim; ++d) {
        const double diff = __dsub_rn(pi[d], (double)pts[j * cols + d]);
        if (fabs(diff) > distance) {
          ok = false;
          break;
        }
        d2 = __dadd_rn(d2, __dmul_rn(diff, diff));
      }
      if (!ok || d2 > dist2) continue;
      bool adjacent = true;
      for (int d = 0; d < dim; ++d) {
        const long long dd = cx[i * 3 + d] - cx[j * 3 + d];
        if (dd < -1 || dd > 1) {
          adjacent = false;
          break;
        }
      }
      if (!adjacent) continue;
      emit(count, j);
      ++count;
    }
    from = s;
    next_cell = cj + 1;
  }
  return count;
}
