// Closest hit of one ray below a bound by a walk of the uniform grid (the
// grid DDA); shared by the grid's closest-hit kernel (grid_traverse.cu) and
// the bounce kernel's grid search (bounce_kernel.cuh).
//
// What it computes: what prim_search_group computes on the same ray, bound
// and SoA, bit for bit: the lexicographic minimum of (t, sorted lane) over
// the pairs that the kind's exact test (Kind::hit: disk_hit.cuh,
// tri_hit.cuh) accepts below the bound. Only which pairs are tested
// differs: the lanes of the cells the ray walks through, not those of the
// chunks it cannot rule out.
//
// The walk is the JAX package's (viennaray_tpu/ops/grid_traverse.py:64-169)
// on the walk's table (geometry/grid_accel.py:walk_table): clip the ray to
// the grid's box (slab test; a direction component of 0 keeps the slab when
// the origin lies in it), start in the cell of o + (t_enter + 1e-6 cs) d,
// and step along the axis whose far face the ray crosses first (x before y
// before z on a tie), at most nx + ny + nz + 3 cells. In 2D (the table has
// one layer of cells along z) z never steps and takes no part in the clip.
// Two changes, each for the bitwise contract:
// - the crossing time of a cell's far face, (wo + i cs - o) / d for face i,
//   is computed from the cell's index in every cell, not accumulated by
//   adding cs / |d| per step, so that its error does not grow along the
//   walk (the margin argument of grid_accel.py:walk_margin takes it);
// - the walk stops after a cell where t_best < t_exit, strictly, or where
//   t_exit >= the bound. The JAX package stops where t_best <= t_exit, which
//   can stop before a cell that holds a lane of equal t and lower number.
// A pair found in a cell is final only once the walk has passed its t; the
// table's widened boxes (walk_margin) put every pair the exhaustive search
// selects into a cell the walk visits at its t.
//
// Mapping: G threads walk for one ray (G a power of two, 1 to 32; both
// kernels launch it at G = 32, a warp per ray; all hold the same ray and
// take the same steps, so the walk needs no vote). In each
// cell thread l tests slots l, l + G, ... of the cell's row of the table (a
// row's lanes lie first, -1 after them), reading the SoA lane straight from
// global memory, then the group takes the lexicographic minimum of (t, lane)
// over its threads with __shfl_xor_sync (none at G = 1), as
// prim_search_group does after each chunk.
#pragma once

#include "prim_search.cuh"
#include "scalar.cuh"

// The walk's table on the device, in the scalar of the search.
template <class T>
struct GridWalk {
  const int* lanes;  // (nx ny nz, k) sorted lanes, -1 after a row's lanes
  int k;             // slots a cell
  int nx, ny, nz;    // cells along x, y, z (nz = 1: the 2D grid)
  T ox, oy, oz;      // the grid's minimum corner
  T cs;              // the cell size
};

// One axis of the slab clip: [lo, hi] of the ray's t within the axis' slab
// [o_a, o_a + cs n], intersected into t_lo / t_hi.
template <class T>
__device__ __forceinline__ void slab_clip(T o, T d, T inv, T lo, T hi,
                                          T& t_lo, T& t_hi) {
  T a, b;
  if (d == T(0)) {
    const bool inside = o >= lo && o <= hi;
    a = inside ? -Const<T>::big() : Const<T>::big();
    b = inside ? Const<T>::big() : -Const<T>::big();
  } else {
    const T t0 = mul_rn(sub_rn(lo, o), inv);
    const T t1 = mul_rn(sub_rn(hi, o), inv);
    a = vmin(t0, t1);
    b = vmax(t0, t1);
  }
  t_lo = vmax(t_lo, a);
  t_hi = vmin(t_hi, b);
}

// The cell of coordinate p along an axis of n cells from lo: floor((p - lo)
// / cs), clamped to [0, n - 1].
template <class T>
__device__ __forceinline__ int cell_of(T p, T lo, T cs, int n) {
  const T q = floor(div_rn(sub_rn(p, lo), cs));
  const int c = q < T(0) ? 0 : (q > T(n - 1) ? n - 1 : (int)q);
  return c;
}

// The crossing time of the far face of cell c along an axis (step s = +1 or
// -1; BIG where s = 0): (lo + (c + [s > 0]) cs - o) * inv.
template <class T>
__device__ __forceinline__ T face_time(int c, int s, T lo, T cs, T o, T inv) {
  if (s == 0) return Const<T>::big();
  const T face = add_rn(lo, mul_rn(T(c + (s > 0 ? 1 : 0)), cs));
  return mul_rn(sub_rn(face, o), inv);
}

// Every thread of a group calls it with the same ray and bound; gl is the
// thread's place in the group. On entry tmin is the bound; on return every
// thread of the group holds the same (tmin, idx): the closest hit below the
// bound (idx its sorted lane), or tmin unchanged and idx -1. visited: the
// cells the walk tested.
template <class Kind, int G>
__device__ __forceinline__ void grid_search_group(
    typename Kind::Scalar ox, typename Kind::Scalar oy,
    typename Kind::Scalar oz, typename Kind::Scalar dx,
    typename Kind::Scalar dy, typename Kind::Scalar dz,
    const typename Kind::Scalar* __restrict__ prims, int npad,
    const GridWalk<typename Kind::Scalar>& g, typename Kind::Scalar t_near,
    int gl, typename Kind::Scalar& tmin, int& idx, int& visited) {
  using T = typename Kind::Scalar;
  const unsigned mask = group_mask<G>();
  const T big = Const<T>::big();
  const bool flat = g.nz == 1;
  idx = -1;
  visited = 0;
  const T bound = tmin;
  const T ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  const T hx = add_rn(g.ox, mul_rn(g.cs, T(g.nx)));
  const T hy = add_rn(g.oy, mul_rn(g.cs, T(g.ny)));
  const T hz = add_rn(g.oz, mul_rn(g.cs, T(g.nz)));
  T t_lo = -big, t_hi = big;
  slab_clip(ox, dx, ix, g.ox, hx, t_lo, t_hi);
  slab_clip(oy, dy, iy, g.oy, hy, t_lo, t_hi);
  if (!flat) slab_clip(oz, dz, iz, g.oz, hz, t_lo, t_hi);
  const T t_enter = vmax(t_lo, T(0));
  if (t_enter > t_hi) return;  // the ray misses the grid

  const T te = add_rn(t_enter, mul_rn(T(1e-6), g.cs));
  int cx = cell_of(add_rn(ox, mul_rn(te, dx)), g.ox, g.cs, g.nx);
  int cy = cell_of(add_rn(oy, mul_rn(te, dy)), g.oy, g.cs, g.ny);
  int cz = flat ? 0 : cell_of(add_rn(oz, mul_rn(te, dz)), g.oz, g.cs, g.nz);
  const int sx = dx > T(0) ? 1 : (dx < T(0) ? -1 : 0);
  const int sy = dy > T(0) ? 1 : (dy < T(0) ? -1 : 0);
  const int sz = flat ? 0 : (dz > T(0) ? 1 : (dz < T(0) ? -1 : 0));
  const int max_steps = g.nx + g.ny + g.nz + 3;

  for (int step = 0; step < max_steps; ++step) {
    const T tx = face_time(cx, sx, g.ox, g.cs, ox, ix);
    const T ty = face_time(cy, sy, g.oy, g.cs, oy, iy);
    const T tz = face_time(cz, sz, g.oz, g.cs, oz, iz);
    ++visited;
    const int* row =
        g.lanes + ((size_t)((cx * g.ny + cy) * g.nz + cz)) * g.k;
    T tl = tmin;
    int il = idx;
    for (int s = gl; s < g.k; s += G) {
      const int lane = row[s];
      if (lane < 0) break;  // the row's lanes lie first
      typename Kind::Staged st[Kind::kVec];
      Kind::stage(st, prims, npad, lane);
      T t;
      if (Kind::hit(st, ox, oy, oz, dx, dy, dz, t_near, t) &&
          (t < tl || (t == tl && lane < il))) {
        tl = t;
        il = lane;
      }
    }
    // every thread starts from (tmin, idx), so the minimum over the group
    // is the running minimum of the walk; equal t: the lower lane
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) {
      const T to = __shfl_xor_sync(mask, tl, o);
      const int io = __shfl_xor_sync(mask, il, o);
      if (to < tl || (to == tl && io < il)) {
        tl = to;
        il = io;
      }
    }
    tmin = tl;
    idx = il;

    const T t_exit = vmin(vmin(tx, ty), tz);
    if (tmin < t_exit || t_exit >= bound || t_exit >= big) break;
    if (tx <= ty && tx <= tz) {
      cx += sx;
      if (cx < 0 || cx >= g.nx) break;
    } else if (ty <= tz) {
      cy += sy;
      if (cy < 0 || cy >= g.ny) break;
    } else {
      cz += sz;
      if (cz < 0 || cz >= g.nz) break;
    }
  }
}
