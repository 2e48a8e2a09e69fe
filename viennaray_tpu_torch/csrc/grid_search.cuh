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
// The sequential walk (ops/grid_traverse.py:grid_walk_ref says it op by op)
// holds after cell s the lexicographic minimum of (t, lane) over the bound
// (lane -1) and the hits of cells 0..s, and stops at the first s where
// t_best < t_exit, t_exit >= bound, t_exit >= BIG, the next step leaves the
// grid, or s + 1 reaches the cap. So its result is that minimum at that s.
//
// Mapping: a warp per ray, which walks kWalkCells (W) cells a round. A walk
// is latency-bound: walked cell by cell, each cell waits on its entries,
// then on their SoA lanes, then on a reduction, before the next cell is
// read, and a cell holds fewer than one primitive on average (51.6 cells
// and 35.7 pairs a search at 704,250 disks), so 31 of 32 threads would idle
// through two dependent round trips a cell. A round does:
// 1. Thread l finds the cell at step base + l and its t_exit by stepping the
//    DDA l times from the round's first cell in registers (the sequential
//    walk's arithmetic, face times from the cell index; no memory read),
//    and the static part of the stop rule there (t_exit >= bound or BIG,
//    the next step leaves the grid, the cap). Cells after the first static
//    stop are never read.
// 2. Each thread reads its cell's [start, end) from the compact table
//    (GridWalk::start, GridWalk::lanes: geometry/grid_accel.py:
//    compact_table): one round trip for W cells, on a table that fits in
//    L2 (7.1 MB of starts and 7.7 MB of entries at 704,250 disks, where the
//    padded table takes 299 MB).
// 3. A shuffle prefix sum of the counts numbers the round's (cell, slot)
//    pairs in walk order; the warp tests them 32 at a time (pair p on
//    thread p mod 32; its cell by a binary search of the offsets by
//    shuffle), staging each lane and putting it through the same Kind::hit.
// 4. An inclusive prefix minimum of (t, lane) over the pairs, in walk
//    order and seeded with the running best, is the sequential walk's state
//    after each cell: cell s reads it at its last pair. A ballot of the stop
//    rule over the cells whose state is known finds the first cell where
//    the sequential walk stops; the walk stops testing pairs there.
// 5. The result is the state at that cell. Only a round without a stop goes
//    on, from the cell after its last.
// The same values, the same stopping cell: bit for bit the sequential walk,
// and the counts too: visited is the stopping cell's step + 1, tested the
// pairs of the visited cells; pairs tested past the stopping cell (in the
// stopping cell's last batch of 32) are counted apart as wasted.
#pragma once

#include "prim_search.cuh"
#include "scalar.cuh"

// cells a warp walks a round, W (PERF.md holds the H100's A/B of 8, 16 and
// 32, chip_diagnose.py --walk-cells)
constexpr int kWalkCells = 32;
static_assert(kWalkCells >= 1 && kWalkCells <= 32, "a round fits a warp");

// The walk's compact table on the device, in the scalar of the search.
template <class T>
struct GridWalk {
  const int* start;  // (nx ny nz + 1,) cell c's entries: [start[c], start[c+1])
  const int* lanes;  // (entries,) sorted lanes, cell after cell
  int nx, ny, nz;    // cells along x, y, z (nz = 1: the 2D grid)
  T ox, oy, oz;      // the grid's minimum corner
  T cs;              // the cell size
};

// What a walk did: cells visited (the sequential count), pairs of the
// visited cells, and pairs tested past the stopping cell.
struct WalkCounts {
  int visited;
  int tested;
  int wasted;
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

// (t, lane) a before b: the lower t, then the lower lane
template <class T>
__device__ __forceinline__ bool walk_before(T at, int al, T bt, int bl) {
  return at < bt || (at == bt && al < bl);
}

// The DDA's place: a cell and the crossing times of its far faces.
template <class T>
struct DdaCell {
  int cx, cy, cz;
  T tx, ty, tz;
};

// The ray's constants of the walk.
template <class T>
struct DdaRay {
  T ox, oy, oz, ix, iy, iz;
  int sx, sy, sz;
};

// The axis the walk steps along after cell c (x before y before z on a tie)
template <class T>
__device__ __forceinline__ int dda_axis(const DdaCell<T>& c) {
  return (c.tx <= c.ty && c.tx <= c.tz) ? 0 : (c.ty <= c.tz ? 1 : 2);
}

// Whether the step after cell c leaves the grid
template <class T>
__device__ __forceinline__ bool dda_leaves(const DdaCell<T>& c,
                                           const DdaRay<T>& r,
                                           const GridWalk<T>& g) {
  const int a = dda_axis(c);
  if (a == 0) return c.cx + r.sx < 0 || c.cx + r.sx >= g.nx;
  if (a == 1) return c.cy + r.sy < 0 || c.cy + r.sy >= g.ny;
  return c.cz + r.sz < 0 || c.cz + r.sz >= g.nz;
}

// One step of the walk, in place; the stepped axis' face time recomputed
// from the new index (face_time), the others as they were.
template <class T>
__device__ __forceinline__ void dda_step(DdaCell<T>& c, const DdaRay<T>& r,
                                         const GridWalk<T>& g) {
  const int a = dda_axis(c);
  if (a == 0) {
    c.cx += r.sx;
    c.tx = face_time(c.cx, r.sx, g.ox, g.cs, r.ox, r.ix);
  } else if (a == 1) {
    c.cy += r.sy;
    c.ty = face_time(c.cy, r.sy, g.oy, g.cs, r.oy, r.iy);
  } else {
    c.cz += r.sz;
    c.tz = face_time(c.cz, r.sz, g.oz, g.cs, r.oz, r.iz);
  }
}

// Every thread of a warp calls it with the same ray and bound (G = 32: the
// warp is the group); gl is the thread's lane. On entry tmin is the bound;
// on return every thread holds the same (tmin, idx): the closest hit below
// the bound (idx its sorted lane), or tmin unchanged and idx -1; and the
// walk's counts.
template <class Kind, int G>
__device__ __forceinline__ void grid_search_group(
    typename Kind::Scalar ox, typename Kind::Scalar oy,
    typename Kind::Scalar oz, typename Kind::Scalar dx,
    typename Kind::Scalar dy, typename Kind::Scalar dz,
    const typename Kind::Scalar* __restrict__ prims, int npad,
    const GridWalk<typename Kind::Scalar>& g, typename Kind::Scalar t_near,
    int gl, typename Kind::Scalar& tmin, int& idx, WalkCounts& counts) {
  static_assert(G == 32, "the grid walk runs a warp per ray");
  using T = typename Kind::Scalar;
  constexpr unsigned kFull = 0xffffffffu;
  constexpr int kNone = 0x7fffffff;  // a pair that is no hit
  const T big = Const<T>::big();
  const bool flat = g.nz == 1;
  idx = -1;
  counts = WalkCounts{0, 0, 0};
  const T bound = tmin;
  DdaRay<T> r;
  r.ox = ox;
  r.oy = oy;
  r.oz = oz;
  r.ix = safe_inv(dx);
  r.iy = safe_inv(dy);
  r.iz = safe_inv(dz);
  const T hx = add_rn(g.ox, mul_rn(g.cs, T(g.nx)));
  const T hy = add_rn(g.oy, mul_rn(g.cs, T(g.ny)));
  const T hz = add_rn(g.oz, mul_rn(g.cs, T(g.nz)));
  T t_lo = -big, t_hi = big;
  slab_clip(ox, dx, r.ix, g.ox, hx, t_lo, t_hi);
  slab_clip(oy, dy, r.iy, g.oy, hy, t_lo, t_hi);
  if (!flat) slab_clip(oz, dz, r.iz, g.oz, hz, t_lo, t_hi);
  const T t_enter = vmax(t_lo, T(0));
  if (t_enter > t_hi) return;  // the ray misses the grid

  const T te = add_rn(t_enter, mul_rn(T(1e-6), g.cs));
  r.sx = dx > T(0) ? 1 : (dx < T(0) ? -1 : 0);
  r.sy = dy > T(0) ? 1 : (dy < T(0) ? -1 : 0);
  r.sz = flat ? 0 : (dz > T(0) ? 1 : (dz < T(0) ? -1 : 0));
  DdaCell<T> base;
  base.cx = cell_of(add_rn(ox, mul_rn(te, dx)), g.ox, g.cs, g.nx);
  base.cy = cell_of(add_rn(oy, mul_rn(te, dy)), g.oy, g.cs, g.ny);
  base.cz = flat ? 0 : cell_of(add_rn(oz, mul_rn(te, dz)), g.oz, g.cs, g.nz);
  base.tx = face_time(base.cx, r.sx, g.ox, g.cs, ox, r.ix);
  base.ty = face_time(base.cy, r.sy, g.oy, g.cs, oy, r.iy);
  base.tz = face_time(base.cz, r.sz, g.oz, g.cs, oz, r.iz);
  const int max_steps = g.nx + g.ny + g.nz + 3;
  const bool in_round = gl < kWalkCells;

  T best_t = bound;  // the running state: the bound and no lane
  int best_l = -1;
  for (int step0 = 0;; step0 += kWalkCells) {
    // ---- 1. this thread's cell, step0 + gl, in registers ----------------
    DdaCell<T> c = base;
    for (int k = 0; k < gl && k < kWalkCells; ++k) dda_step(c, r, g);
    const T t_exit = vmin(vmin(c.tx, c.ty), c.tz);
    // the stop rule's part that does not depend on the hits; a thread past
    // the round's cells stops (and is never reached)
    const bool fixed_stop = !in_round || t_exit >= bound || t_exit >= big ||
                            step0 + gl + 1 >= max_steps ||
                            dda_leaves(c, r, g);
    const unsigned fixed = __ballot_sync(kFull, fixed_stop);
    // reached: no fixed stop before this cell (so the cell lies in the grid
    // and below the cap)
    const bool reached = in_round && (fixed & ((1u << gl) - 1u)) == 0u;

    // ---- 2. the cell's entries ------------------------------------------
    int first = 0, n = 0;
    if (reached) {
      const int cell = (c.cx * g.ny + c.cy) * g.nz + c.cz;
      first = g.start[cell];
      n = g.start[cell + 1] - first;
    }
    // ---- 3. the round's pairs in walk order: [lo, end) are this cell's, its
    // pair p the entry at p + shift --------------------------------------
    int end = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, end, o);
      if (gl >= o) end += y;
    }
    const int lo = end - n;
    const int shift = first - lo;
    const int total = __shfl_sync(kFull, end, 31);

    // ---- 4. the state after each cell; the first cell that stops -------
    T cell_t = best_t;  // the state after this cell, once known
    int cell_l = best_l;
    bool known = end == 0;
    unsigned stops = __ballot_sync(
        kFull, reached && known && (fixed_stop || cell_t < t_exit));
    T carry_t = best_t;
    int carry_l = best_l;
    int done = 0;  // pairs tested
    for (int p0 = 0; stops == 0u && p0 < total; p0 += 32) {
      const int p = p0 + gl;
      // the cell of pair p: the last cell whose first pair is at most p
      int owner = 0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        if (__shfl_sync(kFull, lo, owner + o) <= p) owner += o;
      }
      const int owner_shift = __shfl_sync(kFull, shift, owner);
      T pt = big;
      int pl = kNone;
      if (p < total) {
        const int lane = g.lanes[p + owner_shift];
        typename Kind::Staged st[Kind::kVec];
        Kind::stage(st, prims, npad, lane);
        T t;
        // the sequential walk takes no hit at or past the bound
        if (Kind::hit(st, ox, oy, oz, dx, dy, dz, t_near, t) && t < bound) {
          pt = t;
          pl = lane;
        }
      }
      // inclusive prefix minimum over the batch, then the carry before it
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const T ut = __shfl_up_sync(kFull, pt, o);
        const int ul = __shfl_up_sync(kFull, pl, o);
        if (gl >= o && walk_before(ut, ul, pt, pl)) {
          pt = ut;
          pl = ul;
        }
      }
      if (walk_before(carry_t, carry_l, pt, pl)) {
        pt = carry_t;
        pl = carry_l;
      }
      carry_t = __shfl_sync(kFull, pt, 31);
      carry_l = __shfl_sync(kFull, pl, 31);
      done = min(total, p0 + 32);
      // a cell whose last pair lies in this batch reads its state there
      const int src = (end - 1 - p0) & 31;
      const T st_t = __shfl_sync(kFull, pt, src);
      const int st_l = __shfl_sync(kFull, pl, src);
      if (!known && end <= p0 + 32) {
        cell_t = st_t;
        cell_l = st_l;
        known = true;
      }
      stops = __ballot_sync(
          kFull, reached && known && (fixed_stop || cell_t < t_exit));
    }

    // ---- 5. finish at the first stop, or go on -------------------------
    if (stops != 0u) {
      const int s = __ffs(stops) - 1;
      tmin = __shfl_sync(kFull, cell_t, s);
      idx = __shfl_sync(kFull, cell_l, s);
      const int pairs = __shfl_sync(kFull, end, s);
      counts.visited = step0 + s + 1;
      counts.tested += pairs;
      counts.wasted += done - pairs;
      return;
    }
    // no cell of the round stops: each was reached and passed
    best_t = carry_t;
    best_l = carry_l;
    counts.tested += total;
    const int last = kWalkCells - 1;
    dda_step(c, r, g);  // the cell after the round's last (its thread's)
    base.cx = __shfl_sync(kFull, c.cx, last);
    base.cy = __shfl_sync(kFull, c.cy, last);
    base.cz = __shfl_sync(kFull, c.cz, last);
    base.tx = __shfl_sync(kFull, c.tx, last);
    base.ty = __shfl_sync(kFull, c.ty, last);
    base.tz = __shfl_sync(kFull, c.tz, last);
  }
}

// The same without the counts but the cells visited.
template <class Kind, int G>
__device__ __forceinline__ void grid_search_group(
    typename Kind::Scalar ox, typename Kind::Scalar oy,
    typename Kind::Scalar oz, typename Kind::Scalar dx,
    typename Kind::Scalar dy, typename Kind::Scalar dz,
    const typename Kind::Scalar* __restrict__ prims, int npad,
    const GridWalk<typename Kind::Scalar>& g, typename Kind::Scalar t_near,
    int gl, typename Kind::Scalar& tmin, int& idx, int& visited) {
  WalkCounts counts;
  grid_search_group<Kind, G>(ox, oy, oz, dx, dy, dz, prims, npad, g, t_near,
                             gl, tmin, idx, counts);
  visited = counts.visited;
}
