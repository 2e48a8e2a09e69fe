"""Closest disk or triangle hit per ray by a walk of the uniform grid (the
grid DDA): plain versions and CUDA wrappers.

Counterpart of ``viennaray_tpu/ops/grid_traverse.py``, which walks the grid
in XLA. The port walks the table of ``geometry.grid_accel.GridData`` (its
compact table of sorted SoA lanes) and tests each slot with the closest-hit
kernels' own exact test (``ops/nearest_hit.py:disk_test`` /
``triangle_test``; ``csrc/disk_hit.cuh``, ``csrc/tri_hit.cuh``), so that
(t, prim, hit) are the chunk search's (``nearest_hit.disk_nearest_hit``)
bit for bit, not the JAX package's DDA test within a tolerance.

- ``disk_grid_nearest_hit_ref`` / ``triangle_grid_nearest_hit_ref`` are the
  plain PyTorch versions (any device, float32 or float64), ``grid_walk_ref``
  the walk they share. ``grid_walk_window_ref`` is the kernels' round of W
  cells in tensor ops: the tests hold it to
  ``grid_walk_ref``, as the kernels are held to it on the card.
- ``disk_grid_nearest_hit`` / ``triangle_grid_nearest_hit`` wrap the CUDA
  kernels of ``csrc/grid_traverse.cu`` (the search is
  ``csrc/grid_search.cuh``, which says how the walk goes and why it finds
  what the chunk search finds): on a CUDA tensor they launch the kernel or
  raise, on a CPU tensor they run the plain version. Float64 rays launch the
  float64 forms, counted in ``<wrapper>.launches_f64``.
- ``with_grid`` makes either the ``search`` of ``ops/bounce.py:bounce_step``.

The plain versions repeat the kernel's float operations one tensor op each,
in its order, so that the walk visits the same cells.
"""

from __future__ import annotations

import torch

from .. import _build
from ..utils import telemetry
from ..utils.telemetry import COUNTS
from .nearest_hit import (
    BIG,
    MAX_RAYS,
    PRIM_ROWS,
    TRI_ROWS,
    disk_test,
    triangle_test,
)


def _walk_entry(org, dirn, grid):
    """Where every ray's walk starts (``csrc/grid_search.cuh``): (dims (3,)
    int64, inv (R, 3) the direction's safe reciprocal, active (R,) the ray
    meets the grid, cell (R, 3) int64 its first cell, step (R, 3) int64 the
    direction's signs, z's 0 on the 2D grid)."""
    R = org.shape[0]
    dt, dev = org.dtype, org.device
    like = dict(dtype=dt, device=dev)
    big = torch.tensor(float(BIG), **like)
    tiny = torch.tensor(1e-30, **like)
    wo, cs = grid.walk_origin, grid.cell_size
    dims = torch.tensor(grid.walk_dims, dtype=torch.int64, device=dev)
    flat = grid.walk_dims[2] == 1
    inv = 1.0 / torch.where(dirn == 0, tiny, dirn)
    hi = wo + cs * dims.to(dt)

    # slab clip to the grid's box (csrc/grid_search.cuh:slab_clip)
    t_lo = (-big).expand(R)
    t_hi = big.expand(R)
    for a in range(2 if flat else 3):
        o, d, i = org[:, a], dirn[:, a], inv[:, a]
        t0 = (wo[a] - o) * i
        t1 = (hi[a] - o) * i
        inside = (o >= wo[a]) & (o <= hi[a])
        lo_a = torch.where(d == 0, torch.where(inside, -big, big),
                           torch.minimum(t0, t1))
        hi_a = torch.where(d == 0, torch.where(inside, big, -big),
                           torch.maximum(t0, t1))
        t_lo = torch.maximum(t_lo, lo_a)
        t_hi = torch.minimum(t_hi, hi_a)
    t_enter = torch.maximum(t_lo, torch.zeros((), **like))
    active = ~(t_enter > t_hi)

    # the first cell and the steps (cell_of)
    te = t_enter + torch.tensor(1e-6, **like) * cs
    q = torch.floor(((org + te[:, None] * dirn) - wo) / cs)
    cell = torch.where(q < 0, torch.zeros((), **like),
                       torch.where(q > (dims - 1).to(dt), (dims - 1).to(dt),
                                   q)).to(torch.int64)
    step = (dirn > 0).to(torch.int64) - (dirn < 0).to(torch.int64)
    if flat:
        cell[:, 2] = 0
        step[:, 2] = 0
    return dims, inv, active, cell, step


def _table(grid):
    """The compact table for reading padded rows: (cell_start (C' + 1,)
    int64, its entries int64 followed by K' -1s, slots arange(K'))."""
    start = grid.cell_start.long()
    k = max(grid.walk_slots, 1)
    entries = torch.cat([grid.cell_lanes.long(),
                         torch.full((k,), -1, device=start.device)])
    return start, entries, torch.arange(k, device=start.device)


def _rows(table, lin):
    """Cells ``lin`` (any shape) as padded rows (..., K'): each cell's lanes
    in slot order, then -1."""
    start, entries, slots = table
    first = start[lin][..., None]
    has = slots < (start[lin + 1][..., None] - first)
    return torch.where(has, entries[first + slots], -1)


def grid_walk_ref(org, dirn, grid, prims, test, t_near, bound=None):
    """The walk of ``csrc/grid_search.cuh:grid_search_group`` for every ray
    at once: (t (R,), sorted lane (R,) int64, -1 without a hit, cells
    visited (R,) int64, pairs tested (R,) int64: the lanes of the visited
    cells). ``test(o, d, cols, t_near) -> (t, valid)`` is the
    kind's exact test on broadcastable tensors; ``bound`` (R,) the search
    bound (None: ``BIG``)."""
    R = org.shape[0]
    dt, dev = org.dtype, org.device
    big = torch.tensor(float(BIG), dtype=dt, device=dev)
    wo, cs = grid.walk_origin, grid.cell_size
    table = _table(grid)
    if bound is None:
        bound = big.expand(R)
    dims, inv, active, cell, step = _walk_entry(org, dirn, grid)

    t_best = bound.to(dt).clone()
    lane_best = torch.full((R,), -1, dtype=torch.int64, device=dev)
    visited = torch.zeros(R, dtype=torch.int64, device=dev)
    tested = torch.zeros(R, dtype=torch.int64, device=dev)
    stride = torch.stack([dims[1] * dims[2], dims[2],
                          torch.ones((), dtype=torch.int64, device=dev)])
    n_rows = prims.shape[0]
    for _ in range(int(dims.sum()) + 3):
        rays = active.nonzero().squeeze(1)
        if rays.numel() == 0:
            break
        o, d, c, s = org[rays], dirn[rays], cell[rays], step[rays]
        # crossing times of the cell's far faces (face_time)
        face = wo + (c + (s > 0).to(torch.int64)).to(dt) * cs
        tm = torch.where(s == 0, big, (face - o) * inv[rays])
        visited[rays] += 1
        row = _rows(table, (c * stride).sum(dim=1))
        cols = prims[:, torch.clamp(row, min=0)]
        t, valid = test(
            tuple(o[:, a:a + 1] for a in range(3)),
            tuple(d[:, a:a + 1] for a in range(3)),
            tuple(cols[r] for r in range(n_rows)), t_near,
        )
        valid = valid & (row >= 0)
        tested[rays] += (row >= 0).sum(dim=1)
        # the lexicographic minimum of (t, lane) over the running best and
        # the cell's valid slots
        tb, lb = t_best[rays], lane_best[rays]
        tc = torch.where(valid, t, torch.full_like(t, float("inf")))
        t_new = torch.minimum(tb, tc.amin(dim=1))
        cand = torch.where(valid & (t == t_new[:, None]), row,
                           torch.full_like(row, 1 << 40))
        lane_c = cand.amin(dim=1)
        l_new = torch.where(tb == t_new, torch.minimum(lb, lane_c), lane_c)
        t_best[rays] = t_new
        lane_best[rays] = l_new

        tx, ty, tz = tm[:, 0], tm[:, 1], tm[:, 2]
        t_exit = torch.minimum(torch.minimum(tx, ty), tz)
        stop = ((t_new < t_exit) | (t_exit >= bound[rays])
                | (t_exit >= big))
        ax = torch.where((tx <= ty) & (tx <= tz), 0,
                         torch.where(ty <= tz, 1, 2))
        c = c.clone()
        c_ax = c.gather(1, ax[:, None]).squeeze(1) + s.gather(
            1, ax[:, None]).squeeze(1)
        c.scatter_(1, ax[:, None], c_ax[:, None])
        out = (c_ax < 0) | (c_ax >= dims[ax])
        cell[rays] = c
        active[rays] = ~(stop | out)
    return t_best, lane_best, visited, tested


def _lexmin_cells(t, lane, valid):
    """Per row of (n, M) candidates, the lexicographic minimum of (t, lane)
    over the valid ones: (t (n,), lane (n,)); (inf, 2^40) where none."""
    tc = torch.where(valid, t, torch.full_like(t, float("inf")))
    t_min = tc.amin(dim=1)
    cand = torch.where(valid & (tc == t_min[:, None]), lane,
                       torch.full_like(lane, 1 << 40))
    return t_min, cand.amin(dim=1)


def grid_walk_window_ref(org, dirn, grid, prims, test, t_near, bound=None,
                         cells=32):
    """The walk of ``csrc/grid_search.cuh`` as the kernels run it, ``cells``
    (W) cells a round, for every ray at once: (t (R,), sorted lane (R,)
    int64 or -1, cells visited (R,), pairs of the visited cells (R,), pairs
    tested past the stopping cell (R,)). Used by the tests only, which hold
    its first four to ``grid_walk_ref``'s.

    A round: the W cells from the round's first by the DDA's steps (face
    times from the cell index, as ``grid_walk_ref``), the stop rule's fixed
    part in each (t_exit at or past the bound or BIG, the next step leaving
    the grid, the cap), the entries of the cells up to the first fixed stop,
    every one of their pairs tested, the running minimum of (t, lane) after
    each cell in walk order, and the first cell where the sequential rule
    stops. The kernel tests the pairs 32 at a time and stops testing in the
    batch that holds the stopping cell's last pair; the pairs it tested past
    that cell are the third count."""
    R = org.shape[0]
    dt, dev = org.dtype, org.device
    big = torch.tensor(float(BIG), dtype=dt, device=dev)
    wo, cs = grid.walk_origin, grid.cell_size
    table = _table(grid)
    start = table[0]
    if bound is None:
        bound = big.expand(R)
    bound = bound.to(dt)
    dims, inv, active, base, step = _walk_entry(org, dirn, grid)
    max_steps = int(dims.sum()) + 3

    def face_times(c, s, o, i):
        face = wo + (c + (s > 0).to(torch.int64)).to(dt) * cs
        return torch.where(s == 0, big, (face - o) * i)

    def dda_step(c, s, tm):
        """The step after cells c (n, 3): the axis of the first crossing, x
        before y before z on a tie; (next cells, that axis)."""
        tx, ty, tz = tm[:, 0], tm[:, 1], tm[:, 2]
        ax = torch.where((tx <= ty) & (tx <= tz), 0,
                         torch.where(ty <= tz, 1, 2))
        c = c.clone()
        c.scatter_add_(1, ax[:, None], s.gather(1, ax[:, None]))
        return c, ax

    t_best = bound.clone()
    lane_best = torch.full((R,), -1, dtype=torch.int64, device=dev)
    visited = torch.zeros(R, dtype=torch.int64, device=dev)
    tested = torch.zeros(R, dtype=torch.int64, device=dev)
    wasted = torch.zeros(R, dtype=torch.int64, device=dev)
    stride = torch.stack([dims[1] * dims[2], dims[2],
                          torch.ones((), dtype=torch.int64, device=dev)])
    n_rows = prims.shape[0]
    for step0 in range(0, max_steps, cells):
        rays = active.nonzero().squeeze(1)
        if rays.numel() == 0:
            break
        n = rays.numel()
        o, d, s, i = org[rays], dirn[rays], step[rays], inv[rays]
        b_ray = bound[rays]
        # 1. the round's cells, their exit times and the fixed stops
        c = base[rays]
        cell, t_exit, fixed = [], [], []
        for k in range(cells):
            if k:
                c, _ = dda_step(c, s, tm)
            tm = face_times(c, s, o, i)
            t_ex = torch.minimum(torch.minimum(tm[:, 0], tm[:, 1]), tm[:, 2])
            nxt, ax = dda_step(c, s, tm)
            n_ax = nxt.gather(1, ax[:, None]).squeeze(1)
            leaves = (n_ax < 0) | (n_ax >= dims[ax])
            cell.append(c)
            t_exit.append(t_ex)
            fixed.append((t_ex >= b_ray) | (t_ex >= big)
                         | (step0 + k + 1 >= max_steps) | leaves)
        cell = torch.stack(cell, dim=1)  # (n, W, 3)
        t_exit = torch.stack(t_exit, dim=1)
        fixed = torch.stack(fixed, dim=1)
        f = fixed.to(torch.int64)
        reached = (torch.cumsum(f, dim=1) - f) == 0
        # 2. the reached cells' entries
        lin = (cell.clamp(min=0) * stride).sum(dim=2)
        lin = torch.where(reached, lin, torch.zeros_like(lin))
        count = torch.where(reached, start[lin + 1] - start[lin],
                            torch.zeros_like(lin))
        end = torch.cumsum(count, dim=1)
        total = end[:, -1]
        # 3. every pair of the reached cells
        lane = torch.where(reached[:, :, None], _rows(table, lin),
                           -1)  # (n, W, K')
        has = (lane >= 0).reshape(n, -1)
        lane = lane.reshape(n, -1)
        cols = prims[:, lane.clamp(min=0)]
        t, valid = test(tuple(o[:, a:a + 1] for a in range(3)),
                        tuple(d[:, a:a + 1] for a in range(3)),
                        tuple(cols[r] for r in range(n_rows)), t_near)
        valid = valid & has & (t < b_ray[:, None])
        t_c, l_c = _lexmin_cells(t.reshape(n * cells, -1),
                                 lane.reshape(n * cells, -1),
                                 valid.reshape(n * cells, -1))
        t_c, l_c = t_c.reshape(n, cells), l_c.reshape(n, cells)
        # 4. the running minimum after each cell, and the first stop
        run_t, run_l = t_best[rays], lane_best[rays]
        state_t, state_l = [], []
        for k in range(cells):
            take = (t_c[:, k] < run_t) | ((t_c[:, k] == run_t)
                                         & (l_c[:, k] < run_l))
            run_t = torch.where(take, t_c[:, k], run_t)
            run_l = torch.where(take, l_c[:, k], run_l)
            state_t.append(run_t)
            state_l.append(run_l)
        state_t = torch.stack(state_t, dim=1)
        state_l = torch.stack(state_l, dim=1)
        stop = reached & (fixed | (state_t < t_exit))
        stops = stop.any(dim=1)
        at = stop.to(torch.int64).argmax(dim=1)  # the first stop
        pick = at[:, None]
        end_at = end.gather(1, pick).squeeze(1)
        # 5. finish the rays that stop; the others go on
        done = torch.where(end_at == 0, torch.zeros_like(end_at),
                           torch.minimum(total,
                                         (end_at + 31) // 32 * 32))
        fin = rays[stops]
        t_best[fin] = state_t.gather(1, pick).squeeze(1)[stops]
        lane_best[fin] = state_l.gather(1, pick).squeeze(1)[stops]
        visited[fin] = step0 + at[stops] + 1
        tested[fin] += end_at[stops]
        wasted[fin] += (done - end_at)[stops]
        on = rays[~stops]
        t_best[on] = state_t[~stops, -1]
        lane_best[on] = state_l[~stops, -1]
        tested[on] += total[~stops]
        last = cell[~stops, -1]
        base[on], _ = dda_step(last, s[~stops],
                               face_times(last, s[~stops], o[~stops],
                                          i[~stops]))
        active[fin] = False
    return t_best, lane_best, visited, tested, wasted


def _grid_ref(test, org, dirn, prims, perm, grid, t_near):
    t, lane, _, _ = grid_walk_ref(org, dirn, grid, prims, test, t_near)
    hit = lane >= 0
    prim = perm[torch.clamp(lane, min=0)]
    return t, prim, hit


def disk_grid_nearest_hit_ref(org, dirn, prims, perm, grid, t_near=1e-4):
    """Plain PyTorch version of the disk grid kernel, on any device.

    org/dirn (R, 3) f32 or f64; prims (8, Npad) of the same type; perm
    (Npad,) sorted->original; grid: the geometry's ``GridData`` in that
    type. Returns (t (R,) of org's type, prim (R,) int32 original
    numbering, hit (R,) bool): ``nearest_hit.disk_nearest_hit_ref``'s.
    """
    return _grid_ref(disk_test, org, dirn, prims, perm, grid, t_near)


def triangle_grid_nearest_hit_ref(org, dirn, prims, perm, grid,
                                  t_near=1e-4):
    """Plain PyTorch version of the triangle grid kernel, the contract of
    ``disk_grid_nearest_hit_ref`` with prims (12, Npad)."""
    return _grid_ref(triangle_test, org, dirn, prims, perm, grid, t_near)


def _check_inputs(org, dirn, prims, perm, grid, rows):
    """Shape, type, device and contiguity the kernel takes; raises otherwise."""
    if org.ndim != 2 or org.shape[1] != 3 or dirn.shape != org.shape:
        raise ValueError("org and dirn must both be (R, 3)")
    if org.shape[0] > MAX_RAYS:
        raise ValueError(f"at most {MAX_RAYS} rays, got {org.shape[0]}")
    if prims.ndim != 2 or prims.shape[0] != rows:
        raise ValueError(f"prims must be ({rows}, Npad)")
    if perm.shape != (prims.shape[1],):
        raise ValueError("perm must be (Npad,)")
    if org.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"org must be float32 or float64, got {org.dtype}")
    fdt = org.dtype
    check_grid(grid, org)
    for name, x, dt in (
        ("org", org, fdt), ("dirn", dirn, fdt), ("prims", prims, fdt),
        ("perm", perm, torch.int32),
    ):
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")
        if x.device != org.device:
            raise ValueError(f"{name} is on {x.device}, org on {org.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_grid(grid, org):
    """The grid's walk table as the kernels take it: cell_start
    (C' + 1,) and cell_lanes (entries,) int32, corner and cell size of
    org's type, on org's device; raises otherwise."""
    cells = grid.walk_dims[0] * grid.walk_dims[1] * grid.walk_dims[2]
    if grid.cell_start.shape != (cells + 1,) or grid.cell_lanes.ndim != 1:
        raise ValueError(f"the grid's compact table must be cell_start "
                         f"({cells + 1},) and cell_lanes (entries,)")
    for name, x, dt in (
        ("grid cell_start", grid.cell_start, torch.int32),
        ("grid cell_lanes", grid.cell_lanes, torch.int32),
        ("grid walk_origin", grid.walk_origin, org.dtype),
        ("grid cell_size", grid.cell_size, org.dtype),
    ):
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")
        if x.device != org.device:
            raise ValueError(f"{name} is on {x.device}, org on {org.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def walk_args(grid):
    """The kernels' grid arguments: the compact table's starts and lanes,
    nx, ny, nz, corner (3), cell size."""
    wo = grid.walk_origin.tolist()
    return (grid.cell_start.data_ptr(), grid.cell_lanes.data_ptr(),
            *grid.walk_dims, *wo, float(grid.cell_size))


def _launch(wrapper, entry, org, dirn, prims, perm, grid, t_near,
            walk_counts):
    f64 = org.dtype == torch.float64
    if f64:
        entry += "_f64"
    R = org.shape[0]
    t = torch.empty(R, dtype=org.dtype, device=org.device)
    prim = torch.empty(R, dtype=torch.int32, device=org.device)
    hit = torch.empty(R, dtype=torch.bool, device=org.device)
    lib = _build.library()
    with torch.cuda.device(org.device):
        err = getattr(lib, entry)(
            org.data_ptr(), dirn.data_ptr(), prims.data_ptr(),
            perm.data_ptr(), *walk_args(grid), R, prims.shape[1],
            float(t_near), t.data_ptr(), prim.data_ptr(), hit.data_ptr(),
            None if walk_counts is None else walk_counts.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}")
    COUNTS[wrapper + (".launches_f64" if f64 else ".launches")] += 1
    return t, prim, hit


def _check_walk_counts(walk_counts, org):
    """``walk_counts``: None, or (3,) int64 on org's CUDA device."""
    if walk_counts is None:
        return
    if org.device.type != "cuda":
        raise ValueError("walk_counts are counted by the kernel: CUDA only")
    if (walk_counts.shape != (3,) or walk_counts.dtype != torch.int64
            or walk_counts.device != org.device
            or not walk_counts.is_contiguous()):
        raise ValueError("walk_counts must be (3,) int64 on org's device")


def disk_grid_nearest_hit(org, dirn, prims, perm, grid, t_near=1e-4, *,
                          walk_counts=None):
    """Closest disk hit by the grid walk; R up to ``MAX_RAYS``. On CUDA
    tensors launches the kernel of ``csrc/grid_traverse.cu`` (or raises); on
    CPU tensors runs the plain version.

    org/dirn (R, 3) f32 (or f64: the float64 form, counted in
    ``disk_grid_nearest_hit.launches_f64``); prims
    (8, Npad) and perm (Npad,) int32 of the geometry; grid its
    ``GridData``. Returns (t (R,), prim (R,) int32 in ORIGINAL numbering,
    hit (R,) bool), ``nearest_hit.disk_nearest_hit``'s bit for bit.
    ``walk_counts`` (CUDA only; the trace passes none): a (3,) int64 tensor
    to which the launch adds the cells its walks visited, the pairs of those
    cells, and the pairs tested past each walk's stopping cell.
    """
    _check_inputs(org, dirn, prims, perm, grid, PRIM_ROWS)
    _check_walk_counts(walk_counts, org)
    if org.device.type == "cpu":
        return disk_grid_nearest_hit_ref(org, dirn, prims, perm, grid, t_near)
    if org.device.type != "cuda":
        raise RuntimeError(
            f"disk_grid_nearest_hit: unsupported device {org.device}")
    return _launch("disk_grid_nearest_hit", "vr_disk_grid_nearest_hit", org,
                   dirn, prims, perm, grid, t_near, walk_counts)


def triangle_grid_nearest_hit(org, dirn, prims, perm, grid, t_near=1e-4, *,
                              walk_counts=None):
    """Closest triangle hit by the grid walk; the contract of
    ``disk_grid_nearest_hit`` with prims (12, Npad)."""
    _check_inputs(org, dirn, prims, perm, grid, TRI_ROWS)
    _check_walk_counts(walk_counts, org)
    if org.device.type == "cpu":
        return triangle_grid_nearest_hit_ref(org, dirn, prims, perm, grid,
                                             t_near)
    if org.device.type != "cuda":
        raise RuntimeError(
            f"triangle_grid_nearest_hit: unsupported device {org.device}")
    return _launch("triangle_grid_nearest_hit", "vr_tri_grid_nearest_hit",
                   org, dirn, prims, perm, grid, t_near, walk_counts)


telemetry.declare(*(f"{kind}_grid_nearest_hit.{what}"
                    for kind in ("disk", "triangle")
                    for what in ("launches", "launches_f64")))

# the grid search of each geometry kind that has a grid, its plain version
# and the exact test it runs
SEARCH = {"disk": disk_grid_nearest_hit,
          "triangle": triangle_grid_nearest_hit}
SEARCH_REF = {"disk": disk_grid_nearest_hit_ref,
              "triangle": triangle_grid_nearest_hit_ref}
TEST = {"disk": disk_test, "triangle": triangle_test}


def with_grid(search, grid):
    """``search(org, dirn, prims, perm, grid, t_near)`` as the ``search`` of
    ``ops/bounce.py:bounce_step``, ``(org, dirn, prims, perm, chunk_bbs,
    t_near)``: the chunk boxes are not read."""
    def grid_search(org, dirn, prims, perm, chunk_bbs=None, t_near=1e-4):
        return search(org, dirn, prims, perm, grid, t_near)
    return grid_search
