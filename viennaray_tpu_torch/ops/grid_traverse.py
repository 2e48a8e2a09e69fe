"""Closest disk or triangle hit per ray by a walk of the uniform grid (the
grid DDA): plain versions and CUDA wrappers.

Counterpart of ``viennaray_tpu/ops/grid_traverse.py``, which walks the grid
in XLA. The port walks the table of ``geometry.grid_accel.GridData`` (its
``lanes``: sorted SoA lanes) and tests each slot with the closest-hit
kernels' own exact test (``ops/nearest_hit.py:disk_test`` /
``triangle_test``; ``csrc/disk_hit.cuh``, ``csrc/tri_hit.cuh``), so that
(t, prim, hit) are the chunk search's (``nearest_hit.disk_nearest_hit``)
bit for bit, not the JAX package's DDA test within a tolerance.

- ``disk_grid_nearest_hit_ref`` / ``triangle_grid_nearest_hit_ref`` are the
  plain PyTorch versions (any device, float32 or float64), ``grid_walk_ref``
  the walk they share.
- ``disk_grid_nearest_hit`` / ``triangle_grid_nearest_hit`` wrap the CUDA
  kernels of ``csrc/grid_traverse.cu`` (the search is
  ``csrc/grid_search.cuh``, which says how the walk goes and why it finds
  what the chunk search finds): on a CUDA tensor they launch the kernel or
  raise, on a CPU tensor they run the plain version. Float64 rays launch the
  float64 forms, counted in ``launches_f64``.
- ``with_grid`` makes either the ``search`` of ``ops/bounce.py:bounce_step``.

The plain versions repeat the kernel's float operations one tensor op each,
in its order, so that the walk visits the same cells.
"""

from __future__ import annotations

import torch

from .. import _build
from .nearest_hit import (
    BIG,
    MAX_RAYS,
    PRIM_ROWS,
    TRI_ROWS,
    disk_test,
    triangle_test,
)


def grid_walk_ref(org, dirn, grid, prims, test, t_near, bound=None):
    """The walk of ``csrc/grid_search.cuh:grid_search_group`` for every ray
    at once: (t (R,), sorted lane (R,) int64, -1 without a hit, cells
    visited (R,) int64, pairs tested (R,) int64: the lanes of the visited
    cells). ``test(o, d, cols, t_near) -> (t, valid)`` is the
    kind's exact test on broadcastable tensors; ``bound`` (R,) the search
    bound (None: ``BIG``)."""
    R = org.shape[0]
    dt, dev = org.dtype, org.device
    like = dict(dtype=dt, device=dev)
    big = torch.tensor(float(BIG), **like)
    tiny = torch.tensor(1e-30, **like)
    wo, cs = grid.walk_origin, grid.cell_size
    dims = torch.tensor(grid.walk_dims, dtype=torch.int64, device=dev)
    flat = grid.walk_dims[2] == 1
    axes = 2 if flat else 3
    lanes = grid.lanes
    if bound is None:
        bound = big.expand(R)
    inv = 1.0 / torch.where(dirn == 0, tiny, dirn)
    hi = wo + cs * dims.to(dt)

    # slab clip to the grid's box (csrc/grid_search.cuh:slab_clip)
    t_lo = (-big).expand(R)
    t_hi = big.expand(R)
    for a in range(axes):
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
        row = lanes[(c * stride).sum(dim=1)].long()
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
    """The grid's walk tables as the kernels take them: lanes (C', K) int32,
    corner and cell size of org's type, on org's device; raises
    otherwise."""
    cells = grid.walk_dims[0] * grid.walk_dims[1] * grid.walk_dims[2]
    if grid.lanes.ndim != 2 or grid.lanes.shape[0] != cells:
        raise ValueError(f"the grid's lanes must be ({cells}, K)")
    for name, x, dt in (
        ("grid lanes", grid.lanes, torch.int32),
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
    """The kernels' grid arguments: lanes, k, nx, ny, nz, corner (3), cell
    size."""
    wo = grid.walk_origin.tolist()
    return (grid.lanes.data_ptr(), grid.lanes.shape[1], *grid.walk_dims,
            *wo, float(grid.cell_size))


def _launch(wrapper, entry, org, dirn, prims, perm, grid, t_near):
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
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}")
    if f64:
        wrapper.launches_f64 += 1
    else:
        wrapper.launches += 1
    return t, prim, hit


def disk_grid_nearest_hit(org, dirn, prims, perm, grid, t_near=1e-4):
    """Closest disk hit by the grid walk; R up to ``MAX_RAYS``. On CUDA
    tensors launches the kernel of ``csrc/grid_traverse.cu`` (or raises); on
    CPU tensors runs the plain version.

    org/dirn (R, 3) f32 (or f64: the float64 form, ``launches_f64``); prims
    (8, Npad) and perm (Npad,) int32 of the geometry; grid its
    ``GridData``. Returns (t (R,), prim (R,) int32 in ORIGINAL numbering,
    hit (R,) bool), ``nearest_hit.disk_nearest_hit``'s bit for bit.
    """
    _check_inputs(org, dirn, prims, perm, grid, PRIM_ROWS)
    if org.device.type == "cpu":
        return disk_grid_nearest_hit_ref(org, dirn, prims, perm, grid, t_near)
    if org.device.type != "cuda":
        raise RuntimeError(
            f"disk_grid_nearest_hit: unsupported device {org.device}")
    return _launch(disk_grid_nearest_hit, "vr_disk_grid_nearest_hit", org,
                   dirn, prims, perm, grid, t_near)


disk_grid_nearest_hit.launches = 0
disk_grid_nearest_hit.launches_f64 = 0


def triangle_grid_nearest_hit(org, dirn, prims, perm, grid, t_near=1e-4):
    """Closest triangle hit by the grid walk; the contract of
    ``disk_grid_nearest_hit`` with prims (12, Npad)."""
    _check_inputs(org, dirn, prims, perm, grid, TRI_ROWS)
    if org.device.type == "cpu":
        return triangle_grid_nearest_hit_ref(org, dirn, prims, perm, grid,
                                             t_near)
    if org.device.type != "cuda":
        raise RuntimeError(
            f"triangle_grid_nearest_hit: unsupported device {org.device}")
    return _launch(triangle_grid_nearest_hit, "vr_tri_grid_nearest_hit", org,
                   dirn, prims, perm, grid, t_near)


triangle_grid_nearest_hit.launches = 0
triangle_grid_nearest_hit.launches_f64 = 0

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
