"""Uniform-grid acceleration structure: the host build and the device tables
of the grid DDA.

Counterpart of ``viennaray_tpu/geometry/grid_accel.py``, of which
``UniformGrid``, ``build_grid``, ``build_disk_grid`` and
``build_triangle_grid`` are copies: level-set disk clouds are near-uniform at
grid-delta spacing, so a regular cell grid with a padded list of primitives
per cell gives static shapes. Each primitive goes into every cell its box
overlaps. The insertion runs in the compiled host helper
(``utils/native.py:build_grid_native``), or in numpy without it
(``insert_prims_numpy``); both give the JAX package's tables bit for bit.

``GridData`` is the geometries' ``grid`` field: the JAX package's table as
it is, on the host, and on the device the table the walk reads
(``walk_table``), whose slots hold sorted SoA lanes on a grid one cell wider
on every side, with every primitive's box widened by a margin that covers
the rounding of the walk and of the hit tests, in compact form
(``cell_start`` / ``cell_lanes``). ``ops/grid_traverse.py`` walks it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..utils import native


class UniformGrid:
    """Host-side grid: dense padded cell table.

    cells: (C, K) int32 prim ids padded with -1, C = nx*ny*nz (z-major last).
    origin: (3,) grid minimum corner; cell_size: scalar; dims: (nx, ny, nz).
    """

    def __init__(self, cells, counts, origin, cell_size, dims):
        self.cells = cells
        self.counts = counts
        self.origin = origin
        self.cell_size = cell_size
        self.dims = dims

    @property
    def max_per_cell(self) -> int:
        return self.cells.shape[1]


def insert_prims_numpy(prim_lo, prim_hi, origin, cell, dims, dim):
    """The cell insertion in numpy: (cells (C, K) int32 padded -1, counts (C,)
    int32), each primitive in every cell its box overlaps, in ascending id
    order within a cell (the JAX package's fallback path)."""
    prim_lo = np.asarray(prim_lo, np.float64)
    prim_hi = np.asarray(prim_hi, np.float64)
    origin = np.asarray(origin, np.float64)
    dims = np.asarray(dims, np.int64)
    n = len(prim_lo)
    inv = 1.0 / cell
    clo = np.clip(
        np.floor((prim_lo - origin) * inv).astype(np.int64), 0, dims - 1
    )
    chi = np.clip(
        np.floor((prim_hi - origin) * inv).astype(np.int64), 0, dims - 1
    )
    if dim == 2:
        clo[:, 2] = 0
        chi[:, 2] = 0

    # enumerate (cell, prim) pairs
    spans = chi - clo + 1
    total = int(np.prod(spans, axis=1).sum())
    pair_cell = np.empty(total, np.int64)
    pair_prim = np.empty(total, np.int64)
    stride_y = dims[2]
    stride_x = dims[1] * dims[2]
    pos = 0
    for i in range(n):
        xs = np.arange(clo[i, 0], chi[i, 0] + 1)
        ys = np.arange(clo[i, 1], chi[i, 1] + 1)
        zs = np.arange(clo[i, 2], chi[i, 2] + 1)
        lin = (
            xs[:, None, None] * stride_x
            + ys[None, :, None] * stride_y
            + zs[None, None, :]
        ).ravel()
        pair_cell[pos:pos + len(lin)] = lin
        pair_prim[pos:pos + len(lin)] = i
        pos += len(lin)

    c_total = int(np.prod(dims))
    order = np.argsort(pair_cell, kind="stable")
    pair_cell = pair_cell[order]
    pair_prim = pair_prim[order]
    cell_counts = np.bincount(pair_cell, minlength=c_total)
    k = max(1, int(cell_counts.max()) if total else 1)
    cells = np.full((c_total, k), -1, np.int32)
    # position within each cell's slot list
    slot = np.arange(total) - np.repeat(
        np.concatenate([[0], np.cumsum(cell_counts)[:-1]]), cell_counts
    )
    cells[pair_cell, slot] = pair_prim.astype(np.int32)
    return cells, cell_counts.astype(np.int32)


def insert_prims(prim_lo, prim_hi, origin, cell, dims, dim):
    """The cell insertion by the compiled helper, or by numpy without it; the
    same tables either way."""
    got = native.build_grid_native(prim_lo, prim_hi, origin, cell, dims, dim)
    if got is not None:
        return got
    return insert_prims_numpy(prim_lo, prim_hi, origin, cell, dims, dim)


def build_grid(
    lo: np.ndarray,
    hi: np.ndarray,
    prim_lo: np.ndarray,
    prim_hi: np.ndarray,
    target_cell_size: float,
    dim: int = 3,
    max_cells: int = 4_000_000,
) -> UniformGrid:
    """Insert prims into all overlapped cells.

    lo/hi: (3,) scene bounds; prim_lo/prim_hi: (N, 3) per-prim AABBs. The
    cell widens by 1.5x until the grid has at most ``max_cells`` cells.
    """
    lo = np.asarray(lo, np.float64).copy()
    hi = np.asarray(hi, np.float64).copy()

    extent = np.maximum(hi - lo, 1e-12)
    if dim == 2:
        extent[2] = 0.0

    cell = float(target_cell_size)
    dims = np.maximum(np.ceil(extent / cell).astype(np.int64), 1)
    if dim == 2:
        dims[2] = 1
    while int(np.prod(dims)) > max_cells:
        cell *= 1.5
        dims = np.maximum(np.ceil(extent / cell).astype(np.int64), 1)
        if dim == 2:
            dims[2] = 1

    cells, counts = insert_prims(prim_lo, prim_hi, lo, cell, dims, dim)
    return UniformGrid(
        cells=cells,
        counts=counts,
        origin=lo.astype(np.float32),
        cell_size=np.float32(cell),
        dims=(int(dims[0]), int(dims[1]), int(dims[2])),
    )


def disk_boxes(points, radii):
    """Conservative per-disk boxes, centre +- radius: (lo, hi) (N, 3)
    float64."""
    points = np.asarray(points, np.float64)
    radii = np.asarray(radii, np.float64).reshape(-1, 1)
    return points - radii, points + radii


def triangle_boxes(vertices, triangles):
    """Per-triangle boxes: (lo, hi) (N, 3) float64."""
    v = np.asarray(vertices, np.float64)[np.asarray(triangles, np.int64)]
    return v.min(axis=1), v.max(axis=1)


def build_disk_grid(points, normals, radii, dim=3, cell_scale=2.0):
    """Grid over a disk cloud: conservative per-disk AABB = center +- r.

    cell size ~ cell_scale * max_radius balances cells-visited against
    prims-per-cell for gridDelta-spaced clouds.
    """
    prim_lo, prim_hi = disk_boxes(points, radii)
    cell = cell_scale * float(np.asarray(radii, np.float64).max())
    return build_grid(prim_lo.min(axis=0), prim_hi.max(axis=0), prim_lo,
                      prim_hi, cell, dim=dim)


def build_triangle_grid(vertices, triangles, dim=3, cell_size=None):
    """Grid over a triangle mesh: per-triangle AABBs."""
    prim_lo, prim_hi = triangle_boxes(vertices, triangles)
    if cell_size is None:
        # median triangle bbox diagonal as the natural scale
        diag = np.linalg.norm(prim_hi - prim_lo, axis=1)
        cell_size = max(float(np.median(diag)) * 2.0, 1e-6)
    return build_grid(prim_lo.min(axis=0), prim_hi.max(axis=0), prim_lo,
                      prim_hi, cell_size, dim=dim)


def walk_margin(walk_origin, cell_size, walk_dims) -> float:
    """The margin eta by which ``walk_table`` widens every primitive's box:
    2^-8 of a cell plus 2^-12 of B, the walk box's largest |coordinate|.

    Why it is enough (u = 2^-24; the float64 walk and tests round far less).
    The walk (``csrc/grid_search.cuh``, ``ops/grid_traverse.py``) finds the
    search's (t, lane) when the pair that the exhaustive search selects lies
    in a cell the walk visits before it stops. Take that pair, its computed
    t and the exact point p = o + t d, and S = max(|o|_inf, B).

    - Where p lies. disk_hit tests |(o + t d) - c|^2 < r^2 for its own t,
      so (``csrc/disk_hit.cuh:DiskReject``'s argument) a selected disk has
      |p - c| < r (1 + 2u) + 54 u S: p lies within 56 u S of the disk's box
      c +- r, which the host computes exactly in float64.
    - Where the walk is. The walk is in one cell over each interval
      [t_in, t_exit] of its computed crossing times, and those intervals
      cover t from the slab entry on: the crossing times are never
      accumulated but computed from the cell index, (wo + i cs - o) / d in
      three rounded operations, within 3.1 u of the exact time of the face
      that the device computes, wo + i cs rounded twice, itself within
      2 u B of the face the host's insertion uses; and each crossing ends
      the interval it starts, so the intervals do not leave gaps. Over its
      interval the exact point o + t d lies within 6.2 u S + 2 u B of the
      cell's box along every axis; the first cell's floor((pos - wo) / cs)
      and its start 1e-6 cs past the slab entry add 4 u S and 1e-6 cs.
    - So p lies within 71 u S + 1e-6 cs < eta of the box of the cell the
      walk is in at t whenever S <= 32 B, and the widened box of the
      selected pair overlaps that cell: the pair is in its slots. The walk
      stops only after the cell where t_best < t_exit or t_exit >= bound,
      so every pair below its result has been in reach. The grid's outer
      layer of cells holds no box but within eta of its inner faces, so a
      ray that leaves the grid, or never enters it, passes farther than
      cs - eta from every box, and no selected pair lies there. Each step
      moves one cell along one axis, always the same way, so a walk leaves
      the grid within nx + ny + nz - 2 steps, before its cap of
      nx + ny + nz + 3. In 2D the walk ignores z: every box lies in the
      grid's one layer of cells along it.

    Triangles in a plane x, y or z = const, whose two edges have an exact 0
    coordinate a in common (``triangles_covered``). Every product of
    tri_hit's determinant and of t's numerator that holds that 0 vanishes
    exactly, and the two come out as d_a W and -s_a W (s = o - v0, W the one
    nonzero component of e1 x e2), each within (2 kappa + 1) u relative,
    kappa = (|e1_b e2_c| + |e1_c e2_b|) / |W|: t is within (4 kappa + 3) u
    |t| of the plane's exact crossing -s_a / d_a however small d_a is, since
    no cancellation grows as the ray grazes the plane. The barycentrics'
    numerators lose at most u L (9 (|s_b| + |s_c|) |d_a| + 18 |s_a| D)
    (L the edges' largest |component|, D = |d|_inf), so the plane's point
    lies within sqrt(2) u rho (9 (|s_b| + |s_c|) + 18 |t| D) +
    2 sqrt(2) (kappa + 1) u L of the triangle, rho = L^2 / |W|. With
    |s| <= 2 S, |t| D <= 2 S and L <= 2 S, p lies within
    u S (20 kappa + 102 rho + 20) of the triangle's box; for kappa and rho at
    most ``TRI_SHAPE_LIMIT`` = 1.5, with the walk's own 15 u S, within
    218 u S + 1e-6 cs < eta whenever S <= 16 B.

    Any other triangle: p lies within 162 u S L^2 D / |det| of it (Cramer's
    identity o + (T / det) d = v0 + (U / det) e1 + (V / det) e2 with the
    rounding bounds of ``csrc/tri_hit.cuh:TriReject``), and tri_hit accepts
    |det| down to 1e-9: on a ray that grazes the triangle's plane the
    computed t may lie anywhere along the ray, and no widening of the table
    covers it (``tests/test_torch_grid.py`` finds such rays on a rotated
    trench). A mesh with such a triangle, or a degenerate or sliver one, is
    not ``GridData.exact``, and the trace does not walk its grid
    (``trace/kernel.py:grid_for``)."""
    wo = np.asarray(walk_origin, np.float64)
    hi = wo + float(cell_size) * np.asarray(walk_dims, np.float64)
    b = float(max(np.abs(wo).max(), np.abs(hi).max()))
    return float(cell_size) * 2.0**-8 + b * 2.0**-12


# the shape factors kappa and rho (``walk_margin``) up to which the walk's
# margin covers a triangle in a plane x, y or z = const
TRI_SHAPE_LIMIT = 1.5


def triangles_covered(vertices, triangles) -> bool:
    """Whether ``walk_margin``'s argument covers every triangle of a mesh:
    its edges v1 - v0 and v2 - v0 (in float32, as the SoA holds them) have
    an exact 0 coordinate in common, and its shape factors kappa and rho
    are at most ``TRI_SHAPE_LIMIT`` (a degenerate triangle's are
    infinite)."""
    v = np.asarray(vertices, np.float32)
    t = np.asarray(triangles, np.int64)
    v0 = v[t[:, 0]]
    e1 = (v[t[:, 1]] - v0).astype(np.float64)
    e2 = (v[t[:, 2]] - v0).astype(np.float64)
    shared = (e1 == 0) & (e2 == 0)
    i = np.arange(len(t))
    a = shared.argmax(axis=1)
    b, c = (a + 1) % 3, (a + 2) % 3
    # products of two float32 values are exact in float64
    p, q = e1[i, b] * e2[i, c], e1[i, c] * e2[i, b]
    w = np.abs(p - q)
    span = np.maximum(np.abs(e1).max(axis=1), np.abs(e2).max(axis=1))
    with np.errstate(divide="ignore", invalid="ignore"):
        kappa = (np.abs(p) + np.abs(q)) / w
        rho = span * span / w
    ok = (shared.any(axis=1) & (w > 0) & (kappa <= TRI_SHAPE_LIMIT)
          & (rho <= TRI_SHAPE_LIMIT))
    return bool(ok.all())


def walk_table(grid: UniformGrid, prim_lo, prim_hi, dim: int):
    """The table the walk reads: (cells (C', K') int32 original ids padded
    -1, walk_origin (3,) float32, walk_dims). The grid of ``grid`` with one
    more cell on each side (not along z in 2D, where the walk never steps
    z): walk_origin = origin - cs in float32, the same cell size; every
    primitive inserted by ``grid``'s rule into every cell its box widened by
    ``walk_margin`` overlaps, against the walk's own float32 faces."""
    cs = np.float32(grid.cell_size)
    pad = np.array([1, 1, 0 if dim == 2 else 1])
    walk_origin = (np.asarray(grid.origin, np.float32)
                   - cs * pad.astype(np.float32)).astype(np.float32)
    walk_dims = tuple(int(n) for n in np.asarray(grid.dims) + 2 * pad)
    eta = walk_margin(walk_origin, cs, walk_dims)
    cells, _ = insert_prims(
        np.asarray(prim_lo, np.float64) - eta,
        np.asarray(prim_hi, np.float64) + eta,
        walk_origin.astype(np.float64), float(cs), walk_dims, dim,
    )
    return cells, walk_origin, walk_dims


def walk_lanes(grid: UniformGrid, prim_lo, prim_hi, inv_perm, dim: int,
               device):
    """``walk_table`` with each slot's sorted SoA lane on ``device``: (lanes
    (C', K') int32 padded -1, walk_origin (3,) float32, walk_dims), the
    padded form of the table that ``GridData`` holds compact."""
    wcells, walk_origin, walk_dims = walk_table(grid, prim_lo, prim_hi, dim)
    inv = (inv_perm if torch.is_tensor(inv_perm)
           else torch.from_numpy(np.array(inv_perm))).to(device, torch.int32)
    wc = torch.from_numpy(wcells).to(device)
    lanes = torch.where(wc >= 0, inv[torch.clamp(wc, min=0).long()],
                        torch.full_like(wc, -1))
    return lanes, walk_origin, walk_dims


def compact_table(lanes: torch.Tensor):
    """The walk's padded table (C', K') int32, each row's lanes first and -1
    after them, as (cell_start (C' + 1,), cell_lanes (entries,)) int32 on its
    device: cell c's lanes are cell_lanes[cell_start[c]:cell_start[c + 1]],
    in the row's slot order."""
    counts = (lanes >= 0).sum(dim=1)
    if int(counts.sum()) >= 2**31:
        raise ValueError("the grid's table holds 2^31 entries or more")
    cell_start = torch.zeros(lanes.shape[0] + 1, dtype=torch.int32,
                             device=lanes.device)
    cell_start[1:] = torch.cumsum(counts, dim=0).to(torch.int32)
    # a boolean mask takes the entries in row-major order: each row's
    # prefix, rows one after another
    cell_lanes = lanes[lanes >= 0].to(torch.int32).contiguous()
    return cell_start, cell_lanes


@dataclasses.dataclass
class GridData:
    """The uniform grid of a geometry (its ``grid`` field): the JAX
    package's ``GridData`` (``viennaray_tpu/geometry/disk_geometry.py:20-28``)
    on the host, and the walk's table on the device.

    On the host: cells (C, K) int32, the JAX package's table of original ids
    padded -1; origin (3,) float32; dims (nx, ny, nz). On the device: the
    walk's table (``walk_lanes``: each slot's sorted SoA lane) on a grid of
    ``walk_dims`` cells from ``walk_origin`` (3,); cell_size (); both in the
    geometry's dtype. The table is held compact (``compact_table``): cell
    c's lanes are cell_lanes[cell_start[c]:cell_start[c + 1]], each padded
    row's non-negative prefix in its slot order; cell_start (C' + 1,)
    int32, cell_lanes (entries,) int32; walk_slots K', the most lanes a
    cell holds (the padded rows' width). At 704,250 disks the padded table
    would be 299 MB on the card (K' = 42 slots a cell, most of them -1),
    far past the 50 MB L2; the compact one is 14.8 MB (1,780,124 starts,
    1,913,583 entries).
    exact: ``walk_margin``'s argument covers every primitive, so the walk
    finds the chunk search's hits on every ray: always for disks, for a
    mesh where ``triangles_covered``. The trace walks only an exact grid.
    """

    cells: np.ndarray
    origin: np.ndarray
    dims: Tuple[int, int, int]
    walk_origin: torch.Tensor
    cell_size: torch.Tensor
    walk_dims: Tuple[int, int, int]
    cell_start: torch.Tensor
    cell_lanes: torch.Tensor
    walk_slots: int
    exact: bool = True

    @classmethod
    def build(cls, grid: UniformGrid, prim_lo, prim_hi, inv_perm, dim: int,
              device, dtype=torch.float32, exact=True) -> "GridData":
        """The grid ``grid`` (primitive boxes (N, 3) ``prim_lo`` /
        ``prim_hi``, the geometry's ``soa_inv_perm`` original id -> sorted
        lane) with the walk's table on ``device``, its lanes gathered
        there."""
        lanes, walk_origin, walk_dims = walk_lanes(grid, prim_lo, prim_hi,
                                                   inv_perm, dim, device)
        cell_start, cell_lanes = compact_table(lanes)
        walk_slots = lanes.shape[1]
        del lanes
        return cls(
            cells=np.require(grid.cells, np.int32, ["C"]),
            origin=np.asarray(grid.origin, np.float32),
            dims=tuple(int(n) for n in grid.dims),
            walk_origin=torch.from_numpy(walk_origin).to(device, dtype),
            cell_size=torch.tensor(float(np.float32(grid.cell_size)),
                                   dtype=dtype, device=device),
            walk_dims=walk_dims,
            cell_start=cell_start,
            cell_lanes=cell_lanes,
            walk_slots=walk_slots,
            exact=bool(exact),
        )

    @classmethod
    def from_reference_arrays(cls, arrays, prim_lo, prim_hi, inv_perm,
                              dim: int, device, dtype=torch.float32,
                              exact=True) -> "GridData":
        """From a JAX-package ``GridData`` handed across as numpy arrays
        (``cells``, ``origin``, ``cell_size``, ``dims``)."""
        grid = UniformGrid(
            cells=np.asarray(arrays["cells"], np.int32), counts=None,
            origin=np.asarray(arrays["origin"], np.float32),
            cell_size=np.float32(arrays["cell_size"]),
            dims=tuple(int(n) for n in arrays["dims"]),
        )
        return cls.build(grid, prim_lo, prim_hi, inv_perm, dim, device, dtype,
                         exact)

    def to(self, dtype) -> "GridData":
        """The walk's corner and cell size in ``dtype``: float32 values
        widened, so the float64 walk crosses the faces of the float32
        table."""
        return dataclasses.replace(
            self, walk_origin=self.walk_origin.to(dtype),
            cell_size=self.cell_size.to(dtype),
        )

    @property
    def device_bytes(self) -> int:
        """Bytes of the walk's table on the device (compact)."""
        return (self.cell_start.numel() + self.cell_lanes.numel()) * 4

    @property
    def padded_bytes(self) -> int:
        """Bytes the walk's table would take padded, (C', K') int32."""
        return (self.cell_start.numel() - 1) * self.walk_slots * 4
