"""Point neighborhood: all pairs within a distance, as a padded index matrix.

Counterpart of ``viennaray_tpu/geometry/neighborhood.py``. ``build_neighborhood``
runs the port's compiled host helper (``native/host_accel.cpp`` through
``utils/native.py``), as the JAX package runs its own; ``build_neighborhood_numpy``
is the numpy path, a copy, which it falls back to where the helper cannot be
built. Both give the same table, counts and row order: row i lists its
neighbours by (grid cell, index), the order the flux smoothing and the window
list read.

The reference builds ragged per-point neighbor lists with a median-split
divide & conquer in 3D and a hash grid in 2D (rayPointNeighborhood.hpp). The
consumers here (disk multi-hit, flux smoothing) gather whole rows, so we
build a uniform-grid neighborhood on the host (numpy, O(N) for level-set-
derived point clouds) and emit a padded ``(N, K)`` int32 matrix where K is the
observed max degree and empty slots are ``-1``.
"""

from __future__ import annotations

import numpy as np

from ..utils import native


def build_neighborhood(points: np.ndarray, distance: float, dim: int = 3):
    """All-pairs-within-``distance`` (strictly: ||p_i - p_j|| <= distance).

    Matches the reference's membership predicate (rayPointNeighborhood.hpp:
    287-298): per-axis |d| <= distance prefilter then squared-norm test, over
    the first ``dim`` coordinates only. Self is never a neighbor.

    Returns:
      neighbors: (N, K) int32 padded with -1.
      counts: (N,) int32 neighbor counts.
    """
    points = np.asarray(points, np.float64)[:, :dim]
    n = len(points)
    if n == 0 or distance <= 0:
        return np.full((n, 1), -1, np.int32), np.zeros((n,), np.int32)
    got = native.build_neighborhood_native(points, distance, dim)
    if got is not None:
        return got
    return build_neighborhood_numpy(points, distance, dim)


def build_neighborhood_numpy(points: np.ndarray, distance: float, dim: int = 3):
    """``build_neighborhood`` in numpy: the uniform-grid pass of the JAX
    package's fallback, the same tables as the compiled helper."""
    points = np.asarray(points, np.float64)[:, :dim]
    n = len(points)
    if n == 0 or distance <= 0:
        return np.full((n, 1), -1, np.int32), np.zeros((n,), np.int32)

    inv_cell = 1.0 / distance
    mins = points.min(axis=0)
    cells = np.floor((points - mins) * inv_cell).astype(np.int64)

    # linearize cell ids
    spans = cells.max(axis=0) + 1
    strides = np.ones(dim, np.int64)
    for i in range(dim - 2, -1, -1):
        strides[i] = strides[i + 1] * spans[i + 1]
    cell_ids = cells @ strides

    order = np.argsort(cell_ids, kind="stable")
    sorted_ids = cell_ids[order]
    unique_ids, starts = np.unique(sorted_ids, return_index=True)
    ends = np.append(starts[1:], n)
    cell_lookup = {cid: (s, e) for cid, s, e in zip(unique_ids, starts, ends)}

    dist2 = distance * distance
    neighbor_lists = [[] for _ in range(n)]

    offsets = np.array(
        np.meshgrid(*([[-1, 0, 1]] * dim), indexing="ij")
    ).reshape(dim, -1).T

    for cid, (s, e) in cell_lookup.items():
        idxs = order[s:e]
        base_cell = cells[idxs[0]]
        # candidate points: this cell + forward neighbor cells (visit each
        # cell-pair once by only looking at cells with id >= current)
        for off in offsets:
            nb_cell = base_cell + off
            if np.any(nb_cell < 0) or np.any(nb_cell >= spans):
                continue
            nb_id = nb_cell @ strides
            if nb_id < cid:
                continue
            got = cell_lookup.get(nb_id)
            if got is None:
                continue
            cand = order[got[0]:got[1]]
            if nb_id == cid:
                a, b = np.meshgrid(idxs, cand, indexing="ij")
                mask_pairs = a < b
            else:
                a, b = np.meshgrid(idxs, cand, indexing="ij")
                mask_pairs = np.ones_like(a, dtype=bool)
            a = a[mask_pairs]
            b = b[mask_pairs]
            if len(a) == 0:
                continue
            diff = points[a] - points[b]
            ok = np.all(np.abs(diff) <= distance, axis=1)
            ok &= np.sum(diff * diff, axis=1) <= dist2
            for i, j in zip(a[ok], b[ok]):
                neighbor_lists[i].append(j)
                neighbor_lists[j].append(i)

    counts = np.array([len(lst) for lst in neighbor_lists], np.int32)
    k = max(1, int(counts.max()) if n else 1)
    neighbors = np.full((n, k), -1, np.int32)
    for i, lst in enumerate(neighbor_lists):
        neighbors[i, : len(lst)] = lst
    return neighbors, counts
