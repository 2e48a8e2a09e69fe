"""Point neighborhood: all pairs within a distance, as a padded index matrix.

Counterpart of ``viennaray_tpu/geometry/neighborhood.py``. ``build_neighborhood``
takes its path from the device of the points it is handed. A CUDA tensor
goes to ``build_neighborhood_cuda``, the CUDA kernels of
``csrc/neighborhood.cu``, and the table comes back on that device: that is
what ``DiskGeometry.build`` on a CUDA device hands it. A numpy array or a
CPU tensor goes to the port's compiled host helper (``native/host_accel.cpp``
through ``utils/native.py``), as the JAX package runs its own, and the table
is numpy; ``build_neighborhood_numpy`` is the numpy path, a copy, which it
falls back to where the helper cannot be built. All three give the same
table, counts and row order, bit for bit: row i lists its neighbours by
(grid cell, index), the order the flux smoothing and the window list read.

The reference builds ragged per-point neighbor lists with a median-split
divide & conquer in 3D and a hash grid in 2D (rayPointNeighborhood.hpp). The
consumers here (disk multi-hit, flux smoothing) gather whole rows, so we
build a uniform-grid neighborhood (O(N) for level-set-derived point clouds)
and emit a padded ``(N, K)`` int32 matrix where K is the observed max degree
and empty slots are ``-1``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..utils import native

# builds by path, always counted: on the card (``build_neighborhood_cuda``)
# and on the host (the helper or the numpy path)
device_builds = 0
host_builds = 0


def build_neighborhood(points, distance: float, dim: int = 3):
    """All-pairs-within-``distance`` (strictly: ||p_i - p_j|| <= distance).

    Matches the reference's membership predicate (rayPointNeighborhood.hpp:
    287-298): per-axis |d| <= distance prefilter then squared-norm test, over
    the first ``dim`` coordinates only. Self is never a neighbor.

    ``points``: (N, >= dim). A CUDA tensor is built on its device by
    ``build_neighborhood_cuda`` (counted in the module's ``device_builds``);
    anything else on the host (counted in ``host_builds``) by the helper,
    or by the numpy path where it cannot be built.

    Returns:
      neighbors: (N, K) int32 padded with -1.
      counts: (N,) int32 neighbor counts.
      Both CUDA tensors for CUDA points, else numpy arrays.
    """
    global host_builds
    if isinstance(points, torch.Tensor) and points.device.type == "cuda":
        return build_neighborhood_cuda(points, distance, dim)
    host_builds += 1
    if isinstance(points, torch.Tensor):
        points = points.detach().numpy()
    points = np.asarray(points, np.float64)[:, :dim]
    n = len(points)
    if n == 0 or distance <= 0:
        return np.full((n, 1), -1, np.int32), np.zeros((n,), np.int32)
    got = native.build_neighborhood_native(points, distance, dim)
    if got is not None:
        return got
    return build_neighborhood_numpy(points, distance, dim)


def build_neighborhood_cuda(points: torch.Tensor, distance: float,
                            dim: int = 3):
    """``build_neighborhood`` on the card: (neighbors (N, K) int32 padded
    -1, counts (N,) int32) on the points' device, the host helper's table
    bit for bit (``csrc/neighborhood.cu`` says how). ``points``: (N, >= dim)
    float32 or float64 on a CUDA device, read at the first ``dim`` columns
    and widened to float64 in the kernels. Reads one number back, the
    largest count, which sizes the table. Counted in ``device_builds``; its
    kernel launches (four a build with points and a positive distance: the
    cells, the ids, the rows counted and filled) in ``launches`` for float32
    points and ``launches_f64`` for float64."""
    global device_builds
    if points.device.type != "cuda":
        raise RuntimeError(f"build_neighborhood_cuda: points on {points.device}")
    if points.ndim != 2 or points.shape[1] < dim or dim not in (2, 3):
        raise ValueError(f"points must be (N, >= {dim}) with dim 2 or 3")
    if points.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"points must be float32 or float64, got {points.dtype}")
    device_builds += 1
    device = points.device
    pts = points.detach().contiguous()
    n, cols = pts.shape
    if n == 0 or distance <= 0:
        return (torch.full((n, 1), -1, dtype=torch.int32, device=device),
                torch.zeros(n, dtype=torch.int32, device=device))
    f64 = "_f64" if pts.dtype == torch.float64 else ""
    distance = float(distance)
    lib = _build.library()

    def launch(entry, *args):
        err = getattr(lib, entry)(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{entry}: CUDA error {err}")
        if f64:
            build_neighborhood_cuda.launches_f64 += 1
        else:
            build_neighborhood_cuda.launches += 1

    with torch.cuda.device(device):
        lo = pts[:, :dim].amin(dim=0).contiguous()
        cx = torch.empty((n, 3), dtype=torch.int64, device=device)
        launch("vr_neighborhood_cells" + f64, pts.data_ptr(), n, cols, dim,
               lo.data_ptr(), 1.0 / distance, cx.data_ptr())
        maxc = cx.amax(dim=0).contiguous()
        ids = torch.empty(n, dtype=torch.int64, device=device)
        grid = torch.empty(32, dtype=torch.int64, device=device)  # NbrGrid
        launch("vr_neighborhood_ids", cx.data_ptr(), n, dim, maxc.data_ptr(),
               ids.data_ptr(), grid.data_ptr())
        ids, order = torch.sort(ids, stable=True)
        args = (pts.data_ptr(), n, cols, dim, cx.data_ptr(), ids.data_ptr(),
                order.data_ptr(), grid.data_ptr(), distance,
                distance * distance)
        counts = torch.empty(n, dtype=torch.int32, device=device)
        launch("vr_neighborhood_rows" + f64, *args, counts.data_ptr(), None, 0)
        k = max(1, int(counts.max()))
        neighbors = torch.empty((n, k), dtype=torch.int32, device=device)
        launch("vr_neighborhood_rows" + f64, *args, counts.data_ptr(),
               neighbors.data_ptr(), k)
    return neighbors, counts


build_neighborhood_cuda.launches = 0
build_neighborhood_cuda.launches_f64 = 0


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
