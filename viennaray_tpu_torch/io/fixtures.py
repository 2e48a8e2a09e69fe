"""Test-geometry generators (ports of rayUtil.hpp fixtures).

Counterpart of ``viennaray_tpu/io/fixtures.py`` (kept as a copy): the plane
and 3D-trench point clouds. The 2D trench, the source grid and the triangle
mesh wait for the slices that port their consumers.
"""

from __future__ import annotations

import numpy as np


def create_plane_grid(grid_delta: float, extent: float, direction=(0, 1, 2)):
    """Regular plane grid of points with constant normals
    (ref: rayUtil.hpp:324-351): the plane spans [-extent, extent] in
    direction[0] x direction[1], sits at 0 along direction[2], normal =
    +direction[2]. Iteration order matches the reference (direction[0] outer,
    direction[1] inner, inclusive of +extent)."""
    d0, d1, d2 = direction
    # replicate the reference's incremental loop (inclusive upper bound with
    # accumulated float steps)
    coords0 = []
    v = -float(extent)
    while v <= extent:
        coords0.append(v)
        v += grid_delta
    coords0 = np.array(coords0, np.float64)

    pts = []
    for a in coords0:
        b = -float(extent)
        while b <= extent:
            p = np.zeros(3)
            p[d0] = a
            p[d1] = b
            p[d2] = 0.0
            pts.append(p)
            b += grid_delta
    points = np.array(pts, np.float32)
    normal = np.zeros(3, np.float32)
    normal[d2] = 1.0
    normals = np.broadcast_to(normal, points.shape).copy()
    return points, normals


def create_trench_grid_3d(grid_delta=0.5, extent=5.0, trench_width=4.0,
                          trench_depth=4.0):
    """Synthetic 3D trench point cloud (trench running along y, z vertical)."""
    pts, nrm = [], []
    half_w = trench_width / 2.0
    xs = np.arange(-extent, extent + 1e-9, grid_delta)
    ys = np.arange(-extent, extent + 1e-9, grid_delta)
    for x in xs:
        for y in ys:
            if abs(x) >= half_w:
                pts.append([x, y, 0.0])
                nrm.append([0.0, 0.0, 1.0])
    zs = np.arange(-grid_delta, -trench_depth + 1e-9, -grid_delta)
    for z in zs:
        for y in ys:
            pts.append([-half_w, y, z])
            nrm.append([1.0, 0.0, 0.0])
            pts.append([half_w, y, z])
            nrm.append([-1.0, 0.0, 0.0])
    xs_in = np.arange(-half_w, half_w + 1e-9, grid_delta)
    for x in xs_in:
        for y in ys:
            pts.append([x, y, -trench_depth])
            nrm.append([0.0, 0.0, 1.0])
    return np.array(pts, np.float32), np.array(nrm, np.float32)
