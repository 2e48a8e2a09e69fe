"""Exact clipped disk areas at domain boundaries (host, numpy).

Counterpart of ``viennaray_tpu/geometry/disk_area.py`` (kept as a copy).

Port of ``DiskBoundingBoxXYIntersector`` (rayDiskBoundingBoxIntersector.hpp)
and ``GeometryDisk::computeDiskAreas`` (rayGeometryDisk.hpp:266-354). This
runs once per geometry on the host; the result feeds flux normalization.

The area of a 3D oriented disk inside an x/y-bounded box is computed by
canonicalizing each of the four walls into "the high-x wall" via swap/reflect
transforms, measuring the in-disk-plane closest approach of the wall
intersection chord, subtracting circular-segment areas per wall, and
correcting double-subtracted corner overlaps with a plane-plane-disk
intersection construction — exactly the reference's algorithm.

Fast path: disks fully inside (the vast majority for level-set clouds) are
resolved vectorized; only near-wall disks take the scalar corner path.
"""

from __future__ import annotations

import numpy as np

from ..config import BoundaryCondition


def _transforms(xmin, ymin, xmax, ymax):
    """The four (swapXY, reflectX) bbox transforms
    (ref: rayDiskBoundingBoxIntersector.hpp:222-291). Each value is
    (lowx, lowy, highx, highy) with low <= high restored."""
    out = {}
    # (False, False): identity
    out[(False, False)] = (xmin, ymin, xmax, ymax)
    # (True, False): swap x/y then reflect y
    lx, ly, hx, hy = ymin, -xmin, ymax, -xmax
    out[(True, False)] = (min(lx, hx), min(ly, hy), max(lx, hx), max(ly, hy))
    # (False, True): reflect x and y
    lx, ly, hx, hy = -xmin, -ymin, -xmax, -ymax
    out[(False, True)] = (min(lx, hx), min(ly, hy), max(lx, hx), max(ly, hy))
    # (True, True): swap then reflect x
    lx, ly, hx, hy = -ymin, xmin, -ymax, xmax
    out[(True, True)] = (min(lx, hx), min(ly, hy), max(lx, hx), max(ly, hy))
    return out


def _closest_approach(disk, nrm, swap_xy, reflect_x, transforms):
    """Signed in-plane distance from disk center to the wall chord
    (ref: rayDiskBoundingBoxIntersector.hpp:328-387). +inf = wall does not cut
    the disk (inside); -inf = disk fully beyond the wall."""
    x_idx, y_idx, z_idx = (1, 0, 2) if swap_xy else (0, 1, 2)
    xx = disk[x_idx]
    r = disk[3]
    ny = nrm[y_idx]
    nz = nrm[z_idx]
    if reflect_x:
        xx = -xx
    bb = transforms[(swap_xy, reflect_x)]
    hx = bb[2]
    xterm = r * np.sqrt(nz * nz + ny * ny)
    if xx + xterm <= hx:
        return np.inf
    if xx - xterm >= hx:
        return -np.inf
    if xterm <= 1e-9:
        return np.inf
    return (hx - xx) * r / xterm


def _untransform(px, py, nx_, ny_, swap_xy, reflect_x):
    """Map a point/normal from the canonical frame back to the original
    (ref: rayDiskBoundingBoxIntersector.hpp:137-171)."""
    if reflect_x:
        py, ny_ = -py, -ny_
        px, nx_ = -px, -nx_
    if swap_xy:
        py, ny_ = -py, -ny_
        px, py = py, px
        nx_, ny_ = ny_, nx_
    return px, py, nx_, ny_


def _area_inside_one(disk, nrm, transforms, bbox_xy):
    """Exact disk area inside the x/y box for one disk
    (ref: DiskBoundingBoxXYIntersector::areaInside)."""
    x, y, _, r = disk
    xmin, ymin, xmax, ymax = bbox_xy
    full = np.pi * r * r

    if (xmin <= x - r and x + r <= xmax) and (ymin <= y - r and y + r <= ymax):
        return full
    if (x + r <= xmin or xmax <= x - r) or (y + r <= ymin or ymax <= y - r):
        return 0.0

    # wall order: right, bottom, left, top (the corner-overlap pairing relies
    # on this adjacency; ref lines 293-326)
    flags = [(False, False), (True, True), (False, True), (True, False)]
    approach = []
    for swap_xy, reflect_x in flags:
        d = _closest_approach(disk, nrm, swap_xy, reflect_x, transforms)
        if d < -r:
            return 0.0
        approach.append(d)

    area_outside = 0.0
    for d in approach:
        if -r < d < r:
            angle = 2.0 * np.arccos(np.clip(d / r, -1.0, 1.0))
            area_outside += r * r / 2.0 * (angle - np.sin(angle))

    center = np.array([x, y, disk[2]])
    for i in range(4):
        d1 = approach[i]
        d2 = approach[(i + 1) % 4]
        if not (-r < d1 < r and -r < d2 < r):
            continue
        s1, rx1 = flags[i]
        s2, rx2 = flags[(i + 1) % 4]
        bb1 = transforms[(s1, rx1)]
        bb2 = transforms[(s2, rx2)]
        # wall plane point = transformed high corner; inward normal = (-1,0)
        p1x, p1y, n1x, n1y = _untransform(bb1[2], bb1[3], -1.0, 0.0, s1, rx1)
        p2x, p2y, n2x, n2y = _untransform(bb2[2], bb2[3], -1.0, 0.0, s2, rx2)
        n1 = np.array([n1x, n1y, 0.0])
        n2 = np.array([n2x, n2y, 0.0])

        i_dir1 = np.cross(nrm, n1)
        i_dir2 = np.cross(nrm, n2)
        l1 = np.linalg.norm(i_dir1)
        l2 = np.linalg.norm(i_dir2)
        if l1 < 1e-12 or l2 < 1e-12:
            continue
        i_dir1 /= l1
        i_dir2 /= l2
        if np.dot(i_dir1, n2) >= 0:
            i_dir1 = -i_dir1
        if np.dot(i_dir2, n1) >= 0:
            i_dir2 = -i_dir2

        # corner point lifted onto the disk plane
        # (ref: intersectionPointPlaneAndXY, lines 389-398)
        if abs(nrm[2]) < 1e-12:
            continue
        cz = (
            nrm[0] * center[0]
            + nrm[1] * center[1]
            + nrm[2] * center[2]
            - nrm[0] * p2x
            - nrm[1] * p2y
        ) / nrm[2]
        ipoint = np.array([p2x, p2y, cz])
        if np.linalg.norm(center - ipoint) >= r:
            continue

        def circ_point(i_dir, d):
            ca = np.dot(center - ipoint, i_dir)
            closest = ipoint + ca * i_dir
            thc = np.sqrt(max(r * r - d * d, 0.0))
            return closest + i_dir * thc

        q1 = circ_point(i_dir1, d1)
        q2 = circ_point(i_dir2, d2)
        v1 = q1 - center
        v2 = q2 - center
        denom = np.linalg.norm(v1) * np.linalg.norm(v2)
        if denom < 1e-18:
            continue
        angle = np.arccos(np.clip(np.dot(v1, v2) / denom, -1.0, 1.0))
        seg = r * r / 2.0 * (angle - np.sin(angle))
        tri = 0.5 * np.linalg.norm(np.cross(q1 - ipoint, q2 - ipoint))
        area_outside -= seg + tri

    return full - area_outside


def disk_areas_3d(
    points: np.ndarray,
    normals: np.ndarray,
    radii: np.ndarray,
    bbox: np.ndarray,
    boundary_dirs=(0, 1),
    boundary_conds=(BoundaryCondition.REFLECTIVE, BoundaryCondition.REFLECTIVE),
):
    """Per-disk areas clipped at the domain walls in 3D
    (ref: rayGeometryDisk.hpp:274-312)."""
    points = np.asarray(points, np.float64)
    normals = np.asarray(normals, np.float64)
    radii = np.broadcast_to(np.asarray(radii, np.float64), (len(points),))
    full = np.pi * radii * radii

    bc0 = BoundaryCondition(boundary_conds[boundary_dirs[0]])
    bc1 = BoundaryCondition(boundary_conds[boundary_dirs[1]])
    if bc0 == BoundaryCondition.IGNORE and bc1 == BoundaryCondition.IGNORE:
        return full

    if boundary_dirs[0] != 2 and boundary_dirs[1] != 2:
        xmin, ymin = bbox[0][0], bbox[0][1]
        xmax, ymax = bbox[1][0], bbox[1][1]
        transforms = _transforms(xmin, ymin, xmax, ymax)
        bbox_xy = (xmin, ymin, xmax, ymax)

        # fast path: fully inside
        x, y, r = points[:, 0], points[:, 1], radii
        inside = (
            (xmin <= x - r) & (x + r <= xmax) & (ymin <= y - r) & (y + r <= ymax)
        )
        areas = np.where(inside, full, 0.0)
        unit_n = normals / np.maximum(
            np.linalg.norm(normals, axis=1, keepdims=True), 1e-30
        )
        for idx in np.nonzero(~inside)[0]:
            disk = (points[idx, 0], points[idx, 1], points[idx, 2], radii[idx])
            areas[idx] = _area_inside_one(
                np.array(disk), unit_n[idx], transforms, bbox_xy
            )
        return areas

    # z-boundary heuristic: halve per near-wall boundary dir
    # (ref: rayGeometryDisk.hpp:296-311), eps = 1e-3
    eps = 1e-3
    areas = full.copy()
    for bd in boundary_dirs:
        c = points[:, bd]
        near = (np.abs(c - bbox[0][bd]) < eps) | (np.abs(c - bbox[1][bd]) < eps)
        areas = np.where(near, areas / 2.0, areas)
    return areas


def disk_areas_2d(
    points: np.ndarray,
    normals: np.ndarray,
    radii: np.ndarray,
    bbox: np.ndarray,
    boundary_dirs=(0, 2),
    boundary_conds=(BoundaryCondition.REFLECTIVE, BoundaryCondition.REFLECTIVE,
                    BoundaryCondition.REFLECTIVE),
):
    """2D disk (= line segment of length 2r) areas with chord subtraction at
    the first-boundary-dir walls (ref: rayGeometryDisk.hpp:314-352)."""
    points = np.asarray(points, np.float64)
    normals = np.asarray(normals, np.float64)
    radii = np.broadcast_to(np.asarray(radii, np.float64), (len(points),))
    areas = 2.0 * radii.copy()

    bd = boundary_dirs[0]
    if BoundaryCondition(boundary_conds[bd]) == BoundaryCondition.IGNORE:
        return areas

    n_bd = normals[:, bd]
    inside_test = 1.0 - n_bd * n_bd
    c = points[:, bd]
    for wall in (bbox[0][bd], bbox[1][bd]):
        dist = np.abs(c - wall)
        applies = (dist < radii) & (inside_test > 1e-4)
        depth = dist / np.sqrt(np.maximum(inside_test, 1e-30))
        cut = (depth < radii) & applies
        areas = np.where(cut, areas - (radii - depth), areas)
    return areas
