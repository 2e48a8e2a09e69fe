"""Host-side mesh containers (numpy).

Counterpart of ``viennaray_tpu/geometry/mesh.py`` (kept as a copy):
``LineMesh``, ``TriangleMesh``, ``DiskMesh``, bounding boxes, and the 2D line
-> extruded-triangle conversion (``convertLinesToTriangles``,
rayMesh.hpp:133-175). These are host structures; the device geometry lives in
disk_geometry.py / triangle_geometry.py.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def compute_bounding_box(nodes: np.ndarray):
    """(2, 3) [min; max] over nodes (ref: rayMesh.hpp:12-25)."""
    return np.stack([nodes.min(axis=0), nodes.max(axis=0)])


@dataclasses.dataclass
class DiskMesh:
    """Oriented-disk point cloud (ref: rayMesh.hpp:115-131)."""

    nodes: np.ndarray  # (N, 3) float32
    normals: np.ndarray  # (N, 3) float32
    grid_delta: float = 0.0
    radius: float = 0.0
    radii: Optional[np.ndarray] = None  # (N,) per-point radii override

    def __post_init__(self):
        self.nodes = np.asarray(self.nodes, np.float32).reshape(-1, 3)
        self.normals = np.asarray(self.normals, np.float32).reshape(-1, 3)
        if self.radii is not None:
            self.radii = np.asarray(self.radii, np.float32)
        self.minimum_extent, self.maximum_extent = compute_bounding_box(self.nodes)


@dataclasses.dataclass
class TriangleMesh:
    """Triangle mesh with per-triangle normals (ref: rayMesh.hpp:82-113)."""

    nodes: np.ndarray  # (V, 3)
    triangles: np.ndarray  # (N, 3) uint32
    grid_delta: float = 0.0
    normals: Optional[np.ndarray] = None

    def __post_init__(self):
        self.nodes = np.asarray(self.nodes, np.float32).reshape(-1, 3)
        self.triangles = np.asarray(self.triangles, np.uint32).reshape(-1, 3)
        if self.normals is None:
            self.normals = self.calculate_normals()
        else:
            self.normals = np.asarray(self.normals, np.float32).reshape(-1, 3)
        self.minimum_extent, self.maximum_extent = compute_bounding_box(self.nodes)

    def calculate_normals(self):
        """Cross-product normals (ref: rayMesh.hpp:99-112)."""
        p0 = self.nodes[self.triangles[:, 0]]
        p1 = self.nodes[self.triangles[:, 1]]
        p2 = self.nodes[self.triangles[:, 2]]
        n = np.cross(p1 - p0, p2 - p0)
        length = np.linalg.norm(n, axis=1, keepdims=True)
        return (n / np.where(length > 0, length, 1.0)).astype(np.float32)


@dataclasses.dataclass
class LineMesh:
    """2D line-segment mesh (ref: rayMesh.hpp:27-80).

    Normals are the left-hand perpendicular (-dy, dx); zero-length lines are
    dropped on construction.
    """

    nodes: np.ndarray  # (V, 3)
    lines: np.ndarray  # (N, 2) uint32
    grid_delta: float = 0.0

    def __post_init__(self):
        self.nodes = np.asarray(self.nodes, np.float32).reshape(-1, 3)
        self.lines = np.asarray(self.lines, np.uint32).reshape(-1, 2)
        p0 = self.nodes[self.lines[:, 0]]
        p1 = self.nodes[self.lines[:, 1]]
        d = p1 - p0
        length = np.linalg.norm(d, axis=1)
        keep = length > 1e-6
        self.lines = self.lines[keep]
        d = d[keep]
        length = length[keep][:, None]
        normals = np.stack(
            [-d[:, 1], d[:, 0], np.zeros(len(d), np.float32)], axis=1
        )
        self.normals = (normals / length).astype(np.float32)
        self.minimum_extent, self.maximum_extent = compute_bounding_box(self.nodes)


def lines_to_triangles(line_mesh: LineMesh) -> TriangleMesh:
    """Extrude each 2D line into two triangles at z = +-gridDelta/2
    (ref: rayMesh.hpp:133-175). Triangle ordering matches the reference:
    triangle 2i   = (2*l0, 2*l1, 2*l0+1)
    triangle 2i+1 = (2*l0+1, 2*l1, 2*l1+1)
    so even/odd triangles alternate which edge carries the segment length
    (used by the 2D area formula, rayGeometryTriangle.hpp:66-70).
    """
    half_w = line_mesh.grid_delta * 0.5
    pts = line_mesh.nodes
    nodes = np.empty((len(pts) * 2, 3), np.float32)
    nodes[0::2] = np.stack(
        [pts[:, 0], pts[:, 1], np.full(len(pts), half_w, np.float32)], axis=1
    )
    nodes[1::2] = np.stack(
        [pts[:, 0], pts[:, 1], np.full(len(pts), -half_w, np.float32)], axis=1
    )
    l0 = line_mesh.lines[:, 0].astype(np.uint32) * 2
    l1 = line_mesh.lines[:, 1].astype(np.uint32) * 2
    tri1 = np.stack([l0, l1, l0 + 1], axis=1)
    tri2 = np.stack([l0 + 1, l1, l1 + 1], axis=1)
    triangles = np.empty((len(l0) * 2, 3), np.uint32)
    triangles[0::2] = tri1
    triangles[1::2] = tri2
    return TriangleMesh(
        nodes=nodes, triangles=triangles, grid_delta=line_mesh.grid_delta
    )
