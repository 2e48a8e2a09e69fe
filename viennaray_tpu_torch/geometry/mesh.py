"""Host-side mesh containers (numpy).

Counterpart of ``viennaray_tpu/geometry/mesh.py``: ``DiskMesh`` and the
bounding box (rayMesh.hpp). Triangle and line meshes are not ported yet.
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
