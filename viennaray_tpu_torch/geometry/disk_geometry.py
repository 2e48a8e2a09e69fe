"""Device-resident oriented-disk geometry.

Counterpart of ``viennaray_tpu/geometry/disk_geometry.py``: the analog of
``GeometryDisk`` (rayGeometryDisk.hpp). The point cloud lives as torch tensors
on one device, with a padded neighbor matrix (for the disk multi-hit
semantics and flux smoothing), the packed SoA tables of the nearest-hit
kernel, and precomputed clipped areas. Built on the host (numpy) once per
geometry via ``DiskGeometry.build``. The uniform-grid field of the JAX
geometry is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..config import disk_factor
from ..device import resolve_device
from ..ops.nearest_hit import pack_disk_prims
from . import disk_area, neighborhood
from .mesh import DiskMesh, compute_bounding_box

# field -> dtype of the tables handed across by ``from_reference_arrays``
_FIELD_DTYPES = {
    "points": np.float32, "normals": np.float32, "radii": np.float32,
    "material_ids": np.int32, "neighbors": np.int32, "areas": np.float32,
    "bbox": np.float32, "prims_soa": np.float32, "soa_perm": np.int32,
    "soa_chunk_bbs": np.float32, "soa_inv_perm": np.int32,
    "neighbor_pack": np.float32,
}


@dataclasses.dataclass
class DiskGeometry:
    """Oriented-disk point cloud on one device.

    points: (N, 3); normals: (N, 3) unit; radii: (N,); material_ids: (N,) int32
    neighbors: (N, K) padded -1 (pairs within 2*radius,
      ref: rayGeometryDisk.hpp:97-98); areas: (N,) boundary-clipped.
    bbox: (2, 3) raw geometry bounds (pre source adjustment).
    prims_soa: (8, Npad) SoA packing for the nearest-hit kernel, Morton-compact
      chunks sorted source-side-first; soa_perm maps sorted->original ids,
      soa_chunk_bbs carries per-chunk AABBs, soa_inv_perm maps original id ->
      sorted position.
    neighbor_pack: (N, K*8) per-prim neighbor records
      [center(3) normal(3) radius valid]*K: one contiguous gather per hit.
    """

    points: torch.Tensor
    normals: torch.Tensor
    radii: torch.Tensor
    material_ids: torch.Tensor
    neighbors: torch.Tensor
    areas: torch.Tensor
    bbox: torch.Tensor
    prims_soa: torch.Tensor
    soa_perm: torch.Tensor
    soa_chunk_bbs: torch.Tensor
    soa_inv_perm: torch.Tensor
    neighbor_pack: torch.Tensor
    dim: int = 3
    grid_delta: float = 0.0
    disk_radius: float = 0.0

    @property
    def num_primitives(self) -> int:
        return self.points.shape[0]

    @property
    def device(self) -> torch.device:
        return self.points.device

    def replace(self, **changes) -> "DiskGeometry":
        return dataclasses.replace(self, **changes)

    @classmethod
    def from_reference_arrays(
        cls,
        fields: Dict[str, np.ndarray],
        *,
        dim: int,
        grid_delta: float,
        disk_radius: float,
        device,
    ) -> "DiskGeometry":
        """Geometry from the tables of a JAX-package ``DiskGeometry`` handed
        across as numpy arrays (all twelve array fields), so that both
        packages can trace the very same tables."""
        missing = sorted(set(_FIELD_DTYPES) - set(fields))
        if missing:
            raise KeyError(f"missing geometry fields: {missing}")
        tensors = {
            name: torch.from_numpy(np.array(fields[name], dt)).to(device)
            for name, dt in _FIELD_DTYPES.items()
        }
        return cls(
            **tensors, dim=int(dim), grid_delta=float(grid_delta),
            disk_radius=float(disk_radius),
        )

    @classmethod
    def build(
        cls,
        points,
        normals,
        grid_delta: float,
        dim: int = 3,
        disk_radius: Optional[float] = None,
        radii=None,
        material_ids=None,
        device=None,
    ) -> "DiskGeometry":
        """Host-side construction (ref: rayGeometryDisk.hpp:initGeometry).

        The tables go to ``device``; ``None`` is the CUDA device, and without
        one this raises (``device="cpu"`` asks for the CPU).

        In 2D the z coordinate of points and normals is zeroed
        (ref: rayGeometryDisk.hpp:49-51,68-69).
        """
        device = resolve_device(device)
        points = np.asarray(points, np.float32).reshape(-1, 3).copy()
        normals = np.asarray(normals, np.float32).reshape(-1, 3).copy()
        if dim == 2:
            points[:, 2] = 0.0
            normals[:, 2] = 0.0
        norms = np.linalg.norm(normals, axis=1, keepdims=True)
        normals = normals / np.where(norms > 0, norms, 1.0)

        if disk_radius is None:
            disk_radius = float(grid_delta) * disk_factor(dim)
        n = len(points)
        radii_arr = (
            np.full((n,), disk_radius, np.float32)
            if radii is None
            else np.asarray(radii, np.float32)
        )
        mat = (
            np.zeros((n,), np.int32)
            if material_ids is None
            else np.asarray(material_ids, np.int32)
        )

        bbox = compute_bounding_box(points)
        if dim == 2:
            bbox[:, 2] = 0.0

        nbrs, _ = neighborhood.build_neighborhood(
            points, 2.0 * disk_radius, dim=dim
        )

        sort_axis = 2 if dim == 3 else 1
        soa, soa_perm, soa_bbs = pack_disk_prims(
            points, normals, radii_arr, sort_axis=sort_axis
        )
        inv_perm = np.zeros((n,), np.int32)
        inv_perm[soa_perm[:n]] = np.arange(n, dtype=np.int32)

        k = nbrs.shape[1]
        cl = np.clip(nbrs, 0, None)
        pack = np.zeros((n, k, 8), np.float32)
        pack[:, :, 0:3] = points[cl]
        pack[:, :, 3:6] = normals[cl]
        pack[:, :, 6] = radii_arr[cl]
        pack[:, :, 7] = (nbrs >= 0).astype(np.float32)

        return cls.from_reference_arrays(
            dict(
                points=points, normals=normals, radii=radii_arr,
                material_ids=mat, neighbors=nbrs,
                areas=np.zeros((n,), np.float32), bbox=bbox, prims_soa=soa,
                soa_perm=soa_perm, soa_chunk_bbs=soa_bbs,
                soa_inv_perm=inv_perm, neighbor_pack=pack.reshape(n, -1),
            ),
            dim=dim, grid_delta=grid_delta, disk_radius=disk_radius,
            device=device,
        )

    @classmethod
    def from_mesh(cls, mesh: DiskMesh, dim: int = 3,
                  device=None) -> "DiskGeometry":
        radius = None if mesh.radius == 0.0 else float(mesh.radius)
        return cls.build(
            mesh.nodes, mesh.normals, mesh.grid_delta, dim=dim,
            disk_radius=radius, radii=mesh.radii, device=device,
        )

    def with_areas(self, boundary_dirs, boundary_conds) -> "DiskGeometry":
        """Compute boundary-clipped disk areas against the geometry's own
        bounding box (ref: rayGeometryDisk.hpp:computeDiskAreas uses
        ``this->getBoundingBox()``, i.e. the raw extents, not the
        source-adjusted box). Runs in float64 numpy on the host."""
        pts = self.points.cpu().numpy().astype(np.float64)
        nrm = self.normals.cpu().numpy().astype(np.float64)
        rad = self.radii.cpu().numpy().astype(np.float64)
        bbox = self.bbox.cpu().numpy().astype(np.float64)
        if self.dim == 3:
            areas = disk_area.disk_areas_3d(
                pts, nrm, rad, bbox, boundary_dirs, boundary_conds
            )
        else:
            areas = disk_area.disk_areas_2d(
                pts, nrm, rad, bbox, boundary_dirs, boundary_conds
            )
        return self.replace(
            areas=torch.from_numpy(np.asarray(areas, np.float32)).to(self.device)
        )
