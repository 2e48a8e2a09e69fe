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
from typing import ClassVar, Dict, Optional

import numpy as np
import torch

from ..config import disk_factor
from ..device import resolve_device
from ..ops import vec
from ..ops.nearest_hit import pack_disk_prims
from . import disk_area, neighborhood
from .mesh import DiskMesh, compute_bounding_box, with_dtype

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
    window_ids, window_pack: the window list of the window flux model, or
      ``None`` until ``with_window_list`` builds it: (N, W) int32 padded -1,
      and (N, W*8) records in the SoA's layout [center(3) normal(3) r2 n.c]
      (a padding record is all zeros: its zero normal never passes).
    """

    kind: ClassVar[str] = "disk"  # the primitive kind the kernels search

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
    window_ids: Optional[torch.Tensor] = None
    window_pack: Optional[torch.Tensor] = None

    @property
    def num_primitives(self) -> int:
        return self.points.shape[0]

    @property
    def device(self) -> torch.device:
        return self.points.device

    def replace(self, **changes) -> "DiskGeometry":
        return dataclasses.replace(self, **changes)

    @property
    def dtype(self) -> torch.dtype:
        """The float type of the tables: float32 as built, float64 after
        ``to(torch.float64)``."""
        return self.prims_soa.dtype

    def to(self, dtype) -> "DiskGeometry":
        """The geometry in ``dtype`` (``mesh.with_dtype``): the float64
        tracing of ``trace.kernel.trace_batch`` and ``diff`` takes a
        geometry widened so. The SoA's derived rows, r^2 and n . c ((x + y)
        + z), are recomputed in ``dtype`` from the widened radii, normals and
        centres, as the JAX package's float64 search computes them
        (viennaray_tpu/ops/intersect.py:54-55), and so is the window list's
        copy of them."""
        if dtype == self.dtype:
            return self
        geo = with_dtype(self, dtype)
        soa = geo.prims_soa.detach().clone()
        lanes = geo.soa_inv_perm.long()
        r = geo.radii.detach()
        soa[6, lanes] = r * r
        soa[7, lanes] = vec.dot(geo.normals.detach(), geo.points.detach())
        geo = geo.replace(prims_soa=soa)
        if geo.window_ids is not None:
            columns = soa.T[lanes]
            ids = geo.window_ids.long()
            pack = torch.where((ids >= 0)[:, :, None],
                               columns[torch.clamp(ids, min=0)],
                               torch.zeros((), dtype=dtype, device=geo.device))
            geo = geo.replace(window_pack=pack.reshape(len(ids), -1))
        return geo

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

    @property
    def window_tau(self) -> float:
        """The window flux model's width past the primary hit: 1.1 grid
        deltas (ref: gpu/raygTrace.hpp:116)."""
        return 1.1 * self.grid_delta

    def with_window_list(self) -> "DiskGeometry":
        """The geometry with its window list (itself when it has one).

        Under the window flux model a colliding ray deposits on every disk j
        it crosses with t_near < t_j <= t_hit + tau. The primary hit is the
        closest valid crossing, so t_j >= t_hit: the crossing point of j lies
        within r_j of c_j and within tau |d| of the primary hit point, which
        lies within r_i of the hit disk's centre c_i. Every such j has
        |c_j - c_i| < tau + 2 r_max, and the window list of disk i holds
        every disk within that distance, widened by a relative 1e-4 against
        rounding, the hit disk itself first. Its records are the SoA's
        columns bit for bit, so that a kernel re-testing them computes what
        its search computed. Built on the host once (numpy)."""
        if self.window_pack is not None:
            return self
        ids, pack = window_tables(
            self.points.detach().cpu().numpy(), self.prims_soa.cpu().numpy(),
            self.soa_inv_perm.cpu().numpy(), self.window_radius(), self.dim,
        )
        return self.replace(
            window_ids=torch.from_numpy(ids).to(self.device),
            window_pack=torch.from_numpy(pack).to(self.device, self.dtype),
        )

    def window_radius(self) -> float:
        """The distance between centres within which a disk can take a
        window deposit from a hit on another: (tau + 2 r_max)(1 + 1e-4)."""
        r_max = max(self.disk_radius, float(self.radii.max()))
        return (self.window_tau + 2.0 * r_max) * (1.0 + 1e-4)

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
            areas=torch.from_numpy(np.asarray(areas, np.float32)).to(
                self.device, self.dtype)
        )


def window_tables(points, prims_soa, inv_perm, radius, dim):
    """The window list of every disk: (ids (N, W) int32, padded -1, the disk
    itself in slot 0; records (N, W*8) of the SoA's type, each the disk's
    SoA column
    [cx cy cz nx ny nz r2 n.c], zeros for padding). W is the longest list."""
    n = len(points)
    nbrs, _ = neighborhood.build_neighborhood(points, radius, dim=dim)
    ids = np.concatenate([np.arange(n, dtype=np.int32)[:, None], nbrs], axis=1)
    columns = np.asarray(prims_soa).T[np.asarray(inv_perm)]
    pack = np.where((ids >= 0)[:, :, None], columns[np.clip(ids, 0, None)], 0.0)
    return ids, pack.astype(columns.dtype).reshape(n, -1)
