"""Device-resident oriented-disk geometry.

Counterpart of ``viennaray_tpu/geometry/disk_geometry.py``: the analog of
``GeometryDisk`` (rayGeometryDisk.hpp). The point cloud lives as torch tensors
on one device, with a padded neighbor matrix (for the disk multi-hit
semantics and flux smoothing), the packed SoA tables of the nearest-hit
kernel, and precomputed clipped areas. Built once per geometry via
``DiskGeometry.build``: on the host (numpy), but for the neighbor table,
which is built on the card where the device is CUDA
(``neighborhood.build_neighborhood``), and the neighbor records, gathered
on the device. ``build(accel=True)`` (the default) also builds the uniform grid
of the grid DDA (``grid``, ``geometry.grid_accel.GridData``), as the JAX
geometry does.
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
from ..utils import telemetry
from . import disk_area, grid_accel, neighborhood
from .grid_accel import GridData
from .mesh import DiskMesh, compute_bounding_box, with_dtype

# the fields ``with_areas`` reads: a ``replace`` that changes one drops the
# key the areas were computed for
_AREAS_INPUTS = frozenset(("points", "normals", "radii", "bbox", "dim",
                           "areas"))

# field -> dtype of the tables handed across by ``from_reference_arrays``
_FIELD_DTYPES = {
    "points": np.float32, "normals": np.float32, "radii": np.float32,
    "material_ids": np.int32, "neighbors": np.int32, "areas": np.float32,
    "bbox": np.float32, "prims_soa": np.float32, "soa_perm": np.int32,
    "soa_chunk_bbs": np.float32, "soa_inv_perm": np.int32,
    "neighbor_pack": np.float32,
}
# the same as torch dtypes, for a field handed as a tensor
_TORCH_DTYPES = {np.float32: torch.float32, np.int32: torch.int32}


def _on_device(value, dtype, device):
    """A field of ``from_reference_arrays`` on ``device``: None as it is, a
    tensor already there of the field's dtype as it is, else a copy."""
    if value is None:
        return None
    if not isinstance(value, torch.Tensor):
        return torch.from_numpy(np.array(value, dtype)).to(device)
    device = torch.device(device)
    if (value.dtype != _TORCH_DTYPES[dtype]
            or value.device.type != device.type
            or device.index not in (None, value.device.index)):
        raise ValueError(f"a {value.dtype} tensor on {value.device} handed as "
                         f"a {np.dtype(dtype)} field on {device}")
    return value


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
      [center(3) normal(3) radius valid]*K: one contiguous gather per hit;
      ``None`` from ``build(..., pack_neighbors=False)`` until
      ``with_neighbor_pack`` gathers it (the trace does, where a deposit
      needs it).
    window_ids, window_pack: the window list of the window flux model, or
      ``None`` until ``with_window_list`` builds it: (N, W) int32 padded -1,
      and (N, W*8) records in the SoA's layout [center(3) normal(3) r2 n.c]
      (a padding record is all zeros: its zero normal never passes).
    grid: the uniform grid of the grid DDA (``grid_accel.GridData``), or
      ``None`` (``build(..., accel=False)``, or no disks).
    areas_key: what ``areas`` were computed for by ``with_areas``,
      (dim, boundary_dirs, boundary_conds) as tuples of ints, or ``None``
      for the placeholder or handed-across areas of a new geometry.
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
    neighbor_pack: Optional[torch.Tensor]
    dim: int = 3
    grid_delta: float = 0.0
    disk_radius: float = 0.0
    window_ids: Optional[torch.Tensor] = None
    window_pack: Optional[torch.Tensor] = None
    grid: Optional[GridData] = None
    areas_key: Optional[tuple] = None

    @property
    def num_primitives(self) -> int:
        return self.points.shape[0]

    @property
    def device(self) -> torch.device:
        return self.points.device

    def replace(self, **changes) -> "DiskGeometry":
        """A copy with ``changes``; one to a field the areas are computed
        from (or to ``areas``) drops ``areas_key``, so that ``with_areas``
        computes them again."""
        if "areas_key" not in changes and not _AREAS_INPUTS.isdisjoint(
                changes):
            changes["areas_key"] = None
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
        if geo.grid is not None:
            geo = geo.replace(grid=geo.grid.to(dtype))
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
        grid=None,
    ) -> "DiskGeometry":
        """Geometry from the tables of a JAX-package ``DiskGeometry`` handed
        across as numpy arrays (all twelve array fields; ``neighbor_pack``
        may be None, as a JAX geometry built with ``pack_neighbors=False``
        holds it), so that both packages can trace the very same tables.
        A field may also be a tensor on ``device`` of the field's dtype,
        taken as it is (``build`` hands its points and neighbor table so
        where it built the table on the card).
        ``grid``: its ``GridData`` as numpy arrays (``cells``, ``origin``,
        ``cell_size``, ``dims``), or None for a geometry without one; the
        walk's table is built from it and the disks' boxes."""
        missing = sorted(set(_FIELD_DTYPES) - set(fields))
        if missing:
            raise KeyError(f"missing geometry fields: {missing}")
        tensors = {
            name: _on_device(fields[name], dt, device)
            for name, dt in _FIELD_DTYPES.items()
        }
        if grid is not None:
            grid = GridData.from_reference_arrays(
                grid, *grid_accel.disk_boxes(
                    np.asarray(fields["points"], np.float32),
                    np.asarray(fields["radii"], np.float32)),
                fields["soa_inv_perm"], int(dim), device)
        return cls(
            **tensors, dim=int(dim), grid_delta=float(grid_delta),
            disk_radius=float(disk_radius), grid=grid,
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
        accel: bool = True,
        pack_neighbors: bool = True,
    ) -> "DiskGeometry":
        """Host-side construction (ref: rayGeometryDisk.hpp:initGeometry).

        The tables go to ``device``; ``None`` is the CUDA device, and without
        one this raises (``device="cpu"`` asks for the CPU). On a CUDA
        device the neighbor table is built there from the points' copy
        (``neighborhood.build_neighborhood_cuda``), which the geometry
        keeps; elsewhere by the host helper. The tables are the same.

        ``accel``: build the uniform grid of the grid DDA (``grid``), as the
        JAX package's ``build`` does, wherever there are disks; the trace
        walks it from ``TraceConfig.grid_min_prims`` disks on. The (N, K*8)
        neighbor records are gathered on the device (``with_neighbor_pack``);
        ``pack_neighbors=False`` leaves them out (about 600 MB at 700,000
        disks). Unlike the JAX package's fused kernel, which sweeps the
        chunks a second time for its neighbor deposits, the port's bounce
        kernel gathers these records, so the trace still needs them: it
        gathers them once, where a deposit of the neighbor flux model needs
        them (``trace.kernel.with_deposit_tables``; ``TraceDisk.apply``
        keeps them for its later applies).

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

        # on a CUDA device the table is built there, from the points' copy
        # that the geometry keeps (no synchronise: the table's size is the
        # build's one read, and its fill is queued behind it)
        on_device = device.type == "cuda"
        with telemetry.span("geometry.neighborhood") as sp:
            nbr_points = (torch.from_numpy(points).to(device) if on_device
                          else points)
            nbrs, _ = neighborhood.build_neighborhood(
                nbr_points, 2.0 * disk_radius, dim=dim
            )
            sp.set(K=nbrs.shape[1], on_device=int(on_device))

        # ``geometry.pack``: the SoA on the host, then, after the grid (whose
        # build on the device peaks before the tables take the card's
        # memory), the tables' copies to the device and the neighbor records
        with telemetry.span("geometry.pack"):
            sort_axis = 2 if dim == 3 else 1
            soa, soa_perm, soa_bbs = pack_disk_prims(
                points, normals, radii_arr, sort_axis=sort_axis
            )
            inv_perm = np.zeros((n,), np.int32)
            inv_perm[soa_perm[:n]] = np.arange(n, dtype=np.int32)

        grid = None
        if accel and n > 0:
            with telemetry.span("geometry.grid") as sp:
                grid = GridData.build(
                    grid_accel.build_disk_grid(points, normals, radii_arr,
                                               dim=dim),
                    *grid_accel.disk_boxes(points, radii_arr), inv_perm, dim,
                    device)
                sp.set(cells=int(np.prod(grid.dims)))
        with telemetry.span("geometry.pack") as sp:
            fields = dict(
                points=nbr_points, normals=normals, radii=radii_arr,
                material_ids=mat, neighbors=nbrs,
                areas=np.zeros((n,), np.float32), bbox=bbox, prims_soa=soa,
                soa_perm=soa_perm, soa_chunk_bbs=soa_bbs,
                soa_inv_perm=inv_perm, neighbor_pack=None,
            )
            sp.set(bytes=sum(a.nbytes for a in fields.values()
                             if isinstance(a, np.ndarray)))
            geometry = cls.from_reference_arrays(
                fields, dim=dim, grid_delta=grid_delta,
                disk_radius=disk_radius, device=device,
            ).replace(grid=grid)
            return (geometry.with_neighbor_pack() if pack_neighbors
                    else geometry)

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

    def with_neighbor_pack(self) -> "DiskGeometry":
        """The geometry with its neighbor records (itself when it has them):
        row i holds [center(3) normal(3) radius valid] of each of disk i's K
        neighbor-list disks (valid 0 and disk 0's values in a padding slot),
        gathered on the geometry's device from its own tables: the JAX
        package's host packing bit for bit, as a gather rounds nothing.
        Outside any gradient's graph."""
        if self.neighbor_pack is not None:
            return self
        nbrs = self.neighbors.long()
        cl = torch.clamp(nbrs, min=0)
        radii = self.radii.detach()[cl][..., None]
        pack = torch.cat([
            self.points.detach()[cl], self.normals.detach()[cl], radii,
            (nbrs >= 0)[..., None].to(radii.dtype),
        ], dim=2)
        return self.replace(
            neighbor_pack=pack.reshape(len(nbrs), nbrs.shape[1] * 8))

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
        """The geometry with its boundary-clipped disk areas for these walls:
        itself when its ``areas_key`` says they were computed for them, so
        that they are computed once per geometry and wall setting (a
        ``replace`` of the points, normals, radii, bounding box, ``dim`` or
        areas drops the key, as does ``to``). Else they are computed against
        the geometry's own bounding box (ref: rayGeometryDisk.hpp
        :computeDiskAreas uses ``this->getBoundingBox()``, i.e. the raw
        extents, not the source-adjusted box), in float64 numpy on the host,
        inside the span ``areas``, and counted in ``areas_computed``."""
        key = (int(self.dim), tuple(int(d) for d in boundary_dirs),
               tuple(int(c) for c in boundary_conds))
        if key == self.areas_key:
            return self
        telemetry.COUNTS["areas_computed"] += 1
        with telemetry.span("areas"):
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
                    self.device, self.dtype),
                areas_key=key,
            )


telemetry.declare("areas_computed")  # areas computed, always counted


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
