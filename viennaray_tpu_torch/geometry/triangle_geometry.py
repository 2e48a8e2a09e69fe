"""Device-resident triangle geometry.

Counterpart of ``viennaray_tpu/geometry/triangle_geometry.py``: the analog of
``GeometryTriangle`` (rayGeometryTriangle.hpp). Vertex and index arrays live
as torch tensors on one device with per-triangle normals and areas and the
packed SoA tables of the closest-hit kernel. 2D line meshes are extruded to
triangle pairs up front (ref: rayTraceTriangle.hpp:76-81). Built on the host
(numpy) once per geometry via ``TriangleGeometry.build``. The uniform-grid
field of the JAX geometry is not ported: ``accel`` is accepted and unused.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict

import numpy as np
import torch

from ..device import resolve_device
from ..ops.nearest_hit import pack_triangle_prims
from .mesh import (
    LineMesh, TriangleMesh, compute_bounding_box, lines_to_triangles,
    with_dtype,
)

# field -> dtype of the tables handed across by ``from_reference_arrays``
_FIELD_DTYPES = {
    "vertices": np.float32, "triangles": np.int32, "normals": np.float32,
    "areas": np.float32, "material_ids": np.int32, "bbox": np.float32,
    "prims_soa": np.float32, "soa_perm": np.int32,
    "soa_chunk_bbs": np.float32, "soa_inv_perm": np.int32,
}


@dataclasses.dataclass
class TriangleGeometry:
    """vertices: (V, 3); triangles: (N, 3) int32; normals/areas per triangle.

    Areas: 3D = 0.5*|cross| ; 2D (extruded lines) = alternating half edge
    lengths so the two triangles of a segment each carry half the segment
    length (ref: rayGeometryTriangle.hpp:57-75,147-176).
    prims_soa: (12, Npad) SoA packing [v0 e1 e2 n] for the closest-hit kernel;
    soa_perm maps sorted->original ids, soa_chunk_bbs carries per-chunk AABBs,
    soa_inv_perm maps original id -> sorted position.
    """

    kind: ClassVar[str] = "triangle"  # the primitive kind the kernels search

    vertices: torch.Tensor
    triangles: torch.Tensor
    normals: torch.Tensor
    areas: torch.Tensor
    material_ids: torch.Tensor
    bbox: torch.Tensor
    prims_soa: torch.Tensor
    soa_perm: torch.Tensor
    soa_chunk_bbs: torch.Tensor
    soa_inv_perm: torch.Tensor
    dim: int = 3
    grid_delta: float = 0.0

    @property
    def num_primitives(self) -> int:
        return self.triangles.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vertices.device

    def replace(self, **changes) -> "TriangleGeometry":
        return dataclasses.replace(self, **changes)

    @property
    def dtype(self) -> torch.dtype:
        """The float type of the tables: float32 as built, float64 after
        ``to(torch.float64)``."""
        return self.prims_soa.dtype

    def to(self, dtype) -> "TriangleGeometry":
        """The geometry in ``dtype`` (``mesh.with_dtype``): the float64
        tracing of ``trace.kernel.trace_batch`` and ``diff`` takes a
        geometry widened so. The SoA's edges e1 = v1 - v0 and e2 = v2 - v0
        are recomputed in ``dtype`` from the widened vertices, as the JAX
        package's float64 search computes them
        (viennaray_tpu/ops/intersect.py:114-116)."""
        if dtype == self.dtype:
            return self
        geo = with_dtype(self, dtype)
        n = geo.num_primitives
        soa = geo.prims_soa.detach().clone()
        tri = geo.triangles.long()[geo.soa_perm[:n].long()]
        v = geo.vertices.detach()
        v0 = v[tri[:, 0]]
        soa[3:6, :n] = (v[tri[:, 1]] - v0).T
        soa[6:9, :n] = (v[tri[:, 2]] - v0).T
        return geo.replace(prims_soa=soa)

    @classmethod
    def from_reference_arrays(
        cls,
        fields: Dict[str, np.ndarray],
        *,
        dim: int,
        grid_delta: float,
        device,
    ) -> "TriangleGeometry":
        """Geometry from the tables of a JAX-package ``TriangleGeometry``
        handed across as numpy arrays (all ten array fields), so that both
        packages can trace the very same tables."""
        missing = sorted(set(_FIELD_DTYPES) - set(fields))
        if missing:
            raise KeyError(f"missing geometry fields: {missing}")
        tensors = {
            name: torch.from_numpy(np.array(fields[name], dt)).to(device)
            for name, dt in _FIELD_DTYPES.items()
        }
        return cls(**tensors, dim=int(dim), grid_delta=float(grid_delta))

    @classmethod
    def build(
        cls,
        vertices,
        triangles,
        grid_delta: float,
        dim: int = 3,
        normals=None,
        material_ids=None,
        accel: bool = True,
        device=None,
    ) -> "TriangleGeometry":
        """Host-side construction (ref: rayGeometryTriangle.hpp:initGeometry).

        The tables go to ``device``; ``None`` is the CUDA device, and without
        one this raises (``device="cpu"`` asks for the CPU).
        """
        device = resolve_device(device)
        vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
        triangles = np.asarray(triangles, np.int32).reshape(-1, 3)
        n = len(triangles)

        v0 = vertices[triangles[:, 0]]
        v1 = vertices[triangles[:, 1]]
        v2 = vertices[triangles[:, 2]]
        cr = np.cross(v1 - v0, v2 - v0)
        length = np.linalg.norm(cr, axis=1)
        safe = np.where(length > 0, length, 1.0)
        if normals is None:
            normals = cr / safe[:, None]
            normals[length == 0] = 0.0  # degenerate guard
            # (ref: rayGeometryTriangle.hpp:171-175)
        else:
            normals = np.asarray(normals, np.float32).reshape(-1, 3)

        if dim == 2:
            even = np.arange(n) % 2 == 0
            areas = np.where(
                even,
                0.5 * np.linalg.norm(v1 - v0, axis=1),
                0.5 * np.linalg.norm(v2 - v0, axis=1),
            )
        else:
            areas = 0.5 * length
        areas = np.where(length > 0, areas, 0.0)

        mat = (
            np.zeros((n,), np.int32)
            if material_ids is None
            else np.asarray(material_ids, np.int32)
        )
        bbox = compute_bounding_box(vertices)

        sort_axis = 2 if dim == 3 else 1
        soa, soa_perm, soa_bbs = pack_triangle_prims(
            vertices, triangles, normals=normals, sort_axis=sort_axis
        )
        inv_perm = np.zeros((n,), np.int32)
        inv_perm[soa_perm[:n]] = np.arange(n, dtype=np.int32)

        return cls.from_reference_arrays(
            dict(
                vertices=vertices, triangles=triangles, normals=normals,
                areas=areas, material_ids=mat, bbox=bbox, prims_soa=soa,
                soa_perm=soa_perm, soa_chunk_bbs=soa_bbs,
                soa_inv_perm=inv_perm,
            ),
            dim=dim, grid_delta=grid_delta, device=device,
        )

    @classmethod
    def from_mesh(cls, mesh: TriangleMesh, dim: int = 3,
                  device=None) -> "TriangleGeometry":
        return cls.build(
            mesh.nodes, mesh.triangles, mesh.grid_delta, dim=dim,
            normals=mesh.normals, device=device,
        )

    @classmethod
    def from_line_mesh(cls, mesh: LineMesh, device=None) -> "TriangleGeometry":
        """2D path: extrude lines to triangles (ref: rayTraceTriangle.hpp:76-81)."""
        return cls.from_mesh(lines_to_triangles(mesh), dim=2, device=device)
