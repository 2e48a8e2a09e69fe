"""Device-resident 2D line-segment geometry.

Counterpart of ``viennaray_tpu/geometry/line_geometry.py``: native segment
primitives (parity with the GPU-only line tracer, gpu/raygTraceLine.hpp +
gpu/raygLineGeometry.hpp). Segments are intersected directly in 2D with the
reference's endpoint-clipped cross-product test (GeneralPipelineLine.cu:19-49)
— no triangle extrusion. Areas are segment lengths; smoothing is not
implemented (matches raygTraceLine.hpp:26-28). Built on the host (numpy) once
per geometry via ``LineGeometry.from_mesh``.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict

import numpy as np
import torch

from ..device import resolve_device
from ..ops.nearest_hit import pack_line_prims
from ..utils import telemetry
from .mesh import LineMesh, compute_bounding_box, with_dtype

# field -> dtype of the tables handed across by ``from_reference_arrays``
_FIELD_DTYPES = {
    "p0": np.float32, "p1": np.float32, "normals": np.float32,
    "areas": np.float32, "material_ids": np.int32, "bbox": np.float32,
    "prims_soa": np.float32, "soa_perm": np.int32,
    "soa_chunk_bbs": np.float32, "soa_inv_perm": np.int32,
}


@dataclasses.dataclass
class LineGeometry:
    """p0/p1: (N, 3) segment endpoints (z = 0); normals: (-dy, dx)
    normalized, (N, 3) with z = 0; areas: segment lengths.
    prims_soa: (6, Npad) SoA packing [p0x p0y ldx ldy nx ny] for the
    closest-hit and bounce kernels; soa_perm maps sorted->original ids,
    soa_chunk_bbs carries per-chunk AABBs (z inflated by +-1), soa_inv_perm
    maps original id -> sorted position.
    """

    kind: ClassVar[str] = "line"  # the primitive kind the kernels search

    p0: torch.Tensor
    p1: torch.Tensor
    normals: torch.Tensor
    areas: torch.Tensor
    material_ids: torch.Tensor
    bbox: torch.Tensor
    prims_soa: torch.Tensor
    soa_perm: torch.Tensor
    soa_chunk_bbs: torch.Tensor
    soa_inv_perm: torch.Tensor
    dim: int = 2
    grid_delta: float = 0.0

    @property
    def num_primitives(self) -> int:
        return self.p0.shape[0]

    @property
    def device(self) -> torch.device:
        return self.p0.device

    # alias so the trace can treat all geometries uniformly
    @property
    def points(self) -> torch.Tensor:
        return self.p0

    def replace(self, **changes) -> "LineGeometry":
        return dataclasses.replace(self, **changes)

    @property
    def dtype(self) -> torch.dtype:
        """The float type of the tables: float32 as built, float64 after
        ``to(torch.float64)``."""
        return self.prims_soa.dtype

    def to(self, dtype) -> "LineGeometry":
        """The geometry in ``dtype`` (``mesh.with_dtype``): the float64
        tracing of ``trace.kernel.trace_batch`` and ``diff`` takes a
        geometry widened so. The SoA's segment directions p1 - p0 are
        recomputed in ``dtype`` from the widened end points, as the JAX
        package's float64 search computes them
        (viennaray_tpu/ops/intersect.py:186)."""
        if dtype == self.dtype:
            return self
        geo = with_dtype(self, dtype)
        n = geo.num_primitives
        soa = geo.prims_soa.detach().clone()
        order = geo.soa_perm[:n].long()
        soa[2:4, :n] = (geo.p1.detach() - geo.p0.detach())[order, :2].T
        return geo.replace(prims_soa=soa)

    @classmethod
    def from_reference_arrays(
        cls,
        fields: Dict[str, np.ndarray],
        *,
        grid_delta: float,
        device,
    ) -> "LineGeometry":
        """Geometry from the tables of a JAX-package ``LineGeometry`` handed
        across as numpy arrays (all ten array fields), so that both packages
        can trace the very same tables."""
        missing = sorted(set(_FIELD_DTYPES) - set(fields))
        if missing:
            raise KeyError(f"missing geometry fields: {missing}")
        tensors = {
            name: torch.from_numpy(np.array(fields[name], dt)).to(device)
            for name, dt in _FIELD_DTYPES.items()
        }
        return cls(**tensors, dim=2, grid_delta=float(grid_delta))

    @classmethod
    def from_mesh(cls, mesh: LineMesh, material_ids=None,
                  device=None) -> "LineGeometry":
        """Host-side construction. The tables go to ``device``; ``None`` is
        the CUDA device, and without one this raises (``device="cpu"`` asks
        for the CPU)."""
        device = resolve_device(device)
        p0 = mesh.nodes[mesh.lines[:, 0]].astype(np.float32)
        p1 = mesh.nodes[mesh.lines[:, 1]].astype(np.float32)
        p0[:, 2] = 0.0
        p1[:, 2] = 0.0
        n = len(p0)
        lengths = np.linalg.norm((p1 - p0)[:, :2], axis=1)
        mat = (
            np.zeros((n,), np.int32)
            if material_ids is None
            else np.asarray(material_ids, np.int32)
        )
        bbox = compute_bounding_box(np.concatenate([p0, p1]))
        bbox[:, 2] = 0.0

        # the SoA and the tables' copies to the device
        with telemetry.span("geometry.pack") as sp:
            soa, soa_perm, soa_bbs = pack_line_prims(p0, p1, mesh.normals)
            inv_perm = np.zeros((n,), np.int32)
            inv_perm[soa_perm[:n]] = np.arange(n, dtype=np.int32)
            fields = dict(
                p0=p0, p1=p1, normals=mesh.normals, areas=lengths,
                material_ids=mat, bbox=bbox, prims_soa=soa,
                soa_perm=soa_perm, soa_chunk_bbs=soa_bbs,
                soa_inv_perm=inv_perm,
            )
            sp.set(bytes=sum(np.asarray(a).nbytes for a in fields.values()))
            return cls.from_reference_arrays(
                fields, grid_delta=mesh.grid_delta, device=device)
