"""Batched ray sources.

Counterpart of ``viennaray_tpu/physics/source.py``:

- ``RandomSource`` (ref: raySourceRandom.hpp) — uniform origins on the source
  plane, power-cosine directions, optionally tilted around a primary
  direction;
- ``GridSource`` (ref: raySourceGrid.hpp) — origins cycling through a
  precomputed grid (``io.fixtures.create_source_grid``) by global ray index,
  the same direction distribution;
- ``SurfaceSource`` (ref: gpu/raygTrace.hpp:267-297, gpu/raygSource.hpp:
  102-132) — rays from surface points along their normals, with per-point
  relative weights.

A source's ``sample(rng, batch_index, n, ray_indices)`` returns (origins
(n, 3), directions (n, 3), weights (n,)) of one batch on the trace's device,
in the trace's float type: float32, or float64 for the float64 trace, where a
source samples in the type of its box, grid or points (``to(dtype)`` widens
them) from a ``RayRNG`` of that type, as the JAX package's sources sample in
``self.bbox.dtype`` / ``self.grid.dtype`` / ``self.points.dtype``. Any object with such a method is a source (``check_source``): a
user's source draws from ``rng`` as these do, by stream, and gives
``source_area()`` where the flux is normalized to the source. The three here
are the reference's; the grid and surface sources pick their
points by the global ray indices and draw their lobe from the streams
``SOURCE_LOBE_1`` / ``SOURCE_LOBE_2`` (the JAX package feeds them the batch's
source key unsplit, where the random source splits it into origin and
direction keys).

2D note: the reference samples the full 3D lobe and lets
``fillRayDirection<2>`` zero the z component and renormalize
(rayUtil.hpp:210-215). Mirrored exactly: the 2D direction distribution is the
z-flattened renormalized 3D one.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Optional

import numpy as np
import torch

from .. import rng as rng_streams
from ..config import adjust_bounding_box, get_trace_settings
from ..device import resolve_device
from ..ops import sampling, vec

MAX_REJECTION_ROUNDS = 64


@dataclasses.dataclass
class RandomSource:
    """Uniform plane origins + power-cosine directions (raySourceRandom.hpp)."""

    bbox: torch.Tensor  # (2, 3) adjusted bounding box, float32, on the device
    cosine_power: float
    basis: Optional[torch.Tensor] = None  # (3, 3) ONB rows for a tilted source
    ray_dir: int = 2
    first_dir: int = 0
    second_dir: int = 1
    min_max: int = 1
    pos_neg: float = -1.0
    dim: int = 3
    num_points: int = 0

    @property
    def dtype(self):
        return self.bbox.dtype

    @classmethod
    def default(cls, geometry, config, cosine_power: float = 1.0
                ) -> "RandomSource":
        """The tracers' own source for ``geometry`` under ``config``: the
        plane on the face ``config.source_direction`` names of
        ``source_box(geometry, config)`` (in float32 on the geometry's
        device), tilted to ``config.primary_direction`` where one is given,
        a point per primitive. Its ``bbox`` is the box that ``trace_batch``
        and the sharded trace take beside it."""
        ray_dir, first_dir, second_dir, min_max, pos_neg = (
            get_trace_settings(config.source_direction))
        dev = geometry.device
        basis = None
        if config.primary_direction is not None:
            basis = vec.orthonormal_basis(torch.tensor(
                config.primary_direction, dtype=torch.float32, device=dev))
        return cls(
            bbox=torch.tensor(source_box(geometry, config),
                              dtype=torch.float32, device=dev),
            cosine_power=float(cosine_power), basis=basis, ray_dir=ray_dir,
            first_dir=first_dir, second_dir=second_dir, min_max=min_max,
            pos_neg=float(pos_neg), dim=config.dim,
            num_points=geometry.num_primitives,
        )

    def replace(self, **changes) -> "RandomSource":
        """A copy with ``changes`` (the JAX package's ``struct`` method)."""
        return dataclasses.replace(self, **changes)

    def to(self, dtype) -> "RandomSource":
        """The source sampling in ``dtype``: its box and basis cast."""
        basis = None if self.basis is None else self.basis.to(dtype)
        return dataclasses.replace(self, bbox=self.bbox.to(dtype), basis=basis)

    def source_area(self):
        """(ref: raySourceRandom.hpp:40-47)"""
        return _plane_area(self.bbox, self.first_dir, self.second_dir,
                           self.dim)

    def _origins(self, rng, batch_index, n):
        r1 = rng.uniform(rng_streams.SOURCE_ORIGIN_1, batch_index, 0, n)
        lo1 = self.bbox[0, self.first_dir]
        hi1 = self.bbox[1, self.first_dir]
        origins = torch.zeros((n, 3), dtype=self.bbox.dtype,
                              device=self.bbox.device)
        origins[:, self.ray_dir] = self.bbox[self.min_max, self.ray_dir]
        origins[:, self.first_dir] = lo1 + (hi1 - lo1) * r1
        if self.dim == 3:
            r2 = rng.uniform(rng_streams.SOURCE_ORIGIN_2, batch_index, 0, n)
            lo2 = self.bbox[0, self.second_dir]
            hi2 = self.bbox[1, self.second_dir]
            origins[:, self.second_dir] = lo2 + (hi2 - lo2) * r2
        return origins

    def _lobe(self, rng, batch_index, round_index, n):
        r1 = rng.uniform(rng_streams.SOURCE_DIR_1, batch_index, round_index, n)
        r2 = rng.uniform(rng_streams.SOURCE_DIR_2, batch_index, round_index, n)
        return sampling.power_cosine_direction(r1, r2, self.cosine_power)

    def _directions(self, rng, batch_index, round_index, n):
        lobe = self._lobe(rng, batch_index, round_index, n)
        d = torch.zeros_like(lobe)
        # axis mapping (ref: raySourceRandom.hpp:81-83)
        d[:, self.ray_dir] = self.pos_neg * lobe[:, 2]
        d[:, self.first_dir] = lobe[:, 0]
        d[:, self.second_dir] = lobe[:, 1]
        return d

    def _custom_directions(self, rng, batch_index, n):
        """Tilted lobe rotated by the primary-direction ONB, rejecting samples
        pointing away from the trace direction (ref: raySourceRandom.hpp:
        88-116): a batch-level accept-reject loop that re-proposes only the
        lanes that have not accepted yet."""
        value = torch.zeros((n, 3), dtype=self.bbox.dtype,
                            device=self.bbox.device)
        done = torch.zeros(n, dtype=torch.bool, device=self.bbox.device)
        for i in range(MAX_REJECTION_ROUNDS):
            if bool(done.all()):
                break
            lobe = self._lobe(rng, batch_index, i, n)
            # reference maps (cosTheta, cosPhi sinTheta, sinPhi sinTheta)
            # through ONB rows: d = B0*l0 + B1*l1 + B2*l2
            cand = (
                lobe[:, 2:3] * self.basis[0]
                + lobe[:, 0:1] * self.basis[1]
                + lobe[:, 1:2] * self.basis[2]
            )
            comp = cand[:, self.ray_dir]
            ok = comp <= 0.0 if self.pos_neg < 0 else comp >= 0.0
            value = torch.where((ok & ~done)[:, None], cand, value)
            done = done | ok
        # lanes that never accepted fall back to the untilted lobe
        fallback = self._directions(rng, batch_index, -1, n)
        return torch.where(done[:, None], value, fallback)

    def sample(self, rng, batch_index, n, ray_indices=None):
        """(origins (n, 3), directions (n, 3), weights (n,)) for one batch;
        ``ray_indices`` is not read."""
        origins = self._origins(rng, batch_index, n)
        if self.basis is not None:
            dirs = self._custom_directions(rng, batch_index, n)
        else:
            dirs = self._directions(rng, batch_index, 0, n)
        if self.dim == 2:
            dirs = vec.flatten_2d(dirs)
        weights = torch.ones(n, dtype=self.bbox.dtype, device=self.bbox.device)
        return origins, dirs, weights


def source_box(geometry, config):
    """The geometry's bounding box extended toward the source face
    (``config.adjust_bounding_box``) by the disk radius, or by the grid
    delta for triangles and lines (ref: rayTraceDisk.hpp:30,
    rayTraceTriangle.hpp:31): a (2, 3) float64 numpy array."""
    margin = (geometry.disk_radius if geometry.kind == "disk"
              else geometry.grid_delta)
    return adjust_bounding_box(geometry.bbox.detach().cpu().numpy(),
                               config.source_direction, margin, config.dim)


def _plane_area(bbox, first_dir, second_dir, dim):
    """The source plane's area: its extent along the first lateral axis, times
    the second's in 3D (ref: raySourceRandom.hpp:40-47)."""
    ext1 = bbox[1, first_dir] - bbox[0, first_dir]
    if dim == 2:
        return ext1
    return ext1 * (bbox[1, second_dir] - bbox[0, second_dir])


def _lobe(rng, batch_index, n, cosine_power):
    """The power-cosine lobe around +z from the streams of a source that
    draws no origin."""
    r1 = rng.uniform(rng_streams.SOURCE_LOBE_1, batch_index, 0, n)
    r2 = rng.uniform(rng_streams.SOURCE_LOBE_2, batch_index, 0, n)
    return sampling.power_cosine_direction(r1, r2, cosine_power)


@dataclasses.dataclass
class GridSource:
    """Deterministic origins from a precomputed grid (raySourceGrid.hpp):
    ray i starts at ``grid[i % N]``; directions from the power-cosine lobe
    mapped onto the source's axes, flattened in 2D."""

    bbox: torch.Tensor  # (2, 3) adjusted bounding box, float32
    grid: torch.Tensor  # (N, 3) source points, float32, on the device
    cosine_power: float
    ray_dir: int = 2
    first_dir: int = 0
    second_dir: int = 1
    pos_neg: float = -1.0
    dim: int = 3

    @classmethod
    def build(cls, bbox, grid, cosine_power, source_direction, dim=3,
              device=None):
        """From numpy: the adjusted bounding box, the grid
        (``create_source_grid``) and the trace direction; ``device=None`` is
        the CUDA device."""
        device = resolve_device(device)
        ray_dir, first_dir, second_dir, _, pos_neg = get_trace_settings(
            source_direction
        )
        f32 = dict(dtype=torch.float32, device=device)
        return cls(
            bbox=torch.tensor(np.asarray(bbox, np.float32), **f32),
            grid=torch.tensor(np.asarray(grid, np.float32).reshape(-1, 3),
                              **f32),
            cosine_power=float(cosine_power), ray_dir=ray_dir,
            first_dir=first_dir, second_dir=second_dir,
            pos_neg=float(pos_neg), dim=dim,
        )

    @property
    def num_points(self):
        return self.grid.shape[0]

    @property
    def dtype(self):
        return self.grid.dtype

    def replace(self, **changes) -> "GridSource":
        """A copy with ``changes`` (the JAX package's ``struct`` method)."""
        return dataclasses.replace(self, **changes)

    def to(self, dtype) -> "GridSource":
        """The source sampling in ``dtype``: its box and grid cast."""
        return dataclasses.replace(self, bbox=self.bbox.to(dtype),
                                   grid=self.grid.to(dtype))

    def source_area(self):
        return _plane_area(self.bbox, self.first_dir, self.second_dir,
                           self.dim)

    def sample(self, rng, batch_index, n, ray_indices):
        origins = self.grid[ray_indices % self.grid.shape[0]]
        lobe = _lobe(rng, batch_index, n, self.cosine_power)
        d = torch.zeros_like(lobe)
        d[:, self.ray_dir] = self.pos_neg * lobe[:, 2]
        d[:, self.first_dir] = lobe[:, 0]
        d[:, self.second_dir] = lobe[:, 1]
        if self.dim == 2:
            d = vec.flatten_2d(d)
        weights = torch.ones(n, dtype=self.grid.dtype, device=self.grid.device)
        return origins, vec.normalize(d, eps=1e-12), weights


@dataclasses.dataclass
class SurfaceSource:
    """Rays from surface points along their normals (gpu/raygTrace.hpp:
    267-297, gpu/raygSource.hpp:102-132): ray i starts at point i % N plus
    ``offset`` times its normal, its direction is the power-cosine lobe
    rotated onto the normal (``vec.orthonormal_basis``), its weight the
    point's relative weight; ``area`` is the source area of SOURCE
    normalization."""

    points: torch.Tensor  # (N, 3) float32
    normals: torch.Tensor  # (N, 3) float32, unit
    weights: torch.Tensor  # (N,) float32
    cosine_power: float
    offset: float
    area: float
    dim: int = 3

    @classmethod
    def build(cls, points, normals, weights=None, cosine_power=1.0,
              offset=0.0, area=1.0, dim=3, device=None):
        """From numpy; ``weights=None`` is all ones; ``device=None`` is the
        CUDA device."""
        device = resolve_device(device)
        points = np.asarray(points, np.float32).reshape(-1, 3)
        if weights is None:
            weights = np.ones(len(points))
        f32 = dict(dtype=torch.float32, device=device)
        return cls(
            points=torch.tensor(points, **f32),
            normals=torch.tensor(
                np.asarray(normals, np.float32).reshape(-1, 3), **f32),
            weights=torch.tensor(np.asarray(weights, np.float32), **f32),
            cosine_power=float(cosine_power), offset=float(offset),
            area=float(area), dim=dim,
        )

    @property
    def num_points(self):
        return self.points.shape[0]

    @property
    def dtype(self):
        return self.points.dtype

    def replace(self, **changes) -> "SurfaceSource":
        """A copy with ``changes`` (the JAX package's ``struct`` method)."""
        return dataclasses.replace(self, **changes)

    def to(self, dtype) -> "SurfaceSource":
        """The source sampling in ``dtype``: its points, normals and weights
        cast."""
        return dataclasses.replace(
            self, points=self.points.to(dtype), normals=self.normals.to(dtype),
            weights=self.weights.to(dtype))

    def source_area(self):
        return self.area

    def sample(self, rng, batch_index, n, ray_indices):
        pidx = ray_indices % self.points.shape[0]
        normals = self.normals[pidx]
        origins = self.points[pidx] + self.offset * normals
        lobe = _lobe(rng, batch_index, n, self.cosine_power)
        basis = vec.orthonormal_basis(normals)  # rows u = normal, v, w
        d = (
            lobe[:, 2:3] * basis[:, 0]
            + lobe[:, 0:1] * basis[:, 1]
            + lobe[:, 1:2] * basis[:, 2]
        )
        if self.dim == 2:
            d = vec.flatten_2d(d)
        return origins, vec.normalize(d, eps=1e-12), self.weights[pidx]


def check_source(source) -> None:
    """Raise NotImplementedError, naming the source's type, unless it has a
    ``sample`` that takes (rng, batch_index, n, ray_indices)."""
    sample = getattr(source, "sample", None)
    try:
        if not callable(sample):
            raise TypeError
        inspect.signature(sample).bind(None, 0, 1, None)
    except (TypeError, ValueError):
        raise NotImplementedError(
            f"source {type(source).__name__} has no "
            "sample(rng, batch_index, n, ray_indices)"
        ) from None


def check_sample(org, dirn, w0, n, device, dtype=torch.float32) -> None:
    """Raise unless a user source's sample is (n, 3), (n, 3), (n,) of the
    trace's float type ``dtype`` on ``device``."""
    for name, x, shape in (("origins", org, (n, 3)),
                           ("directions", dirn, (n, 3)),
                           ("weights", w0, (n,))):
        if x.dtype != dtype:
            # a mix of types is not traced
            raise NotImplementedError(
                f"the source's {name} are {x.dtype}, the trace is {dtype}: a "
                "source samples in the trace's float type (float32, or "
                "float64 for f64 tracing on a geometry widened by "
                "to(torch.float64))")
        if tuple(x.shape) != shape or x.device != device:
            raise ValueError(
                f"the source's {name} must be {shape} on {device}, got "
                f"{tuple(x.shape)} on {x.device}")
