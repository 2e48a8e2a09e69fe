"""Trace configuration and enums.

Counterpart of ``viennaray_tpu/config.py`` (kept as a copy: the port imports
nothing of the JAX package). Mirrors the reference's runtime configuration:

- ``TraceDirection``, ``NormalizationType``  (ref: rayUtil.hpp:38-47)
- ``BoundaryCondition``                      (ref: rayBoundary.hpp:10-14)
- ``TraceConfig``                            (ref: rayUtil.hpp:83-94 ``KernelConfig``
  plus the ``Trace`` setters in rayTrace.hpp:76-121)
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import numpy as np


class TraceDirection(enum.IntEnum):
    """Direction from which source rays are traced (ref: rayUtil.hpp:40-47)."""

    POS_X = 0
    NEG_X = 1
    POS_Y = 2
    NEG_Y = 3
    POS_Z = 4
    NEG_Z = 5


class NormalizationType(enum.IntEnum):
    """Flux normalization mode (ref: rayUtil.hpp:38)."""

    SOURCE = 0
    MAX = 1


class BoundaryCondition(enum.IntEnum):
    """Domain-wall behavior (ref: rayBoundary.hpp:10-14)."""

    REFLECTIVE = 0
    PERIODIC = 1
    IGNORE = 2


class ReflectionKind(enum.IntEnum):
    """Reflection model selector for built-in particles."""

    DIFFUSE = 0
    SPECULAR = 1
    CONED_COSINE = 2


# Disk radius factor: radius = gridDelta * DISK_FACTOR[D]
# (ref: rayUtil.hpp:99-101  ``DiskFactor<D>``)
DISK_FACTOR_2D = 0.5 * 1.41421356237 * (1 + 1e-5)
DISK_FACTOR_3D = 0.5 * 1.7320508 * (1 + 1e-5)


def disk_factor(dim: int) -> float:
    return DISK_FACTOR_3D if dim == 3 else DISK_FACTOR_2D


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Trace configuration.

    Mirrors the reference ``KernelConfig`` (rayUtil.hpp:83-94) + ``Trace``
    setters (rayTrace.hpp:76-121).

    Attributes:
      dim: 2 or 3.
      num_rays_per_point: rays per geometry primitive (0 if num_rays_fixed set).
      num_rays_fixed: total ray override; 0 means use num_rays_per_point.
      max_reflections: cap on surface reflections per ray.
      max_boundary_hits: cap on boundary interactions per ray.
      rng_seed: base seed; combined with run_number per apply().
      use_random_seed: draw a fresh nondeterministic seed each apply().
      source_direction: face the source plane sits on.
      boundary_conditions: per-axis boundary conditions (length == dim).
      primary_direction: optional tilted source mean direction (unit 3-vector).
      ray_batch_size: rays per device mega-batch.
      max_bounces: hard cap on wavefront loop iterations (safety net; the
        reference loops until all rays die).
      weight_threshold_frac: Russian-roulette lower threshold as a fraction of
        the initial weight (ref: rayTraceKernel.hpp:438 -> 0.1).
      renew_weight_frac: roulette renewal weight fraction
        (ref: rayTraceKernel.hpp:439 -> 0.3).
      t_near: ray epsilon offset (ref: rayUtil.hpp:230 -> 1e-4).
      use_wdist: 1/distance multi-hit weighting (ref: rayTraceKernel.hpp:
        258-296); the trace runs its unfused body with it.
      grid_min_prims: the trace walks the geometry's uniform grid (the grid
        DDA, ``ops/grid_traverse.py``) from this many primitives on, where
        the geometry has one (an exact one: ``trace/kernel.py:grid_for``)
        and the trace is not differentiable; below it, and for lines, the
        chunk search (the JAX package's field and default,
        viennaray_tpu/config.py:122).
      roulette: Russian roulette on/off.
      flux_model: disk multi-hit flux model. "neighbor" = the CPU reference
        contract (hit prim + neighbor-list re-test, rayTraceKernel.hpp:
        255-300); "window" = the GPU candidate-window contract
        (GeneralPipelineDisk.cu:51-59): every disk the ray crosses within
        tau = 1.1 grid_delta past the primary hit. Disks only.
    """

    dim: int = 3
    num_rays_per_point: int = 1000
    num_rays_fixed: int = 0
    max_reflections: int = 2**30
    max_boundary_hits: int = 1000
    rng_seed: int = 0
    use_random_seed: bool = True
    source_direction: TraceDirection = TraceDirection.POS_Z
    boundary_conditions: Tuple[BoundaryCondition, ...] = (
        BoundaryCondition.REFLECTIVE,
        BoundaryCondition.REFLECTIVE,
        BoundaryCondition.REFLECTIVE,
    )
    primary_direction: Optional[Tuple[float, float, float]] = None
    ray_batch_size: int = 2**17
    max_bounces: int = 3000
    weight_threshold_frac: float = 0.1
    renew_weight_frac: float = 0.3
    t_near: float = 1e-4
    use_wdist: bool = False
    grid_min_prims: int = 8192
    roulette: bool = True
    flux_model: str = "neighbor"

    def __post_init__(self):
        if self.flux_model not in ("neighbor", "window"):
            raise ValueError(
                f"flux_model must be 'neighbor' or 'window', got "
                f"{self.flux_model!r}"
            )
        if self.dim not in (2, 3):
            raise ValueError(f"dim must be 2 or 3, got {self.dim}")
        if self.dim == 2 and self.source_direction in (
            TraceDirection.POS_Z,
            TraceDirection.NEG_Z,
        ):
            raise ValueError("Ray source cannot be in z-direction for 2D geometry")
        if len(self.boundary_conditions) < self.dim:
            raise ValueError(
                "boundary_conditions must have one entry per dimension"
            )

    def total_rays(self, num_primitives: int) -> int:
        """Total number of rays for a geometry (ref: rayTraceKernel.hpp:57-61)."""
        if self.num_rays_fixed > 0:
            return int(self.num_rays_fixed)
        return int(num_primitives) * int(self.num_rays_per_point)


def get_trace_settings(source_dir: TraceDirection):
    """Map source direction to axis bookkeeping.

    Returns (ray_dir_axis, first_dir, second_dir, min_max, pos_neg) exactly as
    the reference's ``getTraceSettings`` (rayUtil.hpp:145-202):
      ray_dir_axis: axis index of the tracing direction,
      first_dir/second_dir: the two boundary axes,
      min_max: 0 if the source plane is the bbox min face, 1 if the max face,
      pos_neg: +1 if rays travel toward +axis, -1 toward -axis.
    """
    table = {
        TraceDirection.POS_X: (0, 1, 2, 1, -1),
        TraceDirection.NEG_X: (0, 1, 2, 0, 1),
        TraceDirection.POS_Y: (1, 0, 2, 1, -1),
        TraceDirection.NEG_Y: (1, 0, 2, 0, 1),
        TraceDirection.POS_Z: (2, 0, 1, 1, -1),
        TraceDirection.NEG_Z: (2, 0, 1, 0, 1),
    }
    return table[TraceDirection(source_dir)]


def adjust_bounding_box(bbox, source_dir: TraceDirection, disc_radius: float, dim: int):
    """Extend the bounding box toward the source (ref: rayUtil.hpp:104-143).

    bbox: numpy-like (2, 3) [min; max]. Returns a new (2, 3) float64 array.
    """
    bbox = np.array(bbox, dtype=np.float64).copy()
    if dim == 2:
        bbox[0][2] -= disc_radius
        bbox[1][2] += disc_radius
    d = TraceDirection(source_dir)
    axis = get_trace_settings(d)[0]
    if d in (TraceDirection.POS_X, TraceDirection.POS_Y, TraceDirection.POS_Z):
        bbox[1][axis] += 2 * disc_radius
    else:
        bbox[0][axis] -= 2 * disc_radius
    return bbox
