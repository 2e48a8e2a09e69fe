"""viennaray_tpu_torch: the PyTorch/CUDA port of the JAX flux tracer beside it.

A Monte Carlo flux tracer with the capabilities of ViennaRay (semiconductor
topography flux simulation), running on one NVIDIA Hopper GPU. Plain tensor
code is PyTorch; the kernels (``csrc/``) are CUDA C++ for ``sm_90a``, built at
first use. The port goes slice by slice: this package holds the 3D disk path
through ``TraceDisk`` (random source, diffuse and specular reflection, all
three wall conditions, the neighbor flux model, normalization and smoothing).
Every setting outside the ported slice raises ``NotImplementedError``.

The package imports ``torch`` and ``numpy`` only.
"""

from .config import (
    BoundaryCondition,
    NormalizationType,
    ReflectionKind,
    TraceConfig,
    TraceDirection,
    disk_factor,
)
from .data import DataLog, MergeType, TraceInfo, TracingData
from .geometry.disk_geometry import DiskGeometry
from .geometry.mesh import DiskMesh
from .physics.particle import DiffuseParticle, Particle, SpecularParticle
from .physics.source import RandomSource
from .rng import GeneratorRNG, RayRNG
from .trace.tracer import TraceDisk, TraceLine, TraceTriangle

__version__ = "0.1.0"

__all__ = [
    "BoundaryCondition",
    "NormalizationType",
    "ReflectionKind",
    "TraceConfig",
    "TraceDirection",
    "disk_factor",
    "DataLog",
    "MergeType",
    "TraceInfo",
    "TracingData",
    "DiskGeometry",
    "DiskMesh",
    "Particle",
    "DiffuseParticle",
    "SpecularParticle",
    "RandomSource",
    "RayRNG",
    "GeneratorRNG",
    "TraceDisk",
    "TraceLine",
    "TraceTriangle",
]
