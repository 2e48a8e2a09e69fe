"""viennaray_tpu_torch: the PyTorch/CUDA port of the JAX flux tracer beside it.

A Monte Carlo flux tracer with the capabilities of ViennaRay (semiconductor
topography flux simulation), running on one NVIDIA Hopper GPU. Plain tensor
code is PyTorch; the kernels (``csrc/``) are CUDA C++ for ``sm_90a``, built at
first use. The port goes slice by slice: this package holds the disk path
through ``TraceDisk``, the triangle path through ``TraceTriangle`` (3D
meshes, and 2D line meshes extruded to triangles) and the native 2D
line-segment path through ``TraceLine``: random, grid and surface sources,
diffuse, specular and coned-cosine reflection, one sticking value or one per
material, gas scattering, all three wall conditions, the neighbor flux model
of disks (with optional 1/distance weights) and their window flux model, the
single-hit deposit of triangles and lines, normalization and smoothing;
custom particles (collision, reflection, per-ray state, initial-direction
and data-log hooks, multi-channel flux, user sources) and multi-species runs
(``apply_particles``); the host's readers, writers, checkpoints and logging.
Every setting outside the ported slices raises ``NotImplementedError``.

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
from .geometry.line_geometry import LineGeometry
from .geometry.mesh import DiskMesh, LineMesh, TriangleMesh
from .geometry.triangle_geometry import TriangleGeometry
from .physics.particle import (
    ConedCosineParticle,
    DiffuseParticle,
    Particle,
    SpecularParticle,
)
from .physics.source import GridSource, RandomSource, SurfaceSource
from .rng import GeneratorRNG, RayRNG
from .trace.multi import apply_particles
from .trace.tracer import TraceDisk, TraceLine, TraceTriangle
from .io.dat import read_grid_from_file, read_mesh_from_file
from .io.vtk import write_vtk, write_vtp
from .utils.checkpoint import load_checkpoint, save_checkpoint
from .utils.logging import LogLevel, set_log_level

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
    "LineGeometry",
    "LineMesh",
    "TriangleMesh",
    "TriangleGeometry",
    "Particle",
    "ConedCosineParticle",
    "DiffuseParticle",
    "SpecularParticle",
    "GridSource",
    "RandomSource",
    "SurfaceSource",
    "RayRNG",
    "GeneratorRNG",
    "TraceDisk",
    "TraceLine",
    "TraceTriangle",
    "apply_particles",
    "read_grid_from_file",
    "read_mesh_from_file",
    "write_vtk",
    "write_vtp",
    "save_checkpoint",
    "load_checkpoint",
    "LogLevel",
    "set_log_level",
]
