"""Sharded tracing over devices and processes (``mesh``): the JAX package's
``viennaray_tpu/parallel`` on ``torch.distributed``."""

from .mesh import (
    RayMesh,
    initialize_distributed,
    make_ray_mesh,
    trace_batch_sharded,
    trace_sharded,
)

__all__ = [
    "RayMesh",
    "initialize_distributed",
    "make_ray_mesh",
    "trace_batch_sharded",
    "trace_sharded",
]
