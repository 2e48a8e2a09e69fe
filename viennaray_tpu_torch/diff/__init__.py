"""Differentiable flux tracing (``trace_grad``): the JAX package's
``viennaray_tpu/diff`` on torch autograd."""

from .trace_grad import (
    flux_and_grad_normals_batched,
    flux_and_grad_points_batched,
    flux_and_grad_sticking,
    flux_and_grad_sticking_batched,
    trace_flux,
)

__all__ = [
    "trace_flux",
    "flux_and_grad_sticking",
    "flux_and_grad_sticking_batched",
    "flux_and_grad_points_batched",
    "flux_and_grad_normals_batched",
]
