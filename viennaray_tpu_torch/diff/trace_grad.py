"""Differentiable flux tracing.

Counterpart of ``viennaray_tpu/diff/trace_grad.py``. ``trace_flux`` is the
raw flux of one mega-batch as a function that torch autograd differentiates
in the continuous parameters: the particle's sticking (one value or a
per-material table, as tensors) and the geometry's points and normals
(tensors that require a gradient, put in with ``geometry.replace``; the
search's packed tables are not rebuilt, as in the JAX package). The trace
runs ``trace.kernel.trace_batch(differentiable=True)``: the unfused body for
a fixed number of bounces with roulette off (its weight renewal zeroes
d w / d sticking), the closest-hit kernels on detached rays with the hit
time recomputed from the selected primitive, and the deposits through the
histogram kernel, whose backward is a gather kernel
(``ops.histogram.FluxHistogramFn``). Gradients flow through

- the deposited weights (w_k = w0 prod_j (1 - s_j)): exact d flux / d s;
- the hit times and hit points t(org, points, normals), the reflection's
  normal and, with 1/distance weighting, the deposit weights: geometry
  sensitivities;

while discrete events (the hit's selection, walls, backfaces) are
piecewise constant and treated straight-through. Finite differences agree
only for smooth parameters away from visibility changes.

Float64: on a geometry widened by ``to(torch.float64)``, with a source and
an ``rng`` of that type, every function runs in float64 end to end (the
JAX package's float64 mode, in which its normals gradient is checked
against finite differences, tests/test_diff.py:215-287): the leaves take
the geometry's type.

Differences from the JAX package's functions: an ``rng`` (a
``rng.RayRNG``) takes the place of the key, batch b drawing
``rng.begin_batch(b)``'s numbers as the tracer's batch b does; and every
function takes ``device``, resolved by ``device.resolve_device`` (the CUDA
device, or an error without one unless ``"cpu"`` is named), on which the
geometry must lie.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..trace.kernel import trace_batch, with_deposit_tables


def _device(geometry, geo_type, device):
    dev = resolve_device(device)
    if geometry.device != dev:
        raise ValueError(f"the geometry is on {geometry.device}, not {dev}")
    if geo_type is not None and geo_type != geometry.kind:
        raise ValueError(f"geo_type {geo_type!r} but the geometry is a "
                         f"{geometry.kind} geometry")
    return dev


def _leaf(value, dev, dtype):
    """A copy of ``value`` of ``dtype`` on ``dev`` that requires a
    gradient."""
    return (torch.as_tensor(value, dtype=dtype).detach().to(dev)
            .clone().requires_grad_(True))


def _grad(loss, leaf):
    """d loss / d leaf, zeros where the loss does not depend on it."""
    if not loss.requires_grad:
        return torch.zeros_like(leaf)
    (grad,) = torch.autograd.grad(loss, leaf, allow_unused=True)
    return torch.zeros_like(leaf) if grad is None else grad


def trace_flux(geometry, source, particle, bbox, rng, ray_indices, valid,
               config, geo_type=None, num_bounces: int = 16,
               batch_index: int = 0, device=None):
    """Differentiable raw flux (N,) of one mega-batch: the standard trace's
    semantics with roulette off (whatever ``config`` says) and
    ``num_bounces`` bounces.

    Arguments as ``trace.kernel.trace_batch``'s; ``rng.begin_batch(
    batch_index)`` is called here. ``geo_type``: the geometry's kind
    ("disk", "triangle", "line"), or None for whatever it is."""
    _device(geometry, geo_type, device)
    rng.begin_batch(batch_index)
    flux, _ = trace_batch(
        geometry, source, particle, bbox, rng, batch_index, ray_indices,
        valid, config, differentiable=True, num_bounces=num_bounces,
    )
    return flux


def flux_and_grad_sticking(geometry, source, particle, bbox, rng, ray_indices,
                           valid, config, geo_type=None, num_bounces=16,
                           batch_index=0, device=None):
    """(flux (N,), d sum(flux) / d sticking) of one mega-batch, both
    tensors of the geometry's type on the device (the gradient 0-d)."""
    dev = _device(geometry, geo_type, device)
    sticking = _leaf(particle.sticking, dev, geometry.dtype)
    flux = trace_flux(
        geometry, source, particle.replace(sticking=sticking), bbox, rng,
        ray_indices, valid, config, geo_type, num_bounces, batch_index, dev,
    )
    return flux.detach(), _grad(flux.sum(), sticking)


def _batches(total_rays, config, dev):
    """(batch index, ray indices, valid) of each mega-batch of
    ``config.ray_batch_size`` rays, as the tracer numbers them."""
    batch = config.ray_batch_size
    for b in range(max(1, -(-total_rays // batch))):
        ray_indices = torch.arange(b * batch, (b + 1) * batch,
                                   dtype=torch.int64, device=dev)
        yield b, ray_indices, ray_indices < total_rays


def flux_and_grad_sticking_batched(geometry, source, particle, bbox, rng,
                                   total_rays, config, geo_type=None,
                                   num_bounces=16, device=None):
    """d sum(flux) / d sticking of a large ray count, accumulated over
    mega-batches of ``config.ray_batch_size`` rays (BASELINE config 5's
    gradient; the gradient analog of the tracer's batch loop). Batch b
    draws ``rng.begin_batch(b)``'s numbers. Flux and gradient are sums over
    batches, taken in float64 on the host.

    Returns (flux (N,) float64 numpy, d sum(flux) / d sticking float)."""
    dev = _device(geometry, geo_type, device)
    geometry = with_deposit_tables(geometry, config)
    flux_acc = np.zeros((geometry.num_primitives,), np.float64)
    grad_acc = 0.0
    for b, ray_indices, valid in _batches(total_rays, config, dev):
        f, g = flux_and_grad_sticking(
            geometry, source, particle, bbox, rng, ray_indices, valid, config,
            geo_type, num_bounces, b, dev,
        )
        flux_acc += f.double().cpu().numpy()
        grad_acc += float(g)
    return flux_acc, grad_acc


def _flux_and_grad_geom_batched(geometry, source, particle, bbox, rng,
                                total_rays, config, field, geo_type=None,
                                num_bounces=16, loss_weights=None,
                                device=None):
    """The mega-batch driver of a geometry leaf: ``field`` ("points" or
    "normals") is differentiated; the loss is sum(flux), or
    dot(loss_weights, flux). Returns (flux (N,) float64, grad float64 numpy
    of the field's shape), both summed over batches on the host."""
    dev = _device(geometry, geo_type, device)
    leaf = _leaf(getattr(geometry, field), dev, geometry.dtype)
    geo = with_deposit_tables(geometry.replace(**{field: leaf}), config)
    weights = (None if loss_weights is None else torch.as_tensor(
        loss_weights, dtype=geometry.dtype, device=dev))
    flux_acc = np.zeros((geometry.num_primitives,), np.float64)
    grad_acc = np.zeros(tuple(leaf.shape), np.float64)
    for b, ray_indices, valid in _batches(total_rays, config, dev):
        flux = trace_flux(geo, source, particle, bbox, rng, ray_indices,
                          valid, config, geo_type, num_bounces, b, dev)
        loss = flux.sum() if weights is None else torch.dot(weights, flux)
        flux_acc += flux.detach().double().cpu().numpy()
        grad_acc += _grad(loss, leaf).double().cpu().numpy()
    return flux_acc, grad_acc


def flux_and_grad_points_batched(geometry, source, particle, bbox, rng,
                                 total_rays, config, geo_type=None,
                                 num_bounces=16, loss_weights=None,
                                 device=None):
    """d loss / d surface point positions, mega-batched (the geometry
    analog of ``flux_and_grad_sticking_batched``)."""
    return _flux_and_grad_geom_batched(
        geometry, source, particle, bbox, rng, total_rays, config, "points",
        geo_type, num_bounces, loss_weights, device,
    )


def flux_and_grad_normals_batched(geometry, source, particle, bbox, rng,
                                  total_rays, config, geo_type=None,
                                  num_bounces=16, loss_weights=None,
                                  device=None):
    """d loss / d surface normals, mega-batched."""
    return _flux_and_grad_geom_batched(
        geometry, source, particle, bbox, rng, total_rays, config, "normals",
        geo_type, num_bounces, loss_weights, device,
    )
