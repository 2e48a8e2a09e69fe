"""Batched sampling primitives, as functions of uniforms.

Counterpart of ``viennaray_tpu/ops/sampling.py``. The JAX functions draw their
uniforms from a key; here the caller draws them (through ``rng.RayRNG``) and
hands them in, so that both packages can be fed the very same numbers.
``power_cosine_direction`` and ``unit_sphere`` are ported; the coned-cosine
sampler waits for the physics that needs it.
"""

from __future__ import annotations

import math

import torch


def unit_sphere(u1, u2):
    """Uniform points on the unit sphere from two uniforms, shape (+ (3,)).

    Polar method: z = 1 - 2 u1, phi = 2 pi u2 — same distribution as the
    reference's Marsaglia sampler (rayUtil.hpp:266-283) without rejection.
    """
    z = 1.0 - 2.0 * u1
    phi = (2.0 * math.pi) * u2
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def power_cosine_direction(r1, r2, cosine_power):
    """Directions from the power-cosine lobe around +z from two uniforms.

    cos(theta) = r2^(1/(p+1)), phi = 2 pi r1 — matches
    SourceRandom::getDirection (raySourceRandom.hpp:70-86). Returns (..., 3)
    with z = cos(theta) >= 0.
    """
    ee = 1.0 / (cosine_power + 1.0)
    cos_theta = torch.pow(r2, ee)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = (2.0 * math.pi) * r1
    return torch.stack(
        [torch.cos(phi) * sin_theta, torch.sin(phi) * sin_theta, cos_theta],
        dim=-1,
    )
