"""Batched sampling primitives, as functions of uniforms.

Counterpart of ``viennaray_tpu/ops/sampling.py``. The JAX functions draw their
uniforms from a key; here the caller draws them (through ``rng.RayRNG``) and
hands them in, so that both packages can be fed the very same numbers.
``masked_rejection`` is the wavefront form of a per-ray ``do {} while``
accept-reject loop; ``coned_cosine_theta`` runs it for the coned-cosine lobe's
polar angle, with the rounds' uniforms supplied by the caller. Every function
computes in its uniforms' float type (float32, or float64 for the float64
trace), as the JAX functions compute in their ``dtype``.
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


def masked_rejection(propose, shape, device, max_iters=64,
                     dtype=torch.float32):
    """Batch-level accept-reject.

    ``propose(i)`` -> (candidate of ``shape``, accepted bool of ``shape``) for
    round ``i``. Lanes that have accepted keep their value; the others take
    the next round's candidate. Ends when every lane has accepted or after
    ``max_iters`` rounds (ref: the per-ray loops of raySourceRandom.hpp:92-113
    and rayReflection.hpp:87-94). Returns (value of ``dtype``, done bool); a
    lane that never accepted keeps 0.
    """
    value = torch.zeros(shape, dtype=dtype, device=device)
    done = torch.zeros(shape, dtype=torch.bool, device=device)
    for i in range(max_iters):
        if bool(done.all()):
            break
        cand, ok = propose(i)
        value = torch.where(ok & ~done, cand, value)
        done = done | ok
    return value, done


def coned_cosine_proposal(r1, r2, max_cone_angle):
    """One round of the coned-cosine lobe's polar-angle sampler from two
    uniforms: u = sqrt(r1); s = sqrt(1 - u); theta = maxAngle * s; accepted
    when r2 * theta * u <= cos(pi/2 * s) * sin(theta)
    (ref: rayReflection.hpp:86-94). Returns (theta, accepted) in the
    uniforms' type."""
    like = dict(dtype=r1.dtype, device=r1.device)
    angle = torch.tensor(max_cone_angle, **like)
    half_pi = torch.tensor(math.pi / 2, **like)
    u = torch.sqrt(r1)
    s = torch.sqrt(torch.clamp(1.0 - u, min=0.0))
    theta = angle * s
    ok = r2 * theta * u <= torch.cos(half_pi * s) * torch.sin(theta)
    return theta, ok


def coned_cosine_theta(draw, shape, max_cone_angle, device,
                       dtype=torch.float32):
    """Polar angles of the coned-cosine lobe, ``shape`` of ``dtype`` (the
    draws' type), by accept-reject of up to 64 rounds. ``draw(i)`` -> the
    two uniform tensors of ``shape`` for round ``i``."""
    def propose(i):
        r1, r2 = draw(i)
        return coned_cosine_proposal(r1, r2, max_cone_angle)

    return masked_rejection(propose, shape, device, dtype=dtype)[0]
