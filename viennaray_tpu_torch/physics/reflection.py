"""Batched surface reflection models.

Counterpart of ``viennaray_tpu/physics/reflection.py`` (rayReflection.hpp):
each function maps a batch of (ray_dir, normal) pairs to new unit directions.
The diffuse model takes its two uniforms from the caller, the coned-cosine
model its polar angle (sampled by ``ops.sampling.coned_cosine_theta``) and
the uniform of its azimuth.
"""

from __future__ import annotations

import math

import torch

from ..config import ReflectionKind
from ..ops import sampling, vec


def specular(ray_dir, normal, dim: int = 3):
    """Mirror reflection (ref: rayReflection.hpp:13-29)."""
    d = vec.reflect_specular(ray_dir, normal)
    if dim == 2:
        d = vec.flatten_2d(d)
    return d


def diffuse(u1, u2, normal, dim: int = 3):
    """Cosine-weighted diffuse reflection: normalize(sphere_point + normal),
    the sphere point drawn from the uniforms (u1, u2).

    In 2D the z component is zeroed before normalization
    (ref: rayReflection.hpp:32-50).
    """
    d = sampling.unit_sphere(u1, u2) + normal
    if dim == 2:
        d[..., 2] = 0.0
    return vec.normalize(d, eps=1e-12)


def cone_limit_kind(cone_angle):
    """The model the unfused body's coned-cosine reflection takes at a limit
    of the cone: specular at an angle <= 0, diffuse at >= pi/2, else None
    (the lobe itself). Follows the JAX package's unfused ``coned_cosine``
    (reflection.py:74-79, rayReflection.hpp:60-63)."""
    if cone_angle <= 0.0:
        return ReflectionKind.SPECULAR
    if cone_angle >= math.pi / 2:
        return ReflectionKind.DIFFUSE
    return None


def coned_cosine(theta, u_phi, ray_dir, normal, dim: int = 3):
    """Specular lobe with a maximal cone angle (ref: rayReflection.hpp:52-120):
    the polar angle ``theta`` around the specular direction comes from the
    caller (its distribution depends on the cone angle alone), the azimuth is
    2 pi ``u_phi``; a direction that points into the surface is mirrored back
    (:108-111).

    The cone angle itself plays no part here. At the cone's limits the
    unfused body reflects with another model instead (``cone_limit_kind``);
    the fused kernel clips the angle to [1e-6, pi/2 - 1e-6] and always runs
    this one, as the JAX package's two bodies do.
    """
    # specular direction w and Frisvad ONB (ref: rayReflection.hpp:66-83)
    w = vec.normalize(vec.reflect_specular(ray_dir, normal), eps=1e-12)
    t, b = vec.frisvad_basis(w)
    sin_t = torch.sin(theta)[..., None]
    cos_t = torch.cos(theta)[..., None]
    phi = (2.0 * math.pi) * u_phi
    sin_p = torch.sin(phi)[..., None]
    cos_p = torch.cos(phi)[..., None]
    d = sin_t * (cos_p * t + sin_p * b) + cos_t * w
    dp = vec.dot(d, normal)[..., None]
    d = torch.where(dp <= 0.0, d - 2.0 * dp * normal, d)
    if dim == 2:
        d[..., 2] = 0.0
    return vec.normalize(d, eps=1e-12)
