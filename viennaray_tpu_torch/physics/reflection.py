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


def coned_cosine(theta, u_phi, ray_dir, normal, dim: int = 3):
    """Specular lobe with a maximal cone angle (ref: rayReflection.hpp:52-120):
    the polar angle ``theta`` around the specular direction comes from the
    caller (its distribution depends on the cone angle alone), the azimuth is
    2 pi ``u_phi``; a direction that points into the surface is mirrored back
    (:108-111).

    The cone angle itself plays no part here. The JAX package's unfused
    ``coned_cosine`` switches to the specular model at an angle <= 0 and to
    the diffuse one at >= pi/2, while its fused kernel only clips the angle
    to [1e-6, pi/2 - 1e-6]; the port follows the kernel in both bodies.
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
