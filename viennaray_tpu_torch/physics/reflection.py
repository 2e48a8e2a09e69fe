"""Batched surface reflection models.

Counterpart of ``viennaray_tpu/physics/reflection.py`` (rayReflection.hpp):
each function maps a batch of (ray_dir, normal) pairs to new unit directions.
The diffuse model takes its two uniforms from the caller. The coned-cosine
model is not ported yet.
"""

from __future__ import annotations

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
