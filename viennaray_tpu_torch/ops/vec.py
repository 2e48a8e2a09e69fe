"""Batched 3-vector math on ``(..., 3)`` tensors.

Counterpart of ``viennaray_tpu/ops/vec.py``: the reference's scalar ``Vec3D``
helpers (ViennaCore vcVectorType.hpp) as plain functions on torch tensors,
shape-polymorphic over leading batch axes.
"""

from __future__ import annotations

import torch


def dot(a, b):
    """Row-wise dot product of (..., 3) tensors -> (...), summed in the fixed
    order (x + y) + z: the CUDA kernels repeat it product by product, and a
    library reduction's order is not specified."""
    return (
        a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
    )


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def norm2(a):
    return dot(a, a)


def norm(a):
    return torch.sqrt(norm2(a))


def normalize(a, eps: float = 0.0):
    n = norm(a)[..., None]
    if eps:
        n = torch.clamp(n, min=eps)
    return a / n


def reflect_specular(ray_dir, normal):
    """Specular reflection expressed as the reference does:
    dirOldInv = -d; d' = 2 (n . dirOldInv) n - dirOldInv
    (ref: rayReflection.hpp:13-29)."""
    inv = -ray_dir
    return 2.0 * dot(normal, inv)[..., None] * normal - inv


def orthonormal_basis(vec):
    """Deterministic orthonormal basis {u, v, w} with u = normalize(vec).

    Batched port of the reference's ``getOrthonormalBasis``
    (rayUtil.hpp:287-321): helper axis chosen by comparing |x| vs |z|.
    Returns (..., 3, 3) where [..., 0, :] = u, [..., 1, :] = v, [..., 2, :] = w.
    """
    u = normalize(vec)
    ux, uy, uz = u[..., 0], u[..., 1], u[..., 2]
    zero = torch.zeros_like(ux)
    cond = torch.abs(ux) > torch.abs(uz)
    h = torch.where(
        cond[..., None],
        torch.stack([-uy, ux, zero], dim=-1),
        torch.stack([zero, -uz, uy], dim=-1),
    )
    v = normalize(h)
    w = cross(u, v)
    return torch.stack([u, v, w], dim=-2)


def flatten_2d(direction):
    """Zero the z component and renormalize (2D mode ray directions,
    ref: rayUtil.hpp:210-215)."""
    d = direction.clone()
    d[..., 2] = 0.0
    n = norm(d)[..., None]
    return d / torch.where(n > 0, n, torch.ones_like(n))
