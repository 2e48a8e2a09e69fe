"""Neighbor-disk re-tests.

Counterpart of ``viennaray_tpu/ops/intersect.py:232-271``. The brute-force
nearest-hit searches of that module are not carried over: the port's search
is ``ops/nearest_hit.py``.
"""

from __future__ import annotations

import torch

from . import vec


def check_neighbors_packed(org, direction, rec):
    """Neighbor re-test over a pre-packed record gather.

    rec: (R, K, 8) rows [center(3) normal(3) radius valid] gathered in one
    contiguous fetch. Semantics identical to ``check_local_intersection``.
    Returns (valid (R, K) bool, distance (R, K)).
    """
    centers = rec[:, :, 0:3]
    normals = rec[:, :, 3:6]
    radii = rec[:, :, 6]
    pad_ok = rec[:, :, 7] > 0.5
    valid, dist = check_local_intersection(org, direction, centers, normals,
                                           radii)
    return valid & pad_ok, dist


def check_local_intersection(org, direction, centers, normals, radii):
    """Neighbor-disk re-test (ref: rayTraceKernel.hpp:462-507).

    org, direction: (R, 3); centers/normals: (R, K, 3); radii: (R, K).
    Front-face-only: dot(n, dir) must be < -eps (eps = 1e-6); plane t > 0
    (NOT t_near — the reference uses a strict 0 here); in-plane distance
    strictly < radius. Returns (valid (R, K) bool, distance (R, K)).
    """
    eps = 1e-6
    d = direction[:, None, :]
    o = org[:, None, :]
    prod = vec.dot(normals, d)  # (R, K)
    front = prod <= 0.0
    not_parallel = torch.abs(prod) >= eps
    ddneg = vec.dot(centers, normals)
    t = (ddneg - vec.dot(normals, o)) / torch.where(
        prod == 0, torch.full_like(prod, 1e-30), prod
    )
    hitp = o + t[..., None] * d
    diff = hitp - centers
    dist = vec.norm(diff)
    valid = front & not_parallel & (t > 0.0) & (dist < radii)
    return valid, dist
