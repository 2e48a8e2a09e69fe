"""Neighbor-disk re-tests and the window test of gathered disk records.

Counterpart of ``viennaray_tpu/ops/intersect.py:232-329``. The brute-force
nearest-hit searches of that module are not carried over: the port's search
is ``ops/nearest_hit.py``. Its window deposit (``disk_window_deposit``, a
sweep over every disk by matrix products) becomes ``disk_hit_packed`` on the
hit disk's window list.
"""

from __future__ import annotations

import numpy as np
import torch

from . import vec

# the re-test's least |n . d|: the JAX package's float32(1e-6), widened in
# its float64 path (ops/intersect.py:263); in float32 the same value
NEIGHBOR_EPS = float(np.float32(1e-6))


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
    eps = NEIGHBOR_EPS
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


def disk_hit_packed(org, direction, rec, t_near):
    """The closest-hit search's ray/disk test on gathered records.

    rec: (R, W, 8) rows in the SoA's layout [center(3) normal(3) r2 n.c].
    One float32 operation per tensor op in the order of
    ``csrc/disk_hit.cuh:disk_hit`` (and of ``nearest_hit.disk_nearest_hit_ref``),
    so a kernel repeating it gets the same bits. Returns (valid (R, W) bool:
    denom != 0, t > t_near, in-plane distance^2 < r2; t (R, W))."""
    o = org[:, None, :]
    d = direction[:, None, :]
    centers = rec[:, :, 0:3]
    normals = rec[:, :, 3:6]
    denom = vec.dot(d, normals)
    ndo = vec.dot(o, normals)
    nonzero = denom != 0.0
    t = (rec[:, :, 7] - ndo) / torch.where(
        nonzero, denom, torch.full_like(denom, 1e-30)
    )
    h = (o + t[..., None] * d) - centers
    dist2 = vec.dot(h, h)
    tn = torch.tensor(t_near, dtype=org.dtype, device=org.device)
    return nonzero & (t > tn) & (dist2 < rec[:, :, 6]), t
