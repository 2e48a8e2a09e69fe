"""Flux post-processing: normalization and neighborhood smoothing.

Counterpart of ``viennaray_tpu/trace/postprocess.py``:
- ``normalize_flux_source``: flux[i] *= (sourceArea / numTotalRays) / area[i]
  (ref: rayTraceDisk.hpp:120-137, gpu/kernels/normKernels.cu:58-74)
- ``normalize_flux_max_disk``: flux[i] *= (fullDiskArea / area[i]) / max
  (ref: rayTraceDisk.hpp:110-118)
- ``normalize_flux_max_triangle``: flux[i] /= max * area[i]
  (ref: rayTraceTriangle.hpp:99-107)
- ``smooth_flux``: normal-dot-weighted neighborhood average
  (ref: rayTraceDisk.hpp:146-193)
"""

from __future__ import annotations

import math

import torch


def normalize_flux_source(flux, areas, source_area, num_total_rays):
    norm_factor = source_area / num_total_rays
    return flux * norm_factor / torch.clamp(areas, min=1e-30)


def normalize_flux_max_disk(flux, areas, disk_radius):
    total_disk_area = math.pi * disk_radius * disk_radius
    maxv = torch.max(flux)
    return (
        flux * (total_disk_area / torch.clamp(areas, min=1e-30))
        / torch.clamp(maxv, min=1e-30)
    )


def normalize_flux_max_triangle(flux, areas):
    maxv = torch.max(flux)
    return flux / (
        torch.clamp(maxv, min=1e-30) * torch.clamp(areas, min=1e-30)
    )


def smooth_flux(flux, normals, neighbors):
    """Normal-dot-weighted neighborhood average (ref: rayTraceDisk.hpp:173-192).

    flux: (N,); normals: (N, 3); neighbors: (N, K) padded with -1.
    vv = flux[i] + sum_{j in nbrs, w>0} flux[j] * w;  w = n_i . n_j
    out = vv / (1 + sum w)
    """
    n_prims = flux.shape[0]
    nb_valid = neighbors >= 0
    nb_c = torch.clamp(neighbors, 0, n_prims - 1).long()
    w = torch.sum(normals[:, None, :] * normals[nb_c], dim=-1)  # (N, K)
    w = torch.where(nb_valid & (w > 0.0), w, torch.zeros_like(w))
    vv = flux + torch.sum(flux[nb_c] * w, dim=1)
    return vv / (1.0 + torch.sum(w, dim=1))
