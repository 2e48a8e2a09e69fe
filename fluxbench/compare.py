"""The comparison that decides ``correct``.

The program's outputs are Monte Carlo estimates, so they are held to the
plain reference's estimate of the same quantity by how far they lie from it
against the noise both carry. The reference traces its rays in ``chunks``
independent runs of equal size; the spread of the runs gives, for each disk,
the variance s^2 of one ray's contribution to the compared quantity, and
each ray's count of front hits gives that count's variance. The numbers:

- ``flux_chi2``: for each compared output, the sum over disks of
  (program - reference)^2 over the sum of s^2 (1 / N_program +
  1 / N_reference); the worst output's. About 1 for a sound program; more
  where an output is biased anywhere or noisier than its rays allow.
- ``flux_chi2_mean``: the same of the mean of the compared outputs (their
  noise shrinks with their number, so a small bias shows).
- ``flux_chi2_block``: the same of the mean, taken over each block of
  consecutive elements (at most ``BLOCKS`` blocks of at least
  ``BLOCK_MIN`` elements; a cloud's order keeps a block in one region of
  the surface), the worst block's: a fault confined to a region, which the
  sums over every element dilute.
- ``hits_z``: for each output, |the program's front hits per ray
  (``TraceInfo``) - the reference's| in standard errors; the worst.
- ``hits_z_mean``: the same of the outputs' mean hits per ray.

A cell compares the numbers its limits file names. A program output of the
wrong length, or not finite, reads as infinite.
"""

from __future__ import annotations

import math

import numpy as np
import torch

BLOCKS = 64
BLOCK_MIN = 256


class Reference:
    """What the reference traced: the compared quantity of each run,
    ``per_run`` (chunks, N) float64 tensor (each run's own estimate, as the
    program computes its output from its rays); its rays ``rays`` (chunks,),
    and the front hits ``hits`` and sum of squared hits per ray
    ``hits_sq`` over all runs."""

    def __init__(self, per_run, rays, hits, hits_sq):
        self.rays = rays.double()
        n = float(self.rays.sum())
        w = self.rays / n
        self.n = n
        self.mean = (per_run * w[:, None]).sum(dim=0)
        m = per_run.shape[0]
        dev = per_run - self.mean
        # var of a run's estimate is s^2 / rays: s^2 = sum rays dev^2 / (m-1)
        self.s2 = (self.rays[:, None] * dev * dev).sum(dim=0) / (m - 1)
        self.hits = float(hits) / n
        self.hits_var = float(hits_sq) / n - self.hits ** 2


def flux_chi2(ref, out, n_rays):
    """The chi-square per unit noise of one program output ``out`` (numpy,
    the compared quantity from ``n_rays`` rays)."""
    a = np.asarray(out, np.float64).reshape(-1)
    if a.shape[0] != ref.mean.shape[0] or not np.isfinite(a).all():
        return math.inf
    a = torch.from_numpy(a).to(ref.mean.device)
    num = float(((a - ref.mean) ** 2).sum())
    den = float(ref.s2.sum()) * (1.0 / n_rays + 1.0 / ref.n)
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


def flux_chi2_block(ref, out, n_rays):
    """The largest chi-square per unit noise of ``out`` over its blocks of
    consecutive elements."""
    a = np.asarray(out, np.float64).reshape(-1)
    n = ref.mean.shape[0]
    if a.shape[0] != n or not np.isfinite(a).all():
        return math.inf
    a = torch.from_numpy(a).to(ref.mean.device)
    size = max(-(-n // BLOCKS), min(n, BLOCK_MIN))
    k = -(-n // size)
    pad = k * size - n
    num = torch.nn.functional.pad((a - ref.mean) ** 2, (0, pad))
    den = torch.nn.functional.pad(ref.s2, (0, pad))
    num = num.reshape(k, size).sum(dim=1)
    den = den.reshape(k, size).sum(dim=1) * (1.0 / n_rays + 1.0 / ref.n)
    chi = torch.where(den > 0, num / torch.where(den > 0, den, 1.0),
                      torch.where(num == 0, 0.0, math.inf))
    return float(chi.max())


def hits_z(ref, hits_per_ray, n_rays):
    """|program hits per ray - reference's| in standard errors."""
    if not math.isfinite(hits_per_ray):
        return math.inf
    se = math.sqrt(max(ref.hits_var, 0.0) * (1.0 / n_rays + 1.0 / ref.n))
    gap = abs(hits_per_ray - ref.hits)
    return gap / se if se > 0 else (0.0 if gap == 0 else math.inf)


def judge(ref, outputs, limits):
    """``outputs``: [(output, hits per ray, rays)] of the program. Returns
    (correct, {number: (value, limit)}) for the numbers ``limits`` names:
    ``correct`` where there is an output and every number is within its
    limit."""
    values = {}
    if outputs:
        values["flux_chi2"] = max(flux_chi2(ref, o, n) for o, _, n in outputs)
        values["hits_z"] = max(hits_z(ref, h, n) for _, h, n in outputs)
        same = len({np.shape(o) for o, _, _ in outputs}) == 1
        mean = (np.mean([np.asarray(o, np.float64) for o, _, _ in outputs],
                        axis=0) if same else np.full(1, np.nan))
        rays = sum(n for _, _, n in outputs)
        # the mean of outputs of equal rays: as noisy as one of all their rays
        values["flux_chi2_mean"] = flux_chi2(ref, mean, rays)
        values["flux_chi2_block"] = flux_chi2_block(ref, mean, rays)
        values["hits_z_mean"] = hits_z(
            ref, sum(h * n for _, h, n in outputs) / rays, rays)
    numbers = {name: (values.get(name, math.inf), float(limit))
               for name, limit in limits.items()}
    ok = bool(outputs) and all(v <= lim for v, lim in numbers.values())
    return ok, numbers
