"""Batched ray sources.

Counterpart of ``viennaray_tpu/physics/source.py``: ``RandomSource``
(ref: raySourceRandom.hpp) — uniform origins on the source plane,
power-cosine directions, optionally tilted around a primary direction. The
grid and surface sources are not ported yet.

2D note: the reference samples the full 3D lobe and lets
``fillRayDirection<2>`` zero the z component and renormalize
(rayUtil.hpp:210-215). Mirrored exactly: the 2D direction distribution is the
z-flattened renormalized 3D one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import rng as rng_streams
from ..ops import sampling, vec

MAX_REJECTION_ROUNDS = 64


@dataclasses.dataclass
class RandomSource:
    """Uniform plane origins + power-cosine directions (raySourceRandom.hpp)."""

    bbox: torch.Tensor  # (2, 3) adjusted bounding box, float32, on the device
    cosine_power: float
    basis: Optional[torch.Tensor] = None  # (3, 3) ONB rows for a tilted source
    ray_dir: int = 2
    first_dir: int = 0
    second_dir: int = 1
    min_max: int = 1
    pos_neg: float = -1.0
    dim: int = 3
    num_points: int = 0

    def source_area(self):
        """(ref: raySourceRandom.hpp:40-47)"""
        ext1 = self.bbox[1, self.first_dir] - self.bbox[0, self.first_dir]
        if self.dim == 2:
            return ext1
        ext2 = self.bbox[1, self.second_dir] - self.bbox[0, self.second_dir]
        return ext1 * ext2

    def _origins(self, rng, batch_index, n):
        r1 = rng.uniform(rng_streams.SOURCE_ORIGIN_1, batch_index, 0, n)
        lo1 = self.bbox[0, self.first_dir]
        hi1 = self.bbox[1, self.first_dir]
        origins = torch.zeros((n, 3), dtype=self.bbox.dtype,
                              device=self.bbox.device)
        origins[:, self.ray_dir] = self.bbox[self.min_max, self.ray_dir]
        origins[:, self.first_dir] = lo1 + (hi1 - lo1) * r1
        if self.dim == 3:
            r2 = rng.uniform(rng_streams.SOURCE_ORIGIN_2, batch_index, 0, n)
            lo2 = self.bbox[0, self.second_dir]
            hi2 = self.bbox[1, self.second_dir]
            origins[:, self.second_dir] = lo2 + (hi2 - lo2) * r2
        return origins

    def _lobe(self, rng, batch_index, round_index, n):
        r1 = rng.uniform(rng_streams.SOURCE_DIR_1, batch_index, round_index, n)
        r2 = rng.uniform(rng_streams.SOURCE_DIR_2, batch_index, round_index, n)
        return sampling.power_cosine_direction(r1, r2, self.cosine_power)

    def _directions(self, rng, batch_index, round_index, n):
        lobe = self._lobe(rng, batch_index, round_index, n)
        d = torch.zeros_like(lobe)
        # axis mapping (ref: raySourceRandom.hpp:81-83)
        d[:, self.ray_dir] = self.pos_neg * lobe[:, 2]
        d[:, self.first_dir] = lobe[:, 0]
        d[:, self.second_dir] = lobe[:, 1]
        return d

    def _custom_directions(self, rng, batch_index, n):
        """Tilted lobe rotated by the primary-direction ONB, rejecting samples
        pointing away from the trace direction (ref: raySourceRandom.hpp:
        88-116): a batch-level accept-reject loop that re-proposes only the
        lanes that have not accepted yet."""
        value = torch.zeros((n, 3), dtype=self.bbox.dtype,
                            device=self.bbox.device)
        done = torch.zeros(n, dtype=torch.bool, device=self.bbox.device)
        for i in range(MAX_REJECTION_ROUNDS):
            if bool(done.all()):
                break
            lobe = self._lobe(rng, batch_index, i, n)
            # reference maps (cosTheta, cosPhi sinTheta, sinPhi sinTheta)
            # through ONB rows: d = B0*l0 + B1*l1 + B2*l2
            cand = (
                lobe[:, 2:3] * self.basis[0]
                + lobe[:, 0:1] * self.basis[1]
                + lobe[:, 1:2] * self.basis[2]
            )
            comp = cand[:, self.ray_dir]
            ok = comp <= 0.0 if self.pos_neg < 0 else comp >= 0.0
            value = torch.where((ok & ~done)[:, None], cand, value)
            done = done | ok
        # lanes that never accepted fall back to the untilted lobe
        fallback = self._directions(rng, batch_index, -1, n)
        return torch.where(done[:, None], value, fallback)

    def sample(self, rng, batch_index, n):
        """(origins (n, 3), directions (n, 3), weights (n,)) for one batch."""
        origins = self._origins(rng, batch_index, n)
        if self.basis is not None:
            dirs = self._custom_directions(rng, batch_index, n)
        else:
            dirs = self._directions(rng, batch_index, 0, n)
        if self.dim == 2:
            dirs = vec.flatten_2d(dirs)
        weights = torch.ones(n, dtype=self.bbox.dtype, device=self.bbox.device)
        return origins, dirs, weights
