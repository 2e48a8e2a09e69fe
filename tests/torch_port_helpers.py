"""Shared helpers of the ``test_torch_*`` files: the same geometry built by
both packages, and a ``RayRNG`` that hands the port the JAX package's own
uniforms, drawn with ``jax.random`` under the reference's key schedule."""

import jax
import numpy as np
import torch

import viennaray_tpu as vrt
from viennaray_tpu.io import fixtures as ref_fixtures
from viennaray_tpu_torch import rng as streams
from viennaray_tpu_torch.geometry.disk_geometry import DiskGeometry

GEOMETRY_FIELDS = (
    "points", "normals", "radii", "material_ids", "neighbors", "areas",
    "bbox", "prims_soa", "soa_perm", "soa_chunk_bbs", "soa_inv_perm",
    "neighbor_pack",
)

# name -> (maker of (points, normals) in the reference's fixtures, grid delta)
CLOUDS = {
    "trench_0.5": (lambda f: f.create_trench_grid_3d(grid_delta=0.5), 0.5),
    "trench_1.0": (lambda f: f.create_trench_grid_3d(grid_delta=1.0), 1.0),
    "plane": (lambda f: f.create_plane_grid(0.5, 3.0, (0, 1, 2)), 0.5),
}


def reference_geometry(name):
    """(points, normals, grid_delta, JAX-package DiskGeometry) of a cloud."""
    make, grid_delta = CLOUDS[name]
    pts, nrm = make(ref_fixtures)
    return pts, nrm, grid_delta, vrt.DiskGeometry.build(pts, nrm, grid_delta, dim=3)


def reference_arrays(ref_geo):
    return {f: np.asarray(getattr(ref_geo, f)) for f in GEOMETRY_FIELDS}


def port_geometry(ref_geo):
    """The port's geometry on the very tables of the reference's."""
    return DiskGeometry.from_reference_arrays(
        reference_arrays(ref_geo), dim=ref_geo.dim,
        grid_delta=ref_geo.grid_delta, disk_radius=ref_geo.disk_radius,
        device="cpu",
    )


class JaxKeyedRNG(streams.RayRNG):
    """The reference's uniforms by purpose.

    Key schedule of the JAX package: batch key = fold_in(base, batch)
    (tracer.py:350); source key = fold_in(batch key, 0x5EED) split into
    origin and direction keys (kernel.py:282-283, source.py:109-112), each
    split again for its two draws (source.py:58, sampling.py:44); a tilted
    source's round i folds i into the direction key (sampling.py:74) and its
    fallback folds 987654 (source.py:106); bounce ``it`` uses
    fold_in(batch key, it + 1) split four ways into scatter, scatter
    direction, reflection and roulette keys (kernel.py:531-532), the
    reflection key split for the sphere point's two draws (sampling.py:31).
    A fused launch of several bounces starting at ``it`` draws its whole
    block from fold_in(batch key, it + 1) in one call (kernel.py:1118-1121).
    """

    def __init__(self, base_key, tilted=False):
        self.base_key = base_key
        self.tilted = tilted
        self.batch_key = None

    def begin_batch(self, batch_index):
        self.batch_key = jax.random.fold_in(self.base_key, batch_index)

    def _key(self, stream, bounce):
        if stream.startswith("source"):
            k_o, k_d = jax.random.split(
                jax.random.fold_in(self.batch_key, 0x5EED)
            )
            if stream in (streams.SOURCE_ORIGIN_1, streams.SOURCE_ORIGIN_2):
                pair = jax.random.split(k_o)
                return pair[0 if stream == streams.SOURCE_ORIGIN_1 else 1]
            if bounce == -1:
                k_d = jax.random.fold_in(k_d, 987654)
            elif self.tilted:
                k_d = jax.random.fold_in(k_d, bounce)
            pair = jax.random.split(k_d)
            return pair[0 if stream == streams.SOURCE_DIR_1 else 1]
        key_b = jax.random.fold_in(self.batch_key, bounce + 1)
        _, _, k_refl, k_roul = jax.random.split(key_b, 4)
        if stream == streams.ROULETTE:
            return k_roul
        pair = jax.random.split(k_refl)
        return pair[0 if stream == streams.REFLECT_1 else 1]

    def uniform(self, stream, batch_index, bounce, n):
        u = jax.random.uniform(self._key(stream, bounce), (n,), dtype=np.float32)
        return torch.from_numpy(np.array(u))

    def uniform_block(self, batch_index, bounce, n, n_cols):
        key_b = jax.random.fold_in(self.batch_key, bounce + 1)
        u = jax.random.uniform(key_b, (n, n_cols), dtype=np.float32)
        return torch.from_numpy(np.array(u))
