#!/usr/bin/env python3
"""Makes the oracle golden of the 3D triangle trench.

Runs the scalar C++ oracle of ``tests/oracle_ref.py`` (an independent per-ray
implementation of the reference's triangle semantics: single closest-hit
deposit, backface kill; numpy and ``g++`` only) on the mesh and the physics
that ``chip_smoke.py`` traces on the GPU: ``create_trench_mesh_3d`` at
``grid_delta`` 0.25 (5,760 triangles), diffuse particle with sticking 0.1,
periodic walls, source on the +z face. Two seeds run as two processes; the
mean of their source-normalized fluxes goes to
``golden/tri3d_trench_oracle.npy`` and the run's record (rays, seeds, the
rel-L2 between the two seeds, geometry hits per ray) to the ``.json`` beside
it.

    python3 viennaray_tpu_torch/io/make_tri_golden.py [--rays N]

from the repository root; about 3 minutes per million rays per seed on one
CPU core each.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import multiprocessing
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
GOLDEN_DIR = os.path.join(HERE, "golden")
NAME = "tri3d_trench_oracle"
MESH = dict(grid_delta=0.25, extent=5.0, trench_width=4.0, trench_depth=4.0)
STICKING = 0.1
SEEDS = (101, 202)


def _oracle():
    """``tests/oracle_ref.py`` as a module, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "oracle_ref", os.path.join(ROOT, "tests", "oracle_ref.py")
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _mesh():
    sys.path.insert(0, ROOT)
    from viennaray_tpu_torch.io import fixtures

    return fixtures.create_trench_mesh_3d(**MESH)


def _one_seed(args):
    seed, rays = args
    verts, tris = _mesh()
    return _oracle().trace_tris_oracle(
        verts, tris, dim=3, grid_delta=MESH["grid_delta"], num_rays=rays,
        sticking=STICKING, seed=seed, boundary=("periodic", "periodic"),
        reflection="diffuse",
    )


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rays", type=int, default=8_000_000,
                        help="rays per seed")
    rays = parser.parse_args().rays

    verts, tris = _mesh()
    v0, v1, v2 = (verts[tris[:, i]].astype(np.float64) for i in range(3))
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    # the source plane spans the mesh's lateral extents
    extent = verts.max(axis=0) - verts.min(axis=0)
    source_area = float(extent[0] * extent[1])

    with multiprocessing.get_context("spawn").Pool(len(SEEDS)) as pool:
        runs = pool.map(_one_seed, [(s, rays) for s in SEEDS])
    # flux[i] * (source_area / rays) / area[i]: ``normalize_flux`` SOURCE
    norm = [flux * (source_area / rays) / areas for flux, _ in runs]
    between = float(
        np.linalg.norm(norm[0] - norm[1]) / np.linalg.norm(norm[0])
    )
    hits = [c["geometry_hits"] / rays for _, c in runs]

    os.makedirs(GOLDEN_DIR, exist_ok=True)
    np.save(os.path.join(GOLDEN_DIR, NAME + ".npy"),
            np.mean(norm, axis=0).astype(np.float64))
    record = {
        "mesh": {"fixture": "create_trench_mesh_3d", **MESH,
                 "triangles": int(len(tris)), "vertices": int(len(verts))},
        "physics": {"particle": "diffuse", "sticking": STICKING,
                    "boundary": "periodic", "source": "+z face, cosine lobe"},
        "normalization": "SOURCE: flux * source_area / (rays * area)",
        "source_area": source_area,
        "rays_per_seed": rays, "seeds": list(SEEDS),
        "rel_l2_between_seeds": between,
        "geometry_hits_per_ray": float(np.mean(hits)),
        "geometry_hits_per_ray_by_seed": hits,
        "counters": [c for _, c in runs],
    }
    with open(os.path.join(GOLDEN_DIR, NAME + ".json"), "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(json.dumps({k: record[k] for k in (
        "rays_per_seed", "rel_l2_between_seeds", "geometry_hits_per_ray"
    )}))


if __name__ == "__main__":
    main()
