#!/usr/bin/env python3
"""Makes the oracle goldens that ``chip_smoke.py`` holds the GPU flux to.

Runs the scalar C++ oracle of ``tests/oracle_ref.py`` (an independent per-ray
implementation of the reference's semantics; numpy and ``g++`` only) on a
configuration that ``chip_smoke.py`` traces on the GPU. Two seeds run as two
processes; the mean of their source-normalized fluxes goes to
``golden/<name>.npy`` and the run's record (rays, seeds, the rel-L2 between
the two seeds, geometry hits per ray, the counters) to the ``.json`` beside
it. The configurations (``--name``):

- ``tri3d_trench_oracle``: ``create_trench_mesh_3d`` at ``grid_delta`` 0.25
  (5,760 triangles), diffuse particle with sticking 0.1, periodic walls,
  source on the +z face;
- ``line2d_trench_oracle``: ``create_trench_line_mesh`` at ``grid_delta``
  0.023 (782 segments), material 1 on the second half of the segments,
  diffuse particle with per-material sticking [0.5, 0.1], periodic walls,
  source on the +y face. The oracle has no line entry point: it traces the
  mesh extruded to triangle pairs (``lines_to_triangles``) in 2D, each pair
  with its segment's sticking, and a segment's flux is the sum of its pair's;
- ``ion3d_trench_oracle``: ``create_trench_grid_3d`` at ``grid_delta`` 0.25
  (2,993 disks), coned-cosine particle with sticking 0.5, cone angle pi/6 and
  source power 100, periodic walls;
- ``gas3d_trench_oracle``: the same disks, diffuse particle with sticking
  0.1 and a mean free path of one trench depth (4.0), periodic walls;
- ``wdist3d_trench_oracle``: the same disks, diffuse particle with sticking
  0.1, periodic walls, the neighbor deposits weighted by 1/distance
  (``use_wdist``);
- ``disk2d_trench_oracle``: the JAX package's ``disk2d_trench`` configuration
  (``benchmarks/make_goldens.py:config_disk2d_trench``) on its fixture
  ``create_trench_grid_2d`` at ``grid_delta`` 0.1 (180 disks in 2D), diffuse
  particle with sticking 0.1, periodic walls, source on the +y face.

    python3 viennaray_tpu_torch/io/make_oracle_goldens.py --name NAME [--rays N]

from the repository root; each seed takes one CPU core.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import multiprocessing
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
GOLDEN_DIR = os.path.join(HERE, "golden")
TRENCH = dict(extent=5.0, trench_width=4.0, trench_depth=4.0)
SEEDS = (101, 202)
PERIODIC = ("periodic", "periodic")

# name -> geometry kind, grid_delta, default rays per seed, physics record,
# the oracle's keyword arguments
CONFIGS = {
    "tri3d_trench_oracle": dict(
        kind="triangle", grid_delta=0.25, rays=8_000_000,
        physics={"particle": "diffuse", "sticking": 0.1,
                 "boundary": "periodic", "source": "+z face, cosine lobe"},
        oracle=dict(sticking=0.1, reflection="diffuse"),
    ),
    "line2d_trench_oracle": dict(
        kind="line", grid_delta=0.023, rays=3_000_000,
        physics={"particle": "diffuse", "material_sticking": [0.5, 0.1],
                 "materials": "0 on the first half of the segments, 1 on "
                              "the second", "boundary": "periodic",
                 "source": "+y face, cosine lobe flattened to 2D"},
        oracle=dict(reflection="diffuse"),
    ),
    "ion3d_trench_oracle": dict(
        kind="disk", grid_delta=0.25, rays=3_000_000,
        physics={"particle": "coned-cosine", "sticking": 0.5,
                 "cone_angle": math.pi / 6, "source_power": 100.0,
                 "boundary": "periodic", "source": "+z face, power-100 lobe"},
        oracle=dict(sticking=0.5, reflection="coned", cone_angle=math.pi / 6,
                    cosine_exponent=100.0),
    ),
    "gas3d_trench_oracle": dict(
        kind="disk", grid_delta=0.25, rays=4_000_000,
        physics={"particle": "diffuse", "sticking": 0.1,
                 "mean_free_path": 4.0, "boundary": "periodic",
                 "source": "+z face, cosine lobe"},
        oracle=dict(sticking=0.1, reflection="diffuse", mean_free_path=4.0),
    ),
    "wdist3d_trench_oracle": dict(
        kind="disk", grid_delta=0.25, rays=3_000_000,
        physics={"particle": "diffuse", "sticking": 0.1, "use_wdist": True,
                 "boundary": "periodic", "source": "+z face, cosine lobe"},
        oracle=dict(sticking=0.1, reflection="diffuse", use_wdist=True),
    ),
    "disk2d_trench_oracle": dict(
        kind="disk2d", grid_delta=0.1, rays=4_000_000,
        physics={"particle": "diffuse", "sticking": 0.1,
                 "boundary": "periodic",
                 "source": "+y face, cosine lobe flattened to 2D"},
        oracle=dict(sticking=0.1, reflection="diffuse"),
    ),
}


def _oracle():
    """``tests/oracle_ref.py`` as a module, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "oracle_ref", os.path.join(ROOT, "tests", "oracle_ref.py")
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def line_material_ids(n_lines):
    """Material 1 on the second half of the segments, 0 on the first."""
    ids = np.zeros(n_lines, np.int32)
    ids[n_lines // 2:] = 1
    return ids


def _setup(name):
    """The configuration's geometry: a trace function of (seed, rays) that
    returns (flux per primitive, counters), the areas and source area of the
    SOURCE normalization, and the record's geometry entry."""
    sys.path.insert(0, ROOT)
    import viennaray_tpu_torch as vrt
    from viennaray_tpu_torch.geometry.mesh import lines_to_triangles
    from viennaray_tpu_torch.io import fixtures

    cfg = CONFIGS[name]
    gd = cfg["grid_delta"]
    oracle_kw = dict(cfg["oracle"], boundary=PERIODIC)
    if cfg["kind"] == "triangle":
        verts, tris = fixtures.create_trench_mesh_3d(grid_delta=gd, **TRENCH)
        v0, v1, v2 = (verts[tris[:, i]].astype(np.float64) for i in range(3))
        areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
        extent = verts.max(axis=0) - verts.min(axis=0)

        def trace(seed, rays):
            return _oracle().trace_tris_oracle(
                verts, tris, dim=3, grid_delta=gd, num_rays=rays, seed=seed,
                **oracle_kw)

        record = {"fixture": "create_trench_mesh_3d", "grid_delta": gd,
                  **TRENCH, "triangles": int(len(tris)),
                  "vertices": int(len(verts))}
        return trace, areas, float(extent[0] * extent[1]), record
    if cfg["kind"] == "line":
        nodes, lines = fixtures.create_trench_line_mesh(grid_delta=gd, **TRENCH)
        mesh = vrt.LineMesh(nodes, lines, grid_delta=gd)
        pairs = lines_to_triangles(mesh)
        p0 = mesh.nodes[mesh.lines[:, 0]].astype(np.float64)
        p1 = mesh.nodes[mesh.lines[:, 1]].astype(np.float64)
        lengths = np.linalg.norm((p1 - p0)[:, :2], axis=1)
        table = np.asarray(cfg["physics"]["material_sticking"], np.float64)
        sticking = np.repeat(table[line_material_ids(len(lengths))], 2)

        def trace(seed, rays):
            flux, counters = _oracle().trace_tris_oracle(
                pairs.nodes, pairs.triangles, dim=2, grid_delta=gd,
                num_rays=rays, seed=seed, sticking=sticking, **oracle_kw)
            return flux[0::2] + flux[1::2], counters

        record = {"fixture": "create_trench_line_mesh", "grid_delta": gd,
                  **TRENCH, "segments": int(len(lengths))}
        return trace, lengths, float(nodes[:, 0].max() - nodes[:, 0].min()), record
    # disks: in 3D the source lies on the +z face (walls on x and y), in 2D
    # on the +y face (wall on x), as TraceDisk's default source direction
    dim = 2 if cfg["kind"] == "disk2d" else 3
    if dim == 2:
        pts, nrm = fixtures.create_trench_grid_2d(grid_delta=gd, **TRENCH)
        fixture, walls = "create_trench_grid_2d", (0, 2)
    else:
        pts, nrm = fixtures.create_trench_grid_3d(grid_delta=gd, **TRENCH)
        fixture, walls = "create_trench_grid_3d", (0, 1)
    geometry = vrt.DiskGeometry.build(
        pts, nrm, gd, dim=dim, device="cpu"
    ).with_areas(walls, (vrt.BoundaryCondition.PERIODIC,) * 3)
    radius = geometry.disk_radius
    extent = pts.max(axis=0) - pts.min(axis=0)

    def trace(seed, rays):
        return _oracle().trace_disks_oracle(
            pts, nrm, np.full(len(pts), radius), dim=dim, disk_radius=radius,
            num_rays=rays, seed=seed, **oracle_kw)

    record = {"fixture": fixture, "grid_delta": gd, **TRENCH,
              "disks": int(len(pts)), "disk_radius": radius}
    source_area = extent[0] if dim == 2 else extent[0] * extent[1]
    return (trace, geometry.areas.numpy().astype(np.float64),
            float(source_area), record)


def _one_seed(args):
    name, seed, rays = args
    return _setup(name)[0](seed, rays)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--name", required=True, choices=sorted(CONFIGS))
    parser.add_argument("--rays", type=int, default=None, help="rays per seed")
    parser.add_argument("--out", default=GOLDEN_DIR,
                        help="directory the two files go to")
    args = parser.parse_args()
    name = args.name
    rays = args.rays or CONFIGS[name]["rays"]

    _, areas, source_area, geometry_record = _setup(name)
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(len(SEEDS)) as pool:
        runs = pool.map(_one_seed, [(name, s, rays) for s in SEEDS])
    seconds = time.perf_counter() - t0
    # flux[i] * (source_area / rays) / area[i]: ``normalize_flux`` SOURCE
    norm = [flux * (source_area / rays) / areas for flux, _ in runs]
    between = float(
        np.linalg.norm(norm[0] - norm[1]) / np.linalg.norm(norm[0])
    )
    hits = [c["geometry_hits"] / rays for _, c in runs]

    os.makedirs(args.out, exist_ok=True)
    np.save(os.path.join(args.out, name + ".npy"),
            np.mean(norm, axis=0).astype(np.float64))
    record = {
        "mesh": geometry_record,
        "physics": CONFIGS[name]["physics"],
        "normalization": "SOURCE: flux * source_area / (rays * area)",
        "source_area": source_area,
        "rays_per_seed": rays, "seeds": list(SEEDS),
        "rel_l2_between_seeds": between,
        "geometry_hits_per_ray": float(np.mean(hits)),
        "geometry_hits_per_ray_by_seed": hits,
        "counters": [c for _, c in runs],
        "oracle_seconds": round(seconds, 1),
    }
    with open(os.path.join(args.out, name + ".json"), "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(json.dumps({k: record[k] for k in (
        "rays_per_seed", "rel_l2_between_seeds", "geometry_hits_per_ray",
        "oracle_seconds",
    )}))


if __name__ == "__main__":
    main()
