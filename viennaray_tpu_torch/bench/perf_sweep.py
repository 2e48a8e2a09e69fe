"""The port's sweep over the headline configurations: the counterpart of
``benchmarks/perf_sweep.py``, one JSON line per cell.

    python3 -m viennaray_tpu_torch.bench.perf_sweep [CELL ...] [--reps N]
                                                   [--device cpu] [--out F]

Cells (each at seed 42, periodic walls, mega-batches of 2^20 rays):

- ``disk2d``: the 2D trench of disks, ``create_trench_grid_2d(grid_delta=
  0.023)``, source on the +y face, 2,000 rays per point (the JAX sweep's
  fallback where the reference's ``trenchGrid2D.dat`` is missing);
- ``disk3d``: the disk flagship (``bench.py:30-93``): 2,993 disks, 2,000
  rays per point;
- ``tri3d``: the triangle flagship, ``create_trench_mesh_3d`` at the
  flagship's widths (5,760 triangles), 2,000 rays per triangle;
- ``disk18k``: the trench at grid delta 0.1, 18,180 disks, 200 rays per
  point (above ``TraceConfig.grid_min_prims``: the trace walks its uniform
  grid, ``trace/kernel.py:grid_for``);
- ``disk1m``: the trench at grid delta 0.016, 704,250 disks, 4 rays per
  point, its geometry built with ``accel=False, pack_neighbors=False`` as
  the JAX sweep builds it (the apply gathers the neighbor records on the
  device);
- ``ion``: the flagship's disks under ``ConedCosineParticle(0.5, pi/6,
  100)``, 2,000 rays per point;
- ``line2d``: ``create_trench_line_mesh(0.023)`` (782 segments) through
  ``TraceLine``, sticking 0.5 / 0.1 by material (the second half of the
  segments material 1), 2,000 rays per segment.

Each cell makes its fixture on the host (``fixture_seconds``), builds its
tracer (``build_seconds``, the geometry's build),
runs one warm apply, then ``--reps`` timed applies that end in a
synchronise: wall and process CPU seconds of each, rays/s of the median,
peak device memory from before the build, the change of every count of
``utils.telemetry.COUNTS`` over one apply (``counts``: the kernels'
launches among them, none on the CPU), the trace's counters (hits per ray,
``chunks_swept`` and ``tile_bounces`` of the bounce kernel's search, their ratio the chunks
walked per search, or the cells where the trace walks the grid) and, where the repository holds a golden made for that
very configuration, the rel-L2 of the normalized flux against it (disk3d:
``bench_disk3d.npy`` and ``bench_disk3d_oracle.npy``; tri3d, ion, line2d:
the oracle goldens of ``viennaray_tpu_torch/io/golden``), else null.

A cell is ``ok`` where its normalized flux is finite and not all zero and
below each golden's bound. Every cell runs and prints its line; the exit
code is 0 where every cell is ``ok``, else 1.

``--rays-per-point`` and ``--grid-delta`` replace a cell's own values; they
exist for the tests, which run every cell at a tiny size on the CPU. A cell
run with another grid delta has no golden.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import time

import numpy as np

from ..utils import telemetry
from . import common

SEED = 42
LINE_STICKING = [0.5, 0.1]
TEST_ONLY = "replaces every cell's own value (for the tests' tiny runs)"

# cell -> (geometry kind, grid delta, rays per primitive)
CELLS = {
    "disk2d": ("disk2d", 0.023, 2000),
    "disk3d": ("disk3d", 0.25, 2000),
    "tri3d": ("triangle", 0.25, 2000),
    "disk18k": ("disk3d", 0.1, 200),
    "disk1m": ("disk1m", 0.016, 4),
    "ion": ("ion", 0.25, 2000),
    "line2d": ("line", 0.023, 2000),
}

# cell -> goldens made for exactly that configuration: (file, its directory)
GOLDENS = {
    "disk3d": [("bench_disk3d", common.GOLDEN_DIR),
               ("bench_disk3d_oracle", common.GOLDEN_DIR)],
    "tri3d": [("tri3d_trench_oracle", common.PORT_GOLDEN_DIR)],
    "ion": [("ion3d_trench_oracle", common.PORT_GOLDEN_DIR)],
    "line2d": [("line2d_trench_oracle", common.PORT_GOLDEN_DIR)],
}


def fixture(name, grid_delta=None):
    """The cell's geometry as the fixture makes it on the host (Python
    loops; at disk1m's 704,250 disks a few seconds): (points, normals) of
    the disk cells, (vertices, triangles) of tri3d, (nodes, lines) of
    line2d; ``grid_delta`` in place of the cell's own where given."""
    from ..io import fixtures

    kind, gd, _ = CELLS[name]
    gd = gd if grid_delta is None else float(grid_delta)
    widths = dict(common.FLAGSHIP, grid_delta=gd)
    if kind == "disk2d":
        return fixtures.create_trench_grid_2d(grid_delta=gd)
    if kind == "triangle":
        return fixtures.create_trench_mesh_3d(**widths)
    if kind == "line":
        return fixtures.create_trench_line_mesh(**widths)
    return fixtures.create_trench_grid_3d(**widths)


def make_tracer(name, device, arrays=None, rays_per_point=None,
                grid_delta=None, fused=True):
    """The cell's configured tracer on ``device`` (every setting but the
    apply) on ``arrays`` (``fixture(name, grid_delta)``, made here when
    None), with ``rays_per_point`` or ``grid_delta`` in place of the cell's
    own where given; ``fused=False`` the unfused body."""
    import viennaray_tpu_torch as vrt
    from ..geometry.disk_geometry import DiskGeometry

    kind, gd, rays = CELLS[name]
    gd = gd if grid_delta is None else float(grid_delta)
    rays = rays if rays_per_point is None else int(rays_per_point)
    if arrays is None:
        arrays = fixture(name, grid_delta)
    particle = vrt.DiffuseParticle(0.1, "flux")
    dim = 3
    if kind == "disk2d":
        dim = 2
        tracer = vrt.TraceDisk(dim=2, device=device, fused=fused)
        tracer.set_geometry(*arrays, gd)
        tracer.set_source_direction(vrt.TraceDirection.POS_Y)
    elif kind in ("disk3d", "ion"):
        tracer = vrt.TraceDisk(dim=3, device=device, fused=fused)
        tracer.set_geometry(*arrays, gd)
        if kind == "ion":
            particle = vrt.ConedCosineParticle(0.5, math.pi / 6, 100.0)
    elif kind == "disk1m":
        tracer = vrt.TraceDisk(dim=3, device=device, fused=fused)
        tracer.geometry = DiskGeometry.build(
            *arrays, gd, dim=3, accel=False, pack_neighbors=False,
            device=device)
    elif kind == "triangle":
        tracer = vrt.TraceTriangle(dim=3, device=device, fused=fused)
        tracer.set_geometry(*arrays, gd)
    else:
        dim = 2
        nodes, lines = arrays
        ids = np.zeros(len(lines), np.int32)
        ids[len(lines) // 2:] = 1
        tracer = vrt.TraceLine(device=device, fused=fused)
        tracer.set_geometry(vrt.LineMesh(nodes, lines, grid_delta=gd),
                            material_ids=ids)
        particle = vrt.DiffuseParticle(0.5, "flux",
                                       material_sticking=LINE_STICKING)
    tracer.set_boundary_conditions([vrt.BoundaryCondition.PERIODIC] * dim)
    tracer.set_particle_type(particle)
    tracer.set_number_of_rays_per_point(rays)
    tracer.set_rng_seed(SEED)
    return tracer


def goldens(name, grid_delta=None):
    """[(golden name, array, bound)] of the cell, none for a cell run at
    another grid delta. A golden's bound: rel-L2 < 0.05, or 1.45 times its
    two seeds' own difference where that is above 0.035 (the bound of
    ``chip_smoke.py``)."""
    if grid_delta is not None and grid_delta != CELLS[name][1]:
        return []
    out = []
    for golden, folder in GOLDENS.get(name, []):
        tol = common.GOLDEN_TOL
        record = os.path.join(folder, golden + ".json")
        if folder == common.PORT_GOLDEN_DIR and os.path.exists(record):
            with open(record) as f:
                noise = json.load(f)["rel_l2_between_seeds"]
            tol = common.GOLDEN_TOL if noise <= 0.035 else 1.45 * noise
        out.append((golden, np.load(os.path.join(folder, golden + ".npy")),
                    tol))
    return out


def run_cell(name, device, device_info, reps=3, rays_per_point=None,
             grid_delta=None):
    """The cell's JSON object (see the module's docstring)."""
    common.reset_peak(device)
    arrays, fixture_s, _ = common.timed(lambda: fixture(name, grid_delta),
                                        device)
    tracer, build_s, build_cpu_s = common.timed(
        lambda: make_tracer(name, device, arrays, rays_per_point, grid_delta),
        device)
    _, first_s, _ = common.timed(tracer.apply, device)
    walls, cpus = [], []
    for _ in range(reps):
        before = dict(telemetry.COUNTS)
        flux, wall, cpu = common.timed(tracer.apply, device)
        counts = telemetry.since(before)
        walls.append(wall)
        cpus.append(cpu)
    info = tracer.get_ray_trace_info()
    geometry = tracer.geometry
    median = statistics.median(walls)
    norm = np.asarray(tracer.normalize_flux(flux), np.float64)
    held = goldens(name, grid_delta)
    rel = {g: common.rel_l2(norm, arr) for g, arr, _ in held}
    bounds = {g: tol for g, _, tol in held}
    ok = bool(np.isfinite(norm).all() and norm.max() > 0
              and all(rel[g] < bounds[g] for g in rel))
    return {
        "cell": name, "device": device_info,
        "primitives": geometry.num_primitives,
        "kind": geometry.kind, "chunks": int(geometry.soa_chunk_bbs.shape[0]),
        "rays_per_point": (CELLS[name][2] if rays_per_point is None
                           else rays_per_point),
        "num_rays": info.num_rays, "rays_per_s": info.num_rays / median,
        "median_wall_seconds": median, "wall_seconds": walls,
        "cpu_seconds": cpus, "fixture_seconds": fixture_s,
        "build_seconds": build_s,
        "build_cpu_seconds": build_cpu_s, "first_apply_seconds": first_s,
        "peak_memory_bytes": common.peak_bytes(device),
        "counts": counts,
        "hits_per_ray": info.geometry_hits / info.num_rays,
        "flux_sum": float(np.asarray(flux, np.float64).sum()),
        "total_rays_traced": info.total_rays_traced,
        "chunks_swept": info.chunks_swept, "tile_bounces": info.tile_bounces,
        "chunks_per_search": (info.chunks_swept / info.tile_bounces
                              if info.tile_bounces else None),
        "rel_l2": rel or None, "rel_l2_bound": bounds or None, "ok": ok,
    }


def main(argv=None):
    p = common.parser(__doc__.splitlines()[0])
    p.add_argument("cells", nargs="*",
                   help="the cells to run (default: all, in this order: "
                        + ", ".join(CELLS) + ")")
    p.add_argument("--reps", type=int, default=3,
                   help="timed applies per cell after the warm one")
    p.add_argument("--rays-per-point", type=int, default=None,
                   help=TEST_ONLY)
    p.add_argument("--grid-delta", type=float, default=None, help=TEST_ONLY)
    args = p.parse_args(argv)
    unknown = sorted(set(args.cells) - set(CELLS))
    if unknown:
        p.error(f"unknown cells {unknown}; the cells: {', '.join(CELLS)}")
    device, device_info = common.setup(args)
    ok = True
    for name in args.cells or list(CELLS):
        t0 = time.perf_counter()
        row = run_cell(name, device, device_info, args.reps,
                       args.rays_per_point, args.grid_delta)
        row["cell_seconds"] = time.perf_counter() - t0
        common.emit(row, args.out)
        ok = ok and row["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
