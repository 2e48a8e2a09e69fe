"""The port's gradient benchmark: the counterpart of
``benchmarks/grad_bench.py:33-75``, BASELINE config 5 (``grad_1e7``).

    python3 -m viennaray_tpu_torch.bench.grad_bench [--reps 1]
                                                   [--device cpu] [--out F]

d sum(flux) / d sticking of 10^7 rays on the flagship's 2,993 disks
(``DiffuseParticle(0.1)``, periodic walls, the random source on the +z
face), accumulated over mega-batches of 2^19 rays by
``diff.flux_and_grad_sticking_batched``, 8 bounces, roulette off, seed 13.
One warm batch, then ``--reps`` timed runs (forward and backward), each
ending in a synchronise.

Prints one JSON line: rays/s forward and backward, wall and process CPU
seconds, the geometry's build seconds, the peak device memory, the flux and
the gradient, and both per ray against ``grad3d_trench_jax`` (the JAX
package's ``flux_and_grad_sticking_batched`` on the CPU): the flux's rel-L2
below 0.05 and the gradient within 1.45 times the golden's two seeds'
relative difference, at least 0.005 (``PERF.md`` section 2): ``ok``. The
exit code is 0 where ``ok`` holds, else 1.

``--rays`` and ``--batch`` replace the 10^7 and the 2^19 (for the tests'
tiny runs on the CPU; the golden then fails ``ok``).
"""

from __future__ import annotations

import json
import os
import statistics

import numpy as np

from ..utils import telemetry
from . import common

GRAD = dict(rays=10_000_000, batch=1 << 19, bounces=8, seed=13, sticking=0.1)
GRAD_TOL_FLOOR = 0.005


def problem(device, batch):
    """(geometry, source, particle, bbox, config) of config 5."""
    import viennaray_tpu_torch as vrt
    from ..io import fixtures

    pts, nrm = fixtures.create_trench_grid_3d(**common.FLAGSHIP)
    geometry = vrt.DiskGeometry.build(pts, nrm, common.FLAGSHIP["grid_delta"],
                                      device=device)
    config = vrt.TraceConfig(
        dim=3, source_direction=vrt.TraceDirection.POS_Z,
        boundary_conditions=(vrt.BoundaryCondition.PERIODIC,) * 3,
        ray_batch_size=batch, rng_seed=GRAD["seed"], use_random_seed=False,
        roulette=False)
    source = vrt.RandomSource.default(geometry, config)
    return (geometry, source, vrt.DiffuseParticle(GRAD["sticking"], "flux"),
            source.bbox, config)


def main(argv=None):
    p = common.parser(__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=1)
    p.add_argument("--rays", type=int, default=GRAD["rays"],
                   help="replaces the 10^7 (for the tests' tiny runs)")
    p.add_argument("--batch", type=int, default=GRAD["batch"],
                   help="replaces the 2^19 (for the tests' tiny runs)")
    args = p.parse_args(argv)
    device, device_info = common.setup(args)

    from .. import diff
    from ..rng import GeneratorRNG

    common.reset_peak(device)
    (geometry, source, particle, bbox, config), build_s, _ = common.timed(
        lambda: problem(device, args.batch), device)

    def run(rays):
        return diff.flux_and_grad_sticking_batched(
            geometry, source, particle, bbox,
            GeneratorRNG(GRAD["seed"], device), rays, config,
            num_bounces=GRAD["bounces"], device=device)

    run(args.batch)  # warm: one batch builds the kernels
    walls, cpus = [], []
    for _ in range(args.reps):
        before = dict(telemetry.COUNTS)
        (flux, grad), wall, cpu = common.timed(lambda: run(args.rays), device)
        counts = telemetry.since(before)
        walls.append(wall)
        cpus.append(cpu)
    median = statistics.median(walls)

    path = os.path.join(common.PORT_GOLDEN_DIR, "grad3d_trench_jax")
    golden = np.load(path + ".npy")
    with open(path + ".json") as f:
        record = json.load(f)
    flux_err = common.rel_l2(flux / args.rays, golden)
    grad_per_ray = grad / args.rays
    grad_err = abs(grad_per_ray - record["grad_per_ray"]) / abs(
        record["grad_per_ray"])
    grad_tol = max(1.45 * record["grad_rel_diff_between_seeds"],
                   GRAD_TOL_FLOOR)
    ok = bool(np.isfinite(flux).all() and np.isfinite(grad)
              and flux_err < common.GOLDEN_TOL and grad_err <= grad_tol)
    common.emit({
        "config": "grad_1e7", "device": device_info, "total_rays": args.rays,
        "batch": args.batch, "num_bounces": GRAD["bounces"],
        "seed": GRAD["seed"], "rays_per_s_fwd_bwd": args.rays / median,
        "median_wall_seconds": median, "wall_seconds": walls,
        "cpu_seconds": cpus, "build_seconds": build_s,
        "peak_memory_bytes": common.peak_bytes(device), "counts": counts,
        "flux_sum": float(flux.sum()), "d_flux_d_sticking": grad,
        "flux_rel_l2_golden": flux_err, "flux_rel_l2_bound": common.GOLDEN_TOL,
        "d_flux_d_sticking_per_ray": grad_per_ray,
        "golden_d_flux_d_sticking_per_ray": record["grad_per_ray"],
        "d_flux_d_sticking_rel_err": grad_err,
        "d_flux_d_sticking_bound": grad_tol, "ok": ok,
    }, args.out)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
