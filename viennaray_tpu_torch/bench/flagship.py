"""The port's flagship benchmark: the counterpart of ``bench.py:30-93``.

    python3 -m viennaray_tpu_torch.bench.flagship [--reps 3] [--device cpu]
                                                 [--out FILE]

The 3D disk trench of the reference's examples/disk3D (2,993 disks at grid
delta 0.25), ``DiffuseParticle(0.1)``, periodic walls, 2,000 rays per
point, seed 42, through ``TraceDisk``'s default (fused) body. One warm
apply, then ``--reps`` timed applies, each ending in a synchronise; rays/s
is the median's. The normalized flux of the last apply is held to
``benchmarks/golden/bench_disk3d.npy`` and ``bench_disk3d_oracle.npy``
(rel-L2 < 0.05 each, ``bench.py``'s certification): ``ok``. The exit code
is 0 where ``ok`` holds, else 1, as ``bench.py`` fails its assertion.

Prints one JSON line of the form ``bench.py`` prints, ``{"metric": ...,
"value": rays/s, "unit": "rays/s"}``, the card's name and power limit in
``metric``, and beside them the device, each apply's wall and process CPU
seconds, the geometry's build seconds, the peak device memory and the two
rel-L2 values. It keeps no baseline file.

``--rays-per-point`` replaces the 2,000 (for the tests' tiny runs on the
CPU; the goldens then fail ``ok``).
"""

from __future__ import annotations

import statistics

import numpy as np

from . import common

RAYS_PER_POINT = 2000
SEED = 42
GOLDENS = ("bench_disk3d", "bench_disk3d_oracle")


def main(argv=None):
    p = common.parser(__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--rays-per-point", type=int, default=RAYS_PER_POINT,
                   help="replaces the 2,000 (for the tests' tiny runs)")
    args = p.parse_args(argv)
    device, device_info = common.setup(args)

    import viennaray_tpu_torch as vrt
    from ..io import fixtures

    def build():
        pts, nrm = fixtures.create_trench_grid_3d(**common.FLAGSHIP)
        tracer = vrt.TraceDisk(dim=3, device=device)
        tracer.set_geometry(pts, nrm, common.FLAGSHIP["grid_delta"])
        tracer.set_boundary_conditions([vrt.BoundaryCondition.PERIODIC] * 3)
        tracer.set_particle_type(vrt.DiffuseParticle(0.1, "flux"))
        tracer.set_number_of_rays_per_point(args.rays_per_point)
        tracer.set_rng_seed(SEED)
        return tracer

    common.reset_peak(device)
    tracer, build_s, _ = common.timed(build, device)
    _, first_s, _ = common.timed(tracer.apply, device)  # warm: builds kernels
    walls, cpus = [], []
    for _ in range(args.reps):
        flux, wall, cpu = common.timed(tracer.apply, device)
        walls.append(wall)
        cpus.append(cpu)
    info = tracer.get_ray_trace_info()
    median = statistics.median(walls)
    rays_per_s = info.num_rays / median

    norm = np.asarray(tracer.normalize_flux(flux), np.float64)
    rel = {g: common.rel_l2(norm, np.load(
        f"{common.GOLDEN_DIR}/{g}.npy")) for g in GOLDENS}
    ok = bool(np.isfinite(norm).all() and norm.max() > 0
              and all(v < common.GOLDEN_TOL for v in rel.values()))
    card = device_info.get("nvidia_smi", device.type)
    metric = (
        f"rays/s single-chip ({card}; 3D disk trench, sticking 0.1, "
        f"{args.rays_per_point} rays/pt, {info.num_rays} rays, "
        f"{tracer.geometry.num_primitives} disks, ok={ok}, median_of="
        f"{args.reps} runs={['%.4f' % t for t in walls]}s "
        f"golden_rel_l2={rel['bench_disk3d']:.4f} "
        f"oracle_rel_l2={rel['bench_disk3d_oracle']:.4f})")
    common.emit({
        "metric": metric, "value": rays_per_s, "unit": "rays/s",
        "ok": ok, "device": device_info, "num_rays": info.num_rays,
        "wall_seconds": walls, "cpu_seconds": cpus,
        "median_wall_seconds": median, "build_seconds": build_s,
        "first_apply_seconds": first_s,
        "peak_memory_bytes": common.peak_bytes(device),
        "hits_per_ray": info.geometry_hits / info.num_rays,
        "flux_sum": float(np.asarray(flux, np.float64).sum()),
        "rel_l2": rel, "rel_l2_bound": common.GOLDEN_TOL,
    }, args.out)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
