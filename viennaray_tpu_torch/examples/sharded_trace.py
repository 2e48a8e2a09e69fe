"""A large ray count sharded over a ray mesh: the port of the JAX package's
``examples/sharded_trace.py`` (BASELINE config 5's shape) on
``viennaray_tpu_torch.parallel``.

    python3 -m viennaray_tpu_torch.examples.sharded_trace [--shards N]
                                          [--rays R] [--device cpu]

Traces the 2,993-disk trench (diffuse particle, sticking 0.1, periodic
walls, seed 9) over a mesh of ``--shards`` shards on this process's device,
and prints rays/s and the geometry hits. Under a launcher that sets
``RANK``, ``WORLD_SIZE`` and the rendezvous's ``MASTER_ADDR`` /
``MASTER_PORT`` (``torchrun``), each process joins the group first
(``initialize_distributed``: NCCL on CUDA devices, gloo on the CPU) and the
mesh spans every process's shards.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

import viennaray_tpu_torch as vrt
from viennaray_tpu_torch.device import resolve_device
from viennaray_tpu_torch.io import fixtures
from viennaray_tpu_torch.parallel import mesh as ray_mesh


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None)
    parser.add_argument("--shards", type=int, default=1,
                        help="shards of this process, on its one device")
    parser.add_argument("--rays", type=int, default=10_000_000)
    args = parser.parse_args(argv)
    if "WORLD_SIZE" in os.environ:
        ray_mesh.initialize_distributed(
            "cpu" if args.device == "cpu" else "cuda",
            rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]), init_method="env://")
    device = resolve_device(args.device)

    grid_delta = 0.25
    pts, nrm = fixtures.create_trench_grid_3d(grid_delta=grid_delta)
    geometry = vrt.DiskGeometry.build(pts, nrm, grid_delta, dim=3,
                                      device=device)
    particle = vrt.DiffuseParticle(0.1, "flux")
    config = vrt.TraceConfig(
        dim=3, num_rays_fixed=args.rays, rng_seed=9, use_random_seed=False,
        boundary_conditions=(vrt.BoundaryCondition.PERIODIC,) * 3)
    source = vrt.RandomSource.default(geometry, config,
                                      particle.cosine_exponent)
    bbox = source.bbox

    mesh = ray_mesh.make_ray_mesh([device] * args.shards)
    print(f"shards: {mesh.size} ({mesh.world_size} processes), "
          f"rays: {args.rays:.2e}")
    t0 = time.perf_counter()
    flux, totals = ray_mesh.trace_sharded(
        geometry, source, particle, bbox, config, vrt.GeneratorRNG(9, device),
        args.rays, mesh)
    flux = flux.cpu().numpy()  # waits for the device
    dt = time.perf_counter() - t0
    print(f"{args.rays / dt:.3e} rays/s over {mesh.size} shards "
          f"({dt:.1f}s); geometry hits {totals[2]:.3e}, flux sum "
          f"{flux.sum():.6g}")
    if mesh.group is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
