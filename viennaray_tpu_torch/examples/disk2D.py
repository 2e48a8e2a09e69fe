"""2D trench flux: the port of the JAX package's ``examples/disk2D.py``
(the reference's examples/disk2D/disk2D.cpp).

    python3 -m viennaray_tpu_torch.examples.disk2D [GRID.dat] [--out DIR]
                                                   [--device cpu]

Reads a point grid in the reference's ``.dat`` format when one is named,
else builds the trench fixture (``create_trench_grid_2d(0.1)``); traces
2,000 rays per point of a diffuse particle (sticking 0.1) from the +y face
under periodic walls, normalizes and smooths the flux and writes
``trenchResult2D.vtk`` into ``--out``.
"""

from __future__ import annotations

import argparse
import os
import time

import viennaray_tpu_torch as vrt
from viennaray_tpu_torch.io import fixtures


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("grid", nargs="?", default=None,
                        help="a point grid in the reference's .dat format")
    parser.add_argument("--device", default=None)
    parser.add_argument("--rays-per-point", type=int, default=2000)
    parser.add_argument("--out", default=".", help="directory of the VTK file")
    args = parser.parse_args(argv)
    if args.grid is not None:
        grid_delta, points, normals = vrt.read_grid_from_file(args.grid)
    else:
        grid_delta = 0.1
        points, normals = fixtures.create_trench_grid_2d(grid_delta=grid_delta)

    tracer = vrt.TraceDisk(dim=2, device=args.device)
    tracer.set_geometry(points, normals, grid_delta)
    tracer.set_boundary_conditions([vrt.BoundaryCondition.PERIODIC] * 2)
    tracer.set_particle_type(vrt.DiffuseParticle(0.1, "flux"))
    tracer.set_source_direction(vrt.TraceDirection.POS_Y)
    tracer.set_number_of_rays_per_point(args.rays_per_point)

    t0 = time.perf_counter()
    tracer.apply()
    print(f"Tracing time: {time.perf_counter() - t0} s")

    flux = tracer.get_local_data().get_vector_data("flux")
    flux = tracer.normalize_flux(flux, vrt.NormalizationType.SOURCE)
    flux = tracer.smooth_flux(flux, 1)
    path = os.path.join(args.out, "trenchResult2D.vtk")
    vrt.write_vtk(path, points, flux, dim=2)
    print(f"wrote {path}; info: {tracer.get_ray_trace_info()}")


if __name__ == "__main__":
    main()
