"""2D trench flux on a line mesh extruded to triangles: the port of the JAX
package's ``examples/triangle2D.py`` (the reference's
examples/triangle2D/triangle2D.cpp).

    python3 -m viennaray_tpu_torch.examples.triangle2D [MESH.dat] [--out DIR]
                                                       [--device cpu]

Reads a line mesh in the reference's ``.dat`` format when one is named,
else builds the trench fixture (``create_trench_line_mesh(0.1)``, where the
JAX package's example exits). ``TraceTriangle(dim=2)`` extrudes every line
to a pair of triangles (rayTraceTriangle.hpp:76-81); 2,000 rays per
triangle of a diffuse particle (sticking 0.1) from the +y face under
periodic walls. Each line takes the mean of its pair's normalized flux,
written to ``lineResult2D.vtp`` in ``--out``.
"""

from __future__ import annotations

import argparse
import os
import time

import viennaray_tpu_torch as vrt
from viennaray_tpu_torch.io import fixtures


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("mesh", nargs="?", default=None,
                        help="a line mesh in the reference's .dat format")
    parser.add_argument("--device", default=None)
    parser.add_argument("--rays-per-point", type=int, default=2000)
    parser.add_argument("--out", default=".", help="directory of the VTP file")
    args = parser.parse_args(argv)
    if args.mesh is not None:
        grid_delta, nodes, lines = vrt.read_mesh_from_file(args.mesh, 2)
    else:
        grid_delta = 0.1
        nodes, lines = fixtures.create_trench_line_mesh(grid_delta=grid_delta)
    mesh = vrt.LineMesh(nodes, lines, grid_delta=grid_delta)

    tracer = vrt.TraceTriangle(dim=2, device=args.device)
    tracer.set_geometry(mesh)
    tracer.set_boundary_conditions([vrt.BoundaryCondition.PERIODIC] * 2)
    tracer.set_particle_type(vrt.DiffuseParticle(0.1, "flux"))
    tracer.set_source_direction(vrt.TraceDirection.POS_Y)
    tracer.set_number_of_rays_per_point(args.rays_per_point)

    t0 = time.perf_counter()
    tracer.apply()
    print(f"Tracing time: {time.perf_counter() - t0} s")

    flux = tracer.get_local_data().get_vector_data("flux")
    flux = tracer.normalize_flux(flux, vrt.NormalizationType.SOURCE)
    per_line = 0.5 * (flux[0::2] + flux[1::2])  # triangles 2i and 2i + 1
    path = os.path.join(args.out, "lineResult2D.vtp")
    vrt.write_vtp(path, mesh.nodes, mesh.lines, per_line, dim=2)
    print(f"wrote {path}; info: {tracer.get_ray_trace_info()}")


if __name__ == "__main__":
    main()
