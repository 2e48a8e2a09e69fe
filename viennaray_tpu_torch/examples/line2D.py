"""2D trench flux on native line segments: the port of the JAX package's
``examples/line2D.py`` (the reference's gpu/examples/trenchLines.cpp).

    python3 -m viennaray_tpu_torch.examples.line2D [MESH.dat] [--out DIR]
                                                   [--device cpu]

Reads a line mesh in the reference's ``.dat`` format when one is named,
else builds the trench fixture (``create_trench_line_mesh(0.1)``, where the
JAX package's example exits); the second half of the segments is material
1. Traces 5,000 rays per segment of a diffuse particle with sticking 0.5 /
0.1 by material (at most 10 wall crossings a ray) from the +y face under
periodic walls, through ``TraceLine`` (segments are primitives, no triangle
extrusion), and writes the normalized flux per segment to
``trenchLines_lineFlux.vtp`` in ``--out``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

import viennaray_tpu_torch as vrt
from viennaray_tpu_torch.io import fixtures


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("mesh", nargs="?", default=None,
                        help="a line mesh in the reference's .dat format")
    parser.add_argument("--device", default=None)
    parser.add_argument("--rays-per-point", type=int, default=5000)
    parser.add_argument("--out", default=".", help="directory of the VTP file")
    args = parser.parse_args(argv)
    if args.mesh is not None:
        grid_delta, nodes, lines = vrt.read_mesh_from_file(args.mesh, 2)
    else:
        grid_delta = 0.1
        nodes, lines = fixtures.create_trench_line_mesh(grid_delta=grid_delta)
    mesh = vrt.LineMesh(nodes, lines, grid_delta=grid_delta)

    # two materials with a sticking map (ref: trenchLines.cpp:28-37)
    material_ids = np.zeros((len(mesh.lines),), np.int32)
    material_ids[len(mesh.lines) // 2:] = 1
    tracer = vrt.TraceLine(device=args.device)
    tracer.set_geometry(mesh, material_ids=material_ids)
    tracer.set_boundary_conditions([vrt.BoundaryCondition.PERIODIC] * 2)
    tracer.set_particle_type(vrt.DiffuseParticle(
        0.5, "particleFlux", material_sticking=[0.5, 0.1]))
    tracer.set_source_direction(vrt.TraceDirection.POS_Y)
    tracer.set_number_of_rays_per_point(args.rays_per_point)
    tracer.set_max_boundary_hits(10)

    t0 = time.perf_counter()
    tracer.apply()
    print(f"Tracing time: {time.perf_counter() - t0} s")

    flux = tracer.get_local_data().get_vector_data("particleFlux")
    flux = tracer.normalize_flux(flux, vrt.NormalizationType.SOURCE)
    path = os.path.join(args.out, "trenchLines_lineFlux.vtp")
    vrt.write_vtp(path, mesh.nodes, mesh.lines, flux, dim=2)
    print(f"wrote {path}; info: {tracer.get_ray_trace_info()}")


if __name__ == "__main__":
    main()
