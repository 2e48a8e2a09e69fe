"""3D trench flux on a triangle mesh: the port of the JAX package's
``examples/triangle3D.py`` (the reference's examples/triangle3D/
triangle3D.cpp).

    python3 -m viennaray_tpu_torch.examples.triangle3D [MESH.dat] [--out DIR]
                                                       [--device cpu]

Reads a triangle mesh in the reference's ``.dat`` format when one is named,
else builds the trench fixture (``create_trench_mesh_3d(0.25)``, 5,760
triangles, where the JAX package's example exits); traces 1,000 rays per
triangle of a diffuse particle (sticking 0.1) under periodic walls and
writes the normalized flux to ``trenchResultTri3D.vtp`` in ``--out``.
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
                        help="a triangle mesh in the reference's .dat format")
    parser.add_argument("--device", default=None)
    parser.add_argument("--rays-per-point", type=int, default=1000)
    parser.add_argument("--out", default=".", help="directory of the VTP file")
    args = parser.parse_args(argv)
    if args.mesh is not None:
        grid_delta, nodes, triangles = vrt.read_mesh_from_file(args.mesh, 3)
    else:
        grid_delta = 0.25
        nodes, triangles = fixtures.create_trench_mesh_3d(
            grid_delta=grid_delta)
    mesh = vrt.TriangleMesh(nodes, triangles, grid_delta=grid_delta)

    tracer = vrt.TraceTriangle(dim=3, device=args.device)
    tracer.set_geometry(mesh)
    tracer.set_boundary_conditions([vrt.BoundaryCondition.PERIODIC] * 3)
    tracer.set_particle_type(vrt.DiffuseParticle(0.1, "flux"))
    tracer.set_number_of_rays_per_point(args.rays_per_point)

    t0 = time.perf_counter()
    tracer.apply()
    print(f"Tracing time: {time.perf_counter() - t0} s")

    flux = tracer.get_local_data().get_vector_data("flux")
    flux = tracer.normalize_flux(flux, vrt.NormalizationType.SOURCE)
    path = os.path.join(args.out, "trenchResultTri3D.vtp")
    vrt.write_vtp(path, mesh.nodes, mesh.triangles, flux, dim=3)
    print(f"wrote {path}; info: {tracer.get_ray_trace_info()}")


if __name__ == "__main__":
    main()
