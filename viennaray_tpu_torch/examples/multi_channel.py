"""Two-channel particle: ion flux and deposited-energy flux in ONE trace.

The port of the JAX package's ``examples/multi_channel.py``: the ViennaPS
pattern the reference supports through surfaceCollision writing distinct
values into distinct labelled TracingData rows (rayParticle.hpp:60-66; GPU
result buffer numElements x sum(dataLabels), gpu/raygTrace.hpp:97-99). The
particle declares two data labels and a ``collision_fn`` fills both
channels: channel 0 takes the weight, channel 1 the weight times the
incidence cosine (an energy-transfer proxy). Deposits go through the
histogram kernel, so a fixed seed gives the same flux.

    python3 -m viennaray_tpu_torch.examples.multi_channel [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import torch

import viennaray_tpu_torch as vrt
from viennaray_tpu_torch.io import fixtures
from viennaray_tpu_torch.ops import histogram

GRID_DELTA = 0.25
LABELS = ("ionFlux", "energyFlux")


def deposit(flux, ids, w):
    """``flux`` plus the weights ``w`` in bins ``ids`` (both (R, k)): the
    histogram kernel."""
    return flux + histogram.flux_histogram(
        ids.reshape(-1).contiguous(), w.reshape(-1).contiguous(),
        flux.shape[-1])


def collision_fn(flux, ids, w, dirn, normal, mat, rng):
    """The incidence cosine at the primary hit scales the energy channel."""
    cosi = (dirn * normal).sum(dim=1, keepdim=True).abs()
    return torch.stack([deposit(flux[0], ids, w),
                        deposit(flux[1], ids, w * cosi)])


def particle():
    return vrt.SpecularParticle(0.4, 100.0).replace(data_labels=LABELS)


def make_tracer(rays_per_point=500, seed=12, device=None, fused=True):
    """The 2,993-disk trench with periodic walls, the two-channel particle
    and its hook."""
    points, normals = fixtures.create_trench_grid_3d(grid_delta=GRID_DELTA)
    tracer = vrt.TraceDisk(dim=3, device=device, fused=fused)
    tracer.set_geometry(points, normals, GRID_DELTA)
    tracer.set_boundary_conditions([vrt.BoundaryCondition.PERIODIC] * 3)
    tracer.set_particle_type(particle())
    tracer.set_custom_functions(collision_fn=collision_fn)
    tracer.set_number_of_rays_per_point(rays_per_point)
    tracer.set_rng_seed(seed)
    return tracer


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None)
    parser.add_argument("--rays-per-point", type=int, default=500)
    parser.add_argument("--out", default=".", help="directory of the VTK files")
    args = parser.parse_args(argv)
    tracer = make_tracer(args.rays_per_point, device=args.device)
    tracer.apply()
    data = tracer.get_local_data()
    ion = data.get_vector_data("ionFlux")
    energy = data.get_vector_data("energyFlux")
    print(f"ionFlux sum={ion.sum():.1f}, energyFlux sum={energy.sum():.1f}, "
          f"energy/ion ratio={energy.sum() / ion.sum():.3f}")
    points = tracer.geometry.points.cpu().numpy()
    for label, flux in (("Ion", ion), ("Energy", energy)):
        path = os.path.join(args.out, f"trench{label}Flux.vtk")
        vrt.write_vtk(path, points, tracer.normalize_flux(flux))
        print("wrote", path)


if __name__ == "__main__":
    main()
