"""An energy-carrying ion: per-ray state carried through its bounces.

The port of the JAX package's stateful-particle pattern
(``tests/test_stateful_particle.py``), the analog of the reference's stateful
particle classes that ViennaPS builds on: ``initNew`` draws the ion's energy,
``surfaceReflection`` takes 30 % of it each bounce, ``surfaceCollision``
deposits energy-weighted flux (rayParticle.hpp:30-66). A ``log_fn``
histograms the initial energies into the tracer's ``DataLog``.

    python3 -m viennaray_tpu_torch.examples.stateful_ion [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

import viennaray_tpu_torch as vrt
from viennaray_tpu_torch.io import fixtures
from viennaray_tpu_torch.ops import histogram
from viennaray_tpu_torch.physics import reflection

GRID_DELTA = 0.25
STICKING = 0.2
ENERGY_MEAN, ENERGY_SIGMA = 100.0, 10.0
ENERGY_KEPT = 0.7  # per bounce
LOG_BINS = 20  # of 10 energy units, from 0


def aux_init_fn(rng, ray_indices):
    """initNew: each ray's energy, N(100, 10), as its one aux column."""
    n = ray_indices.shape[0]
    return ENERGY_MEAN + ENERGY_SIGMA * rng.normal((n, 1))


def collision_fn(flux, ids, w, dirn, normal, mat, rng, aux):
    """surfaceCollision: energy-weighted deposits, through the histogram
    kernel."""
    energy = torch.clamp(aux[:, 0:1], min=0.0)
    return flux + histogram.flux_histogram(
        ids.reshape(-1).contiguous(), (w * energy).reshape(-1).contiguous(),
        flux.shape[-1])


def reflection_fn(rng, dirn, normal, prim, mat, weight, aux):
    """surfaceReflection: diffuse, with the built-in reflection's uniforms,
    sticking 0.2, 30 % of the energy lost."""
    u1, u2 = rng.reflect_uniforms
    sticking = torch.full(dirn.shape[:1], STICKING, dtype=torch.float32,
                          device=dirn.device)
    return sticking, reflection.diffuse(u1, u2, normal, 3), aux * ENERGY_KEPT


def log_fn(rng, aux, ray_indices, valid):
    """logData: the initial energies of the valid rays in bins of 10."""
    bins = torch.clamp((aux[:, 0] / 10.0).to(torch.int64), 0, LOG_BINS - 1)
    return [torch.bincount(bins[valid], minlength=LOG_BINS).double()]


def make_tracer(rays_per_point=500, seed=7, device=None, fused=True):
    """The 2,993-disk trench, periodic walls, the ion's hooks (which run the
    unfused body whatever ``fused`` says)."""
    points, normals = fixtures.create_trench_grid_3d(grid_delta=GRID_DELTA)
    tracer = vrt.TraceDisk(dim=3, device=device, fused=fused)
    tracer.set_geometry(points, normals, GRID_DELTA)
    tracer.set_boundary_conditions([vrt.BoundaryCondition.PERIODIC] * 3)
    tracer.set_particle_type(vrt.DiffuseParticle(STICKING, "flux"))
    tracer.set_custom_functions(collision_fn=collision_fn,
                                reflection_fn=reflection_fn,
                                aux_init_fn=aux_init_fn)
    tracer.set_data_log_fn(log_fn)
    tracer.set_number_of_rays_per_point(rays_per_point)
    tracer.set_rng_seed(seed)
    return tracer


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None)
    parser.add_argument("--rays-per-point", type=int, default=500)
    args = parser.parse_args(argv)
    tracer = make_tracer(args.rays_per_point, device=args.device)
    flux = tracer.apply()
    info = tracer.get_ray_trace_info()
    print(f"rays={info.num_rays} hits={info.geometry_hits} "
          f"deposit per hit={flux.sum() / info.geometry_hits:.2f} "
          f"time={info.time:.2f}s")
    print("initial energies, bins of 10:",
          tracer.get_data_log().data[0].astype(int).tolist())


if __name__ == "__main__":
    main()
