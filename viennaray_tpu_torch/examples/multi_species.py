"""Multi-species etch flux: an ion (specular, per-material sticking) and a
neutral (diffuse) through ``apply_particles``.

The port of the JAX package's ``examples/multi_species.py``, the
configuration of gpu/examples/trenchDisks.cpp:28-56: the 2,993-disk trench in
two materials, mask (the top surface) and substrate (walls and bottom).

    python3 -m viennaray_tpu_torch.examples.multi_species [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

import viennaray_tpu_torch as vrt
from viennaray_tpu_torch.io import fixtures

GRID_DELTA = 0.25


def species():
    """[ion, neutral]: a highly directional ion source with sticking 0.1 on
    the mask and 0.3 on the substrate, and a diffuse neutral."""
    ion = vrt.SpecularParticle(
        sticking_probability=0.2, source_power=100.0, data_label="ionFlux",
        material_sticking=[0.1, 0.3],
    )
    neutral = vrt.DiffuseParticle(sticking_probability=0.05,
                                  data_label="neutralFlux")
    return [ion, neutral]


def make_tracer(rays_per_point=500, seed=3, device=None, fused=True):
    """The trench with materials 0 (z >= 0, the mask) and 1, periodic walls;
    no particle set (``apply_particles`` sets each)."""
    points, normals = fixtures.create_trench_grid_3d(grid_delta=GRID_DELTA)
    material_ids = np.where(points[:, 2] >= -1e-6, 0, 1).astype(np.int32)
    tracer = vrt.TraceDisk(dim=3, device=device, fused=fused)
    tracer.set_geometry(points, normals, GRID_DELTA)
    tracer.set_material_ids(material_ids)
    tracer.set_boundary_conditions([vrt.BoundaryCondition.PERIODIC] * 3)
    tracer.set_number_of_rays_per_point(rays_per_point)
    tracer.set_rng_seed(seed)
    return tracer


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None)
    parser.add_argument("--rays-per-point", type=int, default=500)
    args = parser.parse_args(argv)
    tracer = make_tracer(args.rays_per_point, device=args.device)
    flux, infos = vrt.apply_particles(tracer, species())
    for name, f, info in zip(["ion", "neutral"], flux, infos):
        norm = tracer.normalize_flux(f)
        print(f"{name}: rays={info.num_rays} hits={info.geometry_hits} "
              f"time={info.time:.2f}s mean_flux={norm.mean():.3f}")
    data = tracer.get_local_data()
    print("channels:", [data.get_vector_data_label(i)
                        for i in range(data.num_vector_data)])


if __name__ == "__main__":
    main()
