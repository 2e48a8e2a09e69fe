"""The disk trench of ViennaRay's examples, traced by ``TraceDisk`` with one
diffuse particle, and its plain reference.

``trench`` is a vectorised copy of the 3D trench point cloud (the program's
``io/fixtures.create_trench_grid_3d``, whose Python loops take seconds at
704,250 disks): the same points, normals and order, bit for bit. A traffic
mix's cycle of ``clouds`` is the trench deepened by ``deepen_deltas`` grid
deltas a cloud (an etch front advancing).

The configuration's keys read here: ``geometry`` (``grid_delta``,
``extent``, ``trench_width``, ``trench_depth``), ``particle`` (``kind``
"diffuse", ``sticking``), ``walls``, ``flux_model``, ``rays_per_point`` and
``dtype``.
"""

from __future__ import annotations

import numpy as np
import torch

from fluxbench.reference import disks


def trench(grid_delta, extent=5.0, trench_width=4.0, trench_depth=4.0):
    """(points (N, 3), normals (N, 3)) float32 of the trench running along y
    with z vertical: the shelves at z = 0 beside |x| >= width / 2, the two
    walls, the floor at z = -depth, spaced ``grid_delta``."""
    half = trench_width / 2.0
    xs = np.arange(-extent, extent + 1e-9, grid_delta)
    ys = np.arange(-extent, extent + 1e-9, grid_delta)
    x, y = np.meshgrid(xs, ys, indexing="ij")
    shelf = np.abs(x) >= half
    top = np.stack([x[shelf], y[shelf], np.zeros(int(shelf.sum()))], axis=1)
    zs = np.arange(-grid_delta, -trench_depth + 1e-9, -grid_delta)
    z, yw = np.meshgrid(zs, ys, indexing="ij")
    left = np.stack([np.full(z.size, -half), yw.ravel(), z.ravel()], axis=1)
    right = np.stack([np.full(z.size, half), yw.ravel(), z.ravel()], axis=1)
    walls = np.stack([left, right], axis=1).reshape(-1, 3)
    xf, yf = np.meshgrid(np.arange(-half, half + 1e-9, grid_delta), ys,
                         indexing="ij")
    floor = np.stack([xf.ravel(), yf.ravel(), np.full(xf.size, -trench_depth)],
                     axis=1)
    up = np.array([0.0, 0.0, 1.0])
    wall_n = np.tile(np.array([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]]),
                     (z.size, 1))
    points = np.concatenate([top, walls, floor]).astype(np.float32)
    normals = np.concatenate([np.tile(up, (len(top), 1)), wall_n,
                              np.tile(up, (len(floor), 1))]).astype(np.float32)
    return points, normals


def clouds(config, traffic):
    """The mix's ``clouds`` clouds: cloud k is the trench deepened by k *
    ``deepen_deltas`` grid deltas."""
    g = config["geometry"]
    gd = float(g["grid_delta"])
    step = int(traffic.get("deepen_deltas", 0)) * gd
    return [trench(gd, g["extent"], g["trench_width"],
                   g["trench_depth"] + k * step)
            for k in range(int(traffic.get("clouds", 1)))]


def _sticking(config):
    part = config["particle"]
    if part["kind"] != "diffuse":
        raise ValueError(f"unknown particle {part['kind']!r}")
    return float(part["sticking"])


def program(config, seed, device):
    """The program's tracer, every setter called, no geometry set yet."""
    import viennaray_tpu_torch as vrt

    tr = vrt.TraceDisk(dim=3, device=device)
    tr.set_boundary_conditions(
        [vrt.BoundaryCondition[w.upper()] for w in config["walls"]])
    tr.set_particle_type(vrt.DiffuseParticle(_sticking(config), "flux"))
    tr.set_flux_model(config["flux_model"])
    tr.set_number_of_rays_per_point(int(config["rays_per_point"]))
    tr.set_rng_seed(seed)
    return tr


def set_geometry(tracer, config, cloud):
    """``cloud`` set on the tracer, with new flux channels: the tracer sums
    its applies' fluxes per label, which a cloud of another size cannot
    join."""
    points, normals = cloud
    tracer.set_geometry(points, normals, float(config["geometry"]["grid_delta"]))
    tracer.get_local_data().set_number_of_vector_data(0)


def rays_per_apply(tracer, config):
    return tracer.geometry.num_primitives * int(config["rays_per_point"])


class Traced:
    """The reference's trace of a cloud: each run's raw deposits ``flux``
    (runs, N) float64 and rays ``rays`` (runs,); the front hits ``hits`` and
    the sum of squared hits a ray ``hits_sq`` over all runs; and the steps'
    operations on (runs, N) fluxes per ray."""

    def __init__(self, cloud, flux, hits, hits_sq, rays):
        self.cloud = cloud
        self.flux = flux
        self.hits = hits
        self.hits_sq = hits_sq
        self.rays = rays
        self._areas = None

    def normalize(self, values):
        """Per source ray and unit area (``normalize_flux``'s SOURCE)."""
        if self._areas is None:
            self._areas = disks.clipped_areas(self.cloud, values.device)
        return disks.normalize(self.cloud, values, 1.0, self._areas)

    def smooth(self, values):
        return disks.smooth(self.cloud, values)


def reference(config, cloud, rays_per_point, seed, device, chunks, dtype):
    """The plain reference's trace of ``cloud``: ``rays_per_point`` rays a
    disk in ``chunks`` runs, tracing in ``dtype``."""
    points, normals = cloud
    rc = disks.build_cloud(points, normals,
                           float(config["geometry"]["grid_delta"]))
    flux, hits, hits_sq, rays = disks.trace(
        rc, rc.num_disks * int(rays_per_point), sticking=_sticking(config),
        walls=tuple(config["walls"][:2]), seed=seed, device=device,
        chunks=int(chunks), dtype=dtype)
    return Traced(rc, flux, hits.sum(), hits_sq.sum(), rays)
