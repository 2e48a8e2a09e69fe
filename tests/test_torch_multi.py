"""Multi-channel flux, multi-species runs, the data log and user sources of
the port, on the CPU: ``apply_particles`` (the reference's
tests/test_features.py:217), the (L, N) flux of a collision_fn filling
labelled channels (tests/test_round3_features.py:50-110), the additive
``DataLog`` (tests/test_round2_features.py:119), a source of the user's own
against the port's ``RandomSource`` and, within Monte Carlo noise, against
the JAX package with the same beam, and the port's examples at a small size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viennaray_tpu as vrt

import viennaray_tpu_torch as vrtt
from viennaray_tpu_torch import rng as rng_mod
from viennaray_tpu_torch.config import adjust_bounding_box
from viennaray_tpu_torch.io import fixtures
from viennaray_tpu_torch.ops.histogram import flux_histogram

torch.set_num_threads(1)

REFLECTIVE = vrtt.BoundaryCondition.REFLECTIVE
PERIODIC = vrtt.BoundaryCondition.PERIODIC


def _rel_l2(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


def _deposit(flux, ids, w):
    return flux + flux_histogram(ids.reshape(-1).contiguous(),
                                 w.reshape(-1).contiguous(), flux.shape[-1])


def _plane3d(rays=50, seed=21):
    """The reference's tests' 3D plane: 81 disks, reflective walls."""
    pts, nrm = fixtures.create_plane_grid(0.5, 2.0, (0, 1, 2))
    t = vrtt.TraceDisk(dim=3, device="cpu")
    t.set_geometry(pts, nrm, 0.5)
    t.set_boundary_conditions([REFLECTIVE] * 3)
    t.set_number_of_rays_per_point(rays)
    t.set_rng_seed(seed)
    return t, pts


# ---- multi-species -------------------------------------------------------------
def test_apply_particles_channels_and_species_equal_their_own_applies():
    """Two species on one tracer: flux (2, N), one labelled channel each in
    call order, each species' counters its own; and each species' flux equals
    its own apply on a fresh tracer at the same run number (the seed plus
    the species' place) bit for bit."""
    t, pts = _plane3d()
    ion = vrtt.SpecularParticle(0.5, 5.0, "ionFlux")
    neutral = vrtt.DiffuseParticle(1.0, "neutralFlux")
    flux, infos = vrtt.apply_particles(t, [ion, neutral])
    assert flux.shape == (2, len(pts)) and flux.dtype == np.float64
    data = t.get_local_data()
    assert data.get_vector_data_index("ionFlux") == 0
    assert data.get_vector_data_index("neutralFlux") == 1
    np.testing.assert_array_equal(data.get_vector_data("ionFlux"), flux[0])
    np.testing.assert_array_equal(data.get_vector_data("neutralFlux"), flux[1])
    # sticking 1: every neutral ray ends where it lands; the ion reflects
    # off the plane and escapes
    assert infos[1].non_geometry_hits == 0
    assert infos[0].non_geometry_hits > 0
    for k, particle in enumerate((ion, neutral)):
        fresh, _ = _plane3d(seed=21 + k)
        fresh.set_particle_type(particle)
        np.testing.assert_array_equal(fresh.apply(), flux[k])


# ---- multi-channel local data and the data log ----------------------------------------
def test_multichannel_local_data():
    """A two-label particle writes distinct values into distinct channels in
    one apply: apply returns (2, N); the channel of doubled weights is twice
    the other (the histogram sums in float64 and rounds once, so exactly)."""
    pts, nrm = fixtures.create_trench_grid_2d(grid_delta=0.2)
    t = vrtt.TraceDisk(dim=2, device="cpu")
    t.set_geometry(pts, nrm, 0.2)
    t.set_boundary_conditions([REFLECTIVE] * 2)
    t.set_particle_type(vrtt.DiffuseParticle(0.3).replace(
        data_labels=("ionFlux", "energyFlux")))

    def collision_fn(flux, ids, w, dirn, normal, mat, rng):
        return torch.stack([_deposit(flux[0], ids, w),
                            _deposit(flux[1], ids, 2.0 * w)])

    t.set_custom_functions(collision_fn=collision_fn)
    t.set_source_direction(vrtt.TraceDirection.POS_Y)
    t.set_number_of_rays_fixed(4096)
    t.set_rng_seed(9)
    flux = t.apply()
    assert flux.shape == (2, len(pts))
    ion = t.get_local_data().get_vector_data("ionFlux")
    energy = t.get_local_data().get_vector_data("energyFlux")
    assert ion.sum() > 0
    np.testing.assert_array_equal(energy, 2.0 * ion)
    norm = t.normalize_flux(energy)
    np.testing.assert_allclose(norm, 2.0 * t.normalize_flux(ion), rtol=1e-6)


def test_data_log_histograms_every_ray_and_adds_up():
    """log_fn histograms the per-ray energies of aux_init_fn: the summed
    histogram counts every valid ray, and a second apply adds to it (the
    reference's DataLog::merge)."""
    t, _ = _plane3d(rays=40)
    t.set_particle_type(vrtt.DiffuseParticle(0.5, "flux"))
    n_bins = 8

    def aux_init(rng, ray_indices):
        return 10.0 + 80.0 * rng.uniform((ray_indices.shape[0], 1))

    def log_fn(rng, aux, ray_indices, valid):
        bins = torch.clamp((aux[:, 0] / 100.0 * n_bins).long(), 0, n_bins - 1)
        return [torch.bincount(bins[valid], minlength=n_bins)]

    t.set_custom_functions(aux_init_fn=aux_init)
    t.set_data_log_fn(log_fn)
    t.apply()
    log = t.get_data_log()
    total = t.get_ray_trace_info().num_rays
    assert len(log.data) == 1 and log.data[0].shape == (n_bins,)
    assert log.data[0].dtype == np.float64 and log.data[0].sum() == total
    assert log.data[0][1:7].min() > 0
    t.apply()
    assert log.data[0].sum() == 2 * total


# ---- sources of the user's own --------------------------------------------------------
class Wrapped:
    """A user's source that hands the draws to a port source."""

    def __init__(self, inner):
        self.inner = inner

    def sample(self, rng, batch_index, n, ray_indices):
        return self.inner.sample(rng, batch_index, n, ray_indices)

    def source_area(self):
        return self.inner.source_area()


def _trench_tracer(fused=True, rays=15, seed=4):
    pts, nrm = fixtures.create_trench_grid_3d(grid_delta=0.5)
    t = vrtt.TraceDisk(dim=3, device="cpu", fused=fused)
    t.set_geometry(pts, nrm, 0.5)
    t.set_boundary_conditions([PERIODIC] * 3)
    t.set_particle_type(vrtt.DiffuseParticle(0.2))
    t.set_number_of_rays_per_point(rays)
    t.set_rng_seed(seed)
    return t


@pytest.mark.parametrize("fused", [True, False])
def test_user_source_wrapping_random_source_gives_its_bits(fused):
    t = _trench_tracer(fused)
    want = t.apply()
    u = _trench_tracer(fused)
    u.set_source(Wrapped(t._last_source))
    np.testing.assert_array_equal(u.apply(), want)
    np.testing.assert_array_equal(u.normalize_flux(want),
                                  t.normalize_flux(want))


def test_user_source_samples_are_checked():
    """A user's source that samples float64 is refused by name (f64 tracing
    is not ported); one of the wrong shape raises before the trace uses it;
    the JAX package's RandomSource and ``object()`` stay refused."""
    t = _trench_tracer()
    inner = _trench_tracer()
    inner.apply()

    class Cast(Wrapped):
        def __init__(self, inner, fn):
            super().__init__(inner)
            self.fn = fn

        def sample(self, *args):
            return self.fn(*super().sample(*args))

    t.set_source(Cast(inner._last_source, lambda o, d, w: (o.double(), d, w)))
    with pytest.raises(NotImplementedError, match="f64"):
        t.apply()
    t.set_source(Cast(inner._last_source, lambda o, d, w: (o, d, w[:-1])))
    with pytest.raises(ValueError, match="weights"):
        t.apply()
    for other in (object(), vrt.RandomSource(
            bbox=jnp.zeros((2, 3)), cosine_power=jnp.float32(1.0))):
        with pytest.raises(NotImplementedError, match="sample"):
            t.set_source(other)


class Beam:
    """Origins uniform on the source plane (+z face), one fixed direction."""

    def __init__(self, bbox, direction):
        self.bbox = torch.as_tensor(bbox, dtype=torch.float32)
        d = torch.tensor(direction, dtype=torch.float32)
        self.direction = d / torch.linalg.norm(d)

    def sample(self, rng, batch_index, n, ray_indices):
        lo, hi = self.bbox[0], self.bbox[1]
        u1 = rng.uniform(rng_mod.SOURCE_ORIGIN_1, batch_index, 0, n)
        u2 = rng.uniform(rng_mod.SOURCE_ORIGIN_2, batch_index, 0, n)
        org = torch.stack([lo[0] + (hi[0] - lo[0]) * u1,
                           lo[1] + (hi[1] - lo[1]) * u2,
                           hi[2].expand(n)], 1)
        return (org, self.direction.expand(n, 3).contiguous(),
                torch.ones(n, dtype=torch.float32))

    def source_area(self):
        ext = self.bbox[1] - self.bbox[0]
        return float(ext[0] * ext[1])


@jax.tree_util.register_pytree_node_class
class RefBeam:
    """The same beam as the JAX package takes a source: ``sample(key,
    ray_indices)``."""

    def __init__(self, bbox, direction):
        self.bbox, self.direction = bbox, direction

    def tree_flatten(self):
        return (self.bbox, self.direction), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    def sample(self, key, ray_indices):
        n = ray_indices.shape[0]
        k1, k2 = jax.random.split(key)
        lo, hi = self.bbox[0], self.bbox[1]
        org = jnp.stack([lo[0] + (hi[0] - lo[0]) * jax.random.uniform(k1, (n,)),
                         lo[1] + (hi[1] - lo[1]) * jax.random.uniform(k2, (n,)),
                         jnp.full((n,), hi[2])], 1)
        d = self.direction / jnp.linalg.norm(self.direction)
        return org, jnp.broadcast_to(d, (n, 3)), jnp.ones((n,))

    def source_area(self):
        ext = self.bbox[1] - self.bbox[0]
        return float(ext[0] * ext[1])


def test_beam_source_matches_the_jax_package():
    """A tilted beam (direction (0.5, 0, -1)) into the 777-disk trench at 40
    rays per point through both packages: normalized flux within rel-L2
    0.15 and hits per ray within 3 %. Measured: three seeds of the port part
    by 0.111 to 0.114, two of the JAX package by 0.111, the port from the
    JAX package by 0.110 to 0.117; hits per ray 1.599 to 1.618 against 1.608
    and 1.625."""
    direction = (0.5, 0.0, -1.0)
    pts, nrm = fixtures.create_trench_grid_3d(grid_delta=0.5)
    geometry = vrtt.DiskGeometry.build(pts, nrm, 0.5, device="cpu")
    bbox = adjust_bounding_box(geometry.bbox.numpy(), vrtt.TraceDirection.POS_Z,
                               geometry.disk_radius, 3).astype(np.float32)
    runs = []
    for seed in (4, 5):
        t = _trench_tracer(fused=False, rays=40, seed=seed)
        t.set_source(Beam(bbox, direction))
        flux = t.apply()
        info = t.get_ray_trace_info()
        runs.append((t.normalize_flux(flux),
                     info.geometry_hits / info.num_rays))
    ref = vrt.TraceDisk(dim=3)
    ref.set_geometry(pts, nrm, 0.5)
    ref.set_boundary_conditions([vrt.BoundaryCondition.PERIODIC] * 3)
    ref.set_particle_type(vrt.DiffuseParticle(0.2))
    ref.set_number_of_rays_per_point(40)
    ref.set_rng_seed(4)
    ref.set_source(RefBeam(jnp.asarray(bbox), jnp.asarray(direction)))
    ref_flux = ref.apply()
    ref_info = ref.get_ray_trace_info()
    ref_norm = np.asarray(ref.normalize_flux(ref_flux))
    ref_hits = ref_info.geometry_hits / ref_info.num_rays
    for norm, hits in runs:
        assert _rel_l2(norm, ref_norm) < 0.15, _rel_l2(norm, ref_norm)
        assert abs(hits - ref_hits) < 0.03 * ref_hits, (hits, ref_hits)
    # the beam's side wall takes more than the other
    x = pts[:, 0]
    walls = np.abs(np.abs(x) - 2.0) < 1e-3
    assert runs[0][0][walls & (x > 0)].sum() > runs[0][0][walls & (x < 0)].sum()


# ---- the port's examples ---------------------------------------------------------
@pytest.mark.parametrize("name", ["multi_channel", "multi_species",
                                  "stateful_ion"])
def test_examples_run_on_the_cpu(name, tmp_path, capsys):
    import importlib

    module = importlib.import_module(f"viennaray_tpu_torch.examples.{name}")
    argv = ["--device", "cpu", "--rays-per-point", "2"]
    if name == "multi_channel":
        argv += ["--out", str(tmp_path)]
    module.main(argv)
    out = capsys.readouterr().out
    if name == "multi_channel":
        assert "energy/ion ratio=0.9" in out
        assert (tmp_path / "trenchIonFlux.vtk").exists()
    elif name == "multi_species":
        assert "channels: ['ionFlux', 'neutralFlux']" in out
    else:
        assert "deposit per hit=" in out
