"""The grid and surface sources of the port against the JAX package's, and
the unfused body's coned-cosine reflection at the cone's limits, at small
sizes on the CPU: samples lane by lane under the reference's uniforms
(``JaxKeyedRNG``), the source grid and the orthonormal basis bit for bit, one
mega-batch lane by lane, and whole runs with the reference's own checks
(tests/test_features.py:80-127).

Tolerance of the samples 1e-6 absolute, as ``tests/test_torch_physics.py``:
the arithmetic is the same, but XLA:CPU and eager PyTorch evaluate
``sin``/``cos``/``pow`` with different last-bit rounding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viennaray_tpu as vrt
from viennaray_tpu.io import fixtures as ref_fixtures
from viennaray_tpu.ops import vec as ref_vec
from viennaray_tpu.trace import kernel as ref_kernel

import viennaray_tpu_torch as vrtt
from viennaray_tpu_torch.config import adjust_bounding_box, get_trace_settings
from viennaray_tpu_torch.io import fixtures
from viennaray_tpu_torch.ops import bounce, vec
from viennaray_tpu_torch.physics import reflection
from viennaray_tpu_torch.physics.source import GridSource, SurfaceSource
from viennaray_tpu_torch.rng import GeneratorRNG
from viennaray_tpu_torch.trace.kernel import trace_batch

from torch_port_helpers import JaxKeyedRNG, lane_matched_batch, surface_source_of

torch.set_num_threads(1)

ATOL = 1e-6
BBOX = np.array([[-5.0, -4.0, -4.0], [5.0, 4.0, 0.9]], np.float32)
# a 2D box with a z extent: the source grid steps through the second axis
# (z in 2D) as the reference does, and places every point at z = 0
BBOX_2D = np.array([[-3.0, -2.5, -0.5], [3.0, 0.6, 0.5]], np.float32)
POS_Z, POS_Y = vrtt.TraceDirection.POS_Z, vrtt.TraceDirection.POS_Y


def _rel_l2(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


def _keys(batch):
    """The port's ``JaxKeyedRNG`` opened at ``batch`` and the reference's
    source key of that batch."""
    base_key = jax.random.PRNGKey(17)
    rng = JaxKeyedRNG(base_key)
    rng.begin_batch(batch)
    k_src = jax.random.fold_in(jax.random.fold_in(base_key, batch), 0x5EED)
    return rng, k_src


# ---- host code -----------------------------------------------------------------
@pytest.mark.parametrize("dim,direction,num_points", [
    (3, POS_Z, 100), (3, POS_Z, 2993), (3, vrtt.TraceDirection.NEG_X, 400),
    (2, POS_Y, 60),
])
def test_create_source_grid_equals_reference(dim, direction, num_points):
    bbox = BBOX if dim == 3 else BBOX_2D
    got = fixtures.create_source_grid(bbox, num_points, 0.25, direction, dim)
    want = ref_fixtures.create_source_grid(bbox, num_points, 0.25,
                                           vrt.TraceDirection(int(direction)),
                                           dim)
    assert got.dtype == want.dtype == np.float32 and len(got) > 10
    np.testing.assert_array_equal(got, want)


def test_orthonormal_basis_equals_reference_to_the_last_bit():
    """``vec.orthonormal_basis`` (the surface source's rotation) against
    ``viennaray_tpu/ops/vec.py:orthonormal_basis`` on seeded vectors, both
    branches of its helper axis. The operations are the same, one by one;
    what is not bit for bit is PyTorch's float32 ``sqrt`` on the CPU, which
    is not correctly rounded (XLA's and numpy's are): with the square root
    taken in float64 and rounded once, the port's basis is bitwise the
    reference's; with its own, at most the last bit of a few rows differs
    (measured: 31 of 4,096 norms, 44 of 4,096 rows)."""
    rng = np.random.default_rng(3)
    v = rng.normal(size=(4096, 3)).astype(np.float32)
    v[:16] = [[1, 0, 0], [0, 1, 0], [0, 0, 1], [0, 0, -1]] * 4
    want = np.asarray(ref_vec.orthonormal_basis(jnp.asarray(v)))
    got = vec.orthonormal_basis(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2.5e-7)
    assert (got != want).any(axis=(1, 2)).mean() < 0.02
    exact_sqrt = torch.sqrt
    try:
        torch.sqrt = lambda x: exact_sqrt(x.double()).to(x.dtype)
        exact = vec.orthonormal_basis(torch.from_numpy(v)).numpy()
    finally:
        torch.sqrt = exact_sqrt
    np.testing.assert_array_equal(exact, want)


# ---- samples lane by lane --------------------------------------------------------
@pytest.mark.parametrize("dim", [3, 2])
def test_grid_source_matches_reference(dim):
    """Origins ``grid[i % N]`` by global ray index (bitwise), directions from
    the lobe the reference draws from the unsplit source key (1e-6),
    weights 1, the source plane's area."""
    direction = POS_Z if dim == 3 else POS_Y
    bbox = BBOX if dim == 3 else BBOX_2D
    grid = fixtures.create_source_grid(bbox, 300, 0.25, direction, dim)
    ray_dir, first_dir, second_dir, _, pos_neg = get_trace_settings(direction)
    axes = dict(ray_dir=ray_dir, first_dir=first_dir, second_dir=second_dir,
                pos_neg=float(pos_neg), dim=dim)
    ref = vrt.GridSource(bbox=jnp.asarray(bbox), grid=jnp.asarray(grid),
                         cosine_power=jnp.asarray(2.0), **axes)
    port = GridSource.build(bbox, grid, 2.0, direction, dim=dim, device="cpu")
    n, batch = 2048, 2
    rng, k_src = _keys(batch)
    ray_indices = np.arange(batch * n, (batch + 1) * n)
    want_o, want_d, want_w = ref.sample(k_src, jnp.asarray(ray_indices))
    org, dirn, w = port.sample(rng, batch, n, torch.from_numpy(ray_indices))
    np.testing.assert_array_equal(org.numpy(), np.asarray(want_o))
    np.testing.assert_allclose(dirn.numpy(), np.asarray(want_d), atol=ATOL)
    np.testing.assert_array_equal(w.numpy(), np.asarray(want_w))
    assert float(port.source_area()) == float(ref.source_area())
    assert port.num_points == ref.num_points == len(grid)
    assert (dirn[:, ray_dir] <= 0).all()
    if dim == 2:
        assert not dirn[:, 2].any()


@pytest.mark.parametrize("dim", [3, 2])
def test_surface_source_matches_reference(dim):
    """Origins point + offset x normal (bitwise), the lobe rotated onto each
    point's normal (1e-6), the points' weights, the given area."""
    rng_np = np.random.default_rng(7)
    n_pts = 97
    pts = rng_np.normal(size=(n_pts, 3)).astype(np.float32)
    nrm = rng_np.normal(size=(n_pts, 3)).astype(np.float32)
    if dim == 2:
        pts[:, 2] = nrm[:, 2] = 0.0
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    weights = rng_np.uniform(0.5, 2.0, n_pts).astype(np.float32)
    ref = vrt.SurfaceSource(
        points=jnp.asarray(pts), normals=jnp.asarray(nrm),
        weights=jnp.asarray(weights), cosine_power=jnp.asarray(1.0),
        offset=jnp.asarray(0.01), area=jnp.asarray(12.5), dim=dim,
    )
    port = SurfaceSource.build(pts, nrm, weights, cosine_power=1.0,
                               offset=0.01, area=12.5, dim=dim, device="cpu")
    n, batch = 2048, 5
    rng, k_src = _keys(batch)
    ray_indices = np.arange(batch * n, (batch + 1) * n)
    want_o, want_d, want_w = ref.sample(k_src, jnp.asarray(ray_indices))
    org, dirn, w = port.sample(rng, batch, n, torch.from_numpy(ray_indices))
    np.testing.assert_array_equal(org.numpy(), np.asarray(want_o))
    np.testing.assert_allclose(dirn.numpy(), np.asarray(want_d), atol=ATOL)
    np.testing.assert_array_equal(w.numpy(), np.asarray(want_w))
    assert port.source_area() == 12.5 and port.num_points == n_pts
    # every direction leaves its point's surface
    lane_nrm = torch.from_numpy(nrm)[torch.from_numpy(ray_indices % n_pts)]
    assert (vec.dot(dirn, lane_nrm) >= -1e-6).all()


def test_generator_rng_draws_the_lobe_streams():
    """The default generator serves the two new streams (and refuses a name
    it does not know); a grid source's samples are repeatable per seed."""
    grid = fixtures.create_source_grid(BBOX, 50, 0.25, POS_Z)
    port = GridSource.build(BBOX, grid, 1.0, POS_Z, device="cpu")
    runs = []
    for _ in range(2):
        rng = GeneratorRNG(9, "cpu")
        rng.begin_batch(0)
        runs.append(port.sample(rng, 0, 512, torch.arange(512)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    with pytest.raises(ValueError):
        rng.uniform("source_lobe_3", 0, 0, 4)


# ---- one mega-batch, lane by lane --------------------------------------------------
@pytest.mark.parametrize("source", ["grid", "surface"])
def test_trace_batch_with_source_lane_matched_with_reference(source):
    """A whole mega-batch from the grid or the surface source through both
    packages' unfused bodies under the reference's uniforms: every counter
    equal, at most two bins off by more than 1e-5 of the largest and rel-L2
    < 1e-2. Why not closer: the source directions differ in the last bit
    (``pow`` / ``sin`` / ``cos``), which can move a grazing ray across a
    neighbor's rim and its whole weight with it (measured: the surface
    source 1.7e-7; the grid source one bin off by one ray's weight, rel-L2
    1.3e-3)."""
    flux, cnt, ref_flux, ref_cnt = lane_matched_batch(
        vrt.DiffuseParticle(0.2, "flux"), vrtt.DiffuseParticle(0.2, "flux"),
        ref_kernel.EnvKnobs(fused=False), source=source, fused=False,
    )
    for name in ("total_traces", "geometry_hits", "boundary_hits",
                 "non_geometry_hits"):
        assert getattr(cnt, name) == int(getattr(ref_cnt, name)) > 300, name
    assert (np.abs(flux - ref_flux) > 1e-5 * ref_flux.max()).sum() <= 2
    assert _rel_l2(flux, ref_flux) < 1e-2


# ---- whole runs (the reference's tests/test_features.py:80-127) ---------------------
def _plane_tracer(rays=100, **kwargs):
    grid_delta = 0.5
    pts, nrm = fixtures.create_plane_grid(grid_delta, 2.0, (0, 1, 2))
    t = vrtt.TraceDisk(dim=3, device="cpu", **kwargs)
    t.set_geometry(pts, nrm, grid_delta)
    t.set_boundary_conditions([vrtt.BoundaryCondition.REFLECTIVE] * 3)
    t.set_number_of_rays_per_point(rays)
    t.set_rng_seed(21)
    t.set_particle_type(vrtt.DiffuseParticle(1.0, "flux"))
    return t, pts


@pytest.mark.parametrize("fused", [True, False])
def test_grid_source_run(fused):
    """Deterministic origins cycling through a precomputed grid: nearly
    every ray hits the plane, the normalized flux averages 1 within 0.1."""
    t, _ = _plane_tracer(fused=fused)
    bbox = adjust_bounding_box(t.geometry.bbox.numpy(), POS_Z,
                               t.geometry.disk_radius, 3)
    grid = fixtures.create_source_grid(bbox, 100, 0.5, POS_Z)
    t.set_source(GridSource.build(bbox, grid, 1.0, POS_Z, device="cpu"))
    flux = t.apply()
    info = t.get_ray_trace_info()
    assert info.geometry_hits > 0.95 * info.num_rays
    np.testing.assert_allclose(t.normalize_flux(flux).mean(), 1.0, rtol=0.1)


@pytest.mark.parametrize("fused", [True, False])
def test_surface_source_run(fused):
    """Emission from points one unit above the plane, straight down: more
    than 0.8 geometry hits per ray (shallow rays leave through the walls'
    top edges, as in the reference's run)."""
    t, pts = _plane_tracer(fused=fused)
    n = len(pts)
    t.set_source(SurfaceSource.build(
        pts + np.float32([0.0, 0.0, 1.0]), np.tile([0.0, 0.0, -1.0], (n, 1)),
        cosine_power=1.0, offset=0.01, area=16.0, device="cpu"))
    flux = t.apply()
    info = t.get_ray_trace_info()
    assert flux.sum() > 0 and info.geometry_hits > 0.8 * info.num_rays
    assert t._last_source.source_area() == 16.0


def test_set_source_takes_the_three_sources_only():
    t, pts = _plane_tracer()
    for source in (
        surface_source_of(vrtt, pts, np.tile([0.0, 0.0, 1.0], (len(pts), 1))),
        GridSource.build(BBOX, fixtures.create_source_grid(BBOX, 9, 1.0, POS_Z),
                         1.0, POS_Z, device="cpu"),
    ):
        t.set_source(source)
    for other in (object(), vrt.RandomSource(bbox=jnp.asarray(BBOX),
                                             cosine_power=jnp.float32(1.0))):
        with pytest.raises(NotImplementedError):
            t.set_source(other)


# ---- the coned-cosine reflection at the cone's limits (unfused body) ------------------
def test_cone_limit_kinds():
    assert reflection.cone_limit_kind(0.0) == vrtt.ReflectionKind.SPECULAR
    assert reflection.cone_limit_kind(-0.5) == vrtt.ReflectionKind.SPECULAR
    assert reflection.cone_limit_kind(np.pi / 2) == vrtt.ReflectionKind.DIFFUSE
    assert reflection.cone_limit_kind(2.0) == vrtt.ReflectionKind.DIFFUSE
    assert reflection.cone_limit_kind(0.3) is None
    config = vrtt.TraceConfig(dim=3)
    for angle, kind in ((0.0, vrtt.ReflectionKind.SPECULAR),
                        (np.pi / 2, vrtt.ReflectionKind.DIFFUSE),
                        (0.3, vrtt.ReflectionKind.CONED_COSINE)):
        particle = vrtt.ConedCosineParticle(0.3, angle)
        unfused = bounce.BounceSettings.from_config(config, particle,
                                                    fused=False)
        fused = bounce.BounceSettings.from_config(config, particle)
        assert unfused.refl_kind == int(kind)
        # the fused kernel clips the angle and keeps the lobe, as the
        # reference's kernel does
        assert fused.refl_kind == int(vrtt.ReflectionKind.CONED_COSINE)
        assert 1e-6 <= fused.cone_angle <= np.pi / 2 - 1e-6


def test_cone_angle_zero_unfused_lane_matched_with_reference():
    """At cone angle 0 the reference's unfused body reflects specularly, and
    so does the port's: over a whole mega-batch under the reference's
    uniforms every counter is equal and the flux within rel-L2 1e-6
    (measured: equal counters, flux 5.5e-8; the two bodies differ only in
    the last bits of the float32 deposits' sums)."""
    flux, cnt, ref_flux, ref_cnt = lane_matched_batch(
        vrt.ConedCosineParticle(0.3, 0.0), vrtt.ConedCosineParticle(0.3, 0.0),
        ref_kernel.EnvKnobs(fused=False), fused=False,
    )
    for name in ("total_traces", "geometry_hits", "boundary_hits",
                 "non_geometry_hits"):
        assert getattr(cnt, name) == int(getattr(ref_cnt, name)) > 300, name
    assert _rel_l2(flux, ref_flux) < 1e-6


def test_cone_angle_right_angle_unfused_follows_the_diffuse_model():
    """At cone angle pi/2 the unfused body is the diffuse model: bitwise the
    port's diffuse particle on the same rays (``GeneratorRNG``), and against
    the reference's unfused body (its diffuse draws come from another key,
    so it agrees within noise, not lane by lane): hits per ray within 3 %,
    flux rel-L2 < 0.25 at 16,384 rays on 777 disks (the two runs share their
    origins and roulette draws and part at the first reflection; measured:
    25,706 against 25,711 hits, rel-L2 0.055)."""
    pts, nrm = fixtures.create_trench_grid_3d(grid_delta=0.5)
    geo = vrtt.DiskGeometry.build(pts, nrm, 0.5, device="cpu")
    bbox = torch.from_numpy(adjust_bounding_box(
        geo.bbox.numpy(), POS_Z, geo.disk_radius, 3).astype(np.float32))
    config = vrtt.TraceConfig(
        dim=3, boundary_conditions=(vrtt.BoundaryCondition.PERIODIC,) * 3)
    source = vrtt.RandomSource(bbox=bbox, cosine_power=1.0)
    runs = []
    for particle in (vrtt.ConedCosineParticle(0.3, np.pi / 2),
                     dataclasses.replace(vrtt.DiffuseParticle(0.3))):
        rng = GeneratorRNG(5, "cpu")
        rng.begin_batch(0)
        runs.append(trace_batch(geo, source, particle, bbox, rng, 0,
                                torch.arange(4096),
                                torch.ones(4096, dtype=torch.bool), config,
                                fused=False))
    assert runs[0][1] == runs[1][1] and torch.equal(runs[0][0], runs[1][0])
    flux, cnt, ref_flux, ref_cnt = lane_matched_batch(
        vrt.ConedCosineParticle(0.3, float(np.pi / 2)),
        vrtt.ConedCosineParticle(0.3, float(np.pi / 2)),
        ref_kernel.EnvKnobs(fused=False), fused=False, R=16384,
    )
    hits, ref_hits = cnt.geometry_hits, int(ref_cnt.geometry_hits)
    assert abs(hits - ref_hits) <= 0.03 * ref_hits
    assert _rel_l2(flux, ref_flux) < 0.25
