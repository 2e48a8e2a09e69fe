"""Calls that work on the JAX package's public surface work on the port's:
``lines_to_triangles`` at the top level, ``DiskGeometry.build(accel=,
pack_neighbors=)`` (its records gathered on the device, the JAX package's
packing bit for bit), the sources' ``replace`` and ``Particle.reflect`` in a
``reflection_fn`` hook; and ``RandomSource.default``, the source the tracers
of both packages make."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viennaray_tpu as vrt
import viennaray_tpu_torch as vrtt
from viennaray_tpu_torch.geometry.disk_geometry import DiskGeometry
from viennaray_tpu_torch.io import fixtures

from torch_port_helpers import (
    packed_geometries, reference_arrays, reference_geometry,
)

torch.set_num_threads(1)

PERIODIC = vrtt.BoundaryCondition.PERIODIC


def test_lines_to_triangles_is_exported_as_in_the_jax_package():
    """``vrt.lines_to_triangles`` of both packages on one line mesh: the same
    nodes and triangles, bit for bit."""
    nodes, lines = fixtures.create_trench_line_mesh(0.5)
    ref = vrt.lines_to_triangles(vrt.LineMesh(nodes=nodes, lines=lines,
                                              grid_delta=0.5))
    got = vrtt.lines_to_triangles(vrtt.LineMesh(nodes, lines, grid_delta=0.5))
    assert "lines_to_triangles" in vrtt.__all__
    np.testing.assert_array_equal(got.nodes, np.asarray(ref.nodes))
    np.testing.assert_array_equal(got.triangles, np.asarray(ref.triangles))


def _tracer(fused, geometry=None):
    pts, nrm = fixtures.create_trench_grid_3d(grid_delta=0.5)
    t = vrtt.TraceDisk(dim=3, device="cpu", fused=fused)
    if geometry is None:
        t.set_geometry(pts, nrm, 0.5)
    else:
        t.geometry = geometry(pts, nrm)
    t.set_boundary_conditions([PERIODIC] * 3)
    t.set_particle_type(vrtt.DiffuseParticle(0.1))
    t.set_number_of_rays_fixed(6000)
    t.set_ray_batch_size(4096)
    t.set_rng_seed(8)
    return t


@pytest.mark.parametrize("fused", [True, False])
def test_build_without_the_neighbor_pack_traces_the_same_bits(fused):
    """``benchmarks/perf_sweep.py:97-99``'s call, ``DiskGeometry.build(pts,
    nrm, gd, dim=3, accel=False, pack_neighbors=False)`` assigned to
    ``tracer.geometry``: the geometry holds no neighbor records, the apply
    gathers them once (the values ``build`` packs, bit for bit) and keeps
    them, and the flux and counters equal the default build's bit for bit,
    on both bodies (the fused one hands its wide launches' deposits out
    through the same records)."""
    want_t = _tracer(fused)
    want = want_t.apply()
    bare = DiskGeometry.build(
        *fixtures.create_trench_grid_3d(grid_delta=0.5), 0.5, dim=3,
        accel=False, pack_neighbors=False, device="cpu")
    assert bare.neighbor_pack is None
    t = _tracer(fused, lambda p, n: DiskGeometry.build(
        p, n, 0.5, dim=3, accel=False, pack_neighbors=False, device="cpu"))
    got = t.apply()
    np.testing.assert_array_equal(got, want)
    a, b = want_t.get_ray_trace_info(), t.get_ray_trace_info()
    assert a.geometry_hits == b.geometry_hits > 0
    assert t.geometry.neighbor_pack is not None
    np.testing.assert_array_equal(t.geometry.neighbor_pack.numpy(),
                                  want_t.geometry.neighbor_pack.numpy())


@pytest.mark.parametrize("name", ["RandomSource", "GridSource",
                                  "SurfaceSource"])
def test_sources_replace_as_the_jax_ones_do(name):
    """``source.replace(cosine_power=...)`` gives a changed copy and leaves
    the source as it was, on both packages' sources."""
    box = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32)
    pts = np.zeros((4, 3), np.float32)
    nrm = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (4, 1))
    if name == "RandomSource":
        src = vrtt.RandomSource(bbox=torch.from_numpy(box), cosine_power=1.0)
        ref = vrt.RandomSource(bbox=jnp.asarray(box),
                               cosine_power=jnp.float32(1.0))
    elif name == "GridSource":
        src = vrtt.GridSource.build(box, pts, 1.0, vrtt.TraceDirection.POS_Z,
                                    device="cpu")
        ref = vrt.GridSource(bbox=jnp.asarray(box), grid=jnp.asarray(pts),
                             cosine_power=jnp.float32(1.0))
    else:
        src = vrtt.SurfaceSource.build(pts, nrm, device="cpu")
        ref = vrt.SurfaceSource(points=jnp.asarray(pts),
                                normals=jnp.asarray(nrm),
                                weights=jnp.ones(4, jnp.float32),
                                cosine_power=jnp.float32(1.0),
                                offset=jnp.float32(0.0),
                                area=jnp.float32(1.0))
    for source in (src, ref):
        changed = source.replace(cosine_power=7.0)
        assert type(changed) is type(source)
        assert float(changed.cosine_power) == 7.0
        assert float(source.cosine_power) == 1.0


PARTICLES = {
    "diffuse": lambda: vrtt.DiffuseParticle(0.1),
    "specular": lambda: vrtt.SpecularParticle(0.3, 50.0),
    "coned": lambda: vrtt.ConedCosineParticle(0.2, np.pi / 6, 50.0),
    "coned_at_its_diffuse_limit": lambda: vrtt.ConedCosineParticle(
        0.2, np.pi / 2, 50.0),
}


@pytest.mark.parametrize("name", list(PARTICLES))
def test_a_reflection_fn_through_particle_reflect_gives_the_builtin_bits(
        name):
    """A ``reflection_fn`` that returns the particle's sticking and
    ``particle.reflect(rng, dirn, normal, dim)`` (the JAX package's
    ``Particle.reflect``, on the hook's ``HookRNG``) against the built-in
    unfused body at the same seed: flux and counters bit for bit, for the
    diffuse, specular and coned-cosine models (and the coned-cosine at its
    diffuse limit, where both take the diffuse model)."""
    particle = PARTICLES[name]()

    def reflection_fn(rng, dirn, normal, prim, mat, weight):
        sticking = torch.full(dirn.shape[:1], particle.sticking)
        return sticking, particle.reflect(rng, dirn, normal, 3)

    runs = []
    for hooked in (False, True):
        t = _tracer(fused=False)
        t.set_particle_type(particle)
        if hooked:
            t.set_custom_functions(reflection_fn=reflection_fn)
        runs.append((t.apply(), t.get_ray_trace_info()))
    (want, a), (got, b) = runs
    assert want.sum() > 0
    np.testing.assert_array_equal(got, want)
    for field in ("total_rays_traced", "geometry_hits", "boundary_hits",
                  "non_geometry_hits", "reflections"):
        assert getattr(a, field) == getattr(b, field), field


@pytest.mark.parametrize("cloud", ["trench_0.5", "plane"])
def test_device_gathered_neighbor_pack_equals_the_jax_packing(cloud):
    """``DiskGeometry.with_neighbor_pack`` on the JAX package's tables handed
    across without their records (``from_reference_arrays`` with a ``None``
    pack) gathers the JAX package's host packing bit for bit; the port's
    ``build`` holds the same records, and its ``pack_neighbors=False`` build
    none."""
    pts, nrm, grid_delta, ref_geo = reference_geometry(cloud)
    fields = reference_arrays(ref_geo)
    want = fields.pop("neighbor_pack")
    bare = DiskGeometry.from_reference_arrays(
        dict(fields, neighbor_pack=None), dim=3, grid_delta=grid_delta,
        disk_radius=ref_geo.disk_radius, device="cpu")
    assert bare.neighbor_pack is None
    got = bare.with_neighbor_pack()
    assert got.with_neighbor_pack() is got
    assert got.neighbor_pack.dtype == torch.float32
    np.testing.assert_array_equal(got.neighbor_pack.numpy(), want)
    built = DiskGeometry.build(pts, nrm, grid_delta, dim=3, device="cpu")
    np.testing.assert_array_equal(built.neighbors.numpy(),
                                  fields["neighbors"])
    np.testing.assert_array_equal(built.neighbor_pack.numpy(), want)
    assert DiskGeometry.build(pts, nrm, grid_delta, dim=3, device="cpu",
                              pack_neighbors=False).neighbor_pack is None


SOURCE_CASES = {
    "disk_pos_z": ("disk", vrt.TraceDirection.POS_Z, None, 1.0),
    "disk_neg_x_tilted": ("disk", vrt.TraceDirection.NEG_X,
                          (0.3, 0.2, -0.93), 50.0),
    "triangle_pos_z": ("triangle", vrt.TraceDirection.POS_Z, None, 1.0),
    "line_pos_y": ("line", vrt.TraceDirection.POS_Y, None, 1.0),
}


@pytest.mark.parametrize("case", list(SOURCE_CASES))
def test_default_source_is_the_jax_tracers_source(case):
    """``RandomSource.default(geometry, config, cosine_power)`` against the
    source the JAX package's tracer makes for the same geometry and
    settings (its ``_default_source`` on the box its ``_run_trace``
    adjusts): the same box bit for bit, basis, axes, face, sign, dimension
    and point count, on disks, triangles and lines, with a tilted source."""
    from viennaray_tpu.config import adjust_bounding_box as ref_adjust

    kind, direction, primary, power = SOURCE_CASES[case]
    ref_geo, geo, _, dim = packed_geometries(kind)
    ref_tracer = vrt.TraceDisk(dim=dim)
    ref_tracer.set_source_direction(direction)
    if primary is not None:
        ref_tracer.set_primary_direction(primary)
    ref_tracer.set_particle_type(vrt.ConedCosineParticle(0.1, 0.5, power)
                                 if power != 1.0 else vrt.DiffuseParticle(0.1))
    margin = ref_geo.disk_radius if kind == "disk" else ref_geo.grid_delta
    ref = ref_tracer._default_source(
        ref_adjust(np.asarray(ref_geo.bbox), direction, margin, dim),
        ref_geo.num_primitives)
    config = vrtt.TraceConfig(dim=dim, source_direction=direction,
                              primary_direction=primary)
    got = vrtt.RandomSource.default(geo, config, power)
    assert got.bbox.dtype == torch.float32 and got.bbox.device == geo.device
    np.testing.assert_array_equal(got.bbox.numpy(), np.asarray(ref.bbox))
    if primary is None:
        assert got.basis is None and ref.basis is None
    else:
        np.testing.assert_allclose(got.basis.numpy(), np.asarray(ref.basis),
                                   rtol=0, atol=1e-7)
    for field in ("ray_dir", "first_dir", "second_dir", "min_max", "pos_neg",
                  "dim", "num_points"):
        assert getattr(got, field) == getattr(ref, field), field
    assert float(got.cosine_power) == float(ref.cosine_power) == power
