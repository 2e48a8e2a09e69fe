"""The clipped disk areas, computed once per geometry and wall setting:
``DiskGeometry.with_areas`` returns itself for the walls its ``areas_key``
holds, ``replace`` drops the key where a change touches what the areas read,
and ``TraceDisk.apply`` computes them (the ``areas`` span, the
``areas_computed`` counter) only on the first apply after a change of the
geometry, the walls or the source direction. The areas equal a fresh
computation bit for bit, and the JAX package's."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import viennaray_tpu as vrt

import viennaray_tpu_torch as vrtt
from viennaray_tpu_torch.config import get_trace_settings
from viennaray_tpu_torch.geometry.disk_geometry import DiskGeometry
from viennaray_tpu_torch.io import fixtures
from viennaray_tpu_torch.utils import telemetry

torch.set_num_threads(1)

PERIODIC = vrtt.BoundaryCondition.PERIODIC
REFLECTIVE = vrtt.BoundaryCondition.REFLECTIVE

# dim -> (fixture, grid delta): 209 disks of the 3D trench, 72 of the 2D one
CLOUDS = {
    3: (lambda: fixtures.create_trench_grid_3d(grid_delta=1.0), 1.0),
    2: (lambda: fixtures.create_trench_grid_2d(grid_delta=0.25), 0.25),
}


def _tracer(dim=3):
    t = vrtt.TraceDisk(dim=dim, device="cpu")
    make, grid_delta = CLOUDS[dim]
    pts, nrm = make()
    t.set_geometry(pts, nrm, grid_delta)
    t.set_boundary_conditions([PERIODIC] * dim)
    t.set_particle_type(vrtt.DiffuseParticle(0.5))
    t.set_number_of_rays_fixed(512)
    t.set_rng_seed(8)
    return t


def _walls(t):
    """(boundary_dirs, boundary_conds) of the tracer's next apply."""
    settings = get_trace_settings(t._source_direction)
    return (settings[1], settings[2]), t._boundary_conditions


def _fresh_areas(t):
    """The tracer's geometry's areas computed anew, on a copy without the
    key, for the tracer's walls."""
    unkeyed = dataclasses.replace(t.geometry, areas_key=None)
    return unkeyed.with_areas(*_walls(t)).areas


def _computed(apply):
    """``apply()``'s change of the always-on count."""
    before = telemetry.COUNTS["areas_computed"]
    apply()
    return telemetry.COUNTS["areas_computed"] - before


@pytest.mark.parametrize("dim", [3, 2])
def test_two_applies_compute_the_areas_once(dim):
    t = _tracer(dim)
    telemetry.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        t.apply()
        first = t.geometry
        t.apply()
    assert t.geometry is first  # the second apply reused the areas
    spans = telemetry.spans()
    roots = [s for s in spans if s.name == "apply"]
    assert [r.attrs["areas_computed"] for r in roots] == [1, 0]
    areas = [s for s in spans if s.name == "areas"]
    assert [s.request_id for s in areas] == [roots[0].span_id]
    assert torch.equal(t.geometry.areas, _fresh_areas(t))

    make, grid_delta = CLOUDS[dim]
    pts, nrm = make()
    dirs, conds = _walls(t)
    ref_geo = vrt.DiskGeometry.build(pts, nrm, grid_delta, dim=dim)
    want = ref_geo.with_areas(
        dirs, [vrt.BoundaryCondition(int(c)) for c in conds]).areas
    np.testing.assert_array_equal(t.geometry.areas.numpy(), np.asarray(want))


def _set_reflective(t):
    t.set_boundary_conditions([REFLECTIVE] * 3)


def _set_ignore(t):
    t.set_boundary_conditions([vrtt.BoundaryCondition.IGNORE] * 3)


def _set_source_x(t):
    t.set_source_direction(vrtt.TraceDirection.POS_X)


def _set_geometry(t):
    pts, nrm = CLOUDS[3][0]()
    t.set_geometry(pts, nrm, CLOUDS[3][1])


def _set_material_ids(t):
    t.set_material_ids(np.arange(t.geometry.num_primitives) % 2)


@pytest.mark.parametrize("change,computes,moves", [
    (_set_reflective, 1, False), (_set_ignore, 1, True),
    (_set_source_x, 1, True), (_set_geometry, 1, False),
    (_set_material_ids, 0, False),
], ids=["reflective", "ignore", "source_direction", "geometry",
        "material_ids"])
def test_a_setter_between_applies(change, computes, moves):
    """A change of the walls or the geometry computes the areas again, for
    the new setting (a reflective wall clips as a periodic one does, an
    ignored one not, another source direction clips other sides); a change
    of the material ids reuses them."""
    t = _tracer()
    assert _computed(t.apply) == 1
    before = t.geometry.areas.clone()
    change(t)
    assert _computed(t.apply) == computes
    assert torch.equal(t.geometry.areas, _fresh_areas(t))
    assert torch.equal(t.geometry.areas, before) is not moves


@pytest.fixture(scope="module")
def keyed():
    """A 3D trench geometry without its neighbor records, its areas computed
    for periodic walls."""
    pts, nrm = CLOUDS[3][0]()
    geo = DiskGeometry.build(pts, nrm, 1.0, device="cpu",
                             pack_neighbors=False)
    return geo.with_areas((0, 1), [PERIODIC] * 3)


@pytest.mark.parametrize("field,keeps", [
    ("points", False), ("normals", False), ("radii", False), ("bbox", False),
    ("dim", False), ("areas", False), ("material_ids", True),
    ("neighbor_pack", True),
])
def test_replace_keeps_the_key_only_apart_from_what_the_areas_read(
        keyed, field, keeps):
    if field == "neighbor_pack":
        geo = keyed.with_neighbor_pack()
        assert geo is not keyed and geo.neighbor_pack is not None
    else:
        value = getattr(keyed, field)
        geo = keyed.replace(**{field: 2 if field == "dim" else value.clone()})
    assert (geo.areas_key == keyed.areas_key) is keeps
    assert (geo.areas_key is None) is not keeps
    again = geo.with_areas((0, 1), [PERIODIC] * 3)
    assert (again is geo) is keeps


def test_to_another_dtype_computes_the_same_areas_again(keyed):
    wide = keyed.to(torch.float64)
    assert wide.areas_key is None
    again = wide.with_areas((0, 1), [PERIODIC] * 3)
    assert again.areas.dtype == torch.float64
    assert torch.equal(again.areas, keyed.areas.double())


@pytest.mark.parametrize("norm", list(vrtt.NormalizationType))
def test_normalize_flux_after_a_reused_apply(norm):
    """The second apply's flux normalized on reused areas equals the same
    apply's flux normalized on areas computed for it."""
    reused, computing = _tracer(), _tracer()
    for t in (reused, computing):
        t.apply()
    computing.geometry = computing.geometry.replace(
        areas=torch.zeros_like(computing.geometry.areas))
    fluxes = {}
    for t, computes in ((reused, 0), (computing, 1)):
        assert _computed(lambda: fluxes.setdefault(t, t.apply())) == computes
    np.testing.assert_array_equal(fluxes[reused], fluxes[computing])
    np.testing.assert_array_equal(
        reused.normalize_flux(fluxes[reused], norm),
        computing.normalize_flux(fluxes[computing], norm))
