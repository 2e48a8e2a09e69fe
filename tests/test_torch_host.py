"""The port's host-side (numpy) code against the JAX package's: same inputs,
equal outputs. These modules are copies, so equality is exact."""

import numpy as np
import pytest
import torch

import viennaray_tpu as vrt
from viennaray_tpu import config as ref_config
from viennaray_tpu.geometry import disk_area as ref_disk_area
from viennaray_tpu.geometry import neighborhood as ref_neighborhood
from viennaray_tpu.ops import pallas_intersect as ref_pack

import viennaray_tpu_torch as vrtt
from viennaray_tpu_torch import config as port_config
from viennaray_tpu_torch.geometry import disk_area, neighborhood
from viennaray_tpu_torch.geometry.disk_geometry import DiskGeometry
from viennaray_tpu_torch.io import fixtures
from viennaray_tpu_torch.ops import nearest_hit

from torch_port_helpers import (
    CLOUDS, GEOMETRY_FIELDS, port_geometry, reference_arrays,
    reference_geometry,
)

torch.set_num_threads(1)

CLOUD_NAMES = sorted(CLOUDS)


@pytest.mark.parametrize("direction", list(ref_config.TraceDirection))
def test_trace_settings_and_bounding_box(direction):
    port_dir = port_config.TraceDirection(int(direction))
    assert port_config.get_trace_settings(port_dir) == \
        ref_config.get_trace_settings(direction)
    bbox = np.array([[-5.0, -4.0, -3.0], [5.0, 4.0, 0.5]])
    for dim in (2, 3):
        np.testing.assert_array_equal(
            port_config.adjust_bounding_box(bbox, port_dir, 0.433, dim),
            ref_config.adjust_bounding_box(bbox, direction, 0.433, dim),
        )


def test_config_constants_and_ray_counts():
    for dim in (2, 3):
        assert port_config.disk_factor(dim) == ref_config.disk_factor(dim)
    for enum_name in ("TraceDirection", "NormalizationType",
                      "BoundaryCondition", "ReflectionKind"):
        ref_enum = getattr(ref_config, enum_name)
        port_enum = getattr(port_config, enum_name)
        assert {m.name: int(m) for m in ref_enum} == \
            {m.name: int(m) for m in port_enum}
    for kwargs in (dict(num_rays_per_point=7), dict(num_rays_fixed=1234)):
        assert port_config.TraceConfig(**kwargs).total_rays(321) == \
            ref_config.TraceConfig(**kwargs).total_rays(321)
    with pytest.raises(ValueError):
        port_config.TraceConfig(dim=2)  # z source direction in 2D


@pytest.mark.parametrize("name", CLOUD_NAMES)
def test_fixtures_equal(name):
    make, _ = CLOUDS[name]
    pts, nrm, _, _ = reference_geometry(name)
    port_pts, port_nrm = make(fixtures)
    np.testing.assert_array_equal(port_pts, pts)
    np.testing.assert_array_equal(port_nrm, nrm)


@pytest.mark.parametrize("name", CLOUD_NAMES)
def test_build_neighborhood_equal(name):
    pts, _, grid_delta, _ = reference_geometry(name)
    dist = 2.0 * grid_delta * ref_config.disk_factor(3)
    ref_nbrs, ref_counts = ref_neighborhood.build_neighborhood(pts, dist, 3)
    nbrs, counts = neighborhood.build_neighborhood(pts, dist, 3)
    np.testing.assert_array_equal(counts, ref_counts)
    np.testing.assert_array_equal(nbrs, ref_nbrs)


@pytest.mark.parametrize("name", CLOUD_NAMES)
def test_disk_areas_equal(name):
    pts, nrm, grid_delta, ref_geo = reference_geometry(name)
    bbox = np.asarray(ref_geo.bbox, np.float64)
    radii = np.asarray(ref_geo.radii, np.float64)
    for conds in ([1, 1, 1], [0, 0, 0], [2, 2, 2]):
        got = disk_area.disk_areas_3d(
            pts, nrm, radii, bbox, (0, 1),
            [port_config.BoundaryCondition(c) for c in conds],
        )
        want = ref_disk_area.disk_areas_3d(
            pts, nrm, radii, bbox, (0, 1),
            [ref_config.BoundaryCondition(c) for c in conds],
        )
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", CLOUD_NAMES)
def test_pack_disk_prims_equal(name):
    pts, nrm, _, ref_geo = reference_geometry(name)
    radii = np.asarray(ref_geo.radii)
    for pad_to in (None, 128):
        got = nearest_hit.pack_disk_prims(pts, nrm, radii, pad_to=pad_to)
        want = ref_pack.pack_disk_prims(pts, nrm, radii, pad_to=pad_to)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert nearest_hit.auto_pt(len(pts)) == ref_pack.auto_pt(len(pts))


@pytest.mark.parametrize("name", CLOUD_NAMES)
def test_disk_geometry_build_equal(name):
    pts, nrm, grid_delta, ref_geo = reference_geometry(name)
    geo = DiskGeometry.build(pts, nrm, grid_delta, dim=3, device="cpu")
    want = reference_arrays(ref_geo)
    for field in GEOMETRY_FIELDS:
        got = getattr(geo, field).numpy()
        assert got.dtype == want[field].dtype, field
        np.testing.assert_array_equal(got, want[field], err_msg=field)
    assert geo.disk_radius == ref_geo.disk_radius
    assert geo.num_primitives == ref_geo.num_primitives

    # with_areas: float64 numpy on the host in both packages
    conds = [vrt.BoundaryCondition.PERIODIC] * 3
    port_conds = [vrtt.BoundaryCondition.PERIODIC] * 3
    np.testing.assert_array_equal(
        geo.with_areas((0, 1), port_conds).areas.numpy(),
        np.asarray(ref_geo.with_areas((0, 1), conds).areas),
    )


def test_from_reference_arrays_carries_every_field():
    _, _, _, ref_geo = reference_geometry("trench_1.0")
    geo = port_geometry(ref_geo)
    want = reference_arrays(ref_geo)
    for field in GEOMETRY_FIELDS:
        np.testing.assert_array_equal(getattr(geo, field).numpy(), want[field])
    incomplete = dict(want)
    del incomplete["neighbor_pack"]
    with pytest.raises(KeyError):
        DiskGeometry.from_reference_arrays(
            incomplete, dim=3, grid_delta=1.0, disk_radius=0.9, device="cpu"
        )


def test_geometry_without_a_device_does_not_land_on_the_cpu():
    """``build`` and ``from_mesh`` default to the CUDA device like the tracer:
    with no card they raise, and only ``device="cpu"`` builds on the CPU."""
    from viennaray_tpu_torch.geometry.mesh import DiskMesh

    pts, nrm, grid_delta, _ = reference_geometry("plane")
    mesh = DiskMesh(nodes=pts, normals=nrm, grid_delta=grid_delta)
    if torch.cuda.is_available():
        assert DiskGeometry.build(pts, nrm, grid_delta).device.type == "cuda"
        assert DiskGeometry.from_mesh(mesh).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            DiskGeometry.build(pts, nrm, grid_delta)
        with pytest.raises(RuntimeError, match="CUDA"):
            DiskGeometry.from_mesh(mesh)
    assert DiskGeometry.from_mesh(mesh, device="cpu").device.type == "cpu"
