"""The port's host utilities (copies of the JAX package's numpy-only modules,
with the port's own imports): the VTK / VTP writers give the JAX package's
bytes, the ``.dat`` readers read back what the reference's format holds, a
checkpointed campaign resumed halfway equals the uninterrupted one, and the
log level setter."""

import logging
import warnings

import numpy as np
import pytest
import torch

from viennaray_tpu.io import dat as ref_dat
from viennaray_tpu.io import vtk as ref_vtk

import viennaray_tpu_torch as vrtt
from viennaray_tpu_torch.io import dat, fixtures, vtk
from viennaray_tpu_torch.utils import checkpoint
from viennaray_tpu_torch.utils import logging as vr_logging

torch.set_num_threads(1)


def _flux(n, seed):
    rng = np.random.default_rng(seed)
    flux = rng.random(n) * 3.0
    flux[::7] = 1e-8  # cleaned to 0 by both writers
    return flux


# ---- writers: the JAX package's bytes ------------------------------------------
@pytest.mark.parametrize("dim", [2, 3])
def test_write_vtk_gives_the_jax_packages_bytes(dim, tmp_path):
    pts, _ = (fixtures.create_trench_grid_2d(grid_delta=0.2) if dim == 2
              else fixtures.create_trench_grid_3d(grid_delta=1.0))
    flux = _flux(len(pts), dim)
    vtk.write_vtk(str(tmp_path / "port.vtk"), pts, flux, dim=dim)
    ref_vtk.write_vtk(str(tmp_path / "ref.vtk"), pts, flux, dim=dim)
    got = (tmp_path / "port.vtk").read_bytes()
    assert got == (tmp_path / "ref.vtk").read_bytes()
    assert got.startswith(b"# vtk DataFile Version 2.0\n")


@pytest.mark.parametrize("case", ["lines_cells", "triangles_cells",
                                  "triangles_points"])
def test_write_vtp_gives_the_jax_packages_bytes(case, tmp_path):
    if case == "lines_cells":
        nodes, elements = fixtures.create_trench_line_mesh(grid_delta=0.5)
        dim, n = 2, len(elements)
    else:
        nodes, elements = fixtures.create_trench_mesh_3d(grid_delta=1.0)
        dim = 3
        n = len(elements) if case == "triangles_cells" else len(nodes)
    flux = _flux(n, 11)
    vtk.write_vtp(str(tmp_path / "port.vtp"), nodes, elements, flux, dim=dim)
    ref_vtk.write_vtp(str(tmp_path / "ref.vtp"), nodes, elements, flux,
                      dim=dim)
    got = (tmp_path / "port.vtp").read_bytes()
    assert got == (tmp_path / "ref.vtp").read_bytes()
    tag = b"<PointData" if case == "triangles_points" else b"<CellData"
    assert tag in got


# ---- readers: the reference's plain-text formats -----------------------------------
def test_grid_file_round_trip(tmp_path):
    """numPoints, gridDelta, the points, the normals (rayUtil.hpp:353-372)."""
    pts, nrm = fixtures.create_trench_grid_3d(grid_delta=1.0)
    path = tmp_path / "grid.dat"
    with open(path, "w") as f:
        f.write(f"{len(pts)} 1.0\n")
        for row in np.concatenate([pts, nrm]):
            f.write(" ".join(repr(float(v)) for v in row) + "\n")
    grid_delta, points, normals = dat.read_grid_from_file(str(path))
    assert grid_delta == 1.0
    np.testing.assert_array_equal(points, pts)
    np.testing.assert_array_equal(normals, nrm)
    for got, want in zip((grid_delta, points, normals),
                         ref_dat.read_grid_from_file(str(path))):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dim", [2, 3])
def test_mesh_file_round_trip_and_short_element_list(dim, tmp_path):
    """'grid_delta', 'n_nodes', 'n_elements', then 'n' and 'e' lines
    (rayUtil.hpp:374-411); a header that overstates the elements is read up
    to the file's end with a warning, as the reference's own lineMesh.dat
    needs."""
    nodes, elements = (fixtures.create_trench_line_mesh(grid_delta=0.5)
                       if dim == 2
                       else fixtures.create_trench_mesh_3d(grid_delta=1.0))

    def write(path, n_declared):
        with open(path, "w") as f:
            f.write(f"grid_delta 0.5\nn_nodes {len(nodes)}\n"
                    f"n_elements {n_declared}\n")
            for p in nodes:
                f.write("n " + " ".join(repr(float(v)) for v in p) + "\n")
            for e in elements:
                f.write("e " + " ".join(str(int(v)) for v in e) + "\n")

    write(tmp_path / "mesh.dat", len(elements))
    grid_delta, got_nodes, got_elements = dat.read_mesh_from_file(
        str(tmp_path / "mesh.dat"), dim)
    assert grid_delta == 0.5
    np.testing.assert_array_equal(got_nodes, nodes)
    np.testing.assert_array_equal(got_elements, elements)
    write(tmp_path / "long.dat", len(elements) + 1)
    with pytest.warns(UserWarning, match="truncating"):
        _, _, short = dat.read_mesh_from_file(str(tmp_path / "long.dat"), dim)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = ref_dat.read_mesh_from_file(str(tmp_path / "long.dat"), dim)
    np.testing.assert_array_equal(short, ref[2])
    np.testing.assert_array_equal(short, elements)


# ---- checkpoints -------------------------------------------------------------------
def _campaign_tracer():
    pts, nrm = fixtures.create_trench_grid_3d(grid_delta=1.0)
    t = vrtt.TraceDisk(dim=3, device="cpu")
    t.set_geometry(pts, nrm, 1.0)
    t.set_boundary_conditions([vrtt.BoundaryCondition.PERIODIC] * 3)
    t.set_particle_type(vrtt.DiffuseParticle(0.2).replace(
        data_labels=("flux", "spare")))
    t.set_number_of_rays_per_point(8)
    t.set_rng_seed(17)
    return t


def test_checkpointed_campaign_resumed_halfway_equals_the_whole(tmp_path):
    """Four applies into one tracer's TracingData, against two applies, a
    checkpoint, a fresh tracer that loads it and two more: every channel
    bit for bit, the run counter and the metadata restored (the per-run seed
    bump, rayTraceDisk.hpp:54, makes the last two runs the same)."""
    whole = _campaign_tracer()
    for _ in range(4):
        whole.apply()
    first = _campaign_tracer()
    for _ in range(2):
        first.apply()
    path = str(tmp_path / "campaign.npz")
    checkpoint.save_checkpoint(path, first, metadata={"runs": 2})
    resumed = _campaign_tracer()
    assert checkpoint.load_checkpoint(path, resumed) == {"runs": 2}
    assert resumed._run_number == 3
    for _ in range(2):
        resumed.apply()
    a, b = whole.get_local_data(), resumed.get_local_data()
    assert a.num_vector_data == b.num_vector_data == 2
    for i in range(2):
        assert a.get_vector_data_label(i) == b.get_vector_data_label(i)
        np.testing.assert_array_equal(a.get_vector_data(i),
                                      b.get_vector_data(i))
    assert a.get_vector_data("flux").sum() > 0


def test_log_level_sets_the_ports_logger():
    vr_logging.set_log_level(vr_logging.LogLevel.DEBUG)
    assert vr_logging.logger.level == logging.DEBUG
    assert vr_logging.logger.name == "viennaray_tpu_torch"
    vrtt.set_log_level(vrtt.LogLevel.WARNING)
    assert vr_logging.logger.level == logging.WARNING
