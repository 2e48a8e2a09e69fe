"""The port's compiled host helper (``viennaray_tpu_torch/native/host_accel.cpp``
loaded by ``viennaray_tpu_torch/utils/native.py``) against the port's numpy
path and the JAX package's ``build_neighborhood``: the same table, counts and
row order, exactly; and its loader under concurrent first loads."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from viennaray_tpu.geometry import neighborhood as ref_neighborhood
from viennaray_tpu_torch.geometry import neighborhood
from viennaray_tpu_torch.io import fixtures
from viennaray_tpu_torch.utils import native

# (cloud, dim, grid delta): the 3D trench of the lane-matched tests and the
# 2D trench of the 2D disk path
CLOUDS = {
    "trench3d": (lambda: fixtures.create_trench_grid_3d(grid_delta=0.5), 3,
                 0.5),
    "trench2d": (lambda: fixtures.create_trench_grid_2d(grid_delta=0.1), 2,
                 0.1),
}


@pytest.mark.parametrize("cloud", sorted(CLOUDS))
@pytest.mark.parametrize("factor", [2.0 * np.sqrt(3) / 2, 3.1])
def test_helper_tables_equal_numpy_and_reference(cloud, factor):
    """At the disk diameter (the neighbor list) and at a wider radius (the
    window list's scale), on 2D and 3D trench clouds."""
    make, dim, grid_delta = CLOUDS[cloud]
    pts, _ = make()
    distance = factor * grid_delta
    assert native.load() is not None, "the helper must build where g++ is"
    got = native.build_neighborhood_native(np.asarray(pts)[:, :dim],
                                           distance, dim)
    nbrs, counts = neighborhood.build_neighborhood(pts, distance, dim=dim)
    np_nbrs, np_counts = neighborhood.build_neighborhood_numpy(
        pts, distance, dim=dim)
    ref_nbrs, ref_counts = ref_neighborhood.build_neighborhood(
        pts, distance, dim=dim)
    assert counts.max() > 1
    for table, cnt in ((got[0], got[1]), (np_nbrs, np_counts),
                       (np.asarray(ref_nbrs), np.asarray(ref_counts))):
        np.testing.assert_array_equal(nbrs, table)
        np.testing.assert_array_equal(counts, cnt)
    assert nbrs.dtype == np.int32 and counts.dtype == np.int32


@pytest.mark.parametrize("n, distance", [(0, 0.5), (50, 0.0), (50, -1.0)])
def test_empty_and_nonpositive_distance(n, distance):
    """n = 0 and distance <= 0: an (n, 1) table of -1 and zero counts, as the
    numpy path and the JAX package give."""
    pts = np.random.default_rng(3).uniform(-1, 1, (n, 3))
    nbrs, counts = neighborhood.build_neighborhood(pts, distance, dim=3)
    ref_nbrs, ref_counts = ref_neighborhood.build_neighborhood(
        pts, distance, dim=3)
    np_nbrs, np_counts = neighborhood.build_neighborhood_numpy(
        pts, distance, dim=3)
    assert nbrs.shape == (n, 1) and (nbrs == -1).all() and (counts == 0).all()
    for table, cnt in ((np_nbrs, np_counts), (ref_nbrs, ref_counts)):
        np.testing.assert_array_equal(nbrs, table)
        np.testing.assert_array_equal(counts, cnt)


# each process imports the loader, says it is ready, waits for the go and
# loads: the six first loads start together
_FIRST_LOAD = """
import os, sys, time
from viennaray_tpu_torch.utils import native
build_dir, flags, i = sys.argv[1], sys.argv[2], sys.argv[3]
open(os.path.join(flags, "ready" + i), "w").close()
while not os.path.exists(os.path.join(flags, "go")):
    time.sleep(0.001)
lib = native.load(build_dir)
print("NONE" if lib is None else lib._name)
"""


def test_concurrent_first_loads(tmp_path):
    """Six processes load the helper at once into an empty build directory
    (given as an argument): all succeed, all load the one library, and no
    temporary file is left behind."""
    build_dir = str(tmp_path / "build")
    flags = tmp_path / "flags"
    flags.mkdir()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                  if p]))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _FIRST_LOAD, build_dir, str(flags), str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i in range(6)]
    try:
        deadline = time.monotonic() + 120
        while len(list(flags.glob("ready*"))) < 6:
            assert time.monotonic() < deadline, "the processes did not start"
            assert all(p.poll() is None for p in procs)
            time.sleep(0.01)
        (flags / "go").touch()
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), outs
    want = str(native.library_path(build_dir))
    assert [out.strip() for out, _ in outs] == [want] * 6, outs
    assert sorted(os.listdir(build_dir)) == sorted(
        ["host_accel.lock", os.path.basename(want)])
