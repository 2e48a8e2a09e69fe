"""The disk neighbor table built on the card (``csrc/neighborhood.cu`` via
``geometry/neighborhood.py:build_neighborhood_cuda``) against the compiled
host helper (``native/host_accel.cpp``) and the numpy path: the same table,
counts and row order, bit for bit. On the CPU the helper's table is held to
the JAX package's ``build_neighborhood`` on every case too (``helper_tables``);
a machine with a card runs the port alone, so there the card is held to the
helper on those same cases (``host_tables``).

(a) A torch twin of the kernels' arithmetic (``twin``: the cells in float64,
    a stable sort of the linear ids, a binary search for each deduplicated
    offset, the predicate, rows in sorted order), held to the helper and
    the numpy path on every case of ``CASES``.
(b) ``csrc/neighborhood.cuh``, the kernels' per-point work, compiled by
    ``g++ -ffp-contract=off`` for the host and run a point at a time: the
    CUDA source's logic, checked without a card (it needs ``g++``).
(c) On a card (marker ``cuda``; skipped here): the kernels against the
    helper on every case, on the 704,250-disk trench and the flagship, and
    ``DiskGeometry.build`` on CUDA against the build on the CPU, 3D and 2D.
    ``python3 -m pytest --noconftest -p no:cacheprovider -m cuda
    tests/test_torch_neighborhood.py -q`` on a machine with a card.

The cases: the flagship trench (2,993 disks), a 2D trench, a flat cloud with
one collapsed axis (the offsets' dedupe), pairs exactly ``distance`` apart
(the inclusive predicate), a pair whose cells are linearly adjacent but two
apart on one axis while it passes the distance test (the wrap guard), pairs
on the float64 boundary where a fused multiply-add would move d2 across
distance^2, duplicate points, a sparse random cloud, and n = 0, n = 1 and
distance <= 0.
"""

from fractions import Fraction
import functools
import math
import shutil
import subprocess
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from viennaray_tpu_torch.config import disk_factor
from viennaray_tpu_torch.geometry import neighborhood
from viennaray_tpu_torch.geometry.disk_geometry import DiskGeometry
from viennaray_tpu_torch.io import fixtures
from viennaray_tpu_torch.trace import postprocess
from viennaray_tpu_torch.utils import native, telemetry

CSRC = Path(neighborhood.__file__).resolve().parent.parent / "csrc"


def _trench3d(grid_delta):
    pts, _ = fixtures.create_trench_grid_3d(grid_delta=grid_delta)
    return pts, 2.0 * grid_delta * disk_factor(3), 3


def _trench2d():
    pts, _ = fixtures.create_trench_grid_2d(grid_delta=0.1)
    return pts, 2.0 * 0.1 * disk_factor(2), 2


def _flat():
    """The 2D trench at dim 3 (z = 0 everywhere), at twice the disk
    diameter: ``smooth_flux(num_neighbors=2)`` on a 2D geometry."""
    pts, _ = fixtures.create_trench_grid_2d(grid_delta=0.1)
    return pts, 4.0 * 0.1 * disk_factor(2), 3


def _exact():
    """A lattice of spacing 0.25 at distance 0.5: every axis pair two
    steps apart lies exactly at the distance."""
    g = np.arange(6, dtype=np.float32) * np.float32(0.25)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    return pts, 0.5, 3


def _wrap():
    """Point A in cell (0, 1), B in cell (2, 0), C at the origin (the
    minima): the y span is 2, so B's cell is A's plus the linear offset 3
    (one x row and one y step, wrapped), and A and B pass the distance test
    while their x cells lie two apart. The distance is searched so that
    (p - lo) * (1 / distance) rounds B's x up to cell 2 while B - A stays
    within it. Only the wrap guard keeps them apart."""
    rng = np.random.default_rng(0)

    def cell(p, inv):
        return np.floor(np.float64(p) * inv)

    while True:
        d = float(rng.uniform(0.05, 2.0))
        inv = 1.0 / d
        x2 = 2.0 * d
        while cell(x2, inv) >= 2:
            x2 = np.nextafter(x2, 0.0)
        x2 = np.nextafter(x2, 10.0)  # the least x in cell 2
        if Fraction(x2) >= 2 * Fraction(d):
            continue  # really in cell 2: no rounding to exploit
        x1 = d
        while cell(x1, inv) >= 1:
            x1 = np.nextafter(x1, 0.0)
        y1 = d
        while cell(y1, inv) < 1:
            y1 = np.nextafter(y1, 10.0)
        y2 = np.nextafter(y1, 0.0)
        while cell(y2, inv) >= 1:
            y2 = np.nextafter(y2, 0.0)
        dx, dy = x2 - x1, y1 - y2
        if abs(dx) <= d and (0.0 + dx * dx) + dy * dy <= d * d:
            pts = np.array([[0.0, 0.0, 0.0], [x1, y1, 0.0], [x2, y2, 0.0]])
            return pts, d, 2


def _fma():
    """Pairs at distance 1 whose d2, summed in axis order with every step
    rounded, lies on the other side of 1 than the sum a fused multiply-add
    gives (each square exact before its add): float64 points, pair k at
    (b, b + v) with b = (8 k, 0, 0), v on a grid of 2^-44 (so b + v - b is
    v exactly and v^2 is not exact) and |v|^2 between 1 + 2^-55 and
    1 + 2^-51, around 1 + 2^-53, where the last add rounds to 1 or up."""
    rng = np.random.default_rng(1)
    one = 1 << 88  # |v|^2 = 1 in units of 2^-88
    pts = []
    while len(pts) < 2 * 32:
        mx, my = (int(m) for m in rng.integers(-(1 << 43), 1 << 43, 2))
        mz = math.isqrt(one - mx * mx - my * my) + 1
        if not 1 << 33 <= mx * mx + my * my + mz * mz - one <= 1 << 37:
            continue
        v = np.array([mx, my, mz], np.float64) / 2.0 ** 44
        plain = ((0.0 + v[0] * v[0]) + v[1] * v[1]) + v[2] * v[2]
        fused = float(Fraction(float(Fraction(v[0] * v[0])
                                     + Fraction(v[1]) ** 2))
                      + Fraction(v[2]) ** 2)
        if (plain <= 1.0) == (fused <= 1.0):
            continue
        base = np.array([4.0 * len(pts), 0.0, 0.0])
        pts += [base, base + v]
    return np.array(pts), 1.0, 3


def _duplicates():
    """Points each present two or three times, and one at a lattice step
    from the others."""
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1.0, 1.0, (150, 3))
    return np.concatenate([pts, pts, pts[:50]]), 0.3, 3


def _random():
    """A sparse cloud: 3,000 points in a box 40 cells wide."""
    rng = np.random.default_rng(3)
    return rng.uniform(-5.0, 5.0, (3000, 3)), 0.25, 3


CASES = {
    "flagship": lambda: _trench3d(0.25),
    "trench2d": _trench2d,
    "flat": _flat,
    "exact": _exact,
    "wrap": _wrap,
    "fma": _fma,
    "duplicates": _duplicates,
    "random": _random,
    "n0": lambda: (np.zeros((0, 3), np.float32), 0.5, 3),
    "n1": lambda: (np.ones((1, 3), np.float32), 0.5, 3),
    "d0": lambda: (_trench2d()[0], 0.0, 2),
    "dneg": lambda: (_trench2d()[0], -1.0, 3),
}


@functools.lru_cache(maxsize=None)
def case(name):
    """``CASES[name]()``, made once (the fma pairs take a second)."""
    return CASES[name]()


def twin(points, distance, dim):
    """The kernels' arithmetic in torch ops (tests only): (neighbors (N, K)
    int32 padded -1, counts (N,) int32) as numpy arrays."""
    p = torch.as_tensor(np.asarray(points))[:, :dim].to(torch.float64)
    n = len(p)
    if n == 0 or distance <= 0:
        return np.full((n, 1), -1, np.int32), np.zeros(n, np.int32)
    distance = float(distance)
    cx = torch.floor((p - p.amin(0)) * (1.0 / distance)).long()
    maxc = cx.amax(0)
    strides = [1] * dim
    for d in range(dim - 2, -1, -1):
        strides[d] = strides[d + 1] * (int(maxc[d + 1]) + 1)
    strides = torch.tensor(strides)
    n_cells = int(strides[0]) * (int(maxc[0]) + 1)
    ids = (cx * strides).sum(1)
    sorted_ids, order = torch.sort(ids, stable=True)
    combos = torch.cartesian_prod(*[torch.tensor([-1, 0, 1])] * dim)
    offs = torch.unique((combos * strides).sum(1))  # ascending, distinct
    cj = ids[:, None] + offs[None, :]  # (N, O)
    start = torch.searchsorted(sorted_ids, cj)
    size = torch.searchsorted(sorted_ids, cj, right=True) - start
    size = torch.where((cj >= 0) & (cj < n_cells), size, 0)
    slot = torch.arange(max(1, int(size.max())))
    present = slot < size[:, :, None]  # (N, O, M)
    j = order[torch.clamp(start[:, :, None] + slot, max=n - 1)]
    i = torch.arange(n)[:, None, None]
    ok = present & (j != i)
    diff = p[i] - p[j]
    ok &= (diff.abs() <= distance).all(-1)
    d2 = torch.zeros(j.shape, dtype=torch.float64)
    for d in range(dim):
        d2 = d2 + diff[..., d] * diff[..., d]
    ok &= d2 <= distance * distance
    ok &= ((cx[i] - cx[j]).abs() <= 1).all(-1)
    ok, j = ok.reshape(n, -1), j.reshape(n, -1)
    counts = ok.sum(1)
    neighbors = torch.full((n, max(1, int(counts.max()))), -1,
                           dtype=torch.int32)
    rows, cols = ok.nonzero(as_tuple=True)
    neighbors[rows, (ok.cumsum(1) - 1)[rows, cols]] = j[rows, cols].int()
    return neighbors.numpy(), counts.int().numpy()


def host_tables(points, distance, dim):
    """The host helper's table and the numpy path's, which must agree (on a
    machine with a card, which runs the port alone)."""
    got = neighborhood.build_neighborhood(np.asarray(points), distance, dim)
    np_got = neighborhood.build_neighborhood_numpy(points, distance, dim)
    for a, b in zip(got, np_got):
        np.testing.assert_array_equal(a, b)
    return got


def helper_tables(points, distance, dim, jax_helper=True):
    """``host_tables``, held to the JAX package's ``build_neighborhood``: its
    numpy pass (its compiled helper set aside), and its compiled helper
    unless ``jax_helper`` is False. That helper is built ``-march=native``
    without ``-ffp-contract=off``, so on a CPU with fused multiply-adds it
    contracts d2 and differs on the fma case's boundary pairs by design."""
    from viennaray_tpu.geometry import neighborhood as ref
    from viennaray_tpu.utils import native as ref_native

    got = host_tables(points, distance, dim)
    with mock.patch.object(ref_native, "build_neighborhood_native",
                           lambda *args: None):
        refs = [ref.build_neighborhood(points, distance, dim)]
    if jax_helper:
        refs.append(ref.build_neighborhood(points, distance, dim))
    for want in refs:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))
    return got


def assert_tables_equal(got, want):
    for a, b in zip(got, want):
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else a
        assert a.dtype == np.int32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ---- (a) the torch twin ----------------------------------------------------
@pytest.mark.parametrize("name", sorted(CASES))
def test_twin_equals_the_helper_and_numpy(name):
    points, distance, dim = case(name)
    assert native.load() is not None, "the helper must build where g++ is"
    want = helper_tables(points, distance, dim, jax_helper=name != "fma")
    assert_tables_equal(twin(points, distance, dim), want)
    if name in ("flagship", "trench2d", "flat", "random", "duplicates"):
        assert want[1].max() > 1


def test_the_cases_reach_what_they_are_for():
    """The flat cloud would list pairs twice without the offsets' dedupe;
    the wrap pair passes the distance test; the fma pairs lie at the
    boundary (some in, some out); exact pairs are kept."""
    pts, d, dim = case("flat")
    assert np.ptp(pts[:, 2]) == 0 and dim == 3
    pts, d, dim = case("wrap")
    nbrs, counts = helper_tables(pts, d, dim)
    assert counts.tolist() == [0, 0, 0]
    cells = np.floor((pts[:, :2] - pts[:, :2].min(0)) * (1.0 / d))
    assert cells[1:].tolist() == [[0.0, 1.0], [2.0, 0.0]]
    assert np.all(np.abs(pts[2, :2] - pts[1, :2]) <= d)
    pts, d, dim = case("fma")
    _, counts = helper_tables(pts, d, dim, jax_helper=False)
    assert 0 < counts.sum() < len(pts)
    pts, d, dim = case("exact")
    nbrs, _ = helper_tables(pts, d, dim)
    at = [int(np.flatnonzero((pts == p).all(1))[0])
          for p in ([0.5, 0, 0], [0, 0.5, 0], [0, 0, 0.5])]
    assert set(at) <= set(nbrs[0].tolist())


# ---- (b) the CUDA source's per-point work, on the host -----------------------
# stand-ins for the CUDA built-ins that csrc/neighborhood.cuh uses: plain
# float64 operations (round to nearest; g++ -ffp-contract=off keeps them
# apart, as the _rn intrinsics do)
CUDA_HOST_HEADER = r"""
#pragma once
#include <cmath>
#define __device__
#define __forceinline__ inline
#define __restrict__ __restrict
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline double __dmul_rn(double a, double b) { return a * b; }
using std::fabs; using std::floor;
"""

# the wrapper's and the kernels' steps a point at a time: argv n cols dim
# distance f64 dir; reads dir/pts, writes dir/counts and dir/neighbors
CUDA_HOST_MAIN = r"""
#include <cuda_runtime.h>
#include "neighborhood.cuh"
#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>

template <class T>
int run(long long n, int cols, int dim, double distance, std::string dir) {
  std::vector<T> pts(n * cols);
  FILE* f = fopen((dir + "/pts").c_str(), "rb");
  if (fread(pts.data(), sizeof(T), pts.size(), f) != pts.size()) return 2;
  fclose(f);
  T lo[3] = {0, 0, 0};
  for (int d = 0; d < dim; ++d) {
    lo[d] = pts[d];
    for (long long i = 0; i < n; ++i) lo[d] = std::min(lo[d], pts[i * cols + d]);
  }
  std::vector<long long> cx(n * 3, 0), ids(n), order(n), sorted(n);
  long long maxc[3] = {0, 0, 0};
  for (long long i = 0; i < n; ++i)
    for (int d = 0; d < dim; ++d) {
      cx[i * 3 + d] = nbr_cell(pts[i * cols + d], lo[d], 1.0 / distance);
      maxc[d] = std::max(maxc[d], cx[i * 3 + d]);
    }
  NbrGrid g;
  nbr_grid(maxc, dim, &g);
  for (long long i = 0; i < n; ++i) ids[i] = nbr_id(&cx[i * 3], maxc, dim);
  for (long long i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(),
                   [&](long long a, long long b) { return ids[a] < ids[b]; });
  for (long long t = 0; t < n; ++t) sorted[t] = ids[order[t]];
  std::vector<int> counts(n);
  int k = 1;
  for (long long t = 0; t < n; ++t) {
    const long long i = order[t];
    counts[i] = nbr_row<T>(i, sorted[t], pts.data(), cols, dim, cx.data(),
                           sorted.data(), order.data(), n, &g, distance,
                           distance * distance, [](int, long long) {});
    k = std::max(k, counts[i]);
  }
  std::vector<int> nbrs(n * k, -1);
  for (long long t = 0; t < n; ++t) {
    const long long i = order[t];
    int* row = nbrs.data() + i * k;
    nbr_row<T>(i, sorted[t], pts.data(), cols, dim, cx.data(), sorted.data(),
               order.data(), n, &g, distance, distance * distance,
               [&](int c, long long j) { row[c] = (int)j; });
  }
  f = fopen((dir + "/counts").c_str(), "wb");
  fwrite(counts.data(), sizeof(int), n, f);
  fclose(f);
  f = fopen((dir + "/neighbors").c_str(), "wb");
  fwrite(nbrs.data(), sizeof(int), nbrs.size(), f);
  fclose(f);
  printf("%d\n", k);
  return 0;
}

int main(int argc, char** argv) {
  const long long n = atoll(argv[1]);
  const int cols = atoi(argv[2]), dim = atoi(argv[3]);
  const double distance = strtod(argv[4], nullptr);
  if (atoi(argv[5])) return run<double>(n, cols, dim, distance, argv[6]);
  return run<float>(n, cols, dim, distance, argv[6]);
}
"""


@pytest.fixture(scope="module")
def host_rows(tmp_path_factory):
    """``csrc/neighborhood.cuh`` built for the host: a program that builds a
    directory's points' table a point at a time."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the CUDA source cannot be built here")
    work = tmp_path_factory.mktemp("neighborhood_host")
    (work / "cuda_runtime.h").write_text(CUDA_HOST_HEADER)
    (work / "main.cpp").write_text(CUDA_HOST_MAIN)
    exe = work / "rows"
    subprocess.run(
        [gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-w", "-I", str(work),
         "-I", str(CSRC), str(work / "main.cpp"), "-o", str(exe)],
        check=True, capture_output=True, text=True, timeout=300)
    return exe


@pytest.mark.parametrize("name", sorted(set(CASES) - {"n0", "d0", "dneg"}))
def test_the_cuda_source_on_the_host(host_rows, tmp_path, name):
    """``nbr_cell``, ``nbr_grid``, ``nbr_id`` and ``nbr_row`` as the kernels
    compile them, a point at a time after a stable sort, give the helper's
    table, in the points' own type (float32 points widened in the row)."""
    points, distance, dim = case(name)
    points = np.ascontiguousarray(points)
    points.tofile(tmp_path / "pts")
    f64 = int(points.dtype == np.float64)
    run = subprocess.run(
        [str(host_rows), str(len(points)), str(points.shape[1]), str(dim),
         repr(float(distance)), str(f64), str(tmp_path)],
        capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run
    k = int(run.stdout)
    got = (np.fromfile(tmp_path / "neighbors", np.int32).reshape(-1, k),
           np.fromfile(tmp_path / "counts", np.int32))
    assert_tables_equal(got, helper_tables(points, distance, dim,
                                           jax_helper=name != "fma"))


# ---- the path taken, the counters and the span --------------------------------
def test_a_cpu_build_counts_a_host_build_and_says_so():
    """On the CPU the table is the helper's (numpy), counted once in
    ``host_builds`` per ``DiskGeometry.build``, and the span says
    ``on_device`` 0; a CPU tensor takes the host path too."""
    pts, nrm = fixtures.create_trench_grid_3d(grid_delta=1.0)
    before = (neighborhood.host_builds,
              neighborhood.device_builds)
    telemetry.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with telemetry.request("set_geometry"):
            geo = DiskGeometry.build(pts, nrm, 1.0, device="cpu")
    assert (neighborhood.host_builds - before[0],
            neighborhood.device_builds - before[1]) == (1, 0)
    span = [s for s in telemetry.spans() if s.name == "geometry.neighborhood"]
    assert [s.attrs for s in span] == [
        {"K": geo.neighbors.shape[1], "on_device": 0}]
    got = neighborhood.build_neighborhood(torch.from_numpy(pts), 1.7, 3)
    assert isinstance(got[0], np.ndarray)
    assert_tables_equal(got, helper_tables(pts, 1.7, 3))


def test_from_reference_arrays_refuses_a_tensor_of_another_type():
    pts, nrm = fixtures.create_trench_grid_3d(grid_delta=1.0)
    geo = DiskGeometry.build(pts, nrm, 1.0, device="cpu", accel=False)
    fields = {name: getattr(geo, name).numpy() for name in (
        "points", "normals", "radii", "material_ids", "neighbors", "areas",
        "bbox", "prims_soa", "soa_perm", "soa_chunk_bbs", "soa_inv_perm")}
    fields["neighbor_pack"] = None
    kw = dict(dim=3, grid_delta=1.0, disk_radius=geo.disk_radius,
              device="cpu")
    taken = DiskGeometry.from_reference_arrays(
        dict(fields, neighbors=geo.neighbors), **kw)
    assert taken.neighbors is geo.neighbors
    with pytest.raises(ValueError, match="int64 tensor"):
        DiskGeometry.from_reference_arrays(
            dict(fields, neighbors=geo.neighbors.long()), **kw)


# ---- (c) on the card ---------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("widen", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_equals_the_helper(cuda, name, widen):
    """Every case in the points' own type and widened to float64 (the same
    values): the card's table is the helper's, on the card."""
    points, distance, dim = case(name)
    dev = torch.from_numpy(np.ascontiguousarray(points)).to(cuda)
    if widen:
        dev = dev.double()
    counted = neighborhood.build_neighborhood_cuda
    before = (counted.launches, counted.launches_f64)
    got = neighborhood.build_neighborhood(dev, distance, dim)
    assert all(t.device == dev.device for t in got)
    assert_tables_equal(got, host_tables(points, distance, dim))
    launches = 4 if len(points) and distance > 0 else 0
    f64 = dev.dtype == torch.float64
    assert (counted.launches - before[0], counted.launches_f64 - before[1]) \
        == ((0, launches) if f64 else (launches, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("grid_delta", [0.016, 0.25])
def test_kernel_equals_the_helper_on_the_trenches(cuda, grid_delta):
    """The 704,250-disk trench of the benchmark's disk1m cells and the
    2,993-disk flagship, at the disk diameter."""
    points, distance, dim = _trench3d(grid_delta)
    got = neighborhood.build_neighborhood_cuda(
        torch.from_numpy(points).to(cuda), distance, dim)
    want = neighborhood.build_neighborhood(points, distance, dim)
    assert_tables_equal(got, want)
    assert len(points) == {0.016: 704_250, 0.25: 2_993}[grid_delta]


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [3, 2])
def test_build_on_the_card_equals_the_build_on_the_cpu(cuda, dim):
    """``DiskGeometry.build`` on CUDA: its neighbors and neighbor records
    are the CPU build's, ``smooth_flux`` at one and at two neighbor
    diameters gives what the host helper's tables give on the card, and
    the counters each count one build of their path (and four kernel
    launches)."""
    from viennaray_tpu_torch.trace.tracer import TraceDisk

    if dim == 3:
        pts, nrm = fixtures.create_trench_grid_3d(grid_delta=0.25)
        delta = 0.25
    else:
        pts, nrm = fixtures.create_trench_grid_2d(grid_delta=0.1)
        delta = 0.1
    host = DiskGeometry.build(pts, nrm, delta, dim=dim, device="cpu")
    before = (neighborhood.host_builds,
              neighborhood.device_builds,
              neighborhood.build_neighborhood_cuda.launches)
    card = DiskGeometry.build(pts, nrm, delta, dim=dim, device=cuda)
    assert (neighborhood.host_builds - before[0],
            neighborhood.device_builds - before[1],
            neighborhood.build_neighborhood_cuda.launches - before[2]) \
        == (0, 1, 4)
    assert card.neighbors.device == cuda
    for name in ("points", "neighbors", "neighbor_pack"):
        assert torch.equal(getattr(card, name).cpu(), getattr(host, name))
    tracer = TraceDisk(dim=dim, device=cuda)
    tracer.set_geometry(pts, nrm, delta)
    flux = np.random.default_rng(4).uniform(0.0, 1.0, len(pts)).astype(
        np.float32)
    flux_dev = torch.from_numpy(flux).to(cuda)
    for k in (1, 2):
        table = (host.neighbors if k == 1 else torch.from_numpy(
            neighborhood.build_neighborhood(
                host.points.numpy(), k * 2.0 * host.disk_radius, 3)[0]))
        want = postprocess.smooth_flux(flux_dev, card.normals,
                                       table.to(cuda)).cpu().numpy()
        np.testing.assert_array_equal(tracer.smooth_flux(flux, k), want)
