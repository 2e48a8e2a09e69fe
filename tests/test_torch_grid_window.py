"""The grid walk's round of W cells (``csrc/grid_search.cuh``) against the
sequential walk, on the CPU.

(a) ``ops/grid_traverse.py:grid_walk_window_ref``, the kernels' round in
    tensor ops on the compact table, equals ``grid_walk_ref`` in (t, lane,
    cells visited, pairs tested) at W = 8, 16 and 32, on a disk cloud, a
    triangle mesh and the 2D disk table, on rays made by hypothesis and
    numpy from a seed: axis-parallel, from outside and inside the box,
    missing it, along shared triangle edges and onto packed flat faces,
    through disk rims, with and without a search bound.
(b) The CUDA source itself: ``grid_search.cuh`` compiled by ``g++`` against
    a warp of 32 host threads whose shuffles and ballots meet at a barrier,
    at its own W, against ``grid_walk_ref`` (and its wasted pairs against
    the window emulation) in float32 and float64.
(c) The compact table's rows are the padded rows' non-negative prefixes.
(d) The wrappers' argument checks: the walk counts, the compact table, the
    permutation.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import viennaray_tpu_torch as vrtt
from viennaray_tpu_torch.geometry import grid_accel
from viennaray_tpu_torch.geometry.disk_geometry import DiskGeometry
from viennaray_tpu_torch.geometry.triangle_geometry import TriangleGeometry
from viennaray_tpu_torch.io import fixtures
from viennaray_tpu_torch.ops import grid_traverse as GT
from viennaray_tpu_torch.ops import permute as P
from viennaray_tpu_torch.ops.bounce import RayState

torch.set_num_threads(1)
T_NEAR = 1e-4
BIG = float(np.float32(3.4e38))
CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                    "viennaray_tpu_torch", "csrc")

_GEOMETRIES = {}


def _geometry(kind):
    """Built once: 3D disks at 0.5 (777), the triangle trench at 0.5
    (1,440), 2D disks at 0.1 (180, a flat table), the 2D line trench at
    0.25 extruded to triangle pairs (a flat triangle table)."""
    if kind not in _GEOMETRIES:
        if kind == "disk3d":
            pts, nrm = fixtures.create_trench_grid_3d(grid_delta=0.5)
            geo = DiskGeometry.build(pts, nrm, 0.5, device="cpu")
        elif kind == "disk2d":
            pts, nrm = fixtures.create_trench_grid_2d(grid_delta=0.1)
            geo = DiskGeometry.build(pts, nrm, 0.1, dim=2, device="cpu")
        elif kind == "ribbon":
            nodes, lines = fixtures.create_trench_line_mesh(0.25)
            geo = TriangleGeometry.from_line_mesh(
                vrtt.LineMesh(nodes=nodes, lines=lines, grid_delta=0.25),
                device="cpu")
        else:
            verts, tris = fixtures.create_trench_mesh_3d(grid_delta=0.5)
            geo = TriangleGeometry.build(verts, tris, 0.5, device="cpu")
        _GEOMETRIES[kind] = geo
    return _GEOMETRIES[kind]


MODES = ("axis", "outside", "inside", "miss", "edge", "rim", "flat_faces")


def _rays(geo, mode, seed, n=192):
    """(org, dir (n, 3) float64, bound (n,) float64) of one kind against
    ``geo``: ``axis`` along a coordinate axis from anywhere in the grid,
    ``outside`` from beyond the box towards a point in it, ``inside`` from a
    point in it, ``miss`` from beyond the box away from it or past it,
    ``edge`` through the midpoints of the primitives' edges (triangles: the
    edges two triangles share; disks: a point of the rim) from their normal's
    side, ``rim`` grazing a disk's rim or a triangle's edge within its plane,
    ``flat_faces`` straight down or sideways onto the packed faces; half of
    them under a search bound."""
    rng = np.random.default_rng(seed)
    g = geo.grid
    wo = g.walk_origin.double().numpy()
    hi = wo + float(g.cell_size) * np.array(g.walk_dims)
    flat = geo.dim == 2
    d = rng.normal(size=(n, 3))
    target = rng.uniform(wo, hi, (n, 3))
    if mode in ("edge", "rim", "flat_faces"):
        pick = rng.integers(0, geo.num_primitives, n)
        if geo.kind == "disk":
            c = geo.points.double().numpy()[pick]
            nrm = geo.normals.double().numpy()[pick]
            r = geo.radii.double().numpy()[pick]
            u = np.cross(nrm, rng.normal(size=(n, 3)))
            u /= np.linalg.norm(u, axis=1, keepdims=True)
            target = c + u * r[:, None] * rng.choice([1.0, 1 - 1e-6, 1 + 1e-6],
                                                     (n, 1))
        else:
            v = geo.vertices.double().numpy()[geo.triangles.numpy()[pick]]
            a, b = rng.integers(0, 3, n), rng.integers(1, 3, n)
            i = np.arange(n)
            target = 0.5 * (v[i, a] + v[i, (a + b) % 3])
            nrm = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
            nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
            u = v[i, (a + b) % 3] - v[i, a]
            u /= np.linalg.norm(u, axis=1, keepdims=True)
        if mode == "edge":
            d = -nrm + 0.3 * rng.normal(size=(n, 3))
        elif mode == "rim":
            d = u + 1e-3 * rng.normal(size=(n, 3))
        else:
            d = np.zeros((n, 3))
            d[np.arange(n), rng.integers(0, 2 if flat else 3, n)] = (
                rng.choice([-1.0, 1.0], n))
    elif mode == "axis":
        d = np.zeros((n, 3))
        d[np.arange(n), rng.integers(0, 2 if flat else 3, n)] = rng.choice(
            [-1.0, 1.0], n)
    if flat:
        target[:, 2] = 0.0
        d[:, 2] = 0.0
        d[np.abs(d).sum(axis=1) == 0, 0] = 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    span = np.linalg.norm(hi - wo)
    if mode == "outside":
        org = target - d * (span + rng.uniform(0, 2, (n, 1)))
    elif mode == "miss":
        org = target + d * (span + rng.uniform(0, 2, (n, 1)))
        side = np.cross(d, rng.normal(size=(n, 3)))
        if flat:
            side = np.stack([-d[:, 1], d[:, 0], np.zeros(n)], axis=1)
        side /= np.linalg.norm(side, axis=1, keepdims=True)
        org[n // 2:] = (target + side * span)[n // 2:]
    elif mode in ("inside", "axis"):
        org = target
    else:
        org = target - d * rng.uniform(0.0, 2.0 * float(g.cell_size), (n, 1))
    bound = np.where(rng.uniform(size=n) < 0.5, BIG,
                     rng.uniform(0.05, 2.0 * span, n))
    return org, d, bound


def _walks(geo, org, d, bound, dtype, cells):
    g = geo.to(dtype)
    o, dd = (torch.from_numpy(x).to(dtype) for x in (org, d))
    b = torch.from_numpy(bound).to(dtype)
    test = GT.TEST[geo.kind]
    seq = GT.grid_walk_ref(o, dd, g.grid, g.prims_soa, test, T_NEAR, b)
    win = GT.grid_walk_window_ref(o, dd, g.grid, g.prims_soa, test, T_NEAR,
                                  b, cells=cells)
    return seq, win


# ---- (a) the round in tensor ops against the sequential walk ---------------------
@pytest.mark.parametrize("kind", ["disk3d", "triangles", "disk2d"])
@pytest.mark.parametrize("cells", [8, 16, 32])
@settings(max_examples=12, deadline=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.function_scoped_fixture])
@given(mode=st.sampled_from(MODES), seed=st.integers(0, 2**31 - 1),
       dtype=st.sampled_from([torch.float32, torch.float64]))
def test_the_round_is_the_sequential_walk(cells, kind, mode, seed, dtype):
    """(t, lane, cells visited, pairs tested) equal; the pairs tested past
    the stopping cell lie within its batch of 32."""
    geo = _geometry(kind)
    seq, win = _walks(geo, *_rays(geo, mode, seed), dtype, cells)
    for name, a, b in zip(("t", "lane", "visited", "tested"), seq, win):
        assert torch.equal(a, b), name
    assert (win[4] >= 0).all() and (win[4] < 32).all()


@pytest.mark.parametrize("cells", [8, 16, 32])
def test_the_round_on_the_flat_triangle_table(cells):
    """The 2D line trench as triangle pairs (a flat table of triangles)."""
    geo = _geometry("ribbon")
    for seed, mode in enumerate(MODES):
        seq, win = _walks(geo, *_rays(geo, mode, seed), torch.float32, cells)
        for a, b in zip(seq, win):
            assert torch.equal(a, b), mode


def test_the_walks_cover_their_cases():
    """The ray kinds reach what they are for: hits and misses, walks longer
    than a round of 8, walks that a bound stops, rays that never enter."""
    geo = _geometry("disk3d")
    org, d, bound = _rays(geo, "outside", 1, n=512)
    seq, _ = _walks(geo, org, d, bound, torch.float32, 8)
    hit = seq[1] >= 0
    assert 0.1 < float(hit.float().mean()) < 0.95
    assert int(seq[2].max()) > 16
    org, d, bound = _rays(geo, "miss", 2, n=512)
    seq, _ = _walks(geo, org, d, bound, torch.float32, 8)
    assert int((seq[2] == 0).sum()) > 100


# ---- (b) the CUDA source on a warp of host threads ---------------------------------
# stand-ins for the CUDA built-ins that csrc/grid_search.cuh and the hit
# tests use: plain float ops (round to nearest; g++ -ffp-contract=off keeps
# them apart, as the _rn intrinsics do), and a warp of 32 threads whose
# shuffles and ballots meet at a barrier
CUDA_HOST_HEADER = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstring>
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
struct dim3 { unsigned x, y, z; };
inline dim3 threadIdx, blockIdx;
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
using std::fabs; using std::floor; using std::fmax; using std::fmin;
using std::min;
inline float fminf(float a, float b) { return std::fmin(a, b); }
inline float fmaxf(float a, float b) { return std::fmax(a, b); }
inline float fabsf(float a) { return std::fabs(a); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline void __syncthreads() {}
inline int __syncthreads_or(int p) { return p; }
struct HostWarp {
  std::barrier<> bar{32};
  unsigned long long slot[32];
};
inline HostWarp* host_warp;
inline thread_local int host_lane;
template <class T> T __shfl_sync(unsigned, T v, int src) {
  unsigned long long u = 0;
  std::memcpy(&u, &v, sizeof(T));
  host_warp->slot[host_lane] = u;
  host_warp->bar.arrive_and_wait();
  const unsigned long long r = host_warp->slot[src & 31];
  host_warp->bar.arrive_and_wait();
  T out;
  std::memcpy(&out, &r, sizeof(T));
  return out;
}
template <class T> T __shfl_up_sync(unsigned m, T v, unsigned o) {
  const int src = host_lane - (int)o;
  const T r = __shfl_sync(m, v, src < 0 ? host_lane : src);
  return src < 0 ? v : r;
}
template <class T> T __shfl_xor_sync(unsigned m, T v, int o) {
  return __shfl_sync(m, v, host_lane ^ o);
}
inline unsigned __ballot_sync(unsigned, int p) {
  host_warp->slot[host_lane] = p ? 1 : 0;
  host_warp->bar.arrive_and_wait();
  unsigned m = 0;
  for (int l = 0; l < 32; ++l) m |= (unsigned)host_warp->slot[l] << l;
  host_warp->bar.arrive_and_wait();
  return m;
}
inline int __any_sync(unsigned m, int p) { return __ballot_sync(m, p) != 0; }
"""

# one warp of 32 host threads walks every ray of the inputs in turn
CUDA_HOST_MAIN = r"""
#include "cuda_runtime.h"
#include "disk_hit.cuh"
#include "grid_search.cuh"
#include "tri_hit.cuh"
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>

template <class T> std::vector<T> load(const char* dir, const char* name) {
  char path[4096];
  snprintf(path, sizeof path, "%s/%s", dir, name);
  FILE* f = fopen(path, "rb");
  if (!f) exit(3);
  fseek(f, 0, SEEK_END);
  const long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<T> v(n / sizeof(T));
  if (fread(v.data(), 1, n, f) != (size_t)n) exit(3);
  fclose(f);
  return v;
}

template <class Kind> int run(const char* dir) {
  using T = typename Kind::Scalar;
  const auto org = load<T>(dir, "org"), dirn = load<T>(dir, "dir"),
             prims = load<T>(dir, "prims"), bound = load<T>(dir, "bound"),
             geo = load<T>(dir, "geo");
  const auto start = load<int>(dir, "start"), lanes = load<int>(dir, "lanes"),
             dims = load<int>(dir, "dims");
  const int n = (int)bound.size();
  const GridWalk<T> g{start.data(), lanes.data(), dims[0], dims[1], dims[2],
                      geo[0], geo[1], geo[2], geo[3]};
  std::vector<T> t_out(n);
  std::vector<int> ints(4 * n);
  HostWarp warp;
  host_warp = &warp;
  int disagree = 0;
  std::vector<std::thread> threads;
  for (int lane = 0; lane < 32; ++lane) {
    threads.emplace_back([&, lane] {
      host_lane = lane;
      for (int r = 0; r < n; ++r) {
        T tmin = bound[r];
        int idx;
        WalkCounts c;
        grid_search_group<Kind, 32>(
            org[3 * r], org[3 * r + 1], org[3 * r + 2], dirn[3 * r],
            dirn[3 * r + 1], dirn[3 * r + 2], prims.data(), dims[3], g,
            geo[4], lane, tmin, idx, c);
        // every thread of the warp returns the same
        const bool same = __shfl_sync(~0u, idx, 0) == idx &&
                          __shfl_sync(~0u, tmin, 0) == tmin &&
                          __shfl_sync(~0u, c.visited, 0) == c.visited;
        if (!same) disagree = 1;
        if (lane == 0) {
          t_out[r] = tmin;
          ints[r] = idx;
          ints[n + r] = c.visited;
          ints[2 * n + r] = c.tested;
          ints[3 * n + r] = c.wasted;
        }
      }
    });
  }
  for (auto& t : threads) t.join();
  char path[4096];
  snprintf(path, sizeof path, "%s/out_t", dir);
  FILE* f = fopen(path, "wb");
  fwrite(t_out.data(), sizeof(T), n, f);
  fclose(f);
  snprintf(path, sizeof path, "%s/out_i", dir);
  f = fopen(path, "wb");
  fwrite(ints.data(), 4, 4 * n, f);
  fclose(f);
  return disagree ? 4 : 0;
}

int main(int argc, char** argv) {
  const char* kind = argv[1];
  if (!strcmp(kind, "disk")) return run<DiskKind>(argv[2]);
  if (!strcmp(kind, "triangle")) return run<TriKind>(argv[2]);
  if (!strcmp(kind, "disk_f64")) return run<DiskKindF64>(argv[2]);
  return run<TriKindF64>(argv[2]);
}
"""


@pytest.fixture(scope="module")
def host_walk(tmp_path_factory):
    """The walk of ``csrc/grid_search.cuh`` built for the host: a program
    that walks the rays of a directory's files on a warp of threads."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the CUDA source cannot be built here")
    work = tmp_path_factory.mktemp("grid_walk_host")
    (work / "cuda_runtime.h").write_text(CUDA_HOST_HEADER)
    (work / "main.cpp").write_text(CUDA_HOST_MAIN)
    exe = work / "walk"
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-w", "-pthread",
         "-I", str(work), "-I", CSRC, str(work / "main.cpp"), "-o", str(exe)],
        check=True, capture_output=True, text=True, timeout=300)
    return exe


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["disk3d", "triangles", "disk2d", "ribbon"])
def test_the_cuda_walk_on_host_threads(host_walk, tmp_path, kind, dtype):
    """``grid_search_group`` as the kernels compile it, on a warp of host
    threads: every thread returns the same, and (t, lane, visited, tested)
    are the sequential walk's bit for bit; the wasted pairs the window
    emulation's at the source's own W."""
    geo = _geometry(kind)
    g = geo.to(dtype)
    org, d, bound = (np.concatenate(x) for x in zip(*(
        _rays(geo, mode, seed, n=48) for seed, mode in enumerate(MODES))))
    npdt = np.float32 if dtype == torch.float32 else np.float64
    files = {
        "org": org.astype(npdt), "dir": d.astype(npdt),
        "prims": g.prims_soa.numpy(), "bound": bound.astype(npdt),
        "geo": np.array([*g.grid.walk_origin.tolist(),
                         float(g.grid.cell_size), T_NEAR], npdt),
        "start": g.grid.cell_start.numpy(), "lanes": g.grid.cell_lanes.numpy(),
        "dims": np.array([*g.grid.walk_dims, g.prims_soa.shape[1]], np.int32),
    }
    for name, x in files.items():
        np.ascontiguousarray(x).tofile(tmp_path / name)
    exe_kind = ("disk" if geo.kind == "disk" else "triangle") + (
        "_f64" if dtype == torch.float64 else "")
    run = subprocess.run([str(host_walk), exe_kind, str(tmp_path)],
                         capture_output=True, timeout=600)
    assert run.returncode == 0, run
    n = len(bound)
    t = torch.from_numpy(np.fromfile(tmp_path / "out_t", npdt))
    lane, visited, tested, wasted = (
        torch.from_numpy(x).long()
        for x in np.fromfile(tmp_path / "out_i", np.int32).reshape(4, n))
    with open(os.path.join(CSRC, "grid_search.cuh")) as f:
        cells = int(f.read().split("constexpr int kWalkCells = ")[1]
                    .split(";")[0])
    seq, win = _walks(geo, org.astype(npdt).astype(np.float64),
                      d.astype(npdt).astype(np.float64),
                      bound.astype(npdt).astype(np.float64), dtype, cells)
    assert int((seq[1] >= 0).sum()) > n // 10
    for name, a, b in zip(("t", "lane", "visited", "tested"), (t, lane,
                                                               visited,
                                                               tested), seq):
        assert torch.equal(a, b), name
    assert torch.equal(wasted, win[4])


# ---- (c) the compact table ----------------------------------------------------------
def _padded(geo):
    """The walk's table of ``geo`` padded, (C', K') int32, as
    ``grid_accel.walk_lanes`` builds it before ``GridData`` compacts it."""
    g = geo.grid
    if isinstance(geo, DiskGeometry):
        boxes = grid_accel.disk_boxes(geo.points.numpy(), geo.radii.numpy())
    else:
        boxes = grid_accel.triangle_boxes(geo.vertices.numpy(),
                                          geo.triangles.numpy())
    host = grid_accel.UniformGrid(cells=g.cells, counts=None,
                                  origin=g.origin,
                                  cell_size=np.float32(g.cell_size),
                                  dims=g.dims)
    lanes, walk_origin, walk_dims = grid_accel.walk_lanes(
        host, *boxes, geo.soa_inv_perm, geo.dim, "cpu")
    assert walk_dims == g.walk_dims
    assert torch.equal(torch.from_numpy(walk_origin), g.walk_origin)
    return lanes


@pytest.mark.parametrize("kind", ["disk3d", "triangles", "disk2d", "ribbon"])
def test_compact_rows_are_the_padded_prefixes(kind):
    """Cell c's entries cell_lanes[cell_start[c]:cell_start[c + 1]] are row
    c of the padded table up to its first -1, in slot order, and the row
    holds no lane after it; int32, contiguous."""
    geo = _geometry(kind)
    grid = geo.grid
    lanes, start, entries = _padded(geo), grid.cell_start, grid.cell_lanes
    assert start.dtype == entries.dtype == torch.int32
    assert start.is_contiguous() and entries.is_contiguous()
    assert start.shape == (lanes.shape[0] + 1,) and int(start[0]) == 0
    assert int(start[-1]) == entries.numel()
    assert grid.walk_slots == lanes.shape[1]
    counts = (lanes >= 0).sum(dim=1)
    assert torch.equal((start[1:] - start[:-1]).long(), counts)
    slots = torch.arange(lanes.shape[1])
    assert torch.equal(lanes >= 0, slots[None, :] < counts[:, None])
    for c in range(lanes.shape[0]):
        row = entries[int(start[c]):int(start[c + 1])]
        assert torch.equal(row, lanes[c, :row.numel()])
    # the plain walk's rows are the padded ones
    lin = torch.arange(lanes.shape[0])
    assert torch.equal(GT._rows(GT._table(grid), lin), lanes.long())
    assert grid.device_bytes == 4 * (start.numel() + entries.numel())
    assert grid.padded_bytes == 4 * lanes.numel()


def test_compact_table_of_a_small_table():
    lanes = torch.tensor([[3, 1, -1], [-1, -1, -1], [0, 2, 4], [5, -1, -1]],
                         dtype=torch.int32)
    start, entries = grid_accel.compact_table(lanes)
    assert start.tolist() == [0, 2, 2, 5, 6]
    assert entries.tolist() == [3, 1, 0, 2, 4, 5]
    empty = torch.full((3, 1), -1, dtype=torch.int32)
    start, entries = grid_accel.compact_table(empty)
    assert start.tolist() == [0, 0, 0, 0] and entries.numel() == 0


# ---- (d) the wrappers' argument checks ----------------------------------------------
def test_the_walk_counts_are_the_kernels_alone():
    """The grid wrappers take walk counts only on the card, as (3,) int64;
    a grid whose compact table is missing a start is refused."""
    geo = _geometry("disk3d")
    org = torch.zeros(4, 3)
    dirn = torch.tensor([[0.0, 0.0, -1.0]]).repeat(4, 1)
    args = (org, dirn, geo.prims_soa, geo.soa_perm, geo.grid)
    with pytest.raises(ValueError, match="CUDA only"):
        GT.disk_grid_nearest_hit(*args, walk_counts=torch.zeros(
            3, dtype=torch.int64))
    with pytest.raises(ValueError, match="CUDA only"):
        tri = _geometry("triangles")
        GT.triangle_grid_nearest_hit(
            org, dirn, tri.prims_soa, tri.soa_perm, tri.grid,
            walk_counts=torch.zeros(3, dtype=torch.int64))
    bad = geo.grid.__class__(**{**geo.grid.__dict__,
                                "cell_start": geo.grid.cell_start[:-1]})
    with pytest.raises(ValueError, match="compact table"):
        GT.disk_grid_nearest_hit(org, dirn, geo.prims_soa, geo.soa_perm, bad)
    wrong = geo.grid.__class__(**{**geo.grid.__dict__,
                                  "cell_lanes": geo.grid.cell_lanes.long()})
    with pytest.raises(TypeError, match="grid cell_lanes must be"):
        GT.disk_grid_nearest_hit(org, dirn, geo.prims_soa, geo.soa_perm,
                                 wrong)


def _state(n, dtype, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.normal(size=s)).to(dtype)
    return RayState(f(n, 3), f(n, 3), f(n), f(n),
                    torch.from_numpy(rng.uniform(size=n) < 0.5),
                    torch.from_numpy(rng.uniform(size=n) < 0.5),
                    torch.from_numpy(rng.integers(0, 9, n)).to(torch.int32),
                    torch.from_numpy(rng.integers(0, 9, n)).to(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_permutation_refuses_what_its_kernel_does_not_take(dtype):
    """By name, in either type: a take of another type or rank, or longer
    than the state; a state array of the wrong shape or type; an aux of
    another type, rank or length, or not contiguous."""
    n = 40
    state = _state(n, dtype, seed=3)
    take = torch.arange(n - 1, -1, -1)
    with pytest.raises(TypeError, match="take must be"):
        P.permute_state(take[:, None], state)
    with pytest.raises(TypeError, match="take must be"):
        P.permute_state(take.to(torch.float32), state)
    with pytest.raises(ValueError, match=f"take has {n + 1} lanes"):
        P.permute_state(torch.arange(n + 1), state)
    with pytest.raises(ValueError, match="org must be"):
        P.permute_state(take, state._replace(org=state.org[:, :2]
                                             .contiguous()))
    with pytest.raises(ValueError, match="alive must be"):
        P.permute_state(take, state._replace(alive=state.alive.to(torch.uint8)))
    with pytest.raises(ValueError, match="weight must be"):
        P.permute_state(take, state._replace(weight=state.weight[:-1]))
    other = torch.float64 if dtype == torch.float32 else torch.float32
    with pytest.raises(ValueError, match="aux must be"):
        P.permute_state(take, state, torch.zeros(n, 2, dtype=other))
    with pytest.raises(ValueError, match="aux must be"):
        P.permute_state(take, state, torch.zeros(n, dtype=dtype))
    with pytest.raises(ValueError, match="aux must be"):
        P.permute_state(take, state, torch.zeros(n + 1, 2, dtype=dtype))
    with pytest.raises(ValueError, match="aux must be contiguous"):
        P.permute_state(take, state, torch.zeros(3, n, dtype=dtype).t())
    # what it takes: any aux width, an empty take, a shorter take
    for width in (1, 2, 3, 7):
        aux = torch.arange(n * width, dtype=dtype).reshape(n, width)
        got, got_aux = P.permute_state(take[:11], state, aux)
        assert torch.equal(got_aux, aux[take[:11]])
        assert all(torch.equal(x, y[take[:11]]) for x, y in zip(got, state))
    got, got_aux = P.permute_state(take[:0], state)
    assert got.org.shape == (0, 3) and got_aux is None
