"""The uniform grid (the grid DDA) of the port against the JAX package's, at
small sizes on the CPU.

(a) The host build: the port's ``grid_accel`` tables equal the JAX
    package's bit for bit, by the compiled helper and by numpy, with the
    ``max_cells`` widening and the flat 2D grid.
(b) The walk against the JAX package's DDA on the same tables and rays:
    hit flags equal, t within 3e-5 relative (the JAX package's disk test
    divides and multiplies in another order, its triangle test multiplies
    by a reciprocal; measured below 1e-6), and the same primitive except at
    ties: where the two pick different primitives, the JAX package's
    primitive must hit at the port's t within the same 3e-5 under the
    port's exact test (overlapping disks of one flat face; triangles that
    share an edge). The ties are counted.
(c) The walk against the chunk search (both plain versions), bit for bit
    in (t, prim, hit), float32 and float64, on hypothesis-made rays through
    cell corners and edges, along the axes, from inside and outside the
    grid.
(d) ``trace_batch`` with ``grid_min_prims=0`` on a geometry with its grid
    against the same geometry without one: flux and counters bit for bit,
    on the unfused body (disks, triangles, 2D disks; float32 and float64)
    and the fused body's plain version; the float32 digests of
    ``tests/torch_parent_f32_digests.json`` with the grid walked.
(e) The public surface: ``TraceConfig.grid_min_prims``, the geometries'
    ``grid``, ``build(accel=)``, ``from_reference_arrays(grid=)``, the path
    rule.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import viennaray_tpu as vrt
from viennaray_tpu.geometry import grid_accel as ref_grid
from viennaray_tpu.io import fixtures as ref_fixtures
from viennaray_tpu.ops import grid_traverse as ref_traverse

import viennaray_tpu_torch as vrtt
from viennaray_tpu_torch.config import disk_factor
from viennaray_tpu_torch.geometry import grid_accel
from viennaray_tpu_torch.geometry.disk_geometry import DiskGeometry
from viennaray_tpu_torch.geometry.line_geometry import LineGeometry
from viennaray_tpu_torch.geometry.triangle_geometry import TriangleGeometry
from viennaray_tpu_torch.io import fixtures
from viennaray_tpu_torch.ops import bounce as B
from viennaray_tpu_torch.ops import grid_traverse as GT
from viennaray_tpu_torch.ops import nearest_hit as NH
from viennaray_tpu_torch.physics.source import RandomSource
from viennaray_tpu_torch.rng import GeneratorRNG
from viennaray_tpu_torch.trace import kernel as TK
from viennaray_tpu_torch.utils import native, telemetry

from torch_port_helpers import (
    F32_DIGEST_TRACES,
    f32_digest,
    reference_arrays,
    reference_triangle_arrays,
)

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
T_NEAR = 1e-4
RTOL = 3e-5


# ---- (a) the host build --------------------------------------------------------
def _disk_inputs(dim, grid_delta):
    if dim == 2:
        pts, nrm = fixtures.create_trench_grid_2d(grid_delta=grid_delta)
    else:
        pts, nrm = fixtures.create_trench_grid_3d(grid_delta=grid_delta)
    pts = np.asarray(pts, np.float32).copy()
    if dim == 2:
        pts[:, 2] = 0.0
    radii = np.full(len(pts), grid_delta * disk_factor(dim), np.float32)
    return pts, np.asarray(nrm, np.float32), radii


GRID_CASES = {
    "disk2d_0.1": lambda m: m.build_disk_grid(*_disk_inputs(2, 0.1), dim=2),
    "disk3d_0.5": lambda m: m.build_disk_grid(*_disk_inputs(3, 0.5)),
    "disk3d_0.25": lambda m: m.build_disk_grid(*_disk_inputs(3, 0.25)),
    "triangles_0.5": lambda m: m.build_triangle_grid(
        *fixtures.create_trench_mesh_3d(grid_delta=0.5)),
    # 600 cells at most: the cell of 0.1 widens by 1.5x until they fit
    "widened": lambda m: m.build_grid(
        *_boxes_and_bounds(), 0.1, max_cells=600),
}


def _boxes_and_bounds():
    pts, _, radii = _disk_inputs(3, 0.5)
    lo, hi = grid_accel.disk_boxes(pts, radii)
    return lo.min(axis=0), hi.max(axis=0), lo, hi


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_grid_tables_equal_the_reference(case, path, monkeypatch):
    """cells, counts, origin, cell size and dims of the port's build equal
    the JAX package's, by the compiled helper and by numpy."""
    want = GRID_CASES[case](ref_grid)
    if path == "numpy":
        monkeypatch.setattr(native, "build_grid_native",
                            lambda *a, **k: None)
    else:
        assert native.load() is not None
    got = GRID_CASES[case](grid_accel)
    np.testing.assert_array_equal(got.cells, want.cells)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.origin.dtype == np.float32 and got.cell_size.dtype == np.float32
    np.testing.assert_array_equal(got.origin, want.origin)
    assert got.cell_size == want.cell_size
    assert got.dims == want.dims
    if case == "widened":
        assert got.cell_size > np.float32(0.1 * 1.5)
        assert np.prod(got.dims) <= 600
    if case == "disk2d_0.1":
        assert got.dims[2] == 1


def test_walk_table_holds_every_box_widened():
    """The walk's table: one more cell on each side (none along z in 2D),
    the same cell size, every primitive in every cell its box widened by
    ``walk_margin`` overlaps, and so in every cell of the JAX package's
    table that held it, one cell further along each axis."""
    for dim in (2, 3):
        pts, nrm, radii = _disk_inputs(dim, 0.5 if dim == 3 else 0.1)
        grid = grid_accel.build_disk_grid(pts, nrm, radii, dim=dim)
        lo, hi = grid_accel.disk_boxes(pts, radii)
        cells, origin, dims = grid_accel.walk_table(grid, lo, hi, dim)
        pad = np.array([1, 1, 1 if dim == 3 else 0])
        assert dims == tuple(np.array(grid.dims) + 2 * pad)
        np.testing.assert_array_equal(
            origin, (grid.origin - grid.cell_size * pad).astype(np.float32))
        eta = grid_accel.walk_margin(origin, grid.cell_size, dims)
        assert 0 < eta < grid.cell_size / 64
        want = grid_accel.insert_prims_numpy(
            lo - eta, hi + eta, origin.astype(np.float64),
            float(grid.cell_size), dims, dim)[0]
        np.testing.assert_array_equal(cells, want)
        # every (cell, prim) of the JAX table, moved by the padding
        old = np.argwhere(grid.cells >= 0)
        c = np.stack(np.unravel_index(old[:, 0], grid.dims), 1) + pad
        lin = np.ravel_multi_index(c.T, dims)
        prim = grid.cells[old[:, 0], old[:, 1]]
        member = (cells[lin] == prim[:, None]).any(axis=1)
        assert member.all()


# ---- geometries of both packages on one set of tables --------------------------
def _grid_arrays(ref_geo):
    g = ref_geo.grid
    return dict(cells=np.asarray(g.cells), origin=np.asarray(g.origin),
                cell_size=np.asarray(g.cell_size), dims=g.dims)


def _disk_pair(dim, grid_delta):
    if dim == 2:
        pts, nrm = ref_fixtures.create_trench_grid_2d(grid_delta=grid_delta)
    else:
        pts, nrm = ref_fixtures.create_trench_grid_3d(grid_delta=grid_delta)
    ref_geo = vrt.DiskGeometry.build(pts, nrm, grid_delta, dim=dim)
    geo = DiskGeometry.from_reference_arrays(
        reference_arrays(ref_geo), dim=dim, grid_delta=grid_delta,
        disk_radius=ref_geo.disk_radius, device="cpu",
        grid=_grid_arrays(ref_geo))
    return ref_geo, geo


def _triangle_pair(grid_delta):
    verts, tris = ref_fixtures.create_trench_mesh_3d(grid_delta=grid_delta)
    ref_geo = vrt.TriangleGeometry.build(verts, tris, grid_delta, dim=3)
    geo = TriangleGeometry.from_reference_arrays(
        reference_triangle_arrays(ref_geo), dim=3, grid_delta=grid_delta,
        device="cpu", grid=_grid_arrays(ref_geo))
    return ref_geo, geo


def _rays(bbox, n, dim, seed, pad=0.5):
    """numpy-seeded rays: origins in the box widened by ``pad``, directions
    all over the sphere (in the plane z = 0 in 2D)."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(bbox, np.float64)
    org = rng.uniform(lo - pad, hi + pad, (n, 3))
    d = rng.normal(size=(n, 3))
    if dim == 2:
        org[:, 2] = 0.0
        d[:, 2] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org.astype(np.float32), d.astype(np.float32)


# ---- (b) against the JAX package's DDA ------------------------------------------
@pytest.mark.parametrize("case", ["disk3d", "disk2d", "triangles"])
def test_walk_agrees_with_the_reference_dda(case):
    if case == "triangles":
        ref_geo, geo = _triangle_pair(0.5)
        dim = 3
        ref_fn = jax.jit(lambda o, d: ref_traverse.triangle_grid_nearest_hit(
            o, d, ref_geo.vertices, ref_geo.triangles, ref_geo.grid, T_NEAR))
        port_fn = GT.triangle_grid_nearest_hit
        test = NH.triangle_test
    else:
        dim = 2 if case == "disk2d" else 3
        ref_geo, geo = _disk_pair(dim, 0.1 if dim == 2 else 0.5)
        ref_fn = jax.jit(lambda o, d: ref_traverse.disk_grid_nearest_hit(
            o, d, ref_geo.points, ref_geo.normals, ref_geo.radii,
            ref_geo.grid, T_NEAR))
        port_fn = GT.disk_grid_nearest_hit
        test = NH.disk_test
    org, d = _rays(geo.bbox.numpy(), 4096, dim, seed=3)
    t_r, p_r, h_r = (np.asarray(x) for x in ref_fn(org, d))
    o, dd = torch.from_numpy(org), torch.from_numpy(d)
    t, p, h = port_fn(o, dd, geo.prims_soa, geo.soa_perm, geo.grid, T_NEAR)
    np.testing.assert_array_equal(h.numpy(), h_r)
    hit = h_r
    assert hit.sum() > 1000
    np.testing.assert_allclose(t.numpy()[hit], t_r[hit], rtol=RTOL)
    # a different primitive only at a tie: the reference's primitive hits
    # at the port's t under the port's own test
    differ = np.nonzero(hit & (p.numpy() != p_r))[0]
    lanes = geo.soa_inv_perm[torch.from_numpy(p_r[differ]).long()].long()
    cols = geo.prims_soa[:, lanes]
    t_o, valid = test(tuple(o[differ, i] for i in range(3)),
                      tuple(dd[differ, i] for i in range(3)),
                      tuple(cols[r] for r in range(cols.shape[0])), T_NEAR)
    assert valid.all()
    np.testing.assert_allclose(t_o.numpy(), t.numpy()[differ], rtol=RTOL)
    print(f"{case}: {len(differ)} ties of {int(hit.sum())} hits")


# ---- (c) against the chunk search, bit for bit ------------------------------------
_GEOMETRIES = {}


def _geometry(kind):
    """Built once: 3D disks at 0.5 (777), 2D disks at 0.1 (180), the
    triangle trench at 0.5 (1,440), the 2D line trench at 0.25 extruded to
    triangle pairs (``ribbon``, a flat grid)."""
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


def _walk_rays(geo, mode, seed, n=256):
    """Rays of one kind against ``geo``'s walk grid: ``corner`` and ``edge``
    through points on (or within 1e-6 of) cell corners and edges, ``axis``
    along a coordinate axis from a cell face, ``outside`` from beyond the
    grid towards it, ``inside`` from anywhere in it."""
    g = geo.grid
    dim = geo.dim
    rng = np.random.default_rng(seed)
    wo = g.walk_origin.double().numpy()
    cs = float(g.cell_size)
    dims = np.array(g.walk_dims)
    hi = wo + cs * dims
    cell = rng.integers(1, np.maximum(dims - 1, 2), (n, 3)).astype(np.float64)
    d = rng.normal(size=(n, 3))
    jitter = rng.choice([0.0, 1e-6, -1e-6, 1e-7], (n, 3))
    if mode == "corner":
        target = wo + cs * (cell + jitter)
    elif mode == "edge":
        target = wo + cs * (cell + jitter)
        free = rng.integers(0, 3, n)
        target[np.arange(n), free] += cs * rng.uniform(0, 1, n)
    elif mode == "axis":
        target = wo + cs * (cell + rng.uniform(0, 1, (n, 3)))
        axis = rng.integers(0, dim, n)
        d = np.zeros((n, 3))
        d[np.arange(n), axis] = rng.choice([-1.0, 1.0], n)
        target[np.arange(n), axis] = (
            wo[axis] + cs * (cell[np.arange(n), axis] + jitter[:, 0]))
    else:
        target = rng.uniform(wo, hi, (n, 3))
    if dim == 2:
        target[:, 2] = 0.0
        d[:, 2] = 0.0
        if mode == "axis":
            d[:, 1] = np.where(d[:, 0] == 0, rng.choice([-1.0, 1.0], n), 0.0)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if mode == "outside":
        org = target - d * (np.linalg.norm(hi - wo) + rng.uniform(0, 2, (n, 1)))
    elif mode == "inside":
        org = target
    else:
        org = target - d * rng.uniform(0.0, 2.0 * cs, (n, 1))
    return org.astype(np.float32), d.astype(np.float32)


def _chunk_and_walk(geo, org, d, dtype):
    g = geo.to(dtype)
    o = torch.from_numpy(org).to(dtype)
    dd = torch.from_numpy(d).to(dtype)
    ref = (NH.disk_nearest_hit_ref if geo.kind == "disk"
           else NH.triangle_nearest_hit_ref)
    want = ref(o, dd, g.prims_soa, g.soa_perm, t_near=T_NEAR)
    got = GT.SEARCH_REF[geo.kind](o, dd, g.prims_soa, g.soa_perm, g.grid,
                                  T_NEAR)
    return want, got


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(kind=st.sampled_from(["disk3d", "disk2d", "triangles", "ribbon"]),
       mode=st.sampled_from(["corner", "edge", "axis", "outside", "inside"]),
       seed=st.integers(0, 2**31 - 1),
       dtype=st.sampled_from([torch.float32, torch.float64]))
def test_walk_equals_the_chunk_search(kind, mode, seed, dtype):
    geo = _geometry(kind)
    org, d = _walk_rays(geo, mode, seed)
    want, got = _chunk_and_walk(geo, org, d, dtype)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["disk3d", "disk2d", "triangles", "ribbon"])
def test_walk_equals_the_chunk_search_on_many_rays(kind, dtype):
    """4,096 rays from the box widened by half a unit, directions all over
    the sphere; at least a third of them hit."""
    geo = _geometry(kind)
    org, d = _rays(geo.bbox.numpy(), 4096, geo.dim, seed=17)
    want, got = _chunk_and_walk(geo, org, d, dtype)
    assert want[2].float().mean() > 0.33
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _rotated(vertices, seed=0):
    """The vertices turned by a seeded rotation: no face in a plane x, y or
    z = const."""
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    return np.asarray(vertices, np.float64) @ q.T


def _grazing_rays(vertices, triangles, faces, n, seed):
    """Rays that meet a point inside one of ``faces`` (triangle ids) nearly
    in its plane, with |det| = |d . (e1 x e2)| log-uniform from 1e-9 to
    1e-4 (tri_hit accepts |det| from 1e-9 on), from 0.01 to 3 units
    before it."""
    rng = np.random.default_rng(seed)
    v = np.asarray(vertices, np.float64)
    tri = np.asarray(triangles, np.int64)[rng.choice(faces, n)]
    a, b, c = v[tri[:, 0]], v[tri[:, 1]], v[tri[:, 2]]
    w = rng.dirichlet([1.0, 1.0, 1.0], n)
    target = w[:, :1] * a + w[:, 1:2] * b + w[:, 2:] * c
    cross = np.cross(b - a, c - a)
    area2 = np.linalg.norm(cross, axis=1, keepdims=True)
    nrm = cross / area2
    t1 = (b - a) / np.linalg.norm(b - a, axis=1, keepdims=True)
    t2 = np.cross(nrm, t1)
    ang = rng.uniform(0.0, 2.0 * np.pi, (n, 1))
    dn = (10.0 ** rng.uniform(-9.0, -4.0, (n, 1)) / area2
          * rng.choice([-1.0, 1.0], (n, 1)))
    d = (np.cos(ang) * t1 + np.sin(ang) * t2) * np.sqrt(1.0 - dn**2) + dn * nrm
    org = target - d * rng.uniform(0.01, 3.0, (n, 1))
    return org.astype(np.float32), d.astype(np.float32)


def _trench_faces(verts, tris, axis):
    """The trench mesh's triangles whose normal lies along ``axis``: z the
    floor and the top, x the walls."""
    v = np.asarray(verts, np.float64)
    t = np.asarray(tris, np.int64)
    cross = np.cross(v[t[:, 1]] - v[t[:, 0]], v[t[:, 2]] - v[t[:, 0]])
    return np.nonzero(np.abs(cross).argmax(axis=1) == axis)[0]


@pytest.mark.parametrize("axis", [0, 2], ids=["walls", "floor_and_top"])
def test_walk_equals_the_chunk_search_on_grazing_rays(axis):
    """Rays nearly in the plane of the trench's floor or walls, where the
    determinant of the triangle test is as small as the test accepts: the
    walk is the chunk search bit for bit in float32, since each face lies
    in a plane x, y or z = const (``grid_accel.walk_margin``)."""
    verts, tris = fixtures.create_trench_mesh_3d(grid_delta=0.5)
    geo = _geometry("triangles")
    assert geo.grid.exact
    faces = _trench_faces(verts, tris, axis)
    assert len(faces) >= 640
    org, d = _grazing_rays(verts, tris, faces, 4096, seed=21 + axis)
    want, got = _chunk_and_walk(geo, org, d, torch.float32)
    assert want[2].float().mean() > 0.5
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_a_tilted_mesh_is_not_walked():
    """The trench turned out of the planes x, y, z = const: its grid is
    built but not exact, so the trace keeps the chunk search; on grazing
    rays its walk does find other hits than the chunk search (the reason
    for the rule)."""
    verts, tris = fixtures.create_trench_mesh_3d(grid_delta=0.5)
    turned = _rotated(verts).astype(np.float32)
    assert grid_accel.triangles_covered(verts, tris)
    assert not grid_accel.triangles_covered(turned, tris)
    geo = TriangleGeometry.build(turned, tris, 0.5, device="cpu")
    assert geo.grid is not None and not geo.grid.exact
    assert TK.grid_for(geo, vrtt.TraceConfig(grid_min_prims=0)) is None
    org, d = _grazing_rays(turned, tris, np.arange(len(tris)), 4096, seed=2)
    want, got = _chunk_and_walk(geo, org, d, torch.float32)
    differ = ~(got[0].eq(want[0]) & got[1].eq(want[1]) & got[2].eq(want[2]))
    assert int(differ.sum()) > 0


def test_triangles_covered():
    """Every triangle mesh of the repo's fixtures lies in the planes x, y,
    z = const with shape factors 1; a sliver and a degenerate triangle do
    not pass, nor does a triangle out of those planes."""
    for gd in (0.5, 0.25):
        assert grid_accel.triangles_covered(
            *fixtures.create_trench_mesh_3d(grid_delta=gd))
    ribbon = _geometry("ribbon")
    assert ribbon.grid.exact
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0], [1, 0.9, 0],
                  [2, 0, 0], [0, 0, 1]], np.float32)
    assert grid_accel.triangles_covered(v, [[0, 1, 2], [1, 3, 2]])
    assert not grid_accel.triangles_covered(v, [[0, 3, 4]])  # sliver
    assert not grid_accel.triangles_covered(v, [[0, 1, 5]])  # a line
    assert not grid_accel.triangles_covered(v, [[1, 2, 6]])  # tilted
    assert all(_geometry(k).grid.exact for k in ("disk3d", "disk2d"))


def test_walk_under_a_bound_is_the_chunk_search_under_it():
    """Kernel 4 searches below a bound: the walk's (t, lane) under random
    bounds (some below every hit, some above ``BIG``, as the kernel's can
    be) is the chunk search's lexicographic minimum below the same bound."""
    geo = _geometry("disk3d")
    org, d = _rays(geo.bbox.numpy(), 2048, 3, seed=5)
    rng = np.random.default_rng(6)
    bound = np.where(rng.random(2048) < 0.5, rng.uniform(0, 6, 2048),
                     np.float32(3.4e38) * 1.0001).astype(np.float32)
    o, dd, b = map(torch.from_numpy, (org, d, bound))
    t_all, valid = NH.disk_test(
        tuple(o[:, i:i + 1] for i in range(3)),
        tuple(dd[:, i:i + 1] for i in range(3)),
        tuple(geo.prims_soa[r][None, :] for r in range(8)), T_NEAR)
    tt = torch.where(valid & (t_all < b[:, None]), t_all,
                     torch.tensor(float("inf")))
    t_want = torch.minimum(tt.amin(dim=1), b)
    lanes = torch.arange(tt.shape[1])[None, :]
    lane_want = torch.where((tt == t_want[:, None]), lanes,
                            tt.shape[1]).amin(dim=1)
    lane_want = torch.where(lane_want == tt.shape[1], -1, lane_want)
    t, lane, visited, tested = GT.grid_walk_ref(
        o, dd, geo.grid, geo.prims_soa, NH.disk_test, T_NEAR, bound=b)
    assert torch.equal(t, t_want)
    assert torch.equal(lane, lane_want)
    assert (lane >= 0).sum() > 300 and (lane < 0).sum() > 300
    assert (tested <= visited * geo.grid.walk_slots).all()


# ---- (d) traces with the grid and without ------------------------------------------
def _trace(kind, grid, fused, dtype):
    """One mega-batch of 2,048 rays (batch 1, seed 3) on the CPU with
    ``grid_min_prims=0``; the geometry with its grid or without."""
    geo = _geometry(kind)
    if not grid:
        geo = geo.replace(grid=None)
    geo = geo.to(dtype)
    dim = geo.dim
    face = vrtt.TraceDirection.POS_Z if dim == 3 else vrtt.TraceDirection.POS_Y
    config = vrtt.TraceConfig(
        dim=dim, source_direction=face,
        boundary_conditions=(vrtt.BoundaryCondition.PERIODIC,) * 3,
        ray_batch_size=2048, rng_seed=3, use_random_seed=False,
        grid_min_prims=0)
    source = RandomSource.default(geo, config).to(dtype)
    rng = GeneratorRNG(3, "cpu", dtype=dtype)
    rng.begin_batch(1)
    idx = torch.arange(2048, 4096)
    return TK.trace_batch(geo, source, vrtt.DiffuseParticle(0.2, "flux"),
                          source.bbox, rng, 1, idx, idx < 4000, config,
                          fused=fused)


@pytest.mark.parametrize("fused,dtype", [
    (False, torch.float32), (False, torch.float64), (True, torch.float32)])
@pytest.mark.parametrize("kind", ["disk3d", "disk2d", "triangles", "ribbon"])
def test_trace_with_the_grid_is_the_trace_without(kind, fused, dtype):
    flux_g, cnt_g = _trace(kind, True, fused, dtype)
    flux_c, cnt_c = _trace(kind, False, fused, dtype)
    assert cnt_g.geometry_hits > 500
    assert torch.equal(flux_g, flux_c)
    assert cnt_g == cnt_c


def test_sharded_trace_walks_the_grid():
    """The sharded trace hands the geometry's grid through
    (``with_deposit_tables``): 2 shards on the CPU with ``grid_min_prims=0``,
    with the grid and without, bit for bit."""
    from viennaray_tpu_torch.parallel import mesh as port_mesh

    geo = _geometry("disk3d")
    config = vrtt.TraceConfig(
        dim=3, rng_seed=5, use_random_seed=False, ray_batch_size=2048,
        boundary_conditions=(vrtt.BoundaryCondition.PERIODIC,) * 3,
        grid_min_prims=0)
    source = RandomSource.default(geo, config)
    runs = [port_mesh.trace_sharded(
        g, source, vrtt.DiffuseParticle(0.2, "flux"), source.bbox, config,
        GeneratorRNG(6, "cpu"), 4000, port_mesh.make_ray_mesh(["cpu"] * 2))
        for g in (geo, geo.replace(grid=None))]
    assert torch.equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    assert runs[0][0].sum() > 0


@pytest.mark.parametrize("name", F32_DIGEST_TRACES)
def test_float32_digest_with_the_grid_walked(name):
    """The float32 traces of ``test_torch_f64.py`` keep their parent's
    digests when the grid is walked (``grid_min_prims=0``); lines have no
    grid and trace as before."""
    with open(os.path.join(HERE, "torch_parent_f32_digests.json")) as f:
        want = json.load(f)[name]
    assert f32_digest(name, grid_min_prims=0) == want


# ---- (e) the public surface and the path rule --------------------------------------
def test_public_surface():
    assert vrtt.TraceConfig().grid_min_prims == 8192
    assert vrt.TraceConfig().grid_min_prims == 8192
    pts, nrm = fixtures.create_trench_grid_3d(grid_delta=1.0)
    geo = DiskGeometry.build(pts, nrm, 1.0, device="cpu")
    assert isinstance(geo.grid, grid_accel.GridData)
    assert DiskGeometry.build(pts, nrm, 1.0, device="cpu",
                              accel=False).grid is None
    g64 = geo.to(torch.float64)
    assert g64.grid.walk_origin.dtype == torch.float64
    assert g64.grid.cell_size.dtype == torch.float64
    # the JAX package's table stays on the host
    assert g64.grid.cells is geo.grid.cells
    assert isinstance(geo.grid.cells, np.ndarray)
    assert geo.grid.origin.dtype == np.float32
    # the walk's table, held compact, is shared
    assert g64.grid.cell_start is geo.grid.cell_start
    assert g64.grid.cell_lanes is geo.grid.cell_lanes
    assert geo.grid.device_bytes == 4 * (
        geo.grid.cell_start.numel() + geo.grid.cell_lanes.numel())
    assert geo.with_neighbor_pack().grid is geo.grid
    assert geo.with_window_list().grid is geo.grid
    assert TK.with_deposit_tables(
        geo, vrtt.TraceConfig(flux_model="window")).grid is geo.grid
    # the walk's lanes are the sorted lanes of the table's ids
    g = geo.grid
    assert g.cell_lanes.dtype == torch.int32 and g.cells.dtype == np.int32
    ids = torch.from_numpy(grid_accel.walk_table(
        grid_accel.build_disk_grid(geo.points.numpy(), None,
                                   geo.radii.numpy()),
        *grid_accel.disk_boxes(geo.points.numpy(), geo.radii.numpy()),
        3)[0]).long()
    want = torch.where(ids >= 0, geo.soa_inv_perm[ids.clamp(min=0)], -1)
    start, entries = grid_accel.compact_table(want)
    assert torch.equal(g.cell_start, start)
    assert torch.equal(g.cell_lanes.long(), entries.long())
    assert g.walk_slots == want.shape[1]
    verts, tris = fixtures.create_trench_mesh_3d(grid_delta=1.0)
    mesh = TriangleGeometry.build(verts, tris, 1.0, device="cpu")
    assert isinstance(mesh.grid, grid_accel.GridData)
    assert TriangleGeometry.build(verts, tris, 1.0, device="cpu",
                                  accel=False).grid is None
    # lines have no grid, as in the JAX package
    assert not hasattr(LineGeometry, "grid")
    assert not any(f.name == "grid" for f in dataclasses.fields(LineGeometry))


def test_from_reference_arrays_carries_the_grid():
    """The JAX package's grid handed across as numpy arrays: its table and
    origin as they are; without it, no grid."""
    ref_geo, geo = _disk_pair(3, 0.5)
    want = ref_geo.grid
    np.testing.assert_array_equal(geo.grid.cells, np.asarray(want.cells))
    np.testing.assert_array_equal(geo.grid.origin, np.asarray(want.origin))
    assert float(geo.grid.cell_size) == float(want.cell_size)
    assert geo.grid.dims == want.dims
    bare = DiskGeometry.from_reference_arrays(
        reference_arrays(ref_geo), dim=3, grid_delta=0.5,
        disk_radius=ref_geo.disk_radius, device="cpu")
    assert bare.grid is None
    ref_tri, tri = _triangle_pair(0.5)
    np.testing.assert_array_equal(tri.grid.cells,
                                  np.asarray(ref_tri.grid.cells))
    assert tri.grid.exact
    # the port's own build gives the JAX package's table
    own = DiskGeometry.build(*ref_fixtures.create_trench_grid_3d(
        grid_delta=0.5), 0.5, device="cpu")
    np.testing.assert_array_equal(own.grid.cells, geo.grid.cells)
    assert torch.equal(own.grid.cell_start, geo.grid.cell_start)
    assert torch.equal(own.grid.cell_lanes, geo.grid.cell_lanes)


def test_path_rule():
    """The grid is walked where the geometry has one, the trace is not
    differentiable and it has at least ``grid_min_prims`` primitives."""
    geo = _geometry("disk3d")
    n = geo.num_primitives
    at = vrtt.TraceConfig(grid_min_prims=n)
    above = vrtt.TraceConfig(grid_min_prims=n + 1)
    assert TK.grid_for(geo, at) is geo.grid
    assert TK.grid_for(geo, above) is None
    assert TK.grid_for(geo, vrtt.TraceConfig()) is None  # 777 < 8,192
    assert TK.grid_for(geo, at, differentiable=True) is None
    assert TK.grid_for(geo.replace(grid=None), at) is None


def test_wrappers_run_the_plain_version_on_the_cpu():
    """On CPU tensors the wrappers give the plain walk's result and launch
    nothing; kernel 4's wrapper refuses a grid on lines."""
    geo = _geometry("triangles")
    org, d = _rays(geo.bbox.numpy(), 256, 3, seed=9)
    o, dd = torch.from_numpy(org), torch.from_numpy(d)
    before = telemetry.COUNTS["triangle_grid_nearest_hit.launches"]
    got = GT.triangle_grid_nearest_hit(o, dd, geo.prims_soa, geo.soa_perm,
                                       geo.grid, T_NEAR)
    want = GT.triangle_grid_nearest_hit_ref(o, dd, geo.prims_soa,
                                            geo.soa_perm, geo.grid, T_NEAR)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert telemetry.COUNTS["triangle_grid_nearest_hit.launches"] == before
    with pytest.raises(TypeError, match="float64"):
        GT.triangle_grid_nearest_hit(o.double(), dd.double(), geo.prims_soa,
                                     geo.soa_perm, geo.grid, T_NEAR)
    nodes, lines = fixtures.create_trench_line_mesh(0.25)
    line_geo = LineGeometry.from_mesh(
        vrtt.LineMesh(nodes=nodes, lines=lines, grid_delta=0.25),
        device="cpu")
    settings_ = B.BounceSettings.from_config(
        vrtt.TraceConfig(dim=2, source_direction=vrtt.TraceDirection.POS_Y),
        vrtt.DiffuseParticle(0.2))
    with pytest.raises(ValueError, match="no grid search"):
        B.fused_bounce(None, None, line_geo, None, settings_,
                       grid=geo.grid)
    # the grid search runs a warp per ray
    disks = _geometry("disk3d")
    walls = B.make_walls(disks.bbox, disks, B.BounceSettings.from_config(
        vrtt.TraceConfig(), vrtt.DiffuseParticle(0.2)))
    state = B.RayState(
        o, dd, torch.ones(256), torch.ones(256), torch.ones(256, dtype=bool),
        torch.zeros(256, dtype=bool), torch.zeros(256, dtype=torch.int32),
        torch.zeros(256, dtype=torch.int32))
    with pytest.raises(ValueError, match="group 32"):
        B.fused_bounce(state, torch.zeros(256, 3), disks, walls,
                       B.BounceSettings.from_config(
                           vrtt.TraceConfig(), vrtt.DiffuseParticle(0.2)),
                       group=1, grid=disks.grid)
