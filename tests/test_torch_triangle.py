"""The port's triangle path against the JAX package's, at small sizes on the
CPU: host code, the closest-hit plain version (kernel 3), the bounce on
triangles (kernel 4's triangle branch), the trace of one mega-batch and
``TraceTriangle`` end to end.

On the CPU the port's wrappers run their plain versions; the CUDA kernels are
held to those plain versions on the card by ``chip_smoke.py``. Where the JAX
function reaches a Pallas kernel it runs in interpret mode, as the JAX
package's own tests run it.

Ties. Neighbouring triangles share edges, and a ray through an edge or a
vertex hits both at the same t. The Pallas kernels and the port give such a
tie to the lowest sorted lane; the reference's brute force
(``intersect.triangle_nearest_hit``) gives it to the lowest ORIGINAL index.
Where the brute force is on the reference's side, the mesh is handed to both
packages in packed order, where the two rules pick the same triangle.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viennaray_tpu as vrt
from viennaray_tpu.geometry import mesh as ref_mesh
from viennaray_tpu.io import fixtures as ref_fixtures
from viennaray_tpu.ops import intersect as ref_intersect
from viennaray_tpu.ops import pallas_intersect as ref_pallas
from viennaray_tpu.trace import kernel as ref_kernel

import viennaray_tpu_torch as vrtt
from viennaray_tpu_torch.config import adjust_bounding_box
from viennaray_tpu_torch.geometry import mesh as port_mesh
from viennaray_tpu_torch.geometry.triangle_geometry import TriangleGeometry
from viennaray_tpu_torch.io import fixtures
from viennaray_tpu_torch.ops import bounce, nearest_hit
from viennaray_tpu_torch.physics.source import RandomSource
from viennaray_tpu_torch.rng import GeneratorRNG
from viennaray_tpu_torch.trace import kernel as trace_kernel
from viennaray_tpu_torch.trace.kernel import hand_out_for, trace_batch

from torch_port_helpers import (
    TRIANGLE_FIELDS,
    JaxKeyedRNG,
    check_state_and_counts,
    make_settings,
    make_state,
    port_state,
    port_triangle_geometry,
    reference_bounce,
    reference_triangle_arrays,
)

torch.set_num_threads(1)

DIFFUSE = vrtt.ReflectionKind.DIFFUSE
SPECULAR = vrtt.ReflectionKind.SPECULAR
PERIODIC = vrtt.BoundaryCondition.PERIODIC
REFLECTIVE = vrtt.BoundaryCondition.REFLECTIVE


def _rel_l2(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


def _line_trench(step=0.25):
    """A 2D trench as (nodes, lines): shelf, wall, floor, wall, shelf, walked
    left to right so that the left-hand normals face the source (+y). One
    zero-length line is appended: ``LineMesh`` drops it."""
    corners = [(-3.0, 0.0), (-1.0, 0.0), (-1.0, -2.0), (1.0, -2.0),
               (1.0, 0.0), (3.0, 0.0)]
    nodes = [corners[0]]
    for (x0, y0), (x1, y1) in zip(corners[:-1], corners[1:]):
        n = int(round(max(abs(x1 - x0), abs(y1 - y0)) / step))
        nodes += [(x0 + (x1 - x0) * i / n, y0 + (y1 - y0) * i / n)
                  for i in range(1, n + 1)]
    nodes = np.c_[np.array(nodes, np.float32), np.zeros(len(nodes), np.float32)]
    lines = np.stack([np.arange(len(nodes) - 1), np.arange(1, len(nodes))], 1)
    lines = np.concatenate([lines, [[3, 3]]])
    return nodes, lines, step


def _packed_order_mesh(grid_delta):
    """The trench mesh with its triangles renumbered in packed order, so that
    sorted lane and original index agree (see the module's note on ties)."""
    verts, tris = ref_fixtures.create_trench_mesh_3d(grid_delta=grid_delta)
    first = vrt.TriangleGeometry.build(verts, tris, grid_delta, dim=3)
    tris = tris[np.asarray(first.soa_perm)[: len(tris)]]
    ref_geo = vrt.TriangleGeometry.build(verts, tris, grid_delta, dim=3)
    np.testing.assert_array_equal(
        np.asarray(ref_geo.soa_perm)[: len(tris)], np.arange(len(tris))
    )
    return verts, tris, ref_geo


# ---- host code: copies, so equality is exact ------------------------------
@pytest.mark.parametrize("grid_delta", [0.5, 1.0])
def test_trench_mesh_and_packing_equal_reference(grid_delta):
    verts, tris = fixtures.create_trench_mesh_3d(grid_delta=grid_delta)
    want_v, want_t = ref_fixtures.create_trench_mesh_3d(grid_delta=grid_delta)
    np.testing.assert_array_equal(verts, want_v)
    np.testing.assert_array_equal(tris, want_t)
    assert tris.dtype == want_t.dtype and verts.dtype == want_v.dtype
    flipped = -port_mesh.TriangleMesh(verts, tris).normals
    for normals in (None, flipped):
        for sort_axis in (2, 1):
            got = nearest_hit.pack_triangle_prims(
                verts, tris, normals=normals, sort_axis=sort_axis
            )
            want = ref_pallas.pack_triangle_prims(
                verts, tris, normals=normals, sort_axis=sort_axis
            )
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
                assert g.dtype == w.dtype
    assert got[0].shape[0] == nearest_hit.TRI_ROWS == ref_pallas.TRI_ROWS


def test_meshes_and_line_extrusion_equal_reference():
    nodes, lines, step = _line_trench()
    got = port_mesh.LineMesh(nodes, lines, grid_delta=step)
    want = ref_mesh.LineMesh(nodes, lines, grid_delta=step)
    assert len(got.lines) == len(lines) - 1  # the zero-length line went
    for name in ("nodes", "lines", "normals", "minimum_extent",
                 "maximum_extent"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    got_t = port_mesh.lines_to_triangles(got)
    want_t = ref_mesh.lines_to_triangles(want)
    for name in ("nodes", "triangles", "normals", "minimum_extent",
                 "maximum_extent"):
        np.testing.assert_array_equal(
            getattr(got_t, name), getattr(want_t, name)
        )
        assert getattr(got_t, name).dtype == getattr(want_t, name).dtype
    assert got_t.grid_delta == want_t.grid_delta == step


@pytest.mark.parametrize("case", ["3d", "3d_user_normals", "2d_lines"])
def test_triangle_geometry_equals_reference(case):
    """Every array field bitwise, dim 2 and 3: normals (computed, or the
    user's where they oppose the winding), areas (half the cross product in
    3D, the alternating half-segment lengths in 2D), ``soa_inv_perm``."""
    if case == "2d_lines":
        nodes, lines, step = _line_trench()
        ref_geo = vrt.TriangleGeometry.from_line_mesh(
            ref_mesh.LineMesh(nodes, lines, grid_delta=step)
        )
        geo = TriangleGeometry.from_line_mesh(
            port_mesh.LineMesh(nodes, lines, grid_delta=step), device="cpu"
        )
        assert geo.dim == ref_geo.dim == 2
        areas = geo.areas.numpy()
        # each triangle of a segment carries half the segment's length
        np.testing.assert_allclose(areas, 0.5 * step, rtol=1e-6)
    else:
        verts, tris = fixtures.create_trench_mesh_3d(grid_delta=1.0)
        tris = np.concatenate([tris, [[0, 0, 1]]]).astype(np.int32)  # degenerate
        normals = None
        if case == "3d_user_normals":
            normals = -ref_mesh.TriangleMesh(verts, tris).normals
        ref_geo = vrt.TriangleGeometry.build(
            verts, tris, 1.0, dim=3, normals=normals
        )
        geo = TriangleGeometry.build(
            verts, tris, 1.0, dim=3, normals=normals, device="cpu"
        )
        assert geo.areas[-1] == 0.0 and not geo.normals[-1].any()
    want = reference_triangle_arrays(ref_geo)
    for name in TRIANGLE_FIELDS:
        got = getattr(geo, name).numpy()
        np.testing.assert_array_equal(got, want[name], err_msg=name)
    assert geo.grid_delta == ref_geo.grid_delta
    assert geo.num_primitives == ref_geo.num_primitives
    assert geo.kind == "triangle" and geo.device.type == "cpu"
    inv = geo.soa_inv_perm.numpy()
    np.testing.assert_array_equal(
        geo.soa_perm.numpy()[inv], np.arange(geo.num_primitives)
    )
    # the handed-across tables make the same geometry
    again = port_triangle_geometry(ref_geo)
    for name in TRIANGLE_FIELDS:
        assert torch.equal(getattr(again, name), getattr(geo, name)), name


# ---- kernel 3's plain version ----------------------------------------------
def _rays(n, seed=0):
    """numpy-seeded rays over the 3D trench: the first half from the source
    plane with a cosine lobe, the second half from anywhere inside the box
    with any direction."""
    rng = np.random.default_rng(seed)
    org = rng.uniform(-5.0, 5.0, (n, 3)).astype(np.float32)
    org[:, 2] = rng.uniform(-3.9, 0.9, n).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    half = n // 2
    org[:half, 2] = 1.0
    d[:half, 2] = -np.abs(d[:half, 2]) - 0.3
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d


@pytest.fixture(scope="module")
def trench():
    """The 1,440-triangle trench (3 chunks of 512 lanes) in packed order in
    both packages, rays, and the port's answer."""
    verts, tris, ref_geo = _packed_order_mesh(0.5)
    geo = port_triangle_geometry(ref_geo)
    assert geo.soa_chunk_bbs.shape[0] == 3
    org, d = _rays(1024)
    got = nearest_hit.triangle_nearest_hit_ref(
        torch.from_numpy(org), torch.from_numpy(d), geo.prims_soa,
        geo.soa_perm, geo.soa_chunk_bbs, t_near=1e-4,
    )
    return ref_geo, geo, org, d, tuple(x.numpy() for x in got)


def _compare_hits(got, want):
    """``hit`` equal on at least 99.9 % of lanes, the triangle equal on at
    least 99.9 % of the lanes both hit, t within 3e-5 relative where the
    triangle agrees. The references multiply by a reciprocal (the Pallas
    kernel by an approximate one plus a Newton step) where the port divides,
    so u, v, det and t differ in the last bits and a ray on an edge can fall
    to either side."""
    t, prim, hit = got
    t_w, prim_w, hit_w = (np.asarray(x) for x in want)
    assert (hit == hit_w).mean() >= 0.999
    both = hit & hit_w
    assert 0.3 < both.mean() < 1.0
    same = both & (prim == prim_w)
    assert same.sum() >= 0.999 * both.sum()
    np.testing.assert_allclose(t[same], t_w[same], rtol=3e-5)


def test_plain_version_matches_pallas_kernel(trench):
    ref_geo, _, org, d, got = trench
    want = ref_pallas.triangle_nearest_hit_pallas(
        jnp.asarray(org), jnp.asarray(d), ref_geo.prims_soa, ref_geo.soa_perm,
        ref_geo.soa_chunk_bbs, rt=256, interpret=True,
    )
    _compare_hits(got, want)


def test_plain_version_matches_brute_force(trench):
    ref_geo, _, org, d, got = trench
    want = ref_intersect.triangle_nearest_hit(
        jnp.asarray(org), jnp.asarray(d), ref_geo.vertices, ref_geo.triangles,
        1e-4,
    )
    _compare_hits(got, want)


def test_user_normals_do_not_change_the_hit_and_ragged_ray_count(trench):
    """The test is double-sided and never reads the stored normal: a mesh
    whose normals oppose the winding gives the same (t, triangle, hit). Any R
    runs, each ray's answer does not depend on the batch it is in, and on CPU
    tensors the wrapper is the plain version."""
    ref_geo, geo, org, d, (t, prim, hit) = trench
    flipped = vrt.TriangleGeometry.build(
        np.asarray(ref_geo.vertices), np.asarray(ref_geo.triangles), 0.5,
        dim=3, normals=-np.asarray(ref_geo.normals),
    )
    geo_f = port_triangle_geometry(flipped)
    assert torch.equal(geo_f.prims_soa[9:12], -geo.prims_soa[9:12])
    n = 777
    got = nearest_hit.triangle_nearest_hit(
        torch.from_numpy(org[:n]), torch.from_numpy(d[:n]), geo_f.prims_soa,
        geo_f.soa_perm, geo_f.soa_chunk_bbs, t_near=1e-4,
    )
    np.testing.assert_array_equal(got[0].numpy(), t[:n])
    np.testing.assert_array_equal(got[1].numpy(), prim[:n])
    np.testing.assert_array_equal(got[2].numpy(), hit[:n])
    assert got[1].dtype == torch.int32 and got[2].dtype == torch.bool
    shifted = nearest_hit.triangle_nearest_hit_ref(
        torch.from_numpy(org[5:n]), torch.from_numpy(d[5:n]), geo.prims_soa,
        geo.soa_perm, None, t_near=1e-4,
    )
    np.testing.assert_array_equal(shifted[0].numpy(), t[5:n])
    np.testing.assert_array_equal(shifted[1].numpy(), prim[5:n])


def test_shared_edge_goes_to_lowest_sorted_lane():
    """Rays straight down onto the diagonal that two triangles of a flat quad
    share hit both at exactly the same t with u + v = 1 on one and u = 0 or
    v = 0 on the other: the lower sorted lane wins, in the port as in the
    Pallas kernel; padded and degenerate triangles are never hit."""
    verts = np.float32([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]])
    tris = np.int32([[0, 2, 3], [0, 1, 2], [0, 0, 1]])  # the last: zero area
    ref_geo = vrt.TriangleGeometry.build(verts, tris, 1.0, dim=3)
    geo = port_triangle_geometry(ref_geo)
    n = 256
    s = np.linspace(0.125, 0.875, n, dtype=np.float32)
    s = np.round(s * 64) / 64  # exactly representable, so x == y exactly
    org = np.stack([s, s, np.ones(n, np.float32)], axis=1).astype(np.float32)
    d = np.tile(np.float32([0.0, 0.0, -1.0]), (n, 1))
    t, prim, hit = nearest_hit.triangle_nearest_hit_ref(
        torch.from_numpy(org), torch.from_numpy(d), geo.prims_soa,
        geo.soa_perm, geo.soa_chunk_bbs,
    )
    inv = geo.soa_inv_perm.numpy()
    winner = min((0, 1), key=lambda p: inv[p])
    assert hit.all() and (prim.numpy() == winner).all()
    assert (t.numpy() == 1.0).all()
    _, prim_ref, _ = ref_pallas.triangle_nearest_hit_pallas(
        jnp.asarray(org), jnp.asarray(d), ref_geo.prims_soa, ref_geo.soa_perm,
        ref_geo.soa_chunk_bbs, rt=256, interpret=True,
    )
    np.testing.assert_array_equal(prim.numpy(), np.asarray(prim_ref))
    # beside the quad nothing is hit, the degenerate triangle included
    away = torch.from_numpy(org + np.float32([2.0, 0.0, 0.0]))
    assert not nearest_hit.triangle_nearest_hit_ref(
        away, torch.from_numpy(d), geo.prims_soa, geo.soa_perm,
    )[2].any()


def test_wrapper_refuses_what_the_kernel_does_not_take(trench):
    _, geo, org, d, _ = trench
    o, dd = torch.from_numpy(org), torch.from_numpy(d)
    args = (geo.prims_soa, geo.soa_perm, geo.soa_chunk_bbs)
    with pytest.raises(TypeError):
        nearest_hit.triangle_nearest_hit(o.double(), dd.double(), *args)
    with pytest.raises(ValueError):
        nearest_hit.triangle_nearest_hit(o[:, :2], dd[:, :2], *args)
    with pytest.raises(ValueError):  # a disk table's 8 rows
        nearest_hit.triangle_nearest_hit(o, dd, geo.prims_soa[:8], *args[1:])
    with pytest.raises(ValueError):  # and the other way round
        nearest_hit.disk_nearest_hit(o, dd, *args)


# ---- kernel 4 on triangles: the bounce --------------------------------------
@pytest.fixture(scope="module")
def bounce_trench(trench):
    ref_geo, geo = trench[:2]
    bbox = adjust_bounding_box(
        np.asarray(ref_geo.bbox), vrtt.TraceDirection.POS_Z,
        ref_geo.grid_delta, 3,
    ).astype(np.float32)
    return ref_geo, geo, bbox


def test_walls_of_triangles_carry_no_reach(bounce_trench):
    _, geo, bbox = bounce_trench
    settings = make_settings(DIFFUSE, PERIODIC)
    walls = bounce.make_walls(torch.from_numpy(bbox), geo, settings).numpy()
    np.testing.assert_array_equal(
        walls, np.float32([-5, 5, -5, 5, bbox[0, 2], bbox[1, 2], 0, 0, 0])
    )
    assert bbox[1, 2] == np.float32(1.0)  # raised by 2 grid_delta


@pytest.mark.parametrize("case", ["diffuse_periodic", "specular_reflective"])
def test_one_bounce_handed_out_matches_reference_kernel(bounce_trench, case):
    """Against the megakernel in interpret mode with ``geo_kind="triangle"``:
    the bounds of ``check_state_and_counts`` (flags, counters and hit
    triangle equal on at least 99.9 % of lanes, weight / direction / deposit
    weight within 1e-5, the new origin within 3e-5 of its flight)."""
    ref_geo, geo, bbox = bounce_trench
    kind, bc = {"diffuse_periodic": (DIFFUSE, PERIODIC),
                "specular_reflective": (SPECULAR, REFLECTIVE)}[case]
    settings = make_settings(kind, bc)
    walls = bounce.make_walls(torch.from_numpy(bbox), geo, settings)
    arrays = make_state(bbox, 1024, 1, seed=5)
    res = bounce.fused_bounce(
        port_state(arrays), torch.from_numpy(arrays[8]), geo, walls, settings,
        n_sub=1, deposit_in_kernel=False,
    )
    ref = reference_bounce(
        ref_geo, walls, arrays, settings, 1, True, geo_kind="triangle"
    )
    assert res.flux is None and (ref["hit_prim"] >= 0).sum() > 100
    # hfb is dead state on triangles: it passes through as it came
    np.testing.assert_array_equal(res.state.hfb.numpy(), arrays[5])
    check_state_and_counts(res, ref, arrays[0])


def test_four_bounces_deposits_in_kernel_match_reference_kernel(bounce_trench):
    """Single-hit deposits on both sides: flux rel-L2 < 1e-3 with at most
    two bins off by more than 1e-5 of the largest."""
    ref_geo, geo, bbox = bounce_trench
    settings = make_settings(DIFFUSE, PERIODIC)
    walls = bounce.make_walls(torch.from_numpy(bbox), geo, settings)
    arrays = make_state(bbox, 1024, 4, seed=6)
    res = bounce.fused_bounce(
        port_state(arrays), torch.from_numpy(arrays[8]), geo, walls, settings,
        n_sub=4, deposit_in_kernel=True,
    )
    ref = reference_bounce(
        ref_geo, walls, arrays, settings, 4, False, geo_kind="triangle"
    )
    assert res.hit_prim is None and res.wdep is None
    check_state_and_counts(
        res, ref, arrays[0], flight=4 * np.linalg.norm(bbox[1] - bbox[0])
    )
    flux = res.flux.numpy()
    assert ref["flux"].sum() > 100
    assert _rel_l2(flux, ref["flux"]) < 1e-3
    off = np.abs(flux - ref["flux"]) > 1e-5 * ref["flux"].max()
    assert off.sum() <= 2, off.sum()


def test_backface_hit_kills_on_a_mesh_with_one_face_flipped(bounce_trench):
    """The trench floor's stored normals are turned to face down: every ray
    that reaches the floor from above dies there without a deposit, whatever
    its ``hfb``, in the port as in the megakernel; the other faces go on
    colliding."""
    ref_geo, _, bbox = bounce_trench
    normals = np.array(ref_geo.normals)
    v0 = np.asarray(ref_geo.vertices)[np.asarray(ref_geo.triangles)[:, 0]]
    floor = (v0[:, 2] == -4.0) & (normals[:, 2] == 1.0)
    assert floor.sum() == 2 * 8 * 20
    normals[floor] *= -1.0
    flipped = vrt.TriangleGeometry.build(
        np.asarray(ref_geo.vertices), np.asarray(ref_geo.triangles), 0.5,
        dim=3, normals=normals,
    )
    geo = port_triangle_geometry(flipped)
    settings = make_settings(DIFFUSE, PERIODIC)
    walls = bounce.make_walls(torch.from_numpy(bbox), geo, settings)
    arrays = make_state(bbox, 1024, 1, seed=7)
    state = port_state(arrays)
    res = bounce.fused_bounce(
        state, torch.from_numpy(arrays[8]), geo, walls, settings, n_sub=1,
        deposit_in_kernel=False,
    )
    ref = reference_bounce(
        flipped, walls, arrays, settings, 1, True, geo_kind="triangle"
    )
    check_state_and_counts(res, ref, arrays[0])
    # which rays reached the floor: the plain search on the same rays
    _, prim, hit = nearest_hit.triangle_nearest_hit_ref(
        state.org, state.dirn, geo.prims_soa, geo.soa_perm
    )
    down = state.dirn[:, 2] < 0
    onto_floor = (
        state.alive & hit & down & torch.from_numpy(floor)[prim.long()]
    )
    assert onto_floor.sum() > 50
    assert not res.state.alive[onto_floor].any()
    assert (res.hit_prim[onto_floor] == -1).all()
    assert not torch.from_numpy(floor)[res.hit_prim.clamp(min=0).long()][
        res.hit_prim >= 0
    ].any()
    assert (res.hit_prim >= 0).sum() > 100
    assert torch.equal(res.state.hfb, state.hfb)


def test_n_sub_equals_repeated_single_bounces_and_dead_batches(bounce_trench):
    """State and counts bit for bit, the flux to float32 rounding (one
    float64 sum rounded once against a sum of float32 fluxes); a batch of
    dead lanes returns its input."""
    _, geo, bbox = bounce_trench
    settings = make_settings(DIFFUSE, PERIODIC)
    walls = bounce.make_walls(torch.from_numpy(bbox), geo, settings)
    k = 4
    arrays = make_state(bbox, 1000, k, seed=9)  # a ragged R
    uniforms = torch.from_numpy(arrays[8])
    whole = bounce.fused_bounce(
        port_state(arrays), uniforms, geo, walls, settings, n_sub=k
    )
    state = port_state(arrays)
    counts = torch.zeros(4, dtype=torch.int64)
    flux = torch.zeros(geo.num_primitives, dtype=torch.float64)
    for j in range(k):
        step = bounce.fused_bounce(
            state, uniforms[:, 3 * j: 3 * j + 3].contiguous(), geo, walls,
            settings, n_sub=1,
        )
        state = step.state
        counts += step.counts[:4]
        flux += step.flux.double()
    for got, want in zip(whole.state, state):
        assert torch.equal(got, want)
    assert torch.equal(whole.counts[:4], counts)
    assert flux.sum() > 100
    np.testing.assert_allclose(whole.flux.numpy(), flux.numpy(), rtol=1e-6)

    dead = port_state(arrays)._replace(alive=torch.zeros(1000, dtype=torch.bool))
    res = bounce.fused_bounce(dead, uniforms, geo, walls, settings, n_sub=k)
    for got, want in zip(res.state, dead):
        assert torch.equal(got, want)
    assert not res.flux.any() and not res.counts.any()


def test_bounce_wrapper_refuses_mismatched_tables(bounce_trench):
    _, geo, bbox = bounce_trench
    settings = make_settings(DIFFUSE, PERIODIC)
    walls = bounce.make_walls(torch.from_numpy(bbox), geo, settings)
    arrays = make_state(bbox, 64, 1, seed=11)
    state, uniforms = port_state(arrays), torch.from_numpy(arrays[8])
    with pytest.raises(ValueError):  # a disk table's 8 rows
        bounce.fused_bounce(
            state, uniforms, geo.replace(prims_soa=geo.prims_soa[:8].clone()),
            walls, settings,
        )
    with pytest.raises(ValueError):  # deposits handed out need n_sub == 1
        bounce.fused_bounce(
            state, torch.cat([uniforms, uniforms], dim=1), geo, walls,
            settings, n_sub=2, deposit_in_kernel=False,
        )


def test_deposit_placement_rule():
    """Disks keep the reference's rule; triangles deposit in the kernel at
    every width (one atomic per colliding ray; measured on an H100)."""
    assert hand_out_for("disk", 6, DIFFUSE, 1)
    assert not hand_out_for("disk", 3, DIFFUSE, 1)
    assert not hand_out_for("disk", 6, SPECULAR, 1)
    assert not hand_out_for("disk", 6, DIFFUSE, 4)
    for chunks in (1, 12, 25):
        assert not hand_out_for("triangle", chunks, DIFFUSE, 1)


# ---- inside the port: fused against unfused ---------------------------------
@pytest.mark.parametrize("hand_out", [False, True])
def test_fused_equals_unfused_with_one_bounce_per_launch(hand_out, monkeypatch):
    """With n_sub = (1, 1, 1) and ``GeneratorRNG`` both bodies draw the same
    numbers in the same order and go through one step function and the exact
    histogram: the counters are equal and the flux is bitwise equal, with
    deposits in the kernel (the rule for triangles) and handed out (the rule
    put aside for the test)."""
    if hand_out:
        monkeypatch.setattr(
            trace_kernel, "hand_out_for", lambda kind, chunks, refl, k: k == 1
        )
    verts, tris = fixtures.create_trench_mesh_3d(grid_delta=0.5)
    geo = TriangleGeometry.build(verts, tris, 0.5, device="cpu")
    bbox = torch.from_numpy(adjust_bounding_box(
        geo.bbox.numpy(), vrtt.TraceDirection.POS_Z, geo.grid_delta, 3,
    ).astype(np.float32))
    R = 4096
    config = vrtt.TraceConfig(
        dim=3, boundary_conditions=(PERIODIC,) * 3, ray_batch_size=R,
    )
    source = RandomSource(
        bbox=bbox, cosine_power=1.0, ray_dir=2, first_dir=0, second_dir=1,
        min_max=1, pos_neg=-1.0, dim=3,
    )
    runs = []
    for kwargs in (dict(fused=False),
                   dict(fused=True, n_sub=(1, 1, 1))):
        rng = GeneratorRNG(21, "cpu")
        rng.begin_batch(0)
        runs.append(trace_batch(
            geo, source, vrtt.DiffuseParticle(0.2, "flux"), bbox, rng, 0,
            torch.arange(R), torch.ones(R, dtype=torch.bool), config, **kwargs,
        ))
    (flux_u, cnt_u), (flux_f, cnt_f) = runs
    assert cnt_u == cnt_f and cnt_u.geometry_hits > 1000
    assert torch.equal(flux_u, flux_f)


# ---- one mega-batch against the reference's bodies ---------------------------
@functools.lru_cache(maxsize=None)
def _lane_matched_setup():
    verts, tris, ref_geo = _packed_order_mesh(0.5)
    geo = port_triangle_geometry(ref_geo)
    bbox = adjust_bounding_box(
        np.asarray(ref_geo.bbox), vrtt.TraceDirection.POS_Z,
        ref_geo.grid_delta, 3,
    ).astype(np.float32)
    return ref_geo, geo, bbox


def _lane_matched(ref_knobs, max_bounces=3000, **port_kwargs):
    """One mega-batch of R = 2,048 through both packages' ``trace_batch`` on
    the same tables (in packed order) with the same uniforms; returns (flux,
    counters) of the port and of the reference. The source sort and the
    ladder's caps 1024 / 512 / 0 run."""
    R, batch_index, seed = 2048, 2, 12346
    ref_geo, geo, bbox = _lane_matched_setup()
    conds = [vrt.BoundaryCondition.PERIODIC] * 3
    ref_config = vrt.TraceConfig(
        dim=3, boundary_conditions=tuple(conds), ray_batch_size=R,
        rng_seed=seed, use_random_seed=False, max_bounces=max_bounces,
    )
    ref_source = vrt.RandomSource(
        bbox=jnp.asarray(bbox), cosine_power=jnp.float32(1.0), ray_dir=2,
        first_dir=0, second_dir=1, min_max=1, pos_neg=-1.0, dim=3,
    )
    base_key = jax.random.PRNGKey(seed)
    ray_indices = np.arange(batch_index * R, (batch_index + 1) * R)
    valid = ray_indices < (batch_index + 1) * R - 100
    ref_trace = jax.jit(functools.partial(
        ref_kernel.trace_batch, config=ref_config, geo_type="triangle",
        knobs=ref_knobs,
    ))
    ref_flux, ref_cnt = ref_trace(
        ref_geo, ref_source, vrt.DiffuseParticle(0.1, "flux"),
        jnp.asarray(bbox), jax.random.fold_in(base_key, batch_index),
        jnp.asarray(ray_indices, jnp.int32), jnp.asarray(valid),
    )
    config = vrtt.TraceConfig(
        dim=3, boundary_conditions=(PERIODIC,) * 3, ray_batch_size=R,
        rng_seed=seed, use_random_seed=False, max_bounces=max_bounces,
    )
    source = RandomSource(
        bbox=torch.from_numpy(bbox), cosine_power=1.0, ray_dir=2,
        first_dir=0, second_dir=1, min_max=1, pos_neg=-1.0, dim=3,
    )
    rng = JaxKeyedRNG(base_key)
    rng.begin_batch(batch_index)
    flux, cnt = trace_batch(
        geo, source, vrtt.DiffuseParticle(0.1, "flux"),
        torch.from_numpy(bbox), rng, batch_index,
        torch.from_numpy(ray_indices), torch.from_numpy(valid), config,
        **port_kwargs,
    )
    return flux.numpy(), cnt, np.asarray(ref_flux), ref_cnt


def _assert_close_runs(flux, cnt, ref_flux, ref_cnt, counters, rel_l2,
                       bins_off):
    for name in ("total_traces", "geometry_hits", "boundary_hits",
                 "non_geometry_hits"):
        want = int(getattr(ref_cnt, name))
        got = getattr(cnt, name)
        assert want > 400, name
        assert abs(got - want) <= counters * want, (name, got, want)
    assert _rel_l2(flux, ref_flux) < rel_l2, _rel_l2(flux, ref_flux)
    if bins_off is not None:
        off = np.abs(flux - ref_flux) > 1e-5 * np.abs(ref_flux).max()
        assert off.sum() <= bins_off, off.sum()


def test_trace_batch_unfused_lane_matched_with_reference():
    """The port's unfused body against the reference's (brute-force search,
    single-hit deposits), the whole ladder: counters within 0.2 %. Flux: a
    ray on a shared edge can fall to the neighbouring triangle (the reference
    multiplies by a reciprocal where the port divides) and moves one deposit
    between two bins; such a ray reflects off the same plane either way, so
    the lanes stay matched: rel-L2 < 1e-2 and at most 10 bins off by more
    than 1e-5 of the largest."""
    _assert_close_runs(
        *_lane_matched(ref_kernel.EnvKnobs(fused=False), fused=False),
        counters=0.002, rel_l2=1e-2, bins_off=10,
    )


def _fused_knobs(n_sub):
    return ref_kernel.EnvKnobs(
        fused=True, fused_interpret=True, nsub_wide=n_sub[0],
        nsub_mid=n_sub[1], nsub_tail=n_sub[2],
    )


def test_trace_batch_fused_lane_matched_up_to_first_compaction():
    """The port's fused body against the reference's megakernel in interpret
    mode: one launch of four bounces at width 2,048 (one block of uniforms),
    before any compaction. Counters within 0.2 %; flux rel-L2 < 1e-2 and at
    most 10 bins off (one flipped ray moves a whole deposit), as for disks."""
    n_sub = (1, 4, 4)
    _assert_close_runs(
        *_lane_matched(_fused_knobs(n_sub), max_bounces=4, fused=True,
                       n_sub=n_sub),
        counters=0.002, rel_l2=1e-2, bins_off=10,
    )


def test_trace_batch_fused_whole_run_agrees_within_noise():
    """The whole ladder with 4 bounces per launch on both sides. After the
    first compaction one flipped ray shifts every later lane's uniforms, so
    the runs are two samples of about 2,000 rays that share their first four
    bounces: counters within 3 %, flux rel-L2 < 0.35 (single-hit deposits on
    1,440 bins, under 3 deposits a bin; disks, with 12 bins a deposit, are
    held to 0.15)."""
    n_sub = (1, 4, 4)
    _assert_close_runs(
        *_lane_matched(_fused_knobs(n_sub), fused=True, n_sub=n_sub),
        counters=0.03, rel_l2=0.35, bins_off=None,
    )


# ---- the slice as a whole: TraceTriangle -------------------------------------
def _tracers(make_geometry, dim, rays, seed=5, sticking=0.2, **port_kwargs):
    """The same trace set up in both packages; returns (port, reference)."""
    out = []
    for pkg, kwargs in ((vrtt, dict(device="cpu", **port_kwargs)), (vrt, {})):
        t = pkg.TraceTriangle(dim=dim, **kwargs)
        make_geometry(pkg, t)
        t.set_boundary_conditions([pkg.BoundaryCondition.PERIODIC] * dim)
        t.set_particle_type(pkg.DiffuseParticle(sticking, "flux"))
        t.set_number_of_rays_fixed(rays)
        t.set_rng_seed(seed)
        t.set_ray_batch_size(8192)
        if dim == 2:
            t.set_source_direction(pkg.TraceDirection.POS_Y)
        out.append(t)
    return out


def test_trace_triangle_3d_agrees_with_reference_and_normalizes_alike():
    """``TraceTriangle(dim=3)`` on the 1,440-triangle trench, 16,384 rays in
    2 batches, against the JAX ``TraceTriangle``. The two draw other numbers
    (``torch.Generator`` against ``jax.random``), so they agree as two
    samples: hits per ray within 2 %, SOURCE-normalized flux rel-L2 < 0.4
    (about 20 deposits a bin: two samples differ by sqrt(2 / 20) = 0.32).
    Normalization itself, on one flux through both packages, to float32
    rounding."""
    verts, tris = fixtures.create_trench_mesh_3d(grid_delta=0.5)

    def geometry(pkg, t):
        t.set_geometry(verts, tris, 0.5)

    port, ref = _tracers(geometry, 3, 16_384)
    flux = port.apply()
    ref_flux = np.asarray(ref.apply(), np.float64)
    assert flux.shape == (1440,) and flux.dtype == np.float64
    info, ref_info = port.get_ray_trace_info(), ref.get_ray_trace_info()
    assert info.num_rays == ref_info.num_rays == 16_384
    want = ref_info.geometry_hits / ref_info.num_rays
    assert abs(info.geometry_hits / info.num_rays - want) <= 0.02 * want
    assert info.reflections == info.geometry_hits
    norm = port.normalize_flux(flux)
    assert _rel_l2(norm, ref.normalize_flux(ref_flux)) < 0.4
    for kind in (vrtt.NormalizationType.SOURCE, vrtt.NormalizationType.MAX):
        np.testing.assert_allclose(
            port.normalize_flux(flux, kind),
            ref.normalize_flux(flux, vrt.NormalizationType(int(kind))),
            rtol=2e-6,
        )
    assert port.normalize_flux(flux, vrtt.NormalizationType.MAX).max() > 1.0
    np.testing.assert_array_equal(port.smooth_flux(flux), flux)
    np.testing.assert_array_equal(
        port.get_local_data().get_vector_data("flux"), flux
    )
    # same seed, same flux, bit for bit
    again, _ = _tracers(geometry, 3, 16_384)
    np.testing.assert_array_equal(again.apply(), flux)


def test_trace_triangle_2d_line_mesh_agrees_with_reference():
    """``TraceTriangle(dim=2)`` on a ``LineMesh`` of 40 segments, extruded to
    80 triangles: areas bitwise equal, normalized flux rel-L2 < 0.1 at 20,000
    rays (about 450 deposits a bin), hits per ray within 5 %: roulette renews
    some rays for long walks in the closed 2D trench, and over seeds the
    port's hits per ray at 20,000 rays spread by 1.3 % either way (at 200,000
    rays port, reference and the C++ oracle give 1.6531, 1.6547 and 1.6552)."""
    nodes, lines, step = _line_trench()

    def geometry(pkg, t):
        mesh = pkg.geometry.mesh if pkg is vrtt else ref_mesh
        t.set_geometry(mesh.LineMesh(nodes, lines[:-1], grid_delta=step))

    port, ref = _tracers(geometry, 2, 20_000)
    np.testing.assert_array_equal(
        port.geometry.areas.numpy(), np.asarray(ref.geometry.areas)
    )
    assert port.geometry.num_primitives == 80 and port.geometry.dim == 2
    flux = port.apply()
    ref_flux = np.asarray(ref.apply(), np.float64)
    info, ref_info = port.get_ray_trace_info(), ref.get_ray_trace_info()
    want = ref_info.geometry_hits / ref_info.num_rays
    assert abs(info.geometry_hits / info.num_rays - want) <= 0.05 * want
    assert _rel_l2(
        port.normalize_flux(flux), ref.normalize_flux(ref_flux)
    ) < 0.1
    with pytest.raises(ValueError):  # a line mesh needs dim=2
        vrtt.TraceTriangle(dim=3, device="cpu").set_geometry(
            port_mesh.LineMesh(nodes, lines[:-1], grid_delta=step)
        )


def test_trace_triangle_setters_and_refusals():
    verts, tris = fixtures.create_trench_mesh_3d(grid_delta=1.0)
    t = vrtt.TraceTriangle(dim=3, device="cpu")
    with pytest.raises(ValueError):
        t.apply()  # no particle
    t.set_particle_type(vrtt.DiffuseParticle(0.5, "flux"))
    with pytest.raises(ValueError):
        t.apply()  # no geometry
    t.set_geometry(port_mesh.TriangleMesh(verts, tris, grid_delta=1.0))
    assert t.geometry.kind == "triangle" and t.geometry.num_primitives == 360
    t.set_material_ids(np.arange(360))
    assert t.geometry.material_ids.dtype == torch.int32
    t.set_number_of_rays_fixed(600)
    t.set_rng_seed(2)
    assert t.apply().sum() > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            vrtt.TraceTriangle(dim=3)
        with pytest.raises(RuntimeError):
            TriangleGeometry.build(verts, tris, 1.0)
    # gas scattering traces on triangles; a particle with two data labels
    # traces one channel, as in the JAX package: the first label receives
    # the flux, the second zeros
    t.set_particle_type(vrtt.Particle(sticking=0.5, mean_free_path=0.5))
    assert t.apply().sum() > 0
    assert t.get_ray_trace_info().particle_hits > 0
    t.set_particle_type(
        vrtt.Particle(sticking=0.5, data_labels=("flux", "energy"))
    )
    flux = t.apply()
    assert flux.sum() > 0
    assert not t.get_local_data().get_vector_data("energy").any()
    # a custom collision function gives each label a channel of its own:
    # (R, 1) ids and weights on triangles
    from viennaray_tpu_torch.ops.histogram import flux_histogram

    def collision_fn(flux, ids, w, dirn, normal, mat, rng):
        assert ids.shape[1] == w.shape[1] == 1
        ids, w = ids.reshape(-1), w.reshape(-1)
        return torch.stack([flux[0] + flux_histogram(ids, w, flux.shape[1]),
                            flux[1] + flux_histogram(ids, 0.5 * w,
                                                     flux.shape[1])])

    t.set_custom_functions(collision_fn=collision_fn)
    flux = t.apply()
    assert flux.shape == (2, t.geometry.num_primitives) and flux[0].sum() > 0
    np.testing.assert_array_equal(flux[1], 0.5 * flux[0])
