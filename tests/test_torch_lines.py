"""The port's 2D line-segment path against the JAX package's, at small sizes on
the CPU: host code, the closest-hit plain version (the line instantiation of
the search), the bounce on lines (kernel 4's line branch), and ``TraceLine``
end to end, against the reference and against the scalar oracle.

On the CPU the port's wrappers run their plain versions; the CUDA kernels are
held to those plain versions on the card by ``chip_smoke.py``. The JAX
package's megakernel runs in interpret mode, as its own tests run it; its
line search is plain XLA (``intersect.line_nearest_hit``).

Last bits. The reference multiplies by one reciprocal where the port divides
twice, and the megakernel by an approximate reciprocal with a Newton step, so
t and s differ in the last bits and a ray that grazes a segment's clipped end
can fall to either side.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viennaray_tpu as vrt
from viennaray_tpu.geometry.line_geometry import LineGeometry as RefLineGeometry
from viennaray_tpu.io import fixtures as ref_fixtures
from viennaray_tpu.ops import intersect as ref_intersect
from viennaray_tpu.ops import pallas_intersect as ref_pallas

import viennaray_tpu_torch as vrtt
from viennaray_tpu_torch.config import adjust_bounding_box
from viennaray_tpu_torch.geometry.line_geometry import LineGeometry
from viennaray_tpu_torch.geometry.mesh import lines_to_triangles
from viennaray_tpu_torch.io import fixtures
from viennaray_tpu_torch.ops import bounce, nearest_hit
from viennaray_tpu_torch.physics.source import RandomSource
from viennaray_tpu_torch.rng import GeneratorRNG
from viennaray_tpu_torch.trace import kernel as trace_kernel
from viennaray_tpu_torch.trace.kernel import hand_out_for, trace_batch

import oracle_ref
from torch_port_helpers import (
    LINE_FIELDS,
    check_state_and_counts,
    make_settings,
    make_state,
    oracle_available,
    port_line_geometry,
    port_state,
    reference_bounce,
    reference_line_arrays,
)

torch.set_num_threads(1)

DIFFUSE = vrtt.ReflectionKind.DIFFUSE
SPECULAR = vrtt.ReflectionKind.SPECULAR
PERIODIC = vrtt.BoundaryCondition.PERIODIC
REFLECTIVE = vrtt.BoundaryCondition.REFLECTIVE
IGNORE = vrtt.BoundaryCondition.IGNORE


def _rel_l2(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


def _flat_mesh(module, extent=2.0, seg=0.2):
    """The flat chain of ``tests/test_line_tracer.py`` as either package's
    ``LineMesh``."""
    xs = np.arange(-extent, extent + 1e-9, seg)
    nodes = np.stack([xs, np.zeros_like(xs), np.zeros_like(xs)], axis=1)
    lines = np.stack([np.arange(len(xs) - 1), np.arange(1, len(xs))], axis=1)
    return module.LineMesh(nodes=nodes.astype(np.float32),
                           lines=lines.astype(np.uint32), grid_delta=seg)


def _trench_meshes(grid_delta, **kwargs):
    """The trench of the fixture as both packages' ``LineMesh``."""
    nodes, lines = fixtures.create_trench_line_mesh(grid_delta, **kwargs)
    return (vrt.LineMesh(nodes=nodes, lines=lines, grid_delta=grid_delta),
            vrtt.LineMesh(nodes, lines, grid_delta=grid_delta))


def _two_materials(n):
    ids = np.zeros(n, np.int32)
    ids[n // 2:] = 1
    return ids


# ---- host code --------------------------------------------------------------
def test_trench_fixtures_equal_reference_and_face_the_open_side():
    for gd in (0.1, 0.25):
        for got, want in zip(fixtures.create_trench_grid_2d(grid_delta=gd),
                             ref_fixtures.create_trench_grid_2d(grid_delta=gd)):
            np.testing.assert_array_equal(got, want)
    nodes, lines = fixtures.create_trench_line_mesh(0.25)
    assert nodes.dtype == np.float32 and lines.dtype == np.int32
    assert len(lines) == len(nodes) - 1 == 12 + 16 + 16 + 16 + 12
    mesh = vrtt.LineMesh(nodes, lines, grid_delta=0.25)
    mid = 0.5 * (mesh.nodes[mesh.lines[:, 0]] + mesh.nodes[mesh.lines[:, 1]])
    shelf_or_floor = (mid[:, 1] == 0.0) | (mid[:, 1] == -4.0)
    np.testing.assert_array_equal(mesh.normals[shelf_or_floor],
                                  np.tile([0, 1, 0], (shelf_or_floor.sum(), 1)))
    walls = ~shelf_or_floor
    # the left wall looks right, the right wall looks left
    np.testing.assert_array_equal(mesh.normals[walls, 0], -np.sign(mid[walls, 0]))
    # the flagship's line trench: 782 segments, 2 chunks of 512 lanes
    n_fine = len(fixtures.create_trench_line_mesh(0.023)[1])
    assert n_fine == 782 and nearest_hit.auto_pt(n_fine) == 512


@pytest.mark.parametrize("case", ["trench_0.25", "trench_0.023", "flat",
                                  "pad_to_64"])
def test_pack_line_prims_equals_reference(case):
    if case == "flat":
        mesh = _flat_mesh(vrt)
    else:
        mesh = _trench_meshes(0.023 if case == "trench_0.023" else 0.25)[0]
    p0 = mesh.nodes[mesh.lines[:, 0]]
    p1 = mesh.nodes[mesh.lines[:, 1]]
    kwargs = dict(pad_to=64) if case == "pad_to_64" else {}
    got = nearest_hit.pack_line_prims(p0, p1, mesh.normals, **kwargs)
    want = ref_pallas.pack_line_prims(p0, p1, mesh.normals, **kwargs)
    assert nearest_hit.LINE_ROWS == ref_pallas.LINE_ROWS == got[0].shape[0]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # padding lanes sit far away with no direction; chunk boxes reach +-1 in z
    n = len(p0)
    assert (got[0][0:2, n:] == np.float32(1e18)).all()
    assert not got[0][2:, n:].any()
    real = got[2][:, 0] < 1e17
    np.testing.assert_array_equal(got[2][real, 2], -1.0)
    np.testing.assert_array_equal(got[2][real, 5], 1.0)


@pytest.mark.parametrize("materials", [False, True])
def test_line_geometry_equals_reference(materials):
    ref_mesh, mesh = _trench_meshes(0.1)
    ids = _two_materials(len(mesh.lines)) if materials else None
    ref_geo = RefLineGeometry.from_mesh(ref_mesh, material_ids=ids)
    geo = LineGeometry.from_mesh(mesh, material_ids=ids, device="cpu")
    assert geo.kind == "line" and geo.dim == ref_geo.dim == 2
    assert geo.grid_delta == ref_geo.grid_delta
    assert geo.num_primitives == ref_geo.num_primitives == len(mesh.lines)
    assert geo.points is geo.p0 and geo.device.type == "cpu"
    for name, want in reference_line_arrays(ref_geo).items():
        got = getattr(geo, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert (geo.bbox[:, 2] == 0).all() and (geo.p0[:, 2] == 0).all()
    np.testing.assert_allclose(geo.areas.numpy(), 0.1, rtol=1e-5)
    # sorted lane -> original id and back
    n = geo.num_primitives
    np.testing.assert_array_equal(
        geo.soa_perm[geo.soa_inv_perm.long()].numpy(), np.arange(n)
    )
    changed = geo.replace(material_ids=torch.ones(n, dtype=torch.int32))
    assert changed.material_ids.sum() == n and changed.p0 is geo.p0


def test_line_geometry_from_reference_arrays():
    ref_geo = RefLineGeometry.from_mesh(_trench_meshes(0.25)[0])
    geo = port_line_geometry(ref_geo)
    for name in LINE_FIELDS:
        np.testing.assert_array_equal(
            getattr(geo, name).numpy(), np.asarray(getattr(ref_geo, name))
        )
    fields = reference_line_arrays(ref_geo)
    del fields["soa_perm"]
    with pytest.raises(KeyError, match="soa_perm"):
        LineGeometry.from_reference_arrays(fields, grid_delta=0.25,
                                           device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):  # no device named: the CUDA device
            LineGeometry.from_mesh(_trench_meshes(0.25)[1])


# ---- the line search's plain version ------------------------------------------
def _rays_2d(n, seed=0):
    """numpy-seeded rays in the plane z = 0 over the 2D trench: the first
    half from the source line y = 0.5 downwards, the second half from
    anywhere inside the box with any direction."""
    rng = np.random.default_rng(seed)
    org = np.zeros((n, 3), np.float32)
    org[:, 0] = rng.uniform(-5.0, 5.0, n)
    org[:, 1] = rng.uniform(-3.9, 0.4, n)
    ang = rng.uniform(0, 2 * np.pi, n)
    d = np.stack([np.cos(ang), np.sin(ang), 0 * ang], axis=1).astype(np.float32)
    half = n // 2
    org[:half, 1] = 0.5
    d[:half, 1] = -np.abs(d[:half, 1]) - 0.3
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d


@pytest.fixture(scope="module")
def trench():
    """The 72-segment trench in both packages, handed over in packed order
    (where the reference's tie rule, lowest original index, and the port's,
    lowest sorted lane, coincide), with two materials."""
    first = RefLineGeometry.from_mesh(_trench_meshes(0.25)[0])
    order = np.asarray(first.soa_perm)[: first.num_primitives]
    nodes, lines = fixtures.create_trench_line_mesh(0.25)
    ref_mesh = vrt.LineMesh(nodes=nodes, lines=lines[order], grid_delta=0.25)
    ids = _two_materials(len(order))
    ref_geo = RefLineGeometry.from_mesh(ref_mesh, material_ids=ids)
    np.testing.assert_array_equal(
        np.asarray(ref_geo.soa_perm)[: len(order)], np.arange(len(order))
    )
    return ref_geo, port_line_geometry(ref_geo)


def _search(geo, org, d):
    return tuple(x.numpy() for x in nearest_hit.line_nearest_hit_ref(
        torch.from_numpy(org), torch.from_numpy(d), geo.prims_soa,
        geo.soa_perm, geo.soa_chunk_bbs, t_near=1e-4,
    ))


def test_plain_version_matches_reference_search(trench):
    """``hit`` equal on at least 99.9 % of lanes, the segment equal on at
    least 99.9 % of the lanes both hit, t within 1e-6 relative where the
    segment agrees (one reciprocal and a product against a division: a last
    bit)."""
    ref_geo, geo = trench
    org, d = _rays_2d(2048)
    t, prim, hit = _search(geo, org, d)
    t_w, prim_w, hit_w = (np.asarray(x) for x in ref_intersect.line_nearest_hit(
        jnp.asarray(org), jnp.asarray(d), ref_geo.p0, ref_geo.p1, 1e-4,
    ))
    assert (hit == hit_w).mean() >= 0.999
    both = hit & hit_w
    assert 0.5 < both.mean() < 1.0
    same = both & (prim == prim_w)
    assert same.sum() >= 0.999 * both.sum()
    np.testing.assert_allclose(t[same], t_w[same], rtol=1e-6)
    # the answer of a ray does not depend on its batch; any R runs; on CPU
    # tensors the wrapper is the plain version
    args = (geo.prims_soa, geo.soa_perm, geo.soa_chunk_bbs)
    part = nearest_hit.line_nearest_hit(
        torch.from_numpy(org[:777]), torch.from_numpy(d[:777]), *args
    )
    assert nearest_hit.line_nearest_hit.launches == 0
    for got, want in zip(part, (t, prim, hit)):
        np.testing.assert_array_equal(got.numpy(), want[:777])


def _chain(points):
    """A ``LineGeometry`` of the chain through ``points`` (x, y)."""
    nodes = np.c_[np.array(points, np.float32), np.zeros(len(points), np.float32)]
    lines = np.stack([np.arange(len(nodes) - 1), np.arange(1, len(nodes))], 1)
    return LineGeometry.from_mesh(vrtt.LineMesh(nodes, lines, grid_delta=1.0),
                                  device="cpu")


def test_shared_node_parallel_ray_and_t_near():
    """A ray through the node two segments share is clipped off both (s = 1
    on one, s = 0 on the other) and flies on to what lies behind; next to
    the node it hits; a ray along a segment's line (denom = 0) hits
    nothing; a hit closer than t_near does not count. All at oz = 0 with
    dz = 0, the case the search's z slab must survive."""
    # two collinear shelf segments sharing the node (1, 0); a floor below
    geo = _chain([(0, 0), (1, 0), (2, 0)])
    floor = _chain([(0, -1), (2, -1)])
    both = LineGeometry.from_mesh(vrtt.LineMesh(
        np.float32([[0, 0, 0], [1, 0, 0], [2, 0, 0], [0, -1, 0], [2, -1, 0]]),
        np.array([[0, 1], [1, 2], [3, 4]]), grid_delta=1.0), device="cpu")
    assert floor.num_primitives == 1 and geo.num_primitives == 2
    org = np.float32([[1.0, 1.0, 0], [1.001, 1.0, 0], [0.999, 1.0, 0],
                      [-1.0, 0.0, 0], [0.5, 5e-5, 0], [0.5, 2e-4, 0]])
    d = np.float32([[0, -1, 0], [0, -1, 0], [0, -1, 0], [1, 0, 0],
                    [0, -1, 0], [0, -1, 0]])
    t, prim, hit = _search(both, org, d)
    np.testing.assert_array_equal(hit, [True, True, True, False, True, True])
    np.testing.assert_array_equal(prim[[0, 1, 2, 4, 5]], [2, 1, 0, 2, 0])
    np.testing.assert_allclose(t[[0, 1, 2, 4, 5]],
                               [2.0, 1.0, 1.0, 1.00005, 2e-4], rtol=1e-4)
    # without the floor the ray through the node hits nothing at all
    t, prim, hit = _search(geo, org[:1], d[:1])
    assert not hit[0] and t[0] == nearest_hit.BIG
    # the clip's two ends are single float32 values
    assert nearest_hit.LINE_S_MAX.dtype == np.float32
    assert nearest_hit.LINE_S_MAX == np.float32(1 - 1e-5)
    assert nearest_hit.LINE_S_MAX.view(np.uint32) == 0x3F7FFF58


def test_wrapper_refuses_what_the_kernel_does_not_take(trench):
    _, geo = trench
    org, d = (torch.from_numpy(x) for x in _rays_2d(16))
    args = (geo.prims_soa, geo.soa_perm, geo.soa_chunk_bbs)
    with pytest.raises(ValueError):  # a disk table's 8 rows
        nearest_hit.line_nearest_hit(org, d, torch.zeros(8, 512), *args[1:])
    with pytest.raises(TypeError):
        nearest_hit.line_nearest_hit(org.double(), d, *args)
    with pytest.raises(ValueError):
        nearest_hit.line_nearest_hit(org[:, :2], d[:, :2], *args)


# ---- kernel 4 on lines: the bounce ------------------------------------------
@pytest.fixture(scope="module")
def bounce_trench(trench):
    ref_geo, geo = trench
    bbox = adjust_bounding_box(
        np.asarray(ref_geo.bbox), vrtt.TraceDirection.POS_Y,
        ref_geo.grid_delta, 2,
    ).astype(np.float32)
    return ref_geo, geo, bbox


def test_walls_of_lines_carry_no_reach(bounce_trench):
    _, geo, bbox = bounce_trench
    settings = make_settings(DIFFUSE, PERIODIC, dim=2)
    walls = bounce.make_walls(torch.from_numpy(bbox), geo, settings).numpy()
    np.testing.assert_array_equal(
        walls, np.float32([-5, 5, -0.25, 0.25, -4, 0.5, 0, 0, 0])
    )  # in 2D the box reaches one grid_delta to either side in z
    assert bbox[1, 1] == np.float32(0.5)  # y raised by 2 grid_delta


@pytest.mark.parametrize("case", ["diffuse_periodic", "specular_reflective",
                                  "diffuse_ignore"])
def test_one_bounce_handed_out_matches_reference_kernel(bounce_trench, case):
    """Against the megakernel in interpret mode with ``geo_kind="line"``: the
    bounds of ``check_state_and_counts`` (flags, counters and hit segment
    equal on at least 99.9 % of lanes, weight / direction / deposit weight
    within 1e-5, the new origin within 3e-5 of its flight)."""
    ref_geo, geo, bbox = bounce_trench
    kind, bc = {"diffuse_periodic": (DIFFUSE, PERIODIC),
                "specular_reflective": (SPECULAR, REFLECTIVE),
                "diffuse_ignore": (DIFFUSE, IGNORE)}[case]
    settings = make_settings(kind, bc, dim=2)
    walls = bounce.make_walls(torch.from_numpy(bbox), geo, settings)
    arrays = make_state(bbox, 1024, 1, seed=5, dim=2)
    res = bounce.fused_bounce(
        port_state(arrays), torch.from_numpy(arrays[8]), geo, walls, settings,
        n_sub=1, deposit_in_kernel=False,
    )
    ref = reference_bounce(
        ref_geo, walls, arrays, settings, 1, True, geo_kind="line"
    )
    assert res.flux is None and (ref["hit_prim"] >= 0).sum() > 100
    # hfb is dead state on lines: it passes through as it came
    np.testing.assert_array_equal(res.state.hfb.numpy(), arrays[5])
    # the rays stay in the plane
    assert not res.state.org[:, 2].any() and not res.state.dirn[:, 2].any()
    check_state_and_counts(res, ref, arrays[0])


def test_four_bounces_deposits_in_kernel_match_reference_kernel(bounce_trench):
    """Single-hit deposits on both sides: flux rel-L2 < 1e-3 with at most
    two bins off by more than 1e-5 of the largest."""
    ref_geo, geo, bbox = bounce_trench
    settings = make_settings(DIFFUSE, PERIODIC, dim=2)
    walls = bounce.make_walls(torch.from_numpy(bbox), geo, settings)
    arrays = make_state(bbox, 1024, 4, seed=6, dim=2)
    res = bounce.fused_bounce(
        port_state(arrays), torch.from_numpy(arrays[8]), geo, walls, settings,
        n_sub=4, deposit_in_kernel=True,
    )
    ref = reference_bounce(
        ref_geo, walls, arrays, settings, 4, False, geo_kind="line"
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


def test_backface_hit_kills(bounce_trench):
    """Rays that start below the floor and fly up meet it from behind: they
    die there without a deposit, whatever their ``hfb``."""
    _, geo, bbox = bounce_trench
    settings = make_settings(DIFFUSE, PERIODIC, dim=2)
    walls = bounce.make_walls(torch.from_numpy(bbox), geo, settings)
    n = 64
    arrays = list(make_state(bbox, n, 1, seed=7, dim=2))
    arrays[0] = np.tile(np.float32([0.3, -4.2, 0.0]), (n, 1))
    arrays[0][:, 0] = np.linspace(-1.5, 1.5, n) + 0.013
    arrays[1] = np.tile(np.float32([0.0, 1.0, 0.0]), (n, 1))
    arrays[4] = np.ones(n, bool)
    res = bounce.fused_bounce(
        port_state(arrays), torch.from_numpy(arrays[8]), geo, walls, settings,
        n_sub=1, deposit_in_kernel=False,
    )
    assert not res.state.alive.any()
    assert (res.hit_prim == -1).all() and not res.wdep.any()
    # the plain version sweeps no chunks: the two search counts are 0
    assert res.counts.tolist() == [0, 0, 0, n, 0, 0, 0, 0]


@pytest.mark.parametrize("k", [4, 16])
def test_n_sub_equals_repeated_single_bounces(bounce_trench, k):
    """State and counts bit for bit, the flux to float32 rounding."""
    _, geo, bbox = bounce_trench
    settings = make_settings(DIFFUSE, PERIODIC, dim=2)
    walls = bounce.make_walls(torch.from_numpy(bbox), geo, settings)
    arrays = make_state(bbox, 1000, k, seed=9, dim=2)  # a ragged R
    uniforms = torch.from_numpy(arrays[8])
    whole = bounce.fused_bounce(
        port_state(arrays), uniforms, geo, walls, settings, n_sub=k
    )
    state = port_state(arrays)
    counts = torch.zeros(bounce.N_EVENTS, dtype=torch.int64)
    flux = torch.zeros(geo.num_primitives, dtype=torch.float64)
    for j in range(k):
        step = bounce.fused_bounce(
            state, uniforms[:, 3 * j: 3 * j + 3].contiguous(), geo, walls,
            settings, n_sub=1,
        )
        state = step.state
        counts += step.counts[:bounce.N_EVENTS]
        flux += step.flux.double()
    for got, want in zip(whole.state, state):
        assert torch.equal(got, want)
    assert torch.equal(whole.counts[:bounce.N_EVENTS], counts)
    assert whole.counts[bounce.N_EVENTS] == state.alive.sum()
    assert flux.sum() > 100
    np.testing.assert_allclose(whole.flux.numpy(), flux.numpy(), rtol=1e-6)


def test_lines_deposit_in_the_kernel_and_as_single_hits(bounce_trench):
    """A line launch never hands its deposits out, whatever the chunk count
    and the particle (the reference's rule would, for a diffuse launch on 4
    chunks or more); handed out all the same, a ray's entry is its hit
    segment alone."""
    _, geo, _ = bounce_trench
    for n_chunks in (1, 4, 25):
        for kind in (DIFFUSE, SPECULAR, vrtt.ReflectionKind.CONED_COSINE):
            for n_sub in (1, 4):
                assert not hand_out_for("line", n_chunks, kind, n_sub)
    hit_prim = torch.tensor([3, -1, 7], dtype=torch.int32)
    wdep = torch.tensor([0.5, 0.0, 0.25])
    ids, w = bounce.deposit_entries(None, None, hit_prim, wdep, geo)
    assert ids.tolist() == [3, 0, 7] and torch.equal(w, wdep)


@pytest.mark.parametrize("per_material", [False, True])
def test_fused_equals_unfused_with_one_bounce_per_launch(per_material):
    """With n_sub = (1, 1, 1) and ``GeneratorRNG`` both bodies draw the same
    numbers in the same order and go through one step function and the exact
    histogram: counters equal, flux bitwise equal."""
    mesh = _trench_meshes(0.1)[1]
    geo = LineGeometry.from_mesh(
        mesh, material_ids=_two_materials(len(mesh.lines)), device="cpu"
    )
    bbox = torch.from_numpy(adjust_bounding_box(
        geo.bbox.numpy(), vrtt.TraceDirection.POS_Y, geo.grid_delta, 2,
    ).astype(np.float32))
    R = 4096
    config = vrtt.TraceConfig(
        dim=2, boundary_conditions=(PERIODIC,) * 3, ray_batch_size=R,
        source_direction=vrtt.TraceDirection.POS_Y,
    )
    source = RandomSource(
        bbox=bbox, cosine_power=1.0, ray_dir=1, first_dir=0, second_dir=2,
        min_max=1, pos_neg=-1.0, dim=2,
    )
    particle = vrtt.DiffuseParticle(
        0.2, material_sticking=[0.5, 0.1] if per_material else None
    )
    runs = []
    for kwargs in (dict(fused=False), dict(fused=True, n_sub=(1, 1, 1))):
        rng = GeneratorRNG(21, "cpu")
        rng.begin_batch(0)
        runs.append(trace_batch(
            geo, source, particle, bbox, rng, 0, torch.arange(R),
            torch.ones(R, dtype=torch.bool), config, **kwargs,
        ))
    (flux_u, cnt_u), (flux_f, cnt_f) = runs
    assert cnt_u == cnt_f and cnt_u.geometry_hits > 4000
    assert torch.equal(flux_u, flux_f)
    assert trace_kernel._SEARCH["line"] is nearest_hit.line_nearest_hit


# ---- TraceLine end to end ---------------------------------------------------
def _line_tracer(module, mesh, bc, rays, seed, sticking=1.0, material_ids=None,
                 direction=None, **kwargs):
    t = module.TraceLine(**kwargs)
    t.set_geometry(mesh, material_ids=material_ids)
    t.set_boundary_conditions([module.BoundaryCondition[bc]] * 2)
    t.set_particle_type(sticking if not isinstance(sticking, float)
                        else module.DiffuseParticle(sticking, "flux"))
    t.set_source_direction(module.TraceDirection[direction or "POS_Y"])
    t.set_number_of_rays_fixed(rays)
    t.set_rng_seed(seed)
    t.set_ray_batch_size(8192)
    return t


@pytest.mark.parametrize("fused", [True, False])
def test_line_uniform_flux(fused):
    """Flat segment chain under cosine illumination -> normalized flux ~ 1
    (``tests/test_line_tracer.py::test_line_uniform_flux`` through the
    port, both bodies)."""
    t = _line_tracer(vrtt, _flat_mesh(vrtt), "REFLECTIVE", 100_000, 13,
                     device="cpu", fused=fused)
    flux = t.apply()
    info = t.get_ray_trace_info()
    assert info.geometry_hits > 0.98 * info.num_rays
    norm = t.normalize_flux(flux)
    np.testing.assert_allclose(norm.mean(), 1.0, rtol=0.05)
    assert norm.std() < 0.1
    assert flux.dtype == np.float64 and flux.shape == (20,)
    np.testing.assert_array_equal(
        t.get_local_data().get_vector_data("flux"), flux
    )
    # MAX normalization goes by length; smoothing is not implemented
    norm_max = t.normalize_flux(flux, vrtt.NormalizationType.MAX)
    np.testing.assert_allclose(
        norm_max, flux / (flux.max() * 0.2), rtol=1e-5
    )
    assert t.smooth_flux(flux) is not None
    np.testing.assert_array_equal(t.smooth_flux(flux), flux)


def test_line_matches_extruded_triangles():
    """The native segment path and the extrusion path agree
    (``tests/test_line_tracer.py::test_line_matches_extruded_triangles``
    through the port)."""
    mesh = _flat_mesh(vrtt, extent=2.0, seg=0.25)
    t_line = _line_tracer(vrtt, mesh, "PERIODIC", 60_000, 3, device="cpu")
    norm_line = t_line.normalize_flux(t_line.apply())
    t_tri = vrtt.TraceTriangle(dim=2, device="cpu")
    t_tri.set_geometry(mesh)
    t_tri.set_boundary_conditions([PERIODIC] * 2)
    t_tri.set_particle_type(vrtt.DiffuseParticle(1.0, "flux"))
    t_tri.set_source_direction(vrtt.TraceDirection.POS_Y)
    t_tri.set_number_of_rays_fixed(60_000)
    t_tri.set_rng_seed(3)
    t_tri.set_ray_batch_size(8192)
    norm_tri = t_tri.normalize_flux(t_tri.apply())
    per_line_tri = 0.5 * (norm_tri[0::2] + norm_tri[1::2])
    np.testing.assert_allclose(norm_line.mean(), per_line_tri.mean(), rtol=0.05)
    assert _rel_l2(norm_line, per_line_tri) < 0.1


def test_line_backface_kill():
    """Rays hitting segments from behind are terminated
    (``tests/test_line_tracer.py::test_line_backface_kill`` through the
    port)."""
    t = _line_tracer(vrtt, _flat_mesh(vrtt), "IGNORE", 20_000, 5,
                     direction="NEG_Y", device="cpu")
    flux = t.apply()
    info = t.get_ray_trace_info()
    assert info.geometry_hits == 0 and flux.sum() == 0
    assert info.total_rays_traced == info.num_rays == 20_000


def test_trace_line_agrees_with_reference():
    """Port against reference on the two-material trench at 20,000 rays:
    hits per ray within 5 %, normalized flux within the noise of two samples
    of 20,000 rays on 72 segments (rel-L2 < 0.15; two seeds of the port
    alone differ by about 0.08)."""
    ref_mesh, mesh = _trench_meshes(0.25)
    ids = _two_materials(len(mesh.lines))
    results = {}
    for name, module, m, kwargs in (
        ("ref", vrt, ref_mesh, {}),
        ("port", vrtt, mesh, dict(device="cpu")),
        ("port_unfused", vrtt, mesh, dict(device="cpu", fused=False)),
    ):
        particle = module.DiffuseParticle(
            0.5, "flux", material_sticking=[0.5, 0.1]
        )
        t = _line_tracer(module, m, "PERIODIC", 20_000, 11, sticking=particle,
                         material_ids=ids, **kwargs)
        norm = np.asarray(t.normalize_flux(t.apply()), np.float64)
        info = t.get_ray_trace_info()
        results[name] = (norm, info.geometry_hits / info.num_rays)
    for name in ("port", "port_unfused"):
        assert abs(results[name][1] / results["ref"][1] - 1) <= 0.05
        assert _rel_l2(results[name][0], results["ref"][0]) < 0.15
    assert results["ref"][1] > 1.3  # the weaker material reflects on


def test_trace_line_agrees_with_oracle():
    """``TraceLine`` on a small two-material trench against the scalar
    oracle, which traces the mesh extruded to triangle pairs in 2D with each
    pair's sticking that of its segment: hits per ray within 2 %, normalized
    flux rel-L2 < 0.1 (100,000 rays on 72 segments against 400,000)."""
    if not oracle_available():
        pytest.skip("the oracle needs g++")
    _, mesh = _trench_meshes(0.25)
    ids = _two_materials(len(mesh.lines))
    table = np.float64([0.5, 0.1])
    pairs = lines_to_triangles(mesh)
    n_oracle = 400_000
    flux_o, counters = oracle_ref.trace_tris_oracle(
        pairs.nodes, pairs.triangles, dim=2, grid_delta=0.25,
        num_rays=n_oracle, sticking=np.repeat(table[ids], 2), seed=5,
        boundary=("periodic", "periodic"), reflection="diffuse",
    )
    lengths = 0.25
    norm_o = (flux_o[0::2] + flux_o[1::2]) * (10.0 / n_oracle) / lengths
    t = _line_tracer(
        vrtt, mesh, "PERIODIC", 100_000, 17, material_ids=ids, device="cpu",
        sticking=vrtt.DiffuseParticle(0.5, "flux", material_sticking=[0.5, 0.1]),
    )
    t.set_ray_batch_size(1 << 15)
    norm = t.normalize_flux(t.apply())
    info = t.get_ray_trace_info()
    want = counters["geometry_hits"] / n_oracle
    assert abs(info.geometry_hits / info.num_rays - want) <= 0.02 * want
    assert _rel_l2(norm, norm_o) < 0.1


def test_trace_line_setters_and_errors():
    t = vrtt.TraceLine(device="cpu")
    t.set_particle_type(vrtt.DiffuseParticle(1.0))
    with pytest.raises(ValueError, match="geometry"):
        t.apply()
    mesh = _flat_mesh(vrtt)
    t.set_geometry(mesh)
    t.set_material_ids(np.ones(20))
    assert t.geometry.material_ids.dtype == torch.int32
    assert t.geometry.material_ids.sum() == 20
    t._particle = None
    with pytest.raises(ValueError, match="particle"):
        t.apply()
    with pytest.raises(NotImplementedError):
        vrtt.TraceLine(device="cpu", dtype=torch.float64)
    # the window flux model is a disk model: a line trace ignores it and
    # traces exactly as under the neighbor model (as the reference does,
    # kernel.py:751)
    fluxes = {}
    for model in ("neighbor", "window"):
        t = vrtt.TraceLine(device="cpu")
        t.set_geometry(mesh)
        t.set_particle_type(vrtt.DiffuseParticle(0.5))
        t.set_number_of_rays_per_point(50)
        t.set_rng_seed(5)
        t.set_flux_model(model)
        fluxes[model] = t.apply()
    assert fluxes["neighbor"].sum() > 0
    assert np.array_equal(fluxes["neighbor"], fluxes["window"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            vrtt.TraceLine()
