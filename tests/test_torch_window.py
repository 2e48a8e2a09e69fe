"""The window flux model and 1/distance weighting of the port against the JAX
package's, at small sizes on the CPU: the window list, one bounce against the
megakernel in interpret mode (its window deposit pass), the unfused window
deposit, one mega-batch lane by lane, and the dispatch (window on triangles
and lines, ``use_wdist`` on the unfused body).

On the CPU the port's wrappers run their plain versions; the CUDA kernel is
held to its plain version on the card by ``chip_smoke.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viennaray_tpu as vrt
from viennaray_tpu.ops import intersect as ref_intersect
from viennaray_tpu.trace import kernel as ref_kernel

import viennaray_tpu_torch as vrtt
from viennaray_tpu_torch.config import adjust_bounding_box
from viennaray_tpu_torch.geometry.disk_geometry import DiskGeometry
from viennaray_tpu_torch.geometry.triangle_geometry import TriangleGeometry
from viennaray_tpu_torch.io import fixtures
from viennaray_tpu_torch.ops import bounce, intersect, nearest_hit
from viennaray_tpu_torch.physics.source import RandomSource
from viennaray_tpu_torch.rng import GeneratorRNG
from viennaray_tpu_torch.trace import kernel as trace_kernel
from viennaray_tpu_torch.trace.kernel import trace_batch

from torch_port_helpers import (
    check_state_and_counts,
    lane_matched_batch,
    make_settings,
    make_state,
    port_geometry,
    port_state,
    reference_bounce,
    reference_geometry,
)

torch.set_num_threads(1)

DIFFUSE = vrtt.ReflectionKind.DIFFUSE
PERIODIC = vrtt.BoundaryCondition.PERIODIC


def _rel_l2(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


def _window(settings):
    return settings._replace(window=True)


# ---- the window list ---------------------------------------------------------
def _clouds():
    return {
        "trench_3d": (lambda: fixtures.create_trench_grid_3d(grid_delta=0.5),
                      0.5, 3),
        "trench_3d_fine": (
            lambda: fixtures.create_trench_grid_3d(grid_delta=0.25), 0.25, 3),
        "trench_2d": (lambda: fixtures.create_trench_grid_2d(0.1), 0.1, 2),
    }


@pytest.mark.parametrize("cloud", sorted(_clouds()))
def test_window_list_holds_every_window_disk(cloud):
    """For seeded rays the closest hit of the search, then every disk the
    ray crosses with t_near < t <= t_hit + tau: over ALL disks by brute
    force, and over the hit disk's window list, in the port's arithmetic.
    The two deposit sets are equal ray by ray, bit for bit, and the hit disk
    is always among them."""
    make, grid_delta, dim = _clouds()[cloud]
    pts, nrm = make()
    geo = DiskGeometry.build(pts, nrm, grid_delta, dim=dim,
                             device="cpu").with_window_list()
    n = geo.num_primitives
    W = geo.window_ids.shape[1]
    ids = geo.window_ids
    assert torch.equal(ids[:, 0], torch.arange(n, dtype=torch.int32))
    direction = vrtt.TraceDirection.POS_Z if dim == 3 else vrtt.TraceDirection.POS_Y
    bbox = adjust_bounding_box(geo.bbox.numpy(), direction, geo.disk_radius,
                               dim).astype(np.float32)
    arrays = make_state(bbox, 2048, 1, seed=5, dim=dim)
    org, dirn = torch.from_numpy(arrays[0]), torch.from_numpy(arrays[1])
    t_near = 1e-4
    t_hit, prim, hit = nearest_hit.disk_nearest_hit_ref(
        org, dirn, geo.prims_soa, geo.soa_perm, t_near=t_near)
    assert hit.sum() > 500
    org, dirn, t_hit, prim = org[hit], dirn[hit], t_hit[hit], prim[hit].long()
    R = org.shape[0]
    tlim = t_hit + torch.tensor(geo.window_tau, dtype=torch.float32)
    # brute force: every disk's SoA column, in original numbering
    cols = geo.prims_soa.T[geo.soa_inv_perm.long()]
    ok_all, t_all = intersect.disk_hit_packed(
        org, dirn, cols[None].expand(R, n, 8), t_near)
    want = ok_all & (t_all <= tlim[:, None])
    # the window list
    rec = geo.window_pack[prim].reshape(R, W, 8)
    ok, t = intersect.disk_hit_packed(org, dirn, rec, t_near)
    ok = ok & (t <= tlim[:, None])
    got = torch.zeros(R, n, dtype=torch.bool)
    rows = torch.arange(R)[:, None].expand(R, W)
    slot = ids[prim].long()
    got[rows[ok], slot[ok]] = True
    assert torch.equal(got, want)
    assert got[torch.arange(R), prim].all()
    # the window reaches past the neighbor list: some deposits land outside
    assert (want.sum(dim=1) > 1).any()


def test_window_tables_come_from_the_soa_columns():
    """The records are the SoA's columns bit for bit, padding is zeros, and a
    geometry built from the reference's tables gets the same list."""
    _, _, _, ref_geo = reference_geometry("trench_0.5")
    geo = port_geometry(ref_geo).with_window_list()
    assert geo.with_window_list() is geo
    n, W = geo.window_ids.shape
    rec = geo.window_pack.reshape(n, W, 8)
    real = geo.window_ids >= 0
    cols = geo.prims_soa.T[geo.soa_inv_perm.long()]
    assert torch.equal(rec[real], cols[geo.window_ids[real].long()])
    assert not rec[~real].any()
    # every pair within the radius is listed, both ways
    pts = geo.points.double()
    d = torch.cdist(pts, pts)
    close = d <= geo.window_radius()
    listed = torch.zeros(n, n, dtype=torch.bool)
    rows = torch.arange(n)[:, None].expand(n, W)
    listed[rows[real], geo.window_ids[real].long()] = True
    assert torch.equal(listed, close)


# ---- one bounce against the megakernel --------------------------------------
@pytest.fixture(scope="module")
def disks():
    _, _, _, ref_geo = reference_geometry("trench_0.5")
    ref_geo = ref_geo.with_areas((0, 1), [vrt.BoundaryCondition.PERIODIC] * 3)
    geo = port_geometry(ref_geo).with_window_list()
    bbox = adjust_bounding_box(
        np.asarray(ref_geo.bbox), vrtt.TraceDirection.POS_Z,
        ref_geo.disk_radius, 3,
    ).astype(np.float32)
    return ref_geo, geo, bbox


@pytest.mark.parametrize("n_sub", [1, 4])
def test_window_bounce_matches_reference_kernel(n_sub, disks):
    """The window form of one launch against the megakernel's window deposit
    pass (deposits in the kernel; the reference hands none out): flags and
    counters on at least 99.9 % of lanes and the state within the bounds of
    ``check_state_and_counts``; flux rel-L2 < 1e-3 with one bounce and < 2e-2
    with four, the bounds of the earlier launches (the reference's approximate
    reciprocal moves a t by up to 1.4e-5 relative, which flips a rare disk's
    rim or its t <= t_hit + tau; over four bounces a flipped ray goes
    elsewhere)."""
    ref_geo, geo, bbox = disks
    settings = _window(make_settings(DIFFUSE, PERIODIC))
    walls = bounce.make_walls(torch.from_numpy(bbox), geo, settings)
    arrays = make_state(bbox, 1024, n_sub, seed=31 + n_sub)
    res = bounce.fused_bounce(
        port_state(arrays), torch.from_numpy(arrays[8]), geo, walls, settings,
        n_sub=n_sub, deposit_in_kernel=True,
    )
    ref = reference_bounce(ref_geo, walls, arrays, settings, n_sub, False,
                           flux_model="window")
    flight = None if n_sub == 1 else n_sub * np.linalg.norm(bbox[1] - bbox[0])
    check_state_and_counts(res, ref, arrays[0], flight=flight)
    assert _rel_l2(res.flux.numpy(), ref["flux"]) < (1e-3 if n_sub == 1 else 2e-2)
    # the same events under the neighbor model, other deposits
    neighbor = bounce.fused_bounce(
        port_state(arrays), torch.from_numpy(arrays[8]), geo, walls,
        settings._replace(window=False), n_sub=n_sub,
    )
    assert torch.equal(neighbor.counts, res.counts)
    assert not torch.allclose(neighbor.flux, res.flux)


def test_window_deposits_match_reference_disk_window_deposit(disks):
    """The unfused window deposit (the window list re-tested with the search's
    arithmetic, landed by the histogram) against the reference's
    ``intersect.disk_window_deposit`` (a sweep over every disk by matrix
    products) on one bounce's colliding rays: at most two bins off by more
    than 1e-5 of the largest, rel-L2 < 1e-2 (one ray's weight in a bin of
    several). Why not equal: the reference computes the in-plane distance as
    |o|^2 - 2 o.c + |c|^2 + ..., which cancels to within about 1e-5 of r^2,
    so a ray that grazes a rim can land on the other side (measured: one
    ray of 4,096, 7.5e-8 outside a rim in float64, in one bin)."""
    ref_geo, geo, bbox = disks
    settings = _window(make_settings(DIFFUSE, PERIODIC))
    walls = bounce.make_walls(torch.from_numpy(bbox), geo, settings)
    arrays = make_state(bbox, 4096, 1, seed=41)
    state = port_state(arrays)
    _, hit_prim, wdep, t_hit, _ = bounce.bounce_step(
        state, torch.from_numpy(arrays[8]), geo, walls, settings,
        nearest_hit.disk_nearest_hit_ref,
    )
    assert (hit_prim >= 0).sum() > 1000
    ids, w = bounce.deposit_entries(state.org, state.dirn, hit_prim, wdep, geo,
                                    t_hit, settings)
    got = torch.zeros(geo.num_primitives, dtype=torch.float64)
    got.index_add_(0, ids.long(), w.double())
    tlim = np.where(hit_prim.numpy() >= 0,
                    t_hit.numpy() + np.float32(geo.window_tau), -3.4e38)
    want = np.asarray(ref_intersect.disk_window_deposit(
        jnp.asarray(arrays[0]), jnp.asarray(arrays[1]), ref_geo.points,
        ref_geo.normals, ref_geo.radii, jnp.asarray(tlim, jnp.float32),
        jnp.asarray(wdep.numpy()), settings.t_near,
    ))
    got = got.numpy()
    assert (np.abs(got - want) > 1e-5 * want.max()).sum() <= 2
    assert _rel_l2(got, want) < 1e-2


def test_window_bounce_hands_out_what_it_deposits(disks):
    """The plain version of a window launch handed out (hit disk, weight and
    hit time) lands, through ``deposit_entries``, exactly the flux it
    deposits in the kernel; and the wrapper wants the window list."""
    _, geo, bbox = disks
    settings = _window(make_settings(DIFFUSE, PERIODIC))
    walls = bounce.make_walls(torch.from_numpy(bbox), geo, settings)
    arrays = make_state(bbox, 1024, 1, seed=43)
    args = (port_state(arrays), torch.from_numpy(arrays[8]), geo, walls,
            settings)
    inside = bounce.fused_bounce(*args, deposit_in_kernel=True)
    out = bounce.fused_bounce(*args, deposit_in_kernel=False)
    assert out.t_hit is not None
    assert torch.equal(out.t_hit == 0, out.hit_prim < 0)
    ids, w = bounce.deposit_entries(args[0].org, args[0].dirn, out.hit_prim,
                                    out.wdep, geo, out.t_hit, settings)
    landed = torch.zeros(geo.num_primitives, dtype=torch.float64)
    landed.index_add_(0, ids.long(), w.double())
    assert torch.equal(landed.float(), inside.flux)
    with pytest.raises(ValueError, match="window list"):
        bounce.fused_bounce(port_state(arrays), args[1],
                            geo.replace(window_ids=None, window_pack=None),
                            walls, settings)


# ---- one mega-batch ----------------------------------------------------------
def test_trace_batch_unfused_window_lane_matched_with_reference():
    """The port's unfused window body against the reference's over the whole
    ladder, lane by lane under the reference's uniforms: every counter equal
    and flux rel-L2 < 1e-6 (bins would differ where the reference's expanded
    distance flips a grazing ray; measured on this seed: 1.6e-8, no bin off
    by more than 1e-5 of the largest)."""
    flux, cnt, ref_flux, ref_cnt = lane_matched_batch(
        vrt.DiffuseParticle(0.2, "flux"), vrtt.DiffuseParticle(0.2, "flux"),
        ref_kernel.EnvKnobs(fused=False), flux_model="window", fused=False,
    )
    for name in ("total_traces", "geometry_hits", "boundary_hits",
                 "non_geometry_hits"):
        assert getattr(cnt, name) == int(getattr(ref_cnt, name)) > 300, name
    assert _rel_l2(flux, ref_flux) < 1e-6


def test_trace_batch_use_wdist_lane_matched_with_reference():
    """1/distance weighting on the unfused body against the reference's:
    every counter equal, flux rel-L2 < 1e-5 (float32 sums of up to K + 1
    weights in another order, measured 3.7e-7)."""
    flux, cnt, ref_flux, ref_cnt = lane_matched_batch(
        vrt.DiffuseParticle(0.2, "flux"), vrtt.DiffuseParticle(0.2, "flux"),
        ref_kernel.EnvKnobs(fused=False), use_wdist=True, fused=False,
    )
    for name in ("total_traces", "geometry_hits", "boundary_hits",
                 "non_geometry_hits"):
        assert getattr(cnt, name) == int(getattr(ref_cnt, name)) > 300, name
    assert _rel_l2(flux, ref_flux) < 1e-5


def _batch(kind="disk", dim=3, **config_kw):
    """Geometry, adjusted box, source and config of a 4,096-ray batch on the
    3D trench at grid delta 0.5, the 2D trench at 0.1, or the 3D trench mesh."""
    if dim == 2:
        pts, nrm = fixtures.create_trench_grid_2d(0.1)
        geo = DiskGeometry.build(pts, nrm, 0.1, dim=2, device="cpu")
        direction, axes = vrtt.TraceDirection.POS_Y, dict(ray_dir=1,
                                                          first_dir=0,
                                                          second_dir=2)
    elif kind == "disk":
        pts, nrm = fixtures.create_trench_grid_3d(grid_delta=0.5)
        geo = DiskGeometry.build(pts, nrm, 0.5, device="cpu")
        direction, axes = vrtt.TraceDirection.POS_Z, dict(ray_dir=2,
                                                          first_dir=0,
                                                          second_dir=1)
    else:
        geo = TriangleGeometry.build(
            *fixtures.create_trench_mesh_3d(grid_delta=0.5), 0.5, device="cpu")
        direction, axes = vrtt.TraceDirection.POS_Z, dict(ray_dir=2,
                                                          first_dir=0,
                                                          second_dir=1)
    margin = geo.disk_radius if kind == "disk" else geo.grid_delta
    bbox = torch.from_numpy(adjust_bounding_box(
        geo.bbox.numpy(), direction, margin, dim).astype(np.float32))
    config = vrtt.TraceConfig(dim=dim, boundary_conditions=(PERIODIC,) * 3,
                              ray_batch_size=4096, source_direction=direction,
                              **config_kw)
    source = RandomSource(bbox=bbox, cosine_power=1.0, min_max=1, pos_neg=-1.0,
                          dim=dim, **axes)
    return geo, bbox, source, config


def _run(geo, bbox, source, config, particle=None, seed=33, **kwargs):
    R = 4096
    rng = GeneratorRNG(seed, "cpu")
    rng.begin_batch(0)
    return trace_batch(
        geo, source, particle or vrtt.DiffuseParticle(0.2), bbox, rng, 0,
        torch.arange(R), torch.ones(R, dtype=torch.bool), config, **kwargs,
    )


@pytest.mark.parametrize("dim,placement", [(3, "in_kernel"), (3, "handed_out"),
                                           (2, "in_kernel")])
def test_window_fused_equals_unfused_with_one_bounce_per_launch(
        dim, placement, monkeypatch):
    """With one bounce per launch and ``GeneratorRNG`` both bodies draw the
    same numbers and run one step function: counters equal and flux bitwise
    equal, with the window deposits in the kernel (the rule: a window launch
    never hands out) and, as the A/B of ``chip_diagnose.py --window`` runs
    it, handed out to the histogram."""
    assert not trace_kernel.hand_out_for("window", 6, DIFFUSE, 1)
    if placement == "handed_out":
        monkeypatch.setattr(trace_kernel, "hand_out_for",
                            lambda kind, chunks, refl, k: k == 1)
    geo, bbox, source, config = _batch(dim=dim, flux_model="window")
    flux_u, cnt_u = _run(geo, bbox, source, config, fused=False)
    flux_f, cnt_f = _run(geo, bbox, source, config, fused=True, n_sub=(1, 1, 1))
    assert cnt_u == cnt_f and cnt_u.geometry_hits > 2000
    assert torch.equal(flux_u, flux_f) and flux_u.sum() > 1000


def test_window_deposits_more_than_neighbor_on_2d_trench():
    """As the reference asserts of itself (tests/test_round3_features.py:
    18-39): on the 2D trench at grid delta 0.1 the window model deposits
    more than the neighbor model on the same rays, with the same events."""
    geo, bbox, source, config = _batch(dim=2)
    flux_nb, cnt_nb = _run(geo, bbox, source, config)
    flux_w, cnt_w = _run(geo, bbox, source,
                         dataclasses.replace(config, flux_model="window"))
    assert cnt_w == cnt_nb
    assert float(flux_w.sum()) > float(flux_nb.sum()) > 0


def test_use_wdist_runs_unfused_and_conserves_weight(monkeypatch):
    """1/distance weighting runs the unfused body whatever ``fused`` says
    (kernels 1 and 2, no bounce kernel: the wrapper is never reached), moves
    weight between the disks of a deposit and keeps its total (the
    reference's tests/test_features.py:145-160)."""
    geo, bbox, source, config = _batch()
    flux_p, cnt_p = _run(geo, bbox, source, config, fused=False)

    def no_bounce_kernel(*args, **kwargs):
        raise AssertionError("use_wdist must not reach the bounce kernel")

    monkeypatch.setattr(trace_kernel, "fused_bounce", no_bounce_kernel)
    wdist = dataclasses.replace(config, use_wdist=True)
    flux_w, cnt_w = _run(geo, bbox, source, wdist, fused=True)
    flux_u, cnt_u = _run(geo, bbox, source, wdist, fused=False)
    assert torch.equal(flux_w, flux_u) and cnt_w == cnt_u == cnt_p
    np.testing.assert_allclose(float(flux_w.sum()), float(flux_p.sum()),
                               rtol=1e-3)
    assert not torch.allclose(flux_w, flux_p)


def test_window_with_wdist_raises_and_the_setters_take_both():
    t = vrtt.TraceDisk(dim=3, device="cpu")
    t.set_geometry(*fixtures.create_plane_grid(0.5, 2.0), 0.5)
    t.set_particle_type(vrtt.DiffuseParticle(0.5))
    t.set_number_of_rays_per_point(5)
    t.set_flux_model("window")
    flux = t.apply()
    assert t.geometry.window_pack is not None and flux.sum() > 0
    t.set_use_wdist(True)
    with pytest.raises(NotImplementedError, match="use_wdist"):
        t.apply()
    t.set_flux_model("neighbor")
    assert t.apply().sum() > 0
    with pytest.raises(ValueError):
        t.set_flux_model("nearest")


def test_trace_triangle_ignores_the_window_model():
    """The flux model is a disk model (the reference reads it in its disk
    branch only, kernel.py:751): a triangle trace under "window" is bitwise
    the trace under "neighbor", on both bodies."""
    for fused in (True, False):
        geo, bbox, source, config = _batch(kind="triangle")
        runs = [_run(geo, bbox, source,
                     dataclasses.replace(config, flux_model=m), fused=fused)
                for m in ("neighbor", "window")]
        assert runs[0][1] == runs[1][1] and runs[0][1].geometry_hits > 1000
        assert torch.equal(runs[0][0], runs[1][0])
