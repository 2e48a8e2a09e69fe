"""What the port's tracers take since they were repaired, held to the JAX
package on the CPU at small sizes:

- ``set_f64_accumulation``: the batches' fluxes summed in float64 (the
  default) or in float32 in batch order, against the JAX package's tracer
  under the same setting, lane-matched (the reference's own uniforms through
  ``JaxKeyedRNG``, the cloud in packed order, both on the unfused body);
- several data labels on a built-in particle: one flux channel, which the
  first label receives, and zeros under the others;
- ``TraceInfo.chunks_swept``, ``chunks_deposited`` and ``tile_bounces``;
- the two choices the wrappers make that the CPU can check: the bounce
  kernel's threads per ray (``group_for``) and the histogram kernel's path
  (``path_for``).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import viennaray_tpu as vrt

import viennaray_tpu_torch as vrtt
from viennaray_tpu_torch.io import fixtures
from viennaray_tpu_torch.ops import bounce, histogram
from viennaray_tpu_torch.trace import tracer as port_tracer
from viennaray_tpu_torch.trace.kernel import MIN_STAGE, N_SUB, n_sub_for

from torch_port_helpers import JaxKeyedRNG, reference_geometry

torch.set_num_threads(1)

SEED = 5
BATCH = 2048
RAYS = 3 * BATCH + 100  # four batches, the last one mostly dead
LABELS = ("flux", "energy")


def _rel_l2(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


def _packed_cloud():
    """The 209-disk trench in the order the packer puts it, where the
    reference's brute-force tie rule and the port's sorted-lane rule pick
    the same disk (``test_torch_trace.py:_lane_matched``)."""
    pts, nrm, grid_delta, first_build = reference_geometry("trench_1.0")
    order = np.asarray(first_build.soa_perm)[: len(pts)]
    return pts[order], nrm[order], grid_delta


def _configure(t, module, particle, rays=RAYS):
    t.set_boundary_conditions([module.BoundaryCondition.PERIODIC] * 3)
    t.set_particle_type(particle)
    t.set_number_of_rays_fixed(rays)
    t.set_rng_seed(SEED)
    t.set_ray_batch_size(BATCH)
    return t


def _reference_run(f64, labels=("flux",)):
    """The JAX package's ``TraceDisk`` on its unfused body."""
    pts, nrm, grid_delta = _packed_cloud()
    t = vrt.TraceDisk(dim=3)
    t.set_geometry(pts, nrm, grid_delta)
    _configure(t, vrt, vrt.DiffuseParticle(0.1).replace(data_labels=labels))
    t.set_f64_accumulation(f64)
    flux = np.asarray(t.apply(), np.float64)
    return flux, t.get_ray_trace_info(), t.get_local_data()


def _jax_keyed(seed, device):
    return JaxKeyedRNG(jax.random.PRNGKey(seed))


def _port_run(make, f64=None, labels=("flux",), lane_matched=False):
    """One apply of ``make()``'s port tracer on the CPU; returns (flux,
    TraceInfo, local data, the batches' own fluxes in order). With
    ``lane_matched`` it draws the JAX package's uniforms."""
    batches = []
    real = port_tracer.trace_batch

    def recording(*args, **kwargs):
        flux, counters = real(*args, **kwargs)
        batches.append(flux.numpy().copy())
        return flux, counters

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_tracer, "trace_batch", recording)
        if lane_matched:
            mp.setattr(port_tracer, "GeneratorRNG", _jax_keyed)
        t = make(labels)
        if f64 is not None:
            t.set_f64_accumulation(f64)
        flux = t.apply()
    return flux, t.get_ray_trace_info(), t.get_local_data(), batches


def _port_disks(labels, fused=False, rays=RAYS):
    pts, nrm, grid_delta = _packed_cloud()
    t = vrtt.TraceDisk(dim=3, device="cpu", fused=fused)
    t.set_geometry(pts, nrm, grid_delta)
    particle = dataclasses.replace(vrtt.DiffuseParticle(0.1),
                                   data_labels=labels)
    return _configure(t, vrtt, particle, rays)


def _port_triangles(labels, fused=False, rays=RAYS):
    verts, tris = fixtures.create_trench_mesh_3d(grid_delta=1.0)
    t = vrtt.TraceTriangle(dim=3, device="cpu", fused=fused)
    t.set_geometry(verts, tris, 1.0)
    particle = dataclasses.replace(vrtt.DiffuseParticle(0.2),
                                   data_labels=labels)
    return _configure(t, vrtt, particle, rays)


def _port_lines(labels, fused=False, rays=RAYS):
    nodes, lines = fixtures.create_trench_line_mesh(0.5)
    t = vrtt.TraceLine(device="cpu", fused=fused)
    t.set_geometry(vrtt.LineMesh(nodes, lines, grid_delta=0.5))
    particle = dataclasses.replace(vrtt.DiffuseParticle(0.3),
                                   data_labels=labels)
    return _configure(t, vrtt, particle, rays)


TRACERS = {"disks": _port_disks, "triangles": _port_triangles,
           "lines": _port_lines}


@pytest.fixture(scope="module")
def lane_matched_runs():
    """Both packages under f64 = False and True, and with two labels."""
    with pytest.MonkeyPatch.context() as mp:
        # the reference's unfused body, whatever the environment asks for
        mp.setenv("VIENNARAY_TPU_FUSED", "0")
        mp.delenv("VIENNARAY_TPU_FUSED_INTERPRET", raising=False)
        ref = {f64: _reference_run(f64) for f64 in (False, True)}
        ref_labels = _reference_run(True, LABELS)
    port = {f64: _port_run(_port_disks, f64, lane_matched=True)
            for f64 in (False, True)}
    port_labels = _port_run(_port_disks, True, LABELS, lane_matched=True)
    return ref, port, ref_labels, port_labels


# ---- float32 / float64 accumulation ----------------------------------------
@pytest.mark.parametrize("f64", [False, True])
def test_f64_accumulation_matches_reference(lane_matched_runs, f64):
    """The same batches through both packages, summed under the same
    setting. Tolerances of the lane-matched trace tests
    (``test_torch_trace.py``): counters within 0.2 %, flux rel-L2 < 1e-3 and
    at most two bins off by more than 1e-5 of the largest."""
    ref, port, _, _ = lane_matched_runs
    flux, info, _, batches = port[f64]
    ref_flux, ref_info, _ = ref[f64]
    assert len(batches) == 4
    for name in ("total_rays_traced", "geometry_hits", "boundary_hits",
                 "non_geometry_hits"):
        want, got = getattr(ref_info, name), getattr(info, name)
        assert want > 800, name
        assert abs(got - want) <= 0.002 * want, (name, got, want)
    assert info.num_rays == ref_info.num_rays == RAYS
    assert _rel_l2(flux, ref_flux) < 1e-3
    off = np.abs(flux - ref_flux) > 1e-5 * np.abs(ref_flux).max()
    assert off.sum() <= 2


def test_float32_and_float64_sums_differ_by_rounding_only(lane_matched_runs):
    """Same rays, two sums: float32 in batch order against float64, in both
    packages; each float32 addition rounds by at most half an ulp of the
    running sum, so four batches stay within 4 * 2^-24 of the largest bin."""
    ref, port, _, _ = lane_matched_runs
    for runs in (ref, port):
        single, double = runs[False][0], runs[True][0]
        bound = 4 * 2.0**-24 * np.abs(double).max()
        assert np.abs(single - double).max() <= bound
        # the float32 sum is float32 values
        np.testing.assert_array_equal(single.astype(np.float32), single)
    # and the two settings trace the same rays
    assert port[False][1].geometry_hits == port[True][1].geometry_hits


@pytest.mark.parametrize("kind", sorted(TRACERS))
def test_f64_accumulation_sums_the_batches_as_asked(kind):
    """Every tracer takes the setter; True (the default) sums the batches'
    own fluxes in float64, False in float32 in batch order."""
    make = TRACERS[kind]
    assert make(("flux",))._accumulate_f64 is True
    for f64 in (True, False):
        flux, _, _, batches = _port_run(make, f64)
        assert len(batches) == 4 and flux.dtype == np.float64
        if f64:
            want = np.sum([b.astype(np.float64) for b in batches], axis=0)
        else:
            want = np.zeros_like(batches[0])
            for b in batches:
                want = want + b
        np.testing.assert_array_equal(flux, want)


# ---- several data labels ---------------------------------------------------
def test_multi_label_flux_matches_reference(lane_matched_runs):
    """Both packages store the one flux channel under the first label and
    zeros under the second; the first channel holds what a one-label run
    traces, within the lane-matched tolerance of the reference's."""
    _, port, ref_labels, port_labels = lane_matched_runs
    ref_flux, _, ref_data = ref_labels
    flux, _, data, _ = port_labels
    np.testing.assert_array_equal(flux, port[True][0])
    for local, want in ((data, flux), (ref_data, ref_flux)):
        assert local.num_vector_data == 2
        np.testing.assert_array_equal(local.get_vector_data("flux"), want)
        assert not local.get_vector_data("energy").any()
        assert local.get_vector_data("energy").shape == want.shape
    assert _rel_l2(data.get_vector_data("flux"),
                   ref_data.get_vector_data("flux")) < 1e-3


@pytest.mark.parametrize("kind", sorted(TRACERS))
def test_multi_label_fills_the_first_label_on_every_tracer(kind):
    """Fused body (the default): the first label gets the flux of the
    one-label run of the same seed, bit for bit; the second zeros; a second
    apply adds to both."""
    make = TRACERS[kind]

    def make_fused(labels):
        return make(labels, fused=True, rays=1000)

    single, _, _, _ = _port_run(make_fused)
    t = make_fused(LABELS)
    first = t.apply()
    np.testing.assert_array_equal(first, single)
    data = t.get_local_data()
    np.testing.assert_array_equal(data.get_vector_data("flux"), first)
    assert not data.get_vector_data("energy").any()
    second = t.apply()
    np.testing.assert_array_equal(data.get_vector_data("flux"),
                                  first + second)
    assert data.get_vector_data("energy").shape == first.shape


def test_custom_hooks_stay_refused():
    with pytest.raises(NotImplementedError):
        _port_disks(LABELS).set_custom_functions(collision_fn=lambda *a: None)


# ---- TraceInfo's search counters -------------------------------------------
SEARCH_COUNTERS = ("chunks_swept", "chunks_deposited", "tile_bounces")


def test_trace_info_has_the_references_fields():
    ref_fields = {f.name for f in dataclasses.fields(vrt.TraceInfo)}
    fields = {f.name: f for f in dataclasses.fields(vrtt.TraceInfo)}
    assert ref_fields <= set(fields)
    info = vrtt.TraceInfo()
    for name in SEARCH_COUNTERS:
        assert getattr(info, name) == 0


def test_search_counters_are_zero_on_both_unfused_bodies(lane_matched_runs):
    ref, port, _, _ = lane_matched_runs
    for info in (ref[True][1], port[True][1]):
        for name in SEARCH_COUNTERS:
            assert getattr(info, name) == 0, name


@pytest.mark.parametrize("kind", sorted(TRACERS))
@pytest.mark.parametrize("fused", [False, True])
def test_search_counters_are_integers_on_either_body(kind, fused):
    """On the CPU both bodies run plain PyTorch, which sweeps no chunks: the
    counters are there, integers, and 0 (on the card the fused body's are
    the kernel's; ``chip_smoke.py`` bounds them)."""
    t = TRACERS[kind](("flux",), fused=fused, rays=1000)
    t.apply()
    info = t.get_ray_trace_info()
    assert info.total_rays_traced > 0
    for name in SEARCH_COUNTERS:
        value = getattr(info, name)
        assert isinstance(value, int) and value == 0, name


def test_a_launch_returns_the_two_search_counts():
    assert bounce.COUNT_NAMES[-2:] == ("chunks_swept", "tile_bounces")
    assert bounce.COUNT_NAMES[bounce.N_EVENTS] == "survivors"


# ---- the wrappers' choices -------------------------------------------------
def test_group_for_covers_every_width_of_the_ladder():
    """Every width the ladder launches gets an instantiated G; one thread per
    ray at the wide launches on few chunks, a warp per ray at the narrow
    ones and on many chunks."""
    widths, w = [], 1 << 20
    while w >= MIN_STAGE:
        widths.append(w)
        w //= 2
    for n_chunks in (1, 2, 6, 7, 8, 12, 18):
        groups = [bounce.group_for(w, n_chunks) for w in widths]
        assert all(g in bounce.GROUPS for g in groups)
        # never more threads per ray at a wider launch
        assert groups == sorted(groups)
        if n_chunks >= bounce.GROUP_ALL_WIDTHS_CHUNKS:
            assert set(groups) == {32}
        else:
            assert bounce.group_for(1 << 20, n_chunks) == 1
    for w in widths:
        if n_sub_for(w, N_SUB) > 1:  # the ladder's 4- and 16-bounce tail
            assert bounce.group_for(w, 6) == 32


def test_fused_bounce_takes_only_instantiated_groups():
    pts, nrm = fixtures.create_plane_grid(1.0, 2.0, (0, 1, 2))
    geo = vrtt.DiskGeometry.build(pts, nrm, 1.0, device="cpu")
    settings = bounce.BounceSettings.from_config(
        vrtt.TraceConfig(dim=3), vrtt.DiffuseParticle(0.5))
    bbox = torch.tensor([[-2.0, -2.0, -1.0], [2.0, 2.0, 1.0]])
    walls = bounce.make_walls(bbox, geo, settings)
    n = 64
    state = bounce.RayState(
        torch.zeros(n, 3) + torch.tensor([0.1, 0.2, 0.9]),
        torch.zeros(n, 3) + torch.tensor([0.0, 0.0, -1.0]), torch.ones(n),
        torch.ones(n), torch.ones(n, dtype=torch.bool),
        torch.zeros(n, dtype=torch.bool), torch.zeros(n, dtype=torch.int32),
        torch.zeros(n, dtype=torch.int32),
    )
    uniforms = torch.rand(n, 3, generator=torch.Generator().manual_seed(1))
    outs = [bounce.fused_bounce(state, uniforms, geo, walls, settings,
                                group=g) for g in bounce.GROUPS]
    for out in outs[1:]:  # the plain version on the CPU: the same outputs
        assert torch.equal(out.flux, outs[0].flux)
        assert torch.equal(out.counts, outs[0].counts)
    assert outs[0].counts[bounce.COUNT_NAMES.index("collide")] == n
    for bad in (0, 3, 64):
        with pytest.raises(ValueError):
            bounce.fused_bounce(state, uniforms, geo, walls, settings,
                                group=bad)


@pytest.mark.parametrize("n_entries,n_bins,path", [
    (6144, 2993, "small"),
    (histogram.SMALL_ENTRIES - 1, 2993, "small"),
    (histogram.SMALL_ENTRIES, 2993, "large"),
    (4096, histogram.SMALL_MAX_BINS + 1, "large"),
])
def test_histogram_path_for(n_entries, n_bins, path):
    assert histogram.path_for(n_entries, n_bins) == path


def test_histogram_paths_on_the_cpu_are_the_plain_version():
    gen = torch.Generator().manual_seed(3)
    ids = torch.randint(0, 50, (1000,), generator=gen, dtype=torch.int32)
    w = torch.rand(1000, generator=gen)
    ref = histogram.flux_histogram_ref(ids, w, 50)
    for path in (None, "small", "large"):
        assert torch.equal(histogram.flux_histogram(ids, w, 50, path=path),
                           ref)
    with pytest.raises(ValueError):
        histogram.flux_histogram(ids, w, 50, path="medium")
    with pytest.raises(ValueError):
        histogram.flux_histogram(ids, w, histogram.SMALL_MAX_BINS + 1,
                                 path="small")
