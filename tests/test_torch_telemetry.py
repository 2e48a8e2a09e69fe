"""The port's spans and counts (``utils.telemetry``): the spans recorded
only under a ``torch.profiler`` session, one tree a request on the
profiler's host clock; the counts one registry of declared names, which an
apply span carries and the benchmark's readers take; and the trace's bits
unchanged by recording."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import viennaray_tpu_torch as vrtt
from viennaray_tpu_torch.config import ReflectionKind, adjust_bounding_box
from viennaray_tpu_torch.geometry.disk_geometry import DiskGeometry
from viennaray_tpu_torch.io import fixtures
from viennaray_tpu_torch.ops.histogram import flux_histogram
from viennaray_tpu_torch.ops.nearest_hit import pack_disk_prims
from viennaray_tpu_torch.physics.source import RandomSource
from viennaray_tpu_torch.rng import GeneratorRNG
from viennaray_tpu_torch.trace import kernel
from viennaray_tpu_torch.utils import telemetry

torch.set_num_threads(1)

PERIODIC = vrtt.BoundaryCondition.PERIODIC


def recorded():
    """A profiler session of the host alone, as a ``with`` block."""
    return profile(activities=[ProfilerActivity.CPU])


def _tracer(fused=True, seed=8):
    """209 disks of the trench, 3,000 rays in two batches of 2,048."""
    t = vrtt.TraceDisk(dim=3, device="cpu", fused=fused)
    pts, nrm = fixtures.create_trench_grid_3d(grid_delta=1.0)
    t.set_geometry(pts, nrm, 1.0)
    t.set_boundary_conditions([PERIODIC] * 3)
    t.set_particle_type(vrtt.DiffuseParticle(0.5))
    t.set_number_of_rays_fixed(3000)
    t.set_ray_batch_size(2048)
    t.set_rng_seed(seed)
    return t


def _apply_recorded(fused):
    t = _tracer(fused)
    telemetry.clear()
    with recorded():
        flux = t.apply()
    return t, flux, telemetry.spans()


def _by_name(spans, name):
    return [s for s in spans if s.name == name]


@pytest.mark.parametrize("request_kind", ["apply", "set_geometry"])
def test_nothing_is_recorded_without_a_profiler(request_kind):
    t = _tracer()
    telemetry.clear()
    if request_kind == "apply":
        t.apply()
    else:
        pts, nrm = fixtures.create_trench_grid_3d(grid_delta=1.0)
        t.set_geometry(pts, nrm, 1.0)
    assert telemetry.spans() == []


def test_a_span_outside_a_recorded_request_is_the_shared_no_op():
    assert not telemetry.recording()
    assert telemetry.request("apply") is telemetry.OFF
    assert telemetry.span("launch", device="cpu", width=4) is telemetry.OFF
    with telemetry.OFF as sp:
        sp.set(entries=1)
    with recorded():
        # outside a request a span records nothing, profiler or not
        assert telemetry.span("launch") is telemetry.OFF
        assert telemetry.request("apply") is not telemetry.OFF


@pytest.mark.parametrize("fused", [True, False])
def test_one_apply_is_one_request_tree(fused):
    t, _, spans = _apply_recorded(fused)
    roots = [s for s in spans if s.parent_id == 0]
    assert [r.name for r in roots] == ["apply"]
    root = roots[0]
    by_id = {s.span_id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        assert s.request_id == root.span_id
        if s is root:
            continue
        parent = by_id[s.parent_id]  # a parent inside the request
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    names = {s.name for s in spans}
    assert {"areas", "batch", "source", "launch", "read",
            "compact"} <= names
    assert root.attrs["rays"] == 3000 and root.attrs["batches"] == 2
    assert root.attrs["prims"] == t.geometry.num_primitives
    assert {b.attrs["index"] for b in _by_name(spans, "batch")} == {0, 1}
    for launch in _by_name(spans, "launch"):
        assert by_id[launch.parent_id].name == "batch"
        assert launch.attrs["n_sub"] in kernel.N_SUB


@pytest.mark.parametrize("fused", [True, False])
def test_host_reads_are_launches_plus_two_a_batch_plus_one(fused):
    _, _, spans = _apply_recorded(fused)
    root = _by_name(spans, "apply")[0]
    launches = len(_by_name(spans, "launch"))
    reads = _by_name(spans, "read")
    assert root.attrs["host_reads"] == launches + 2 * 2 + 1 == len(reads)
    what = [r.attrs["what"] for r in reads]
    assert what.count(kernel.READ_ALIVE) == 2
    assert what.count(kernel.READ_COUNTS) == 2
    assert what.count(kernel.READ_SURVIVORS) == launches
    assert what[-1] == kernel.READ_FLUX
    assert root.attrs["compactions"] == len(_by_name(spans, "compact")) > 0
    assert root.attrs["resorts"] == 0


# the counts an apply span carried before the registry, under the names
# fluxbench/program_spans.py and fluxbench/species_spans.py read
SPAN_COUNTS = ("host_reads", "compactions", "resorts", "cone_calls",
               "cone_rounds", "bounce_launches", "hand_outs", "full_launches",
               "histogram_entries", "histogram_entries_f64",
               "histogram_launches", "histogram_launches_f64",
               "areas_computed")


def test_the_package_declares_the_counts_an_apply_span_carries():
    assert set(SPAN_COUNTS) <= set(telemetry.COUNTS)
    assert all(isinstance(n, int) for n in telemetry.COUNTS.values())


def test_an_apply_span_carries_every_count():
    """A float32 apply on the CPU: every declared count is an attribute of
    its span, 0 included (the float64 entries, the kernels' launches), and
    the change of the registry over the apply."""
    t = _tracer()
    telemetry.clear()
    before = dict(telemetry.COUNTS)
    with recorded():
        t.apply()
    counts = telemetry.since(before)
    root = _by_name(telemetry.spans(), "apply")[0]
    assert {k: root.attrs[k] for k in telemetry.COUNTS} == counts
    assert root.attrs["histogram_entries_f64"] == 0
    assert root.attrs["bounce_launches"] == 0  # no kernel on the CPU
    assert root.attrs["host_reads"] > 0


def test_an_undeclared_count_raises_where_it_is_bumped_or_read():
    with pytest.raises(KeyError):
        telemetry.COUNTS["host_builds"] += 1
    with pytest.raises(KeyError):
        telemetry.COUNTS["disk_nearest_hit.launch"]
    assert "host_builds" not in telemetry.COUNTS
    with pytest.raises(KeyError):
        telemetry.since({})


def test_the_unfused_apply_counts_its_histogram_entries():
    """Every unfused bounce deposits through the histogram: the deposit
    spans' entries sum to the apply's change of the counter."""
    _, _, spans = _apply_recorded(fused=False)
    root = _by_name(spans, "apply")[0]
    deposits = _by_name(spans, "deposit")
    assert len(deposits) == len(_by_name(spans, "launch"))
    assert root.attrs["histogram_entries"] == sum(
        d.attrs["entries"] for d in deposits) > 0
    assert "device_ns" not in deposits[0].attrs  # no CUDA stream here


@pytest.mark.parametrize("path,dtype", [("small", torch.float32),
                                        ("large", torch.float32),
                                        ("small", torch.float64)])
def test_histogram_entries_count_what_it_is_handed(path, dtype):
    gen = torch.Generator().manual_seed(3)
    sizes = (7, 1000, 65)
    before = dict(telemetry.COUNTS)
    for n in sizes:
        ids = torch.randint(0, 50, (n,), generator=gen, dtype=torch.int32)
        w = torch.rand(n, generator=gen, dtype=dtype)
        flux_histogram(ids, w, 50, path=path)
    counts = telemetry.since(before)
    f64 = dtype == torch.float64
    assert counts["histogram_entries_f64" if f64
                  else "histogram_entries"] == sum(sizes)
    assert counts["histogram_entries" if f64
                  else "histogram_entries_f64"] == 0


def _chunked_geometry(pad_to):
    pts, nrm = fixtures.create_trench_grid_3d(grid_delta=0.5)
    geo = DiskGeometry.build(pts, nrm, 0.5, device="cpu")
    soa, perm, bbs = pack_disk_prims(geo.points.numpy(), geo.normals.numpy(),
                                     geo.radii.numpy(), pad_to=pad_to)
    inv = np.zeros(len(pts), np.int32)
    inv[perm[: len(pts)]] = np.arange(len(pts), dtype=np.int32)
    return geo.replace(
        prims_soa=torch.from_numpy(soa), soa_perm=torch.from_numpy(perm),
        soa_chunk_bbs=torch.from_numpy(bbs),
        soa_inv_perm=torch.from_numpy(inv))


@pytest.mark.parametrize("pad_to,hands_out", [(256, True), (512, False)])
def test_the_hand_out_counter_follows_hand_out_for(pad_to, hands_out):
    """A fused trace of one bounce a launch on a cloud of 4 chunks hands
    every launch's deposits out, on one of 2 none; the counter and the
    launch spans agree with ``hand_out_for``."""
    geo = _chunked_geometry(pad_to)
    chunks = geo.soa_chunk_bbs.shape[0]
    assert (chunks >= kernel.HAND_OUT_MIN_CHUNKS) == hands_out
    bbox = torch.from_numpy(adjust_bounding_box(
        geo.bbox.numpy(), vrtt.TraceDirection.POS_Z, geo.disk_radius, 3,
    ).astype(np.float32))
    R = 2048
    config = vrtt.TraceConfig(dim=3, boundary_conditions=(PERIODIC,) * 3,
                              ray_batch_size=R)
    source = RandomSource(bbox=bbox, cosine_power=1.0, ray_dir=2,
                          first_dir=0, second_dir=1, min_max=1, pos_neg=-1.0,
                          dim=3)
    rng = GeneratorRNG(21, "cpu")
    rng.begin_batch(0)
    telemetry.clear()
    before = telemetry.COUNTS["hand_outs"]
    with recorded(), telemetry.request("apply"):
        kernel.trace_batch(geo, source, vrtt.DiffuseParticle(0.5, "flux"),
                           bbox, rng, 0, torch.arange(R),
                           torch.ones(R, dtype=torch.bool), config,
                           fused=True, n_sub=(1, 1, 1))
    launches = _by_name(telemetry.spans(), "launch")
    assert launches
    for s in launches:
        assert s.attrs["hand_out"] == int(kernel.hand_out_for(
            "disk", chunks, ReflectionKind.DIFFUSE, s.attrs["n_sub"]))
    handed = telemetry.COUNTS["hand_outs"] - before
    assert handed == sum(s.attrs["hand_out"] for s in launches)
    assert handed == (len(launches) if hands_out else 0)
    assert len(_by_name(telemetry.spans(), "deposit")) == handed


def _line_mesh():
    nodes, lines = fixtures.create_trench_line_mesh(0.5)
    return vrtt.LineMesh(nodes, lines, grid_delta=0.5)


@pytest.mark.parametrize("kind,phases", [
    ("disk", ["geometry.neighborhood", "geometry.pack", "geometry.grid",
              "geometry.pack"]),
    ("triangle", ["geometry.pack", "geometry.grid", "geometry.pack"]),
    ("line", ["geometry.pack"]),
])
def test_the_geometry_phases_nest_inside_set_geometry(kind, phases):
    if kind == "disk":
        tracer = vrtt.TraceDisk(dim=3, device="cpu")
        pts, nrm = fixtures.create_trench_grid_3d(grid_delta=1.0)
        args = (pts, nrm, 1.0)
    elif kind == "triangle":
        tracer = vrtt.TraceTriangle(dim=2, device="cpu")
        args = (_line_mesh(),)
    else:
        tracer = vrtt.TraceLine(device="cpu")
        args = (_line_mesh(),)
    telemetry.clear()
    with recorded():
        tracer.set_geometry(*args)
    spans = telemetry.spans()
    root = spans[-1]
    assert root.name == "set_geometry" and root.parent_id == 0
    assert root.attrs["primitives"] == tracer.geometry.num_primitives
    assert [s.name for s in spans[:-1]] == phases
    for s in spans[:-1]:
        assert s.parent_id == root.span_id == s.request_id
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    # the second (or only) part of the packing copies the tables
    assert _by_name(spans, "geometry.pack")[-1].attrs["bytes"] > 0
    if kind == "disk":
        assert _by_name(spans, "geometry.neighborhood")[0].attrs["K"] == \
            tracer.geometry.neighbors.shape[1]
        assert _by_name(spans, "geometry.grid")[0].attrs["cells"] == \
            int(np.prod(tracer.geometry.grid.dims))


@pytest.mark.parametrize("fused", [True, False])
def test_the_trace_is_bitwise_the_same_recorded_or_not(fused):
    plain = _tracer(fused, seed=5)
    flux_off = plain.apply()
    info_off = plain.get_ray_trace_info()
    traced = _tracer(fused, seed=5)
    with recorded():
        flux_on = traced.apply()
    info_on = traced.get_ray_trace_info()
    np.testing.assert_array_equal(flux_on, flux_off)
    for field in ("num_rays", "total_rays_traced", "non_geometry_hits",
                  "geometry_hits", "particle_hits", "boundary_hits",
                  "reflections", "chunks_swept", "chunks_deposited",
                  "tile_bounces"):
        assert getattr(info_on, field) == getattr(info_off, field), field


def test_normalize_and_smooth_are_requests():
    t = _tracer()
    flux = t.apply()
    telemetry.clear()
    with recorded():
        t.normalize_flux(flux)
        t.smooth_flux(flux)
    assert [(s.name, s.parent_id) for s in telemetry.spans()] == [
        ("normalize", 0), ("smooth", 0)]


def _kineto(prof, name):
    return [(e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name() == name]


def test_a_span_inside_a_profiler_range_lies_within_it():
    """The spans' clock is the profiler's host clock."""
    telemetry.clear()
    with recorded() as prof:
        for _ in range(3):
            with record_function("outer"):
                with telemetry.request("inner"):
                    torch.ones(1000).sum()
    ranges = sorted(_kineto(prof, "outer"))
    spans = telemetry.spans()
    assert len(ranges) == len(spans) == 3
    for (lo, hi), s in zip(ranges, spans):
        assert lo <= s.start_ns <= s.end_ns <= hi


def test_a_profiler_range_inside_a_span_lies_within_it():
    telemetry.clear()
    with recorded() as prof:
        for _ in range(3):
            with telemetry.request("outer"):
                with record_function("inner"):
                    torch.ones(1000).sum()
    ranges = sorted(_kineto(prof, "inner"))
    spans = telemetry.spans()
    assert len(ranges) == len(spans) == 3
    for (lo, hi), s in zip(ranges, spans):
        assert s.start_ns <= lo <= hi <= s.end_ns


def test_the_log_is_bounded():
    telemetry.clear()
    extra = 10
    with recorded(), telemetry.request("apply"):
        for i in range(telemetry.MAX_SPANS + extra):
            with telemetry.span("read", what=i):
                pass
    spans = telemetry.spans()
    assert len(spans) == telemetry.MAX_SPANS
    # the oldest fell out; the newest and the root (closed last) are kept
    assert spans[0].attrs["what"] == extra + 1
    assert spans[-1].name == "apply"
    telemetry.clear()
    assert telemetry.spans() == []
