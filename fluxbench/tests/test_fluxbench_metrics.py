"""The metric readers' arithmetic on a synthetic profile and counters."""

import math
import statistics

import pytest

from fluxbench import devtrace, readers, spec
from fluxbench.run import Iteration, Run

MS = 1_000_000  # ns


def test_union_of_intervals():
    iv = [(0, 10), (5, 15), (20, 30), (29, 31), (40, 40), (12, 14)]
    assert devtrace.union_length(iv) == 15 + 11
    assert devtrace.union_length([]) == 0.0
    assert devtrace.merged(iv).tolist() == [[0, 15], [20, 31], [40, 40]]


def make_trace():
    """A 100 ms window: two applies (10-40 ms, 50-90 ms), kernels inside
    them and one copy, host operations nested under the spans."""
    dev = [
        ("void bounce_kernel<DiskKind, false, 1>(BounceArgs)", 12 * MS, 20 * MS),
        ("void bounce_kernel<DiskKind, false, 32>(BounceArgs)", 18 * MS, 22 * MS),
        ("void cluster_histogram_kernel<float>(int const*)", 25 * MS, 26 * MS),
        ("void bounce_grid_kernel<DiskKind, false>(BounceArgs)", 52 * MS, 60 * MS),
        ("prepare_kernel", 61 * MS, 62 * MS),
        ("void at::native::elementwise_kernel<128, 2>()", 70 * MS, 71 * MS),
        ("Memcpy DtoH (Device -> Pinned)", 88 * MS, 89 * MS),
        ("void gather_grad_kernel()", 95 * MS, 99 * MS),
        ("fluxbench.apply", 10 * MS, 40 * MS),  # a span's device annotation
    ]
    host = [
        ("fluxbench.window", 0, 100 * MS),
        ("fluxbench.apply", 10 * MS, 40 * MS),
        ("aten::nonzero", 27 * MS, 40 * MS),
        ("fluxbench.apply", 50 * MS, 90 * MS),
        ("aten::item", 72 * MS, 86 * MS),
    ]
    return devtrace.Trace(dev, host)


def test_busy_idle_and_breakdown():
    t = make_trace()
    assert t.window_s == pytest.approx(0.1)
    # 12-22, 25-26, 52-60, 61-62, 70-71, 88-89, 95-99
    assert t.busy_s() == pytest.approx(0.026)
    assert t.busy_s(r"\bbounce_kernel\b") == pytest.approx(0.010)
    ops = dict((n, v) for n, v in t.top_device_ops())
    assert ops["void bounce_grid_kernel<DiskKind, false>(BounceArgs)"] == \
        pytest.approx(0.008)
    gaps = dict((n, v) for n, v in t.idle_gaps())
    # each idle gap goes to what the host did at its midpoint
    assert gaps["apply: aten::nonzero"] == pytest.approx(0.026)  # 26-52
    assert gaps["apply: aten::item"] == pytest.approx(0.017)  # 71-88
    assert gaps["apply: between operations"] == pytest.approx(
        0.003 + 0.001 + 0.008)  # 22-25, 60-61, 62-70
    assert gaps["window: between operations"] == pytest.approx(
        0.012 + 0.006 + 0.001)  # 0-12, 89-95, 99-100
    assert sum(gaps.values()) == pytest.approx(0.1 - 0.026)


def make_run(trace=True):
    run = Run({"rays_per_point": 10}, {"loop": ["apply"]})
    run.window_start = 0.0
    for s, e in [(0.010, 0.040), (0.050, 0.090)]:
        it = Iteration()
        it.spans.append(("apply", s, e))
        it.rays = 1000 * 10
        it.info = (1700, 10000, 32000)
        run.iterations.append(it)
    run.peaks = {"hbm_bytes_per_s": 3.35e12}
    run.trace = make_trace() if trace else None
    return run


def read(name, run):
    return spec.Spec().reader(name)(run)


def test_end_to_end_readers():
    run = make_run(trace=False)
    assert read("rays_per_s", run) == pytest.approx(20000 / 0.090)
    assert read("apply_ms_p90", run) == pytest.approx(
        statistics.quantiles([30.0, 40.0], n=10, method="inclusive")[-1])
    run.setup_s = 12.5
    assert read("setup_s", run) == 12.5
    for name in ("device.idle_pct", "wavefront.kernels_per_apply",
                 "bounce.chunks.roofline_pct", "histogram.device_pct"):
        assert read(name, run) is None  # no trace: nothing to read


def test_per_layer_readers():
    run = make_run()
    assert read("device.idle_pct", run) == pytest.approx(74.0)
    # kernels starting inside the applies: 3 in the first (the copy is
    # not a kernel), 3 in the second
    assert read("wavefront.kernels_per_apply", run) == pytest.approx(3.0)
    byte = 2 * (32000 * 60 + 1000 * 28)
    assert read("bounce.chunks.roofline_pct", run) == pytest.approx(
        100 * byte / 3.35e12 / 0.010)
    assert read("bounce.grid.roofline_pct", run) == pytest.approx(
        100 * byte / 3.35e12 / 0.008)
    assert read("histogram.device_pct", run) == pytest.approx(100 * 2 / 26)
    assert read("geometry.build_ms_per_step", run) is None


def test_bounce_bytes_count_segments_and_disks():
    it = Iteration()
    it.info = (5, 7, 11)
    it.rays = 40
    assert readers.bounce_bytes(it, rays_per_point=4) == 11 * 60 + 10 * 28


def test_a_roofline_with_no_matching_kernel_reads_nothing():
    run = make_run()
    assert readers.bytes_bound_roofline_pct(
        run, r"\bno_such_kernel\b", lambda it: 1) is None
    run.peaks = None
    assert read("bounce.chunks.roofline_pct", run) is None
    assert not math.isnan(read("device.idle_pct", run))
