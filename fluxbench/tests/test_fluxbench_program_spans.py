"""The readers of the program's own spans on a synthetic profile and a
hand-made span log; and None wherever the log or its module is absent."""

import sys

import pytest

from fluxbench import devtrace, program_spans, spec
from fluxbench.run import Run
from viennaray_tpu_torch.utils.telemetry import Span

MS = 1_000_000  # ns
HIST = "void cluster_histogram_kernel<float>(int const*)"


def make_trace():
    """A 100 ms window; device operations at (ms) 14-16, 22-28, 32-34 (kernel
    2), 41-44, 52-60, 62-66, 71-74: idle 0-14, 16-22, 28-32, 34-41, 44-52,
    60-62, 66-71, 74-100."""
    dev = [(n, a * MS, b * MS) for n, a, b in [
        ("void at::native::sort_kernel()", 14, 16),
        ("void bounce_kernel<DiskKind, false, 1>(BounceArgs)", 22, 28),
        (HIST, 32, 34),
        ("void at::native::reduce_kernel()", 41, 44),
        ("void bounce_kernel<DiskKind, false, 1>(BounceArgs)", 52, 60),
        ("void at::native::elementwise_kernel<128, 2>()", 62, 66),
        ("Memcpy DtoH (Device -> Pageable)", 71, 74),
    ]]
    host = [("fluxbench.window", 0, 100 * MS),
            ("fluxbench.apply", 9 * MS, 91 * MS)]
    return devtrace.Trace(dev, host)


APPLY = dict(rays=5000, batches=1, prims=100, run=2, host_reads=3,
             compactions=1, resorts=0, bounce_launches=2, hand_outs=1,
             histogram_entries=1000, histogram_entries_f64=0,
             histogram_launches=1, histogram_launches_f64=0)


def make_log(device_ns=True):
    """One apply (10-90 ms) and one set_geometry (91-99 ms, its packing in
    two parts around the grid, as the disk build has it) inside the window,
    and a span before it."""
    rows = [  # name, start, end, id, parent, request, attrs
        ("apply", -8, -2, 100, 0, 100, dict(APPLY)),
        ("source", 12, 20, 3, 2, 1, {}),
        ("deposit", 30, 38, 5, 4, 1,
         {"entries": 1000, **({"device_ns": 5 * MS} if device_ns else {})}),
        ("launch", 20, 40, 4, 2, 1, {"width": 4096, "n_sub": 1,
                                     "hand_out": 1}),
        ("read", 40, 45, 6, 2, 1, {"what": 1}),
        ("compact", 45, 50, 7, 2, 1, {"before": 4096, "after": 2048}),
        ("launch", 50, 70, 8, 2, 1, {"width": 2048, "n_sub": 4,
                                     "hand_out": 0}),
        ("read", 70, 75, 9, 2, 1, {"what": 1}),
        ("batch", 11, 80, 2, 1, 1, {"index": 0, "width": 4096}),
        ("read", 85, 88, 10, 1, 1, {"what": 3}),
        ("apply", 10, 90, 1, 0, 1, dict(APPLY)),
        ("geometry.neighborhood", 91, 93, 12, 11, 11, {"K": 11}),
        ("geometry.pack", 93, 94, 13, 11, 11, {}),
        ("geometry.grid", 94, 96, 14, 11, 11, {"cells": 64}),
        ("geometry.pack", 96, 98, 15, 11, 11, {"bytes": 4000}),
        ("set_geometry", 91, 99, 11, 0, 11, {"primitives": 100}),
    ]
    return [Span(n, a * MS, b * MS, i, p, r, attrs)
            for n, a, b, i, p, r, attrs in rows]


def make_run(trace=True):
    run = Run({"rays_per_point": 50}, {"loop": ["apply"]})
    run.peaks = {"hbm_bytes_per_s": 3.35e12}
    run.trace = make_trace() if trace else None
    return run


@pytest.fixture
def log(monkeypatch):
    spans = make_log()
    monkeypatch.setattr(program_spans, "program_log", lambda: spans)
    return spans


def read(name, run):
    return spec.Spec().reader(name)(run)


NEW = ["wavefront.host_reads_per_apply", "wavefront.read_wait_ms_per_apply",
       "wavefront.launch_idle_ms_per_apply",
       "wavefront.sort_idle_ms_per_apply", "deposit.device_ms_per_apply",
       "histogram.roofline_pct", "geometry.neighborhood_ms_per_step",
       "geometry.pack_ms_per_step", "geometry.grid_ms_per_step"]


@pytest.mark.parametrize("name,expected", [
    ("wavefront.host_reads_per_apply", 3.0),
    ("wavefront.read_wait_ms_per_apply", 5 + 5 + 3),
    # idle 28-32 and 34-41 in the deposit, 60-62 and 66-71 in the launch
    ("wavefront.launch_idle_ms_per_apply", 4 + 7 + 2 + 5),
    # idle 16-22 in the source, 44-52 in the compaction
    ("wavefront.sort_idle_ms_per_apply", 6 + 8),
    ("deposit.device_ms_per_apply", 5.0),
    ("histogram.roofline_pct",
     100.0 * (1000 * 8 + 100 * 4) / 3.35e12 / 0.002),
    ("geometry.neighborhood_ms_per_step", 2.0),
    ("geometry.pack_ms_per_step", 3.0),
    ("geometry.grid_ms_per_step", 2.0),
])
def test_each_reader_on_a_hand_made_log(log, name, expected):
    assert read(name, make_run()) == pytest.approx(expected)


def test_the_new_metrics_are_listed_with_their_readers():
    listed = {m["name"]: m for m in spec.Spec().data["per_layer"]}
    for name in NEW:
        assert listed[name]["moves"] == "rays_per_s"
        assert listed[name]["source"] in ("program_span", "program_counter")
        assert callable(spec.Spec().reader(name))


def test_innermost_span_and_idle_by_span(log):
    win = program_spans.window(make_run())
    # the apply before the window is left out
    assert all(s.start_ns >= 0 for s in win.spans)
    roots = win.roots("apply")
    assert [r.span_id for r in roots] == [1]
    idle = program_spans.idle_by_span(win, roots)
    # 74-100: its midpoint 87 lies in the flux's read; 0-14 in no apply
    assert idle["read"] == pytest.approx(26 * MS)
    assert idle == pytest.approx({"source": 6 * MS, "deposit": 11 * MS,
                                  "compact": 8 * MS, "launch": 7 * MS,
                                  "read": 26 * MS})


@pytest.mark.parametrize("name", NEW)
def test_none_without_a_log(monkeypatch, name):
    monkeypatch.setattr(program_spans, "program_log", lambda: None)
    assert read(name, make_run()) is None


@pytest.mark.parametrize("name", NEW)
def test_none_without_the_telemetry_module(monkeypatch, name):
    """A program older than its spans: importing the module fails."""
    monkeypatch.setitem(sys.modules, program_spans.TELEMETRY, None)
    assert program_spans.program_log() is None
    assert read(name, make_run()) is None


@pytest.mark.parametrize("name", NEW)
def test_none_without_a_trace(log, name):
    assert read(name, make_run(trace=False)) is None


def test_deposit_device_time_none_where_no_span_took_it(monkeypatch):
    """A CPU run's deposit spans carry no ``device_ns``."""
    spans = make_log(device_ns=False)
    monkeypatch.setattr(program_spans, "program_log", lambda: spans)
    assert read("deposit.device_ms_per_apply", make_run()) is None
    assert read("wavefront.host_reads_per_apply", make_run()) == 3.0
