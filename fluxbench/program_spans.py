"""The program's own spans (``viennaray_tpu_torch.utils.telemetry``) read
against the traced window: the arithmetic the readers of ``program_span``
and ``program_counter`` metrics share.

The program records its spans only while a ``torch.profiler`` session
records, so the ``--trace 1`` run holds them and the others do not; their
clock (``time.time_ns()``) is the profiler's host clock. ``window(run)``
keeps the spans that lie inside the traced window. Every reader returns
None where the run has no trace, the program no span log or no telemetry
module (a program older than its spans), or the window no span it reads.
"""

from __future__ import annotations

import importlib
import importlib.util
from collections import defaultdict
from pathlib import Path

import numpy as np

from fluxbench import devtrace
from fluxbench.readers import traced

TELEMETRY = "viennaray_tpu_torch.utils.telemetry"
# the spans whose host time the device's idle counts against: the bounce
# loop's glue, and the sorts and permutations around it
LAUNCH = ("launch", "deposit")
SORT = ("source", "compact", "resort")


def program_log():
    """The program's span records, or None without its telemetry module."""
    try:
        telemetry = importlib.import_module(TELEMETRY)
    except ImportError:
        return None
    return telemetry.spans()


class Window:
    """The program's spans inside the traced window ``trace``: ``spans``
    (records), and ``roots(name)``, the request roots of that name."""

    def __init__(self, trace, spans):
        self.trace = trace
        self.spans = spans

    def roots(self, name):
        return [s for s in self.spans if s.parent_id == 0 and s.name == name]

    def under(self, roots, names):
        """The spans named one of ``names`` in the requests ``roots``."""
        ids = {r.request_id for r in roots}
        return [s for s in self.spans
                if s.request_id in ids and s.name in names]


def window(run):
    """The program's spans inside the run's traced window, or None."""
    t = traced(run)
    if t is None:
        return None
    log = program_log()
    if not log:
        return None
    inside = [s for s in log if s.start_ns >= t.lo and s.end_ns <= t.hi]
    if not inside:
        return None
    return Window(t, inside)


def host_ms(spans):
    """Host milliseconds of ``spans``."""
    return sum(s.end_ns - s.start_ns for s in spans) * 1e-6


def idle_gaps(trace):
    """(n, 2) ns: the window's device idle gaps, as ``devtrace.Trace
    .idle_gaps`` builds them (the window's edges and the merged device
    intervals)."""
    busy = devtrace.merged(trace.device_intervals())
    edges = np.concatenate([[trace.lo], busy.ravel(), [trace.hi]])
    gaps = edges.reshape(-1, 2)
    return gaps[gaps[:, 1] > gaps[:, 0]]


def innermost(spans, times):
    """For each of ``times`` (ns), the index into ``spans`` of the innermost
    span containing it, or -1. The spans of one thread nest."""
    n = len(spans)
    found = np.full(len(times), -1)
    if n == 0 or len(times) == 0:
        return found
    order = sorted(range(n), key=lambda i: (spans[i].start_ns,
                                            -spans[i].end_ns))
    start = np.array([spans[i].start_ns for i in order], np.float64)
    end = np.array([spans[i].end_ns for i in order], np.float64)
    # parent[i]: the innermost earlier span that contains span i
    parent = np.full(n, -1)
    stack = []
    for i in range(n):
        while stack and end[stack[-1]] < end[i]:
            stack.pop()
        parent[i] = stack[-1] if stack else -1
        stack.append(i)
    idx = np.searchsorted(start, times, side="right") - 1
    while True:
        live = (idx >= 0) & (found < 0)
        if not live.any():
            break
        hit = live & (end[np.maximum(idx, 0)] >= times)
        found[hit] = idx[hit]
        step = live & ~hit
        idx[step] = parent[idx[step]]
    order = np.asarray(order)
    return np.where(found >= 0, order[np.maximum(found, 0)], -1)


def idle_by_span(win, roots):
    """{span name: device idle ns} of the window's idle gaps whose midpoint
    lies inside one of the requests ``roots``, each given to the innermost
    program span there (the root's own name where no span below it holds
    the midpoint)."""
    spans = [s for s in win.spans
             if s.request_id in {r.request_id for r in roots}]
    gaps = idle_gaps(win.trace)
    at = innermost(spans, gaps.mean(axis=1))
    total = defaultdict(float)
    for i, g in zip(at, gaps[:, 1] - gaps[:, 0]):
        if i >= 0:
            total[spans[i].name] += g
    return dict(total)


def idle_ms_per_apply(run, names):
    """The device's idle ms while the program was inside spans of
    ``names`` (the innermost span at the gap's midpoint), per ``apply``."""
    win = window(run)
    if win is None:
        return None
    roots = win.roots("apply")
    if not roots:
        return None
    idle = idle_by_span(win, roots)
    return sum(idle.get(n, 0.0) for n in names) * 1e-6 / len(roots)


def counter_per_apply(run, name):
    """The change of counter ``name`` over an ``apply`` (its attribute),
    mean over the window's applies."""
    win = window(run)
    if win is None:
        return None
    roots = [r for r in win.roots("apply") if name in r.attrs]
    if not roots:
        return None
    return sum(r.attrs[name] for r in roots) / len(roots)


def span_ms_per_request(run, name, request):
    """Host ms of the spans ``name`` per request root ``request``."""
    win = window(run)
    if win is None:
        return None
    roots = win.roots(request)
    if not roots:
        return None
    spans = win.under(roots, (name,))
    if not spans:
        return None
    return host_ms(spans) / len(roots)


def histogram_bytes(root):
    """The bytes of kernel 2's calls in one ``apply`` that no
    implementation can avoid: each entry's int32 id and its weight (float32,
    or float64) read once, each call's bins (one a primitive, of the
    weights' type) written once."""
    a = root.attrs
    return (a["histogram_entries"] * 8 + a["histogram_entries_f64"] * 12
            + a["prims"] * (a["histogram_launches"] * 4
                            + a["histogram_launches_f64"] * 8))


def histogram_pattern():
    """The kernel-name pattern of ``metrics/histogram.device_pct.py``."""
    path = Path(__file__).resolve().parent / "metrics" / \
        "histogram.device_pct.py"
    spec = importlib.util.spec_from_file_location(
        "fluxbench_histogram_device_pct_pattern", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.PATTERN


def histogram_roofline_pct(run):
    """100 x (kernel 2's unavoidable bytes over the window's applies at the
    card's HBM peak) over the device time of kernel 2's kernels."""
    win = window(run)
    if win is None or run.peaks is None:
        return None
    roots = [r for r in win.roots("apply") if "histogram_entries" in r.attrs]
    if not roots:
        return None
    device_s = win.trace.busy_s(histogram_pattern())
    if device_s <= 0:
        return None
    total = sum(histogram_bytes(r) for r in roots)
    return 100.0 * total / run.peaks["hbm_bytes_per_s"] / device_s


def device_ms_per_apply(run, name):
    """The stream's ms of the spans ``name`` (their ``device_ns``) per
    ``apply``; None where no such span took the stream's time."""
    win = window(run)
    if win is None:
        return None
    roots = win.roots("apply")
    spans = [s for s in win.under(roots, (name,)) if "device_ns" in s.attrs]
    if not roots or not spans:
        return None
    return sum(s.attrs["device_ns"] for s in spans) * 1e-6 / len(roots)

