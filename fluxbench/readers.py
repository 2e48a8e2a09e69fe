"""Arithmetic the metric readers share (``metrics/<metric>.py`` import it)."""

from __future__ import annotations


def spans_s(run, step):
    """Host seconds of every ``step`` of the window's iterations."""
    return [end - start for it in run.iterations
            for name, start, end in it.spans if name == step]


def traced(run):
    """The run's profile where it has one with device operations in it."""
    t = run.trace
    if t is None or t.busy_s() <= 0:
        return None
    return t


def bytes_bound_roofline_pct(run, pattern, bytes_of_apply):
    """100 x (the least time the card's memory bandwidth allows for the
    bytes ``bytes_of_apply(iteration)`` of every traced apply) over the
    device time of the kernels matching ``pattern``; None without a trace,
    a peak or a matching kernel."""
    t = traced(run)
    if t is None or run.peaks is None:
        return None
    device_s = t.busy_s(pattern)
    if device_s <= 0:
        return None
    total = sum(bytes_of_apply(it) for it in run.iterations)
    return 100.0 * total / run.peaks["hbm_bytes_per_s"] / device_s


def bounce_bytes(it, rays_per_point):
    """Bytes the bounce kernel cannot avoid in one apply, whatever searches:
    every ray segment the trace ran (``TraceInfo.total_rays_traced``: each
    live ray's bounce, ending in a geometry hit, a wall or an escape) reads
    the ray's origin, direction and weight (7 float32) once and writes the
    new ray and its hit's primitive index (7 float32 and an int32) once;
    every disk's centre, normal and radius (7 float32) is read once. No
    search table, padding or re-read is counted."""
    segments = it.info[2]
    disks = it.rays // rays_per_point
    return segments * (28 + 32) + disks * 28
