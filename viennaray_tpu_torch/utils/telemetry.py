"""Spans of the port's requests, kept in memory while a profiler records,
and the port's always-on counts.

A request (a tracer's ``apply``, ``set_geometry``, ``normalize_flux`` or
``smooth_flux``) asks once, at its entry, whether a ``torch.profiler``
session is recording. If one is, the request and every span opened below it
on its thread are recorded into one bounded log: ``spans()`` returns it,
``clear()`` empties it. If none is, ``request`` and ``span`` return a
shared object that does nothing: a span then costs the test of a global.

A record (``Span``): the span's name; its start and end in ns by
``time.time_ns()``, the clock of the profiler's host events, so that the
spans and the profiler's device intervals compare directly; its own id, its
parent's (0 at a request's root) and its request's (the root's own id); and
a dict of integer attributes. The spans are not profiler ranges on purpose:
the profiler copies every range onto the device timeline, where it would
read as device time.

A span opened with ``device=`` a CUDA device also records a CUDA event on
the device's stream (the current one when its request's first such span
opened) at its start and at its end. Its request reads them when it closes,
after its last read from the device, so no sync is added, and records them
again in its later spans. The attribute ``device_ns`` is the stream's time
from the end of the work queued before the span to the end of the span's
last operation.

The counts (``COUNTS``): one plain dict, name -> count since the process
started, always on. A module that counts declares its names at import
(``declare``) and bumps them in place (``COUNTS[name] += n``); a reader
takes a snapshot (``dict(COUNTS)``) and subtracts (``since``). An
undeclared name raises ``KeyError`` where it is bumped or read. The counts
an ``apply`` span carried before the registry keep their names
(``host_reads``, ``bounce_launches``, ``histogram_entries``, ...); every
other is ``<wrapper>.<what>``, as ``disk_nearest_hit.launches_f64`` or
``flux_histogram.launches_by_branch.global``. A kernel's launches are
``<wrapper>.launches`` and its float64 form's ``<wrapper>.launches_f64``,
but for the bounce and histogram kernels' (``bounce_launches``,
``histogram_launches``, ``histogram_launches_f64``).
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import NamedTuple

import torch

MAX_SPANS = 1 << 18  # the log keeps the newest this many records

_LOG = collections.deque(maxlen=MAX_SPANS)
_IDS = itertools.count(1)
# the process's open recorded requests, so that a span outside them is one
# test of a global; changed under the lock
_OPEN = 0
_OPEN_LOCK = threading.Lock()
# CUDA device index -> timing events read and free to record again, so that
# a span records an event instead of creating one
_FREE_EVENTS = collections.defaultdict(list)


COUNTS = {}


def declare(*names):
    """Register the counts ``names`` at 0."""
    for name in names:
        COUNTS.setdefault(name, 0)


def since(before):
    """Every count's change since ``before``, a snapshot ``dict(COUNTS)``."""
    return {name: n - before[name] for name, n in COUNTS.items()}


class _Thread(threading.local):
    """Per thread: ``stack``, the open spans of its recorded request."""

    def __init__(self):
        self.stack = []


_THREAD = _Thread()


class Span(NamedTuple):
    """One closed span."""

    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent_id: int
    request_id: int
    attrs: dict


def spans():
    """The log's records, oldest first (each appended when it closed)."""
    return list(_LOG)


def clear():
    """Empty the log."""
    _LOG.clear()


def recording() -> bool:
    """Whether a ``torch.profiler`` session records in this process."""
    return bool(getattr(torch.autograd.profiler, "_is_profiler_enabled",
                        False))


class _Off:
    """The span of a request that records nothing: one shared object."""

    __slots__ = ()
    on = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


OFF = _Off()


class _Open:
    """A span being recorded; ``set`` adds attributes before it closes."""

    __slots__ = ("name", "attrs", "stack", "device", "span_id", "parent_id",
                 "request_id", "start", "events", "pending", "streams")
    on = True

    def __init__(self, name, attrs, stack, device=None):
        self.name = name
        self.attrs = attrs
        self.stack = stack
        self.device = device
        self.events = None
        self.pending = None
        self.streams = None

    def set(self, **attrs):
        self.attrs.update(attrs)

    def __enter__(self):
        stack = self.stack
        self.span_id = next(_IDS)
        if stack:
            self.parent_id = stack[-1].span_id
            self.request_id = stack[0].span_id
        else:  # a request's root: it resolves its spans' device events
            self.parent_id = 0
            self.request_id = self.span_id
            self.pending = []
            self.streams = {}
            _count_open(1)
        stack.append(self)
        if self.device is not None:
            self.events = _record(self.device, stack[0].streams)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        stack = self.stack
        stack.pop()
        record = Span(self.name, self.start, end, self.span_id,
                      self.parent_id, self.request_id, self.attrs)
        _LOG.append(record)
        if self.events is not None:
            root = stack[0] if stack else self
            root.pending.append((record, self.device.index, self.events,
                                 _record(self.device, root.streams)))
        if self.pending is not None:
            _count_open(-1)
            for rec, index, start, stop in self.pending:
                # complete after the request's last read, unless it raised
                if stop.query():
                    rec.attrs["device_ns"] = int(
                        round(start.elapsed_time(stop) * 1e6))
                    _FREE_EVENTS[index] += (start, stop)
        return False


def _record(device, streams):
    """A timing event recorded on ``device``'s stream of the request
    (``streams``: device index -> stream, filled at first use)."""
    stream = streams.get(device.index)
    if stream is None:
        stream = streams[device.index] = torch.cuda.current_stream(device)
    free = _FREE_EVENTS[device.index]
    event = free.pop() if free else torch.cuda.Event(enable_timing=True)
    event.record(stream)
    return event


def _count_open(step):
    global _OPEN
    with _OPEN_LOCK:
        _OPEN += step


def request(name, **attrs):
    """The root span of a request, recorded where a ``torch.profiler``
    session records (``recording``) and else ``OFF``; opened inside another
    request, a span of that one."""
    stack = _THREAD.stack
    if not stack and not recording():
        return OFF
    return _Open(name, attrs, stack)


def span(name, device=None, **attrs):
    """A span inside the thread's request, or ``OFF`` outside a recorded
    one. ``device``: where it is a CUDA device, the span also takes the
    stream's time (``device_ns``)."""
    if not _OPEN:
        return OFF
    stack = _THREAD.stack
    if not stack:
        return OFF
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda":
            device = None
        elif device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return _Open(name, attrs, stack, device)
