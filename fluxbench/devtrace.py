"""What a ``torch.profiler`` trace of the window says, reduced to intervals.

``Trace.collect`` keeps, from the profiler's events, the device operations
(name, start, end) and the host operations of the thread that ran the
window, with the benchmark's own spans (``fluxbench.<name>`` ranges) among
them, all in the profiler's clock (ns). The rest is arithmetic on those
intervals: the union of device busy time, the idle gaps and what the host
was doing in each, and the operations that took the most device time.
"""

from __future__ import annotations

import re
from collections import defaultdict

import numpy as np

SPAN_PREFIX = "fluxbench."
WINDOW = SPAN_PREFIX + "window"
# device events that move memory rather than run a kernel
COPY = re.compile(r"^(Memcpy|Memset)")
NAME_CHARS = 160  # a kernel's name in the breakdown, cut after its template


def union_length(intervals):
    """Length of the union of [start, end) intervals, (n, 2) array-like."""
    m = merged(intervals)
    return float((m[:, 1] - m[:, 0]).sum())


def merged(intervals):
    """The union of intervals as sorted disjoint (m, 2) intervals."""
    iv = np.asarray(intervals, np.float64).reshape(-1, 2)
    if len(iv) == 0:
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    reach = np.maximum.accumulate(iv[:, 1])
    first = np.concatenate([[True], iv[1:, 0] > reach[:-1]])
    last = np.concatenate([first[1:], [True]])
    return np.stack([iv[first, 0], reach[last]], axis=1)


def clip(intervals, lo, hi):
    iv = np.asarray(intervals, np.float64).reshape(-1, 2)
    iv = np.stack([np.maximum(iv[:, 0], lo), np.minimum(iv[:, 1], hi)], 1)
    return iv[iv[:, 1] > iv[:, 0]]


class Trace:
    """Device and host intervals of one traced window (ns)."""

    def __init__(self, device, host):
        # device: [(name, start, end)]; host: [(name, start, end)] of the
        # window's thread, spans included. The profiler repeats the spans
        # on the device's timeline as annotations: they are no operations
        self.device = [e for e in device if not e[0].startswith(SPAN_PREFIX)]
        self.host = sorted(host, key=lambda e: (e[1], -e[2]))
        window = [e for e in self.host if e[0] == WINDOW]
        if len(window) != 1:
            raise ValueError(f"the trace holds {len(window)} window spans")
        self.lo, self.hi = window[0][1], window[0][2]

    @classmethod
    def collect(cls, prof):
        """From a finished ``torch.profiler.profile``."""
        from torch.autograd import DeviceType

        device, host, threads = [], [], {}
        for e in prof.profiler.kineto_results.events():
            start = e.start_ns()
            iv = (e.name(), start, start + e.duration_ns())
            if e.device_type() == DeviceType.CUDA:
                device.append(iv)
            elif e.device_type() == DeviceType.CPU:
                host.append((iv, e.start_thread_id()))
                if iv[0] == WINDOW:
                    threads["window"] = e.start_thread_id()
        tid = threads.get("window")
        return cls(device, [iv for iv, t in host if t == tid])

    @property
    def window_s(self):
        return (self.hi - self.lo) * 1e-9

    def spans(self, name):
        """The benchmark's spans ``fluxbench.<name>`` as (n, 2) ns."""
        full = SPAN_PREFIX + name
        return np.array([(s, e) for n, s, e in self.host if n == full],
                        np.float64).reshape(-1, 2)

    def device_intervals(self, pattern=None, kernels_only=False):
        """(n, 2) ns of the device operations whose name matches the regular
        expression ``pattern`` (all where None), clipped to the window;
        ``kernels_only`` leaves copies and fills out."""
        rx = None if pattern is None else re.compile(pattern)
        iv = [(s, e) for n, s, e in self.device
              if (rx is None or rx.search(n))
              and not (kernels_only and COPY.search(n))]
        return clip(iv, self.lo, self.hi)

    def busy_s(self, pattern=None):
        """Seconds of the window in which a matching device operation ran
        (the union of their intervals)."""
        return union_length(self.device_intervals(pattern)) * 1e-9

    def kernel_starts(self):
        """Sorted start times (ns) of the window's kernels."""
        return np.sort(self.device_intervals(kernels_only=True)[:, 0])

    def top_device_ops(self, k=10):
        """[[name, seconds]] of the k operation names with the most device
        time in the window."""
        total = defaultdict(float)
        for n, s, e in self.device:
            s, e = max(s, self.lo), min(e, self.hi)
            if e > s:
                total[n] += (e - s) * 1e-9
        top = sorted(total.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:NAME_CHARS], v] for n, v in top]

    def idle_gaps(self, k=10):
        """[[what the host was doing, idle seconds]]: the window's device
        idle time summed by the host's activity at each gap's midpoint (the
        innermost host operation there, under the benchmark's span), the k
        largest."""
        busy = merged(self.device_intervals())
        edges = np.concatenate([[self.lo], busy.ravel(), [self.hi]])
        gaps = edges.reshape(-1, 2)
        gaps = gaps[gaps[:, 1] > gaps[:, 0]]
        if len(gaps) == 0:
            return []
        mid = gaps.mean(axis=1)
        span_label = self._label(mid, spans=True)
        op_label = self._label(mid, spans=False)
        total = defaultdict(float)
        for a, b, g in zip(span_label, op_label, gaps[:, 1] - gaps[:, 0]):
            total[f"{a}: {b}"] += g * 1e-9
        top = sorted(total.items(), key=lambda kv: -kv[1])[:k]
        return [[n, v] for n, v in top]

    def _label(self, times, spans):
        """The innermost host interval containing each of ``times``: the
        benchmark's spans (``spans``) or the other host operations."""
        ev = [e for e in self.host
              if e[0].startswith(SPAN_PREFIX) == spans and e[0] != WINDOW]
        none = "window" if spans else "between operations"
        if not ev:
            return [none] * len(times)
        names = [e[0] for e in ev]
        start = np.array([e[1] for e in ev], np.float64)
        end = np.array([e[2] for e in ev], np.float64)
        # parent[i]: the innermost earlier interval that contains interval i
        parent = np.full(len(ev), -1)
        stack = []
        for i in range(len(ev)):
            while stack and end[stack[-1]] < end[i]:
                stack.pop()
            parent[i] = stack[-1] if stack else -1
            stack.append(i)
        idx = np.searchsorted(start, times, side="right") - 1
        found = np.full(len(times), -1)
        for _ in range(64):
            live = (idx >= 0) & (found < 0)
            if not live.any():
                break
            hit = live & (end[np.maximum(idx, 0)] >= times)
            found[hit] = idx[hit]
            step = live & ~hit
            idx[step] = parent[idx[step]]
        out = []
        for f in found:
            if f < 0:
                out.append(none)
            else:
                n = names[f]
                out.append(n[len(SPAN_PREFIX):] if spans else n)
        return out
