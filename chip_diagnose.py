#!/usr/bin/env python3
"""Where the flagship's time goes on a GPU: the diagnostics behind PERF.md.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_diagnose.py [--profile FILE]

It builds the flagship tracer of ``chip_smoke.py`` (same geometry, particle,
seed and batch; the default tracer, whose body is the fused bounce kernel),
warms it up with one apply, and prints one JSON object per phase:

- ``repeats``: five more applies of the one tracer (each a new run number, so
  a new seed): wall seconds, the process's CPU seconds, the bounce count and
  the kernel launches of each, and the caching allocator's counters
  afterwards;
- ``kernel_spans``: one apply with CUDA events around every launch of the
  kernels: the seconds inside those spans (a span also holds any wait for the
  host between its two events, so this bounds the kernels' device time from
  above), the share of wall time outside them, and the number of launches at
  each (stage width, bounces per launch);
- with ``--unfused``: both phases once more for ``TraceDisk(fused=False)``,
  the unfused body, in the same process;
- with ``--profile FILE``: one apply of the default tracer under
  ``torch.profiler``, whose tables of kernels and host operators go to FILE.

It checks nothing: ``chip_smoke.py`` holds the kernels and the flux to their
references.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from chip_smoke import FLAGSHIP, make_tracer, read_launches, reset_launches
from viennaray_tpu_torch.ops import bounce as B


def repeats(tracer, n, body):
    seconds, cpu_seconds, bounces, launches = [], [], [], []
    for _ in range(n):
        reset_launches()
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.process_time()
        tracer.apply()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        cpu_seconds.append(time.process_time() - c0)
        counts = read_launches()
        launches.append(counts)
        # the unfused body launches the closest-hit kernel once per bounce
        bounces.append(B.fused_bounce.sub_bounces or counts["disk_nearest_hit"])
    allocator = torch.cuda.memory_stats()
    return {
        "phase": "repeats", "body": body, "seconds": seconds,
        "cpu_seconds": cpu_seconds, "bounces": bounces, "launches": launches,
        "allocator": {k: allocator[k] for k in (
            "num_device_alloc", "num_device_free", "num_alloc_retries")},
    }


def kernel_spans(tracer, body):
    from viennaray_tpu_torch.trace import kernel as TK

    names = ("fused_bounce", "disk_nearest_hit", "flux_histogram")
    spans = {name: [] for name in names}
    widths = {}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            if name == "fused_bounce":  # (state, uniforms, ...), n_sub=
                key = f"{args[0].org.shape[0]}x{kwargs['n_sub']}"
                widths[key] = widths.get(key, 0) + 1
            elif name == "disk_nearest_hit":  # one call per bounce, (R, 3) rays
                key = f"{args[0].shape[0]}x1"
                widths[key] = widths.get(key, 0) + 1
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kwargs)
            b.record()
            spans[name].append((a, b))
            return out
        return wrapper

    # the trace module's own references: the wrappers themselves stay as
    # they are, with their launch counts
    real = {name: getattr(TK, name) for name in names}
    for name in names:
        setattr(TK, name, timed(name, real[name]))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tracer.apply()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for name in names:
            setattr(TK, name, real[name])
    in_kernels = {
        name: sum(a.elapsed_time(b) for a, b in evs) / 1e3
        for name, evs in spans.items()
    }
    return {
        "phase": "kernel_spans", "body": body, "seconds": wall,
        "seconds_in_kernels": in_kernels,
        "share_outside_kernels": 1.0 - sum(in_kernels.values()) / wall,
        "launches_by_width_x_bounces": widths,
    }


def profile_apply(tracer, path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tracer.apply()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(averages.table(sort_by="cuda_time_total", row_limit=40))
        f.write("\n\n")
        f.write(averages.table(sort_by="self_cpu_time_total", row_limit=25))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument(
        "--unfused", action="store_true",
        help="also time the unfused body, TraceDisk(fused=False), beside "
             "the fused one",
    )
    parser.add_argument(
        "--profile", metavar="FILE", default=None,
        help="also run one apply under torch.profiler and write its tables "
             "of kernels and host operators to FILE",
    )
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_diagnose.py needs a CUDA device and found none",
              file=sys.stderr)
        return 1
    from viennaray_tpu_torch.io import fixtures

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0], flush=True)
    pts, nrm = fixtures.create_trench_grid_3d(**FLAGSHIP)
    tracers = {"fused": make_tracer(pts, nrm)}
    if args.unfused:
        tracers["unfused"] = make_tracer(pts, nrm, fused=False)
    for body, tracer in tracers.items():
        tracer.apply()  # warm-up: builds the kernels, fills the allocator
        print(json.dumps(repeats(tracer, args.repeats, body)), flush=True)
        print(json.dumps(kernel_spans(tracer, body)), flush=True)
    if args.profile:
        profile_apply(tracers["fused"], args.profile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
