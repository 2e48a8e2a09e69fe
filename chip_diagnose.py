#!/usr/bin/env python3
"""Where a configuration's time goes on a GPU: the diagnostics behind PERF.md.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_diagnose.py [--triangles | --lines | --ion | --window]
                             [--unfused] [--profile FILE]

It builds a tracer of ``chip_smoke.py`` (same geometry, particle, seed and
batch; the default tracer, whose body is the fused bounce kernel): the
2,993-disk trench through ``TraceDisk``; with ``--triangles`` the
5,760-triangle trench through ``TraceTriangle``; with ``--lines`` the
782-segment 2D trench with two materials through ``TraceLine``; with ``--ion``
the 2,993 disks under the coned-cosine particle; with ``--window`` the 2,993
disks under the window flux model. It warms the tracer up with one apply and
prints one JSON object per phase:

- ``repeats``: five more applies of the one tracer (each a new run number, so
  a new seed): wall seconds, the process's CPU seconds, the bounce count and
  the kernel launches of each, and the caching allocator's counters
  afterwards;
- ``kernel_spans``: one apply with CUDA events around every launch of the
  kernels: the seconds inside those spans (a span also holds any wait for the
  host between its two events, so this bounds the kernels' device time from
  above), the share of wall time outside them, and the number of launches
  and the seconds of the bounce or closest-hit kernel at each (stage width,
  bounces per launch);
- with ``--unfused``: both phases once more for the tracer with
  ``fused=False``, the unfused body, in the same process;
- with ``--triangles`` or ``--window``, ``deposit_policy``: two fused
  tracers in turns, run number by run number (so both trace the same rays;
  which goes first alternates): one deposits in the bounce kernel at every
  width (the port's rule for triangles and for window deposits), the other
  hands the deposits of a diffuse particle's one-bounce launches out to the
  histogram kernel on 4 chunks or more (the reference's rule for triangles;
  for window deposits, through the window list, a placement the reference
  does not have);
- with ``--profile FILE``: one apply of the default tracer under
  ``torch.profiler``, whose tables of kernels and host operators go to FILE.

``python3 chip_diagnose.py --launch-times TREE [TREE ...]`` is another mode,
for comparing two versions of the bounce kernel on one card: for each TREE
in turn (a checkout of this repository, for instance the parent commit
unpacked by ``git archive`` beside ``.``; name each twice, in the order
parent, change, change, parent) a fresh process builds THAT tree's kernels
and times its bounce kernel on both flagships at 2^20 rays x 1 bounce and at
512 rays x 16, and prints ``ptxas``' lines of its bounce kernel.

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

from chip_smoke import (
    FLAGSHIP,
    ion_particle,
    make_line_tracer,
    make_tracer,
    make_tri_tracer,
    read_launches,
    reset_launches,
)
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
        bounces.append(
            B.fused_bounce.sub_bounces or counts["disk_nearest_hit"]
            or counts["triangle_nearest_hit"] or counts["line_nearest_hit"]
        )
    allocator = torch.cuda.memory_stats()
    return {
        "phase": "repeats", "body": body, "seconds": seconds,
        "cpu_seconds": cpu_seconds, "bounces": bounces, "launches": launches,
        "allocator": {k: allocator[k] for k in (
            "num_device_alloc", "num_device_free", "num_alloc_retries")},
    }


def kernel_spans(tracer, body):
    from viennaray_tpu_torch.trace import kernel as TK

    search = f"{tracer.geometry.kind}_nearest_hit"
    names = ("fused_bounce", search, "flux_histogram")
    spans = {name: [] for name in names}
    by_width = {}  # "width x bounces" -> that kernel's spans

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            key = None
            if name == "fused_bounce":  # (state, uniforms, ...), n_sub=
                key = f"{args[0].org.shape[0]}x{kwargs['n_sub']}"
            elif name == search:  # one call per bounce, (R, 3) rays
                key = f"{args[0].shape[0]}x1"
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kwargs)
            b.record()
            spans[name].append((a, b))
            if key is not None:
                by_width.setdefault(key, []).append((a, b))
            return out
        return wrapper

    # the trace module's own references (the closest-hit wrapper sits in its
    # table by geometry kind): the wrappers themselves stay as they are, with
    # their launch counts
    kind = tracer.geometry.kind
    real = {"fused_bounce": TK.fused_bounce, search: TK._SEARCH[kind],
            "flux_histogram": TK.flux_histogram}

    def install(fns):
        TK.fused_bounce = fns["fused_bounce"]
        TK.flux_histogram = fns["flux_histogram"]
        TK._SEARCH[kind] = fns[search]

    install({name: timed(name, fn) for name, fn in real.items()})
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tracer.apply()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        install(real)
    def seconds(evs):
        return sum(a.elapsed_time(b) for a, b in evs) / 1e3

    in_kernels = {name: seconds(evs) for name, evs in spans.items()}
    return {
        "phase": "kernel_spans", "body": body, "seconds": wall,
        "seconds_in_kernels": in_kernels,
        "share_outside_kernels": 1.0 - sum(in_kernels.values()) / wall,
        "launches_by_width_x_bounces": {
            key: len(evs) for key, evs in by_width.items()
        },
        "seconds_by_width_x_bounces": {
            key: seconds(evs) for key, evs in by_width.items()
        },
    }


def reference_hand_out_rule(kind, n_chunks, refl_kind, n_sub):
    """The JAX package's placement of deposits (its trace/kernel.py:1049-1065)
    for every geometry kind, and for window deposits too (which the JAX
    package never hands out)."""
    from viennaray_tpu_torch.config import ReflectionKind
    from viennaray_tpu_torch.trace.kernel import HAND_OUT_MIN_CHUNKS

    return (n_sub == 1 and refl_kind == ReflectionKind.DIFFUSE
            and n_chunks >= HAND_OUT_MIN_CHUNKS)


def deposit_policy(make, n):
    """Applies of two fused tracers in turns: one under the port's placement
    of deposits (``hand_out_for``: triangles deposit in the kernel), one
    under the reference's rule, put in its place for that tracer's applies.
    Both start at the same run number, so apply i of one traces the rays of
    apply i of the other. Which of the two goes first alternates from round
    to round."""
    from viennaray_tpu_torch.trace import kernel as TK

    rules = {"in_kernel": TK.hand_out_for,
             "handed_out": reference_hand_out_rule}
    tracers = {name: make() for name in rules}
    seconds = {name: [] for name in rules}
    launches = {name: [] for name in rules}
    try:
        for i in range(-1, n):  # round -1 warms both tracers up
            for name in list(rules)[::-1] if i % 2 else list(rules):
                TK.hand_out_for = rules[name]
                reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tracers[name].apply()
                torch.cuda.synchronize()
                if i >= 0:
                    seconds[name].append(time.perf_counter() - t0)
                    launches[name].append(read_launches())
    finally:
        TK.hand_out_for = rules["in_kernel"]
    return {"phase": "deposit_policy", "seconds": seconds,
            "launches": launches}


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


# run as ``python3 -c LAUNCH_TIMES tree``: imports the tree's own modules
LAUNCH_TIMES = """
import contextlib, io, json, os, sys
root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
os.chdir(root)
import chip_smoke as cs
from viennaray_tpu_torch import _build
from viennaray_tpu_torch.geometry.disk_geometry import DiskGeometry
from viennaray_tpu_torch.geometry.triangle_geometry import TriangleGeometry
from viennaray_tpu_torch.io import fixtures
_build.library()
lines = [l.strip() for l in _build.build_log.splitlines()]
out = {"tree": sys.argv[1], "ptxas": [
    l for i, l in enumerate(lines)
    if "bounce_kernel" in l or any("bounce_kernel" in p for p in lines[max(i - 2, 0):i])
]}
gd = cs.FLAGSHIP["grid_delta"]
geometries = {
    "disks": DiskGeometry.build(*fixtures.create_trench_grid_3d(**cs.FLAGSHIP), gd),
    "triangles": TriangleGeometry.build(
        *fixtures.create_trench_mesh_3d(**cs.FLAGSHIP), gd),
}
flagship = cs.bounce_settings()
with contextlib.redirect_stdout(io.StringIO()):
    for name, geometry in geometries.items():
        bbox = cs.adjusted_bbox(geometry)
        out[name + "_1048576x1_ms"] = [
            cs.check_bounce(geometry, bbox, 1 << 20, "source", 1, False,
                            flagship, reps=20)["ms"] for _ in range(2)]
        out[name + "_512x16_ms"] = cs.check_bounce(
            geometry, bbox, 512, "interior", 16, True, flagship, reps=100)["ms"]
print(json.dumps(out), flush=True)
"""


def launch_times(trees):
    """One fresh process per tree, in the order given."""
    for tree in trees:
        subprocess.run([sys.executable, "-c", LAUNCH_TIMES, tree], check=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--launch-times", nargs="+", metavar="TREE", default=None,
        help="only time the bounce kernel's flagship launches of each "
             "checkout named, one process each, in the order given",
    )
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument(
        "--unfused", action="store_true",
        help="also time the unfused body (fused=False) beside the fused one",
    )
    which = parser.add_mutually_exclusive_group()
    which.add_argument(
        "--triangles", action="store_true",
        help="the 5,760-triangle flagship through TraceTriangle instead of "
             "the 2,993-disk one, and its two deposit placements in turns",
    )
    which.add_argument(
        "--lines", action="store_true",
        help="the 782-segment 2D trench with per-material sticking through "
             "TraceLine",
    )
    which.add_argument(
        "--ion", action="store_true",
        help="the 2,993 disks under the coned-cosine particle (sticking "
             "0.5, cone angle pi/6, source power 100)",
    )
    which.add_argument(
        "--window", action="store_true",
        help="the 2,993 disks under the window flux model, and its two "
             "deposit placements in turns",
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
    if args.launch_times:
        launch_times(args.launch_times)
        return 0
    if args.triangles:
        mesh = fixtures.create_trench_mesh_3d(**FLAGSHIP)
        make = lambda **kwargs: make_tri_tracer(*mesh, **kwargs)
    elif args.lines:
        make = make_line_tracer
    elif args.ion:
        cloud = fixtures.create_trench_grid_3d(**FLAGSHIP)
        make = lambda **kwargs: make_tracer(
            *cloud, particle=ion_particle(), **kwargs)
    elif args.window:
        cloud = fixtures.create_trench_grid_3d(**FLAGSHIP)
        make = lambda **kwargs: make_tracer(
            *cloud, flux_model="window", **kwargs)
    else:
        cloud = fixtures.create_trench_grid_3d(**FLAGSHIP)
        make = lambda **kwargs: make_tracer(*cloud, **kwargs)
    tracers = {"fused": make()}
    if args.unfused:
        tracers["unfused"] = make(fused=False)
    for body, tracer in tracers.items():
        tracer.apply()  # warm-up: builds the kernels, fills the allocator
        print(json.dumps(repeats(tracer, args.repeats, body)), flush=True)
        print(json.dumps(kernel_spans(tracer, body)), flush=True)
    if args.triangles or args.window:
        print(json.dumps(deposit_policy(make, args.repeats)), flush=True)
    if args.profile:
        profile_apply(tracers["fused"], args.profile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
