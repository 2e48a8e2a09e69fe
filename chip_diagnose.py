#!/usr/bin/env python3
"""Where a configuration's time goes on a GPU: the diagnostics behind PERF.md.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_diagnose.py [--triangles | --lines | --ion | --window |
                              --disk1m]
                             [--unfused] [--profile FILE]
    python3 chip_diagnose.py --groups | --paths | --grad | --f64 | --grid |
                             --resort | --small-sweep
    python3 chip_diagnose.py [--grid | --resort | --paths] --launch-times
                             TREE ...

It builds a tracer of ``chip_smoke.py`` (same geometry, particle, seed and
batch; the default tracer, whose body is the fused bounce kernel): the
2,993-disk trench through ``TraceDisk``; with ``--triangles`` the
5,760-triangle trench through ``TraceTriangle``; with ``--lines`` the
782-segment 2D trench with two materials through ``TraceLine``; with ``--ion``
the 2,993 disks under the coned-cosine particle; with ``--window`` the 2,993
disks under the window flux model; with ``--disk1m`` the sweep's 704,250-disk
cell (``viennaray_tpu_torch/bench/perf_sweep.py``). It warms the tracer up with
one apply and
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
for comparing two versions of the kernels on one card: for each TREE in
turn (a checkout of this repository, for instance the parent commit unpacked
by ``git archive`` beside ``.``; name each twice, in the order parent,
change, change, parent) a fresh process builds THAT tree's kernels, times
its closest-hit kernels (disks, triangles, lines) at 2^20 source rays and
at every width of the unfused ladder (2^20 rays down to 512) on interior
rays, on the 2,993 disks, the 5,760 triangles, the 782 segments and the
18,180 disks, and its bounce kernel on both flagships at 2^20 rays x 1
bounce and at 512 rays x 16, and prints ``ptxas``' lines of its bounce and
closest-hit kernels.

With ``--grid``, ``--launch-times TREE [TREE ...]`` times each tree's grid
walk instead (``GRID_TIMES``: the grid kernel at 2^20 source rays and kernel
4's grid search at 2^20 x 1, 16,384 x 4 and 512 x 16 on the trench at
9,216, 18,180, 72,360 and 704,250 disks, the float64 grid kernel at 18,180,
the 36,000 triangles, then two applies of disk1m with its grid and its
kernel spans); with ``--resort``, the state's permutation at the resort
path's six shapes beside its plain version and the ``index_select`` calls,
the compaction's own takes at three widths, and the coherence key at the
same widths (2^20, 2^18 and 2^16 lanes, 8 and 32 bins) on the device alone
and as the host issues it (``PERMUTE_TIMES``), after ``cuobjdump -sass`` of
each tree's ``permute.cu`` (``build/sass/permute_<n>.sass``, and the global
loads and stores of its kernels); with ``--paths``, kernel 2 (``HIST_TIMES``:
every path and branch of each tree at the main path's shapes, the small
path's shapes in both types and the entries around ``SMALL_ENTRIES`` up to
196,608, on the device alone beside ``index_add_``, with the host's time to
issue a call of each path; then six applies' flux digests), after the
SASS of each tree's ``flux_histogram.cu``.

``python3 chip_diagnose.py --grad`` times the differentiable trace
(``viennaray_tpu_torch.diff``) as ``chip_smoke.py``'s ``phase_grad_paths``
drives it: BASELINE config 5's d sum(flux) / d sticking (10^7 rays) and
d / d points under 1/distance weighting (2^21 rays), each warmed up, then
``--repeats`` runs (wall and CPU seconds), then one run under
``torch.profiler``: its device busy seconds (the kernels' own durations),
the idle share of its wall time, and the operators and kernels that hold
the most device time.

``python3 chip_diagnose.py --groups`` times the bounce kernel under every
instantiated group size G (threads per ray) at every width of the trace's
ladder (2^20 rays down to 512, with the ladder's bounces per launch and
deposit placement), on the disk flagship, its window form, the triangle
flagship, the line configuration and the 18,180-disk trench, in two rounds of
alternating order, one process: the measurement behind
``ops/bounce.py:group_for``. ``--paths`` times the histogram kernel's
two paths beside one ``index_add_`` call at numbers of entries from 2,048 to
2^20 on the flagship's 2,993 bins, as the host issues them.
``--small-sweep`` times the small path at every cluster size C = 1 to 16 on
copies of this tree (``build/small_sweep/c<C>``, each whose rule takes its
C), at 512 to 24,575 entries on 2,993 and 18,180 bins in float32 and
float64, beside ``index_add_``: the measurement behind
``csrc/histogram_cluster.cuh:small_cluster_shift``.

In the default mode the fused body's ``kernel_spans`` run twice more on fresh
tracers (so on the same rays as each other), with every launch of the bounce
kernel at one thread per ray (``group=1``, the mapping before the group
search) and at the default G, in that order and again reversed.

``python3 chip_diagnose.py --f64`` traces the disk and triangle flagships
through ``trace_batch``'s unfused body in float32 and float64 in turns
(``chip_smoke.py:trace_unfused``: the rays of ``phase_f64_paths``, 500 per
disk and 250 per triangle, ``--repeats`` rounds): per run the seconds, the
launches of the search, and the last survivors of each batch (when at most
eight rays are left: their boundary hits, reflections, direction z and
weight), which say what the ladder's tail is spent on.

``python3 chip_diagnose.py --grid`` times the chunk search against the grid
walk (``ops/grid_traverse.py``, kernel 4's grid search) on the trench at
six sizes, 2,993 to 704,250 disks (grid delta 0.25, 0.18, 0.14, 0.1, 0.05,
0.016), in ``--repeats`` rounds whose order of the two searches
alternates, one process: the closest-hit kernel (kernel 1 against the grid
kernel) at 2^20 source and interior rays, and kernel 4 at 2^20 x 1, 16,384
x 4 and 512 x 16 on one seeded state each: the measurement behind the path
rule (``trace/kernel.py:grid_for``). Then disk1m (the sweep's cell, built
with its grid) through ``TraceDisk`` with the grid and without, in turns:
``repeats`` and ``kernel_spans`` of each.

``python3 chip_diagnose.py --resort`` weighs the per-bounce coherence
resort (``trace/kernel.py:resort``) on the four geometries where its gate
holds: the triangle flagship (11,520,000 rays), disk18k (200 rays per
point, with its grid), disk1m (with its grid) and the 36,000-triangle trench
(grid delta 0.1, 100 rays per triangle, with its grid), each through the
default fused tracer with the resort (``bounce_sort=True``) and without, in
turns, ``--repeats`` rounds (default 2) whose order alternates, one process.
Per apply: wall and CPU seconds, the seconds in kernel 4's spans and the
share of wall time outside every kernel's span, cells or chunks a search
(``chunks_swept / tile_bounces``), the resort's calls and their seconds
(key, sort and permutation between two events), and the permutation's
and the key's other launches (source sort, compactions) and their seconds.

It checks nothing: ``chip_smoke.py`` holds the kernels and the flux to their
references.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import functools

import torch

import chip_smoke as cs
from chip_smoke import (
    FLAGSHIP,
    ion_particle,
    make_line_tracer,
    make_tracer,
    make_tri_tracer,
    launches_since,
)
from viennaray_tpu_torch.ops import bounce as B
from viennaray_tpu_torch.utils import telemetry


def repeats(tracer, n, body):
    seconds, cpu_seconds, bounces, launches = [], [], [], []
    for _ in range(n):
        before = dict(telemetry.COUNTS)
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.process_time()
        tracer.apply()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        cpu_seconds.append(time.process_time() - c0)
        counts = telemetry.since(before)
        launches.append(launches_since(before))
        # the unfused body launches the closest-hit kernel once per bounce
        bounces.append(
            counts["fused_bounce.sub_bounces"]
            or counts[cs.DISK] or counts[cs.TRI] or counts[cs.LINE]
        )
    allocator = torch.cuda.memory_stats()
    return {
        "phase": "repeats", "body": body, "seconds": seconds,
        "cpu_seconds": cpu_seconds, "bounces": bounces, "launches": launches,
        "allocator": {k: allocator[k] for k in (
            "num_device_alloc", "num_device_free", "num_alloc_retries")},
    }


def kernel_spans(tracer, body, group=None):
    """One apply with CUDA events around every kernel launch; ``group``
    forces the bounce kernel's threads per ray on every launch."""
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
    bounce = (B.fused_bounce if group is None
              else functools.partial(B.fused_bounce, group=group))
    real = {"fused_bounce": TK.fused_bounce, search: TK._SEARCH[kind],
            "flux_histogram": TK.flux_histogram}

    def install(fns):
        TK.fused_bounce = fns["fused_bounce"]
        TK.flux_histogram = fns["flux_histogram"]
        TK._SEARCH[kind] = fns[search]

    install({name: timed(name, bounce if name == "fused_bounce" else fn)
             for name, fn in real.items()})
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
        "group": "by width" if group is None else group,
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
                before = dict(telemetry.COUNTS)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tracers[name].apply()
                torch.cuda.synchronize()
                if i >= 0:
                    seconds[name].append(time.perf_counter() - t0)
                    launches[name].append(launches_since(before))
    finally:
        TK.hand_out_for = rules["in_kernel"]
    return {"phase": "deposit_policy", "seconds": seconds,
            "launches": launches}


def group_ab(rounds=2):
    """The bounce kernel under every G of ``B.GROUPS`` at every width of the
    ladder, with the ladder's bounces per launch and deposit placement, on
    interior rays of ``chip_smoke.make_state``; rounds in alternating order
    of G. One JSON object per (configuration, width)."""
    from viennaray_tpu_torch.geometry.disk_geometry import DiskGeometry
    from viennaray_tpu_torch.geometry.line_geometry import LineGeometry
    from viennaray_tpu_torch.geometry.triangle_geometry import TriangleGeometry
    from viennaray_tpu_torch.io import fixtures
    from viennaray_tpu_torch.trace import kernel as TK

    gd = FLAGSHIP["grid_delta"]
    disks = DiskGeometry.build(*fixtures.create_trench_grid_3d(**FLAGSHIP), gd)
    fine = dict(FLAGSHIP, grid_delta=0.1)
    mesh, materials = cs.line_trench()
    lines = LineGeometry.from_mesh(mesh, material_ids=materials)
    configs = {
        "disks": (disks, cs.bounce_settings(), "interior", None),
        "window": (disks.with_window_list(),
                   cs.bounce_settings(flux_model="window"), "interior", None),
        "triangles": (TriangleGeometry.build(
            *fixtures.create_trench_mesh_3d(**FLAGSHIP), gd),
            cs.bounce_settings(), "interior", None),
        "lines": (lines, cs.bounce_settings(dim=2, particle=cs.line_particle()),
                  "flat", cs.line_particle()),
        "disks_18180": (DiskGeometry.build(
            *fixtures.create_trench_grid_3d(**fine), fine["grid_delta"]),
            cs.bounce_settings(), "interior", None),
    }
    widths = [1 << k for k in range(20, 8, -1)]
    for name, (geometry, settings, rays, particle) in configs.items():
        bbox = cs.adjusted_bbox(geometry, dim=settings.dim)
        walls = B.make_walls(bbox, geometry, settings)
        stick_lanes = (None if particle is None
                       else B.sticking_lanes(particle, geometry))
        for width in widths:
            n_sub = TK.n_sub_for(width, TK.N_SUB)
            hand_out = TK.hand_out_for(
                settings.deposit_kind(geometry),
                geometry.soa_chunk_bbs.shape[0], settings.refl_kind, n_sub)
            state, uniforms = cs.make_state(geometry, bbox, width, rays,
                                            n_sub, settings, seed=13)
            args = (state, uniforms, geometry, walls, settings)
            kw = dict(n_sub=n_sub, deposit_in_kernel=not hand_out,
                      stick_lanes=stick_lanes)
            reps = 3 if width >= 1 << 17 else 10
            ms = {g: [] for g in B.GROUPS}
            for r in range(rounds):
                for g in B.GROUPS if r % 2 == 0 else B.GROUPS[::-1]:
                    ms[g].append(cs.time_cuda(
                        lambda g=g: B.fused_bounce(*args, **kw, group=g),
                        reps))
            mean = {g: sum(v) / len(v) for g, v in ms.items()}
            print(json.dumps({
                "phase": "group_ab", "config": name, "width": width,
                "n_sub": n_sub, "deposits_handed_out": hand_out,
                "ms_by_group": {str(g): v for g, v in ms.items()},
                "best_group": min(mean, key=mean.get),
                "default_group": B.group_for(
                    width, geometry.soa_chunk_bbs.shape[0]),
            }), flush=True)


def histogram_paths(rounds=2):
    """The histogram kernel's two paths and ``index_add_`` by number of
    entries, on one bounce's worth of the flagship's deposits (2,993 bins),
    in two rounds of alternating order."""
    from viennaray_tpu_torch.geometry.disk_geometry import DiskGeometry
    from viennaray_tpu_torch.io import fixtures
    from viennaray_tpu_torch.ops import histogram as H

    geometry = DiskGeometry.build(*fixtures.create_trench_grid_3d(**FLAGSHIP),
                                  FLAGSHIP["grid_delta"])
    n_bins = geometry.num_primitives
    # 2^17 rays' deposits: 12 entries a ray, 1,572,864 in all
    all_ids, all_w = cs.make_deposits(geometry, 1 << 17, n_bins, seed=11)
    for n in (2048, 6144, 16384, 32768, 49152, 65536, 98304, 131072, 262144,
              1 << 20):
        ids, w = all_ids[:n].contiguous(), all_w[:n].contiguous()
        ids64 = ids.long()
        calls = {
            "small": lambda: H.flux_histogram(ids, w, n_bins, path="small"),
            "large": lambda: H.flux_histogram(ids, w, n_bins, path="large"),
            "index_add_": lambda: torch.zeros(n_bins, device=w.device)
            .index_add_(0, ids64, w),
        }
        ms = {name: [] for name in calls}
        for r in range(rounds):
            for name in list(calls) if r % 2 == 0 else list(calls)[::-1]:
                ms[name].append(cs.time_cuda(calls[name], 200))
        print(json.dumps({
            "phase": "histogram_paths", "entries": n, "bins": n_bins,
            "ms": ms, "default_path": H.path_for(n, n_bins),
        }), flush=True)


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


def grad_runs(n):
    """The gradient paths of ``chip_smoke.phase_grad_paths``: one JSON
    object each (see the module's docstring)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from viennaray_tpu_torch.geometry.disk_geometry import DiskGeometry
    from viennaray_tpu_torch.io import fixtures

    geometry = DiskGeometry.build(*fixtures.create_trench_grid_3d(**FLAGSHIP),
                                  FLAGSHIP["grid_delta"])
    sticking = cs.grad_problem(geometry)
    wdist = cs.grad_problem(geometry, use_wdist=True)
    runs = {
        "sticking_1e7": lambda: cs.grad_sticking(geometry, sticking,
                                                 cs.GRAD["rays"]),
        "points_wdist_2e21": lambda: cs.grad_geometry(
            geometry, wdist, cs.GRAD_SIDE_RAYS, "points"),
    }
    for name, run in runs.items():
        run()  # warm-up
        walls, cpus = [], []
        for _ in range(n):
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), time.process_time()
            run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            cpus.append(time.process_time() - c0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kernels) / 1e6
        ops = sorted(prof.key_averages(), reverse=True,
                     key=lambda e: e.device_time_total)
        print(json.dumps({
            "phase": "grad_" + name, "wall_s": walls, "cpu_s": cpus,
            "profiled_wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / wall,
            "top_kernels_ms": [
                (e.key[:80], e.count, e.self_device_time_total / 1e3)
                for e in sorted(kernels, reverse=True,
                                key=lambda e: e.self_device_time_total)[:12]],
            "top_operators_device_ms": [
                (e.key[:80], e.count, e.device_time_total / 1e3)
                for e in ops if e.device_type != DeviceType.CUDA][:12],
        }), flush=True)


# run as ``python3 -c LAUNCH_TIMES tree``: imports the tree's own modules
LAUNCH_TIMES = """
import contextlib, io, json, os, sys
root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
os.chdir(root)
import chip_smoke as cs
from viennaray_tpu_torch import _build
from viennaray_tpu_torch.geometry.disk_geometry import DiskGeometry
from viennaray_tpu_torch.geometry.line_geometry import LineGeometry
from viennaray_tpu_torch.geometry.triangle_geometry import TriangleGeometry
from viennaray_tpu_torch.io import fixtures
_build.library()
lines = [l.strip() for l in _build.build_log.splitlines()]
names = ("bounce_kernel", "nearest_hit_kernel")
out = {"tree": sys.argv[1], "ptxas": [
    l for i, l in enumerate(lines)
    if any(n in l or any(n in p for p in lines[max(i - 2, 0):i]) for n in names)
]}
gd = cs.FLAGSHIP["grid_delta"]
geometries = {
    "disks": DiskGeometry.build(*fixtures.create_trench_grid_3d(**cs.FLAGSHIP), gd),
    "triangles": TriangleGeometry.build(
        *fixtures.create_trench_mesh_3d(**cs.FLAGSHIP), gd),
}
mesh, materials = cs.line_trench()
fine = dict(cs.FLAGSHIP, grid_delta=0.1)
searches = (
    ("disks", geometries["disks"], 3, "source", "interior"),
    ("triangles", geometries["triangles"], 3, "source", "interior"),
    ("lines", LineGeometry.from_mesh(mesh, material_ids=materials), 2,
     "flat_source", "flat"),
    ("disks_18180", DiskGeometry.build(
        *fixtures.create_trench_grid_3d(**fine), fine["grid_delta"]), 3,
     "source", "interior"),
)
flagship = cs.bounce_settings()
with contextlib.redirect_stdout(io.StringIO()):
    # the closest-hit kernels (kernels 1, 3 and lines): 2^20 source rays,
    # then every width of the unfused ladder on interior rays
    for name, geometry, dim, source, interior in searches:
        bbox = cs.adjusted_bbox(geometry, dim=dim)
        for kind, n in [(source, 1 << 20)] + [
                (interior, 1 << k) for k in range(20, 8, -1)]:
            out[f"search_{name}_{kind}_{n}_ms"] = cs.check_nearest_hit(
                geometry, bbox, n, kind, reps=10 if n >= 1 << 17 else 50)["ms"]
    for name, geometry in geometries.items():
        bbox = cs.adjusted_bbox(geometry)
        out[name + "_1048576x1_ms"] = [
            cs.check_bounce(geometry, bbox, 1 << 20, "source", 1, False,
                            flagship, reps=20)["ms"] for _ in range(2)]
        out[name + "_512x16_ms"] = cs.check_bounce(
            geometry, bbox, 512, "interior", 16, True, flagship, reps=100)["ms"]
print(json.dumps(out), flush=True)
"""


# run as ``python3 -c GRID_TIMES tree``: imports the
# tree's own modules, calls only what every tree since the grid's port has
GRID_TIMES = """
import contextlib, io, json, os, sys
root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
os.chdir(root)
import torch
import chip_smoke as cs
import chip_diagnose as cd
from viennaray_tpu_torch import _build
from viennaray_tpu_torch.bench import perf_sweep
from viennaray_tpu_torch.geometry.disk_geometry import DiskGeometry
from viennaray_tpu_torch.geometry.triangle_geometry import TriangleGeometry
from viennaray_tpu_torch.io import fixtures
from viennaray_tpu_torch.ops import bounce as B
from viennaray_tpu_torch.ops import grid_traverse as GT
_build.library()
lines = [l.strip() for l in _build.build_log.splitlines()]
names = ("bounce_kernel", "bounce_grid_kernel", "grid_hit_kernel")
out = {"tree": sys.argv[1], "ptxas": [
    l for i, l in enumerate(lines)
    if any(n in l or any(n in p for p in lines[max(i - 2, 0):i]) for n in names)
]}
settings = cs.bounce_settings()
F64 = torch.float64
sizes = ((0.14, "disk9k"), (0.1, "disk18k"), (0.05, "disk72k"),
         (0.016, "disk1m"))
with contextlib.redirect_stdout(io.StringIO()):
    for gd, name in sizes:
        pts, nrm = (perf_sweep.fixture("disk1m") if name == "disk1m" else
                    fixtures.create_trench_grid_3d(
                        **dict(cs.FLAGSHIP, grid_delta=gd)))
        geo = DiskGeometry.build(pts, nrm, gd, pack_neighbors=False)
        geo = geo.with_neighbor_pack()
        bbox = cs.adjusted_bbox(geo)
        o, d = cs.make_rays(geo, bbox, 1 << 20, "source", seed=7)
        out[name + "_grid_hit_ms"] = cs.time_cuda(
            lambda: GT.disk_grid_nearest_hit(o, d, geo.prims_soa,
                                             geo.soa_perm, geo.grid), 5)
        if name == "disk18k":
            g64 = geo.to(F64)
            o64, d64 = o.to(F64), d.to(F64)
            out[name + "_grid_hit_f64_ms"] = cs.time_cuda(
                lambda: GT.disk_grid_nearest_hit(
                    o64, d64, g64.prims_soa, g64.soa_perm, g64.grid), 5)
            del g64
        walls = B.make_walls(bbox, geo, settings)
        for n, k in ((1 << 20, 1), (16384, 4), (512, 16)):
            state, uni = cs.make_state(geo, bbox, n, "interior", k, settings,
                                       seed=13)
            out[f"{name}_kernel4_grid_{n}x{k}_ms"] = cs.time_cuda(
                lambda: B.fused_bounce(state, uni, geo, walls, settings,
                                       n_sub=k, grid=geo.grid),
                3 if n > 65536 else 20)
        if name == "disk1m":
            tracer = perf_sweep.make_tracer("disk1m", None)
            tracer.geometry = geo
            tracer.apply()  # warm-up
            out["disk1m_repeats"] = cd.repeats(tracer, 2, "fused, grid")
            out["disk1m_kernel_spans"] = cd.kernel_spans(tracer,
                                                         "fused, grid")
            del tracer
        del geo, walls, state, uni, o, d
        torch.cuda.empty_cache()
    mesh = TriangleGeometry.build(*fixtures.create_trench_mesh_3d(
        **dict(cs.FLAGSHIP, grid_delta=0.1)), 0.1)
    bbox = cs.adjusted_bbox(mesh)
    o, d = cs.make_rays(mesh, bbox, 1 << 20, "source", seed=7)
    out["triangles_grid_hit_ms"] = cs.time_cuda(
        lambda: GT.triangle_grid_nearest_hit(o, d, mesh.prims_soa,
                                             mesh.soa_perm, mesh.grid), 5)
    m64 = mesh.to(F64)
    o64, d64 = o.to(F64), d.to(F64)
    out["triangles_grid_hit_f64_ms"] = cs.time_cuda(
        lambda: GT.triangle_grid_nearest_hit(o64, d64, m64.prims_soa,
                                             m64.soa_perm, m64.grid), 5)
    walls = B.make_walls(bbox, mesh, settings)
    state, uni = cs.make_state(mesh, bbox, 1 << 20, "source", 1, settings,
                               seed=13)
    out["triangles_kernel4_grid_1048576x1_ms"] = cs.time_cuda(
        lambda: B.fused_bounce(state, uni, mesh, walls, settings, n_sub=1,
                               grid=mesh.grid), 3)
print(json.dumps(out), flush=True)
"""

# the head of the tree scripts below: the tree's own modules first on the
# path, its kernels built, and ``device_ms``, which times calls on the device
# alone (the launches queued behind a sleep of the stream, about 50 ms:
# issuing a narrow call can take the host longer than its kernels take the
# card). A tree script runs on any tree, the parent's too, which may lack a
# helper of this file, so the helper travels in the script.
TREE_PREAMBLE = """
import contextlib, hashlib, inspect, io, json, os, sys, time
root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
os.chdir(root)
import torch
import chip_smoke as cs
from viennaray_tpu_torch import _build
_build.library()


def device_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # about 50 ms: longer than the launches
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def ptxas(name):
    lines = [l.strip() for l in _build.build_log.splitlines()]
    return [l for i, l in enumerate(lines) if name in l
            or any(name in p for p in lines[max(i - 2, 0):i])]
"""

# run as ``python3 -c PERMUTE_TIMES tree``: the state's permutation at the
# shapes of ``chip_smoke.py``'s resort path, by the tree's own check; then
# the compaction's own takes (the survivors of a state a third dead, by the
# coherence key at 8 bins, the first half of the lanes) at three widths,
# five samples of 200 launches each against the eight ``index_select`` in
# turns: ``ms`` as the host launches them, ``device_ms`` with 50 launches
# on the device alone; then the coherence key at the same three widths, 8
# and 32 bins (float64 at 2^20 lanes), five samples each on the device
# alone and as the host issues it, and the keys' digests (the trees must
# agree)
PERMUTE_TIMES = TREE_PREAMBLE + """
from viennaray_tpu_torch.geometry.triangle_geometry import TriangleGeometry
from viennaray_tpu_torch.io import fixtures
from viennaray_tpu_torch.ops import permute as PM

out = {"tree": sys.argv[1], "ptxas": ptxas("permute_state")
       + ptxas("coherence_key")}
mesh = TriangleGeometry.build(*fixtures.create_trench_mesh_3d(**cs.FLAGSHIP),
                              cs.FLAGSHIP["grid_delta"])
box = cs.adjusted_bbox(mesh)
n = cs.RESORT_LANES
with contextlib.redirect_stdout(io.StringIO()):
    for dtype in (torch.float32, torch.float64):
        for take, aux in ((n, False), (n, True), (n // 2, True)):
            res = cs.check_permute_state(mesh, box, dtype, take, aux)
            out[f"{dtype}_take{take}_aux{int(aux)}"] = {
                k: res[k] for k in ("ms", "plain_ms", "library_ms",
                                    "bound_ms", "bitwise_equal")}
    for dtype in (torch.float32, torch.float64):
        for width in (1 << 20, 1 << 18, 1 << 16):
            state, aux = cs.resort_state(mesh, box, width, dtype, seed=37)
            lo = box[0].to(dtype).contiguous()
            ext = torch.clamp(box[1] - box[0], min=1e-6).to(dtype).contiguous()
            key = PM.coherence_key(state.org, state.dirn, state.alive, lo,
                                   ext, 8)
            take = torch.argsort(key, stable=True)[:width // 2]
            arrays = list(state) + [aux]
            got = PM.permute_state(take, state, aux)
            want = PM.permute_state_ref(take, state, aux)
            equal = all(bool(torch.equal(a, b)) for a, b in
                        zip([*got[0], got[1]], [*want[0], want[1]]))
            kernel = lambda: PM.permute_state(take, state, aux)
            library = lambda: [x.index_select(0, take) for x in arrays]
            res = {"ms": [], "library_ms": [], "device_ms": [],
                   "library_device_ms": [], "bitwise_equal": equal}
            for _ in range(5):
                res["ms"].append(cs.time_cuda(kernel, 200))
                res["library_ms"].append(cs.time_cuda(library, 200))
                res["device_ms"].append(device_ms(kernel, 50))
                res["library_device_ms"].append(device_ms(library, 50))
            out[f"{dtype}_compaction{width}_aux2"] = res
            for dirbins in (8, 32):
                if dtype == torch.float64 and (width < n or dirbins == 8):
                    continue
                args = (state.org, state.dirn, state.alive, lo, ext, dirbins)
                keyed = PM.coherence_key(*args)
                call = lambda: PM.coherence_key(*args)
                res = {"device_ms": [device_ms(call, 50) for _ in range(5)],
                       "issued_ms": [cs.time_cuda(call, 200)
                                     for _ in range(5)],
                       "equal_plain": bool(torch.equal(
                           keyed, PM.coherence_key_ref(*args))),
                       "digest": hashlib.sha256(keyed.cpu().numpy()
                                                .tobytes()).hexdigest()[:16],
                       "bound_ms": width * (6 * (8 if dtype == torch.float64
                                                 else 4) + 5) / 3.35e9}
                out[f"{dtype}_key{width}_dirbins{dirbins}"] = res
print(json.dumps(out), flush=True)
"""


# the small path's shapes: E entries on n bins (the sweep of C, and the
# threshold of entries between the two paths)
SMALL_SHAPES = tuple((e, n) for n in (2993, 18180)
                     for e in (512, 6144, 12288, 24575))
THRESHOLD_ENTRIES = (24575, 32768, 49152, 65536, 98304, 114688, 131072,
                     196608)

# kernel 2's inputs in the tree scripts: one bounce's deposits as
# chip_smoke.py:make_deposits makes them, the slots a ray an argument (the
# flagship's neighbours where given), the same in every tree
DEPOSITS = f"""
SMALL_SHAPES = {SMALL_SHAPES!r}
THRESHOLD_ENTRIES = {THRESHOLD_ENTRIES!r}
dev = torch.device("cuda")


""" + """def deposits(n_rays, n_bins, slots, seed, nbrs=None):
    # chip_smoke.py:make_deposits, with the slots a ray as an argument
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if nbrs is not None:
        prim = torch.randint(n_bins, (n_rays,), generator=gen, device=dev)
        ids = torch.cat([prim[:, None].to(torch.int32),
                         torch.clamp(nbrs[prim], 0, n_bins - 1)], dim=1)
    else:
        ids = torch.randint(n_bins, (n_rays, slots), generator=gen,
                            device=dev, dtype=torch.int32)
    weight = 0.1 + 0.9 * torch.rand(n_rays, generator=gen, device=dev)
    collide = torch.rand(n_rays, generator=gen, device=dev) < 0.5
    mask = torch.rand((n_rays, slots), generator=gen, device=dev) < 0.25
    mask[:, 0] = True
    mask &= collide[:, None]
    w = torch.where(mask, weight[:, None], torch.zeros((), device=dev))
    return ids.reshape(-1).contiguous(), w.reshape(-1).contiguous()


def digest(t):
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


"""

# run as ``python3 -c HIST_TIMES tree``: kernel 2 at the main path's shapes
# on inputs made here (the same in every tree), timed on the device alone:
# the large path, each of its branches the tree has, the small path where
# the bins fit, and index_add_, five samples each in turns; the digest of
# each output (the trees' bits must agree) and whether every branch gives
# them; the host's time to issue one call of either path (the queue behind
# a sleep, so the device never holds the host back) and the calls' time as
# the host issues them back to back; then the flagship's, disk18k's and
# disk1m's applies and the unfused disk, triangle and float64 disk traces (a
# warm-up and two timed), seconds, flux digests and kernel 2's launches by
# path.
# Arguments after the tree: the shapes to run (and "applies"), by default
# all
HIST_TIMES = TREE_PREAMBLE + DEPOSITS + """
from viennaray_tpu_torch.bench import perf_sweep
from viennaray_tpu_torch.geometry.disk_geometry import DiskGeometry
from viennaray_tpu_torch.io import fixtures
from viennaray_tpu_torch.ops import histogram as H
from viennaray_tpu_torch.utils import telemetry

out = {"tree": sys.argv[1], "ptxas": ptxas("histogram")}
branches = "branch" in inspect.signature(H.flux_histogram).parameters
pts, nrm = fixtures.create_trench_grid_3d(**cs.FLAGSHIP)
geo = DiskGeometry.build(pts, nrm, cs.FLAGSHIP["grid_delta"])
nbrs = geo.neighbors
F64 = torch.float64
shapes = {
    "flagship": (1 << 20, 2993, 12, nbrs, None, torch.float32),
    "E_1048576": (1 << 20, 2993, 12, nbrs, 1 << 20, torch.float32),
    "E_65536": (1 << 20, 2993, 12, nbrs, 65536, torch.float32),
    # the flagship's wide launches hand out R x 12 entries, R from 32,768
    "R_32768": (1 << 15, 2993, 12, nbrs, None, torch.float32),
    "R_131072": (1 << 17, 2993, 12, nbrs, None, torch.float32),
    "R_524288": (1 << 19, 2993, 12, nbrs, None, torch.float32),
    "disk18k": (1 << 20, 18180, 12, None, None, torch.float32),
    "C16": (1 << 20, 300000, 12, None, None, torch.float32),
    "disk1m": (1 << 20, 704250, 43, None, None, torch.float32),
    "f64_flagship": (1 << 19, 2993, 12, nbrs, None, F64),
    "f64_disk18k": (1 << 19, 18180, 12, None, None, F64),
}
# the small path's shapes in both types, and the threshold's on 2,993 bins
for dtype, tag in ((torch.float32, ""), (F64, "f64_")):
    for e, n in SMALL_SHAPES:
        shapes[f"{tag}small_E{e}_n{n}"] = (
            -(-e // 12), n, 12, nbrs if n == 2993 else None, e, dtype)
for e in THRESHOLD_ENTRIES:
    shapes[f"threshold_E{e}"] = (-(-e // 12), 2993, 12, nbrs, e,
                                 torch.float32)
only = sys.argv[2:]  # names of shapes (and "applies") to run; default all
for name, (rays, n, slots, nb, cut, dtype) in shapes.items():
    if only and not any(name.startswith(o) for o in only):
        continue
    ids, w = deposits(rays, n, slots, 11, nb)
    if cut is not None:
        ids, w = ids[:cut].contiguous(), w[:cut].contiguous()
    w = w.to(dtype)
    ids64 = ids.long()
    calls = {"large": lambda: H.flux_histogram(ids, w, n, path="large")}
    if n <= H.small_max_bins(dtype):
        calls["small"] = lambda: H.flux_histogram(ids, w, n, path="small")
    if branches:
        if H.cluster_for(n, dtype):
            calls["cluster"] = lambda: H.flux_histogram(
                ids, w, n, path="large", branch="cluster")
        calls["global"] = lambda: H.flux_histogram(
            ids, w, n, path="large", branch="global")
    try:
        want = calls["large"]()
        ref = H.flux_histogram_ref(ids, w, n)
        equal = {k: bool(torch.equal(f(), want)) for k, f in calls.items()}
    except RuntimeError as err:  # a launch refused: say which, go on
        out[name] = {"error": str(err)}
        continue
    tol = 0.0 if dtype == F64 else float(ref.abs().max()) * 2.0 ** -22
    res = {"E": ids.numel(), "bins": n, "dtype": str(dtype),
           "nonzero": float((w != 0).float().mean()), "digest": digest(want),
           "max_abs_err": float((want - ref).abs().max()), "tolerance": tol,
           "all_equal": all(equal.values()), "equal": equal,
           "path_for": H.path_for(ids.numel(), n, dtype),
           "small_cluster_for": H.small_cluster_for(n, dtype)
           if hasattr(H, "small_cluster_for") else None,
           "cluster_for": H.cluster_for(n, dtype) if branches else None,
           "branch_for": H.branch_for(ids.numel(), n, dtype, H._sm_count(0))
           if branches else None}
    calls["index_add_"] = lambda: torch.zeros(
        n, dtype=dtype, device=dev).index_add_(0, ids64, w)
    reps = 20 if ids.numel() > 1 << 22 else 50
    ms = {k: [] for k in calls}
    for r in range(5):
        for k in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
            ms[k].append(device_ms(calls[k], reps))
    res["ms"] = ms
    res["host_ms"], res["issued_ms"] = {}, {}
    for k in ("small", "large"):
        if k not in calls:
            continue
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        t0 = time.perf_counter()
        for _ in range(50):
            calls[k]()
        res["host_ms"][k] = (time.perf_counter() - t0) / 50 * 1e3
        torch.cuda.synchronize()
        res["issued_ms"][k] = [cs.time_cuda(calls[k], 200) for _ in range(3)]
    out[name] = res
    del ids, w, ids64, want, ref
    torch.cuda.empty_cache()
verts, tris = fixtures.create_trench_mesh_3d(**cs.FLAGSHIP)
# (make the tracer, the float64 trace through trace_batch's unfused body or
# None for the tracer's apply): the fused flagships, and the unfused bodies
# at chip_smoke.py's rays, whose narrow bounces take the small path
makes = {} if only and "applies" not in only else {
    "flagship": (lambda: cs.make_tracer(pts, nrm), None),
    "disk18k": (lambda: perf_sweep.make_tracer("disk18k", None), None),
    "disk1m": (lambda: perf_sweep.make_tracer("disk1m", None), None),
    "flagship_unfused": (lambda: cs.make_tracer(
        pts, nrm, rays_per_point=500, fused=False), None),
    "triangles_unfused": (lambda: cs.make_tri_tracer(
        verts, tris, rays_per_point=250, fused=False), None),
    "flagship_unfused_f64": (lambda: cs.make_tracer(
        pts, nrm, rays_per_point=500, fused=False), F64),
}
with contextlib.redirect_stdout(io.StringIO()):
    for name, (make, dtype) in makes.items():
        tracer = make()
        tracer.apply()  # warm-up
        runs = []
        for _ in range(2):
            before = dict(telemetry.COUNTS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if dtype is None:
                flux = tracer.apply()
            else:
                flux = cs.trace_unfused(tracer, dtype)[0]
            torch.cuda.synchronize()
            runs.append({"seconds": time.perf_counter() - t0,
                         "flux_digest": hashlib.sha256(
                             flux.tobytes()).hexdigest()[:16],
                         "histogram_launches_by_path": {
                             k: n for k, n in telemetry.since(before).items()
                             if ".launches_by_path" in k}})
        out["apply_" + name] = runs
        del tracer
        torch.cuda.empty_cache()
print(json.dumps(out), flush=True)
"""


# run as ``python3 -c SMALL_SWEEP tree``: the small path alone at
# ``SMALL_SHAPES`` in float32 and float64, on the tree's C, five samples on
# the device alone in turns with index_add_; each output's digest (every C
# must give the same bits) and whether it keeps the plain version's
# tolerance
SMALL_SWEEP = TREE_PREAMBLE + DEPOSITS + """
from viennaray_tpu_torch.geometry.disk_geometry import DiskGeometry
from viennaray_tpu_torch.io import fixtures
from viennaray_tpu_torch.ops import histogram as H

out = {"tree": sys.argv[1], "ptxas": ptxas("small_cluster")}
nbrs = DiskGeometry.build(*fixtures.create_trench_grid_3d(**cs.FLAGSHIP),
                          cs.FLAGSHIP["grid_delta"]).neighbors
for dtype in (torch.float32, torch.float64):
    for e, n in SMALL_SHAPES:
        ids, w = deposits(-(-e // 12), n, 12, 11, nbrs if n == 2993 else None)
        ids, w = ids[:e].contiguous(), w[:e].to(dtype).contiguous()
        ids64 = ids.long()
        calls = {
            "small": lambda: H.flux_histogram(ids, w, n, path="small"),
            "index_add_": lambda: torch.zeros(
                n, dtype=dtype, device=dev).index_add_(0, ids64, w)}
        got = calls["small"]()
        ref = H.flux_histogram_ref(ids, w, n)
        tol = 0.0 if dtype == torch.float64 else float(
            ref.abs().max()) * 2.0 ** -22
        ms = {k: [] for k in calls}
        for r in range(5):
            for k in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
                ms[k].append(device_ms(calls[k], 50))
        out[f"{str(dtype)[6:]}_E{e}_n{n}"] = {
            "digest": digest(got), "within_tolerance":
                float((got - ref).abs().max()) <= tol, "ms": ms}
print(json.dumps(out), flush=True)
"""


def small_sweep(rounds=2):
    """The small path's C swept: for each C = 2^s, a copy of this tree in
    ``build/small_sweep/c<C>`` whose ``small_cluster_shift`` takes that C
    (or the smallest above it whose slices fit), all built at once, then
    ``SMALL_SWEEP`` on each copy, one process each, ``rounds`` rounds whose
    order alternates: the measurement behind
    ``csrc/histogram_cluster.cuh:small_cluster_shift``. The copies hold no
    switch: each is its own tree."""
    import shutil

    here = os.path.dirname(os.path.abspath(__file__))
    trees = []
    for s in range(5):
        tree = os.path.join(here, "build", "small_sweep", f"c{1 << s}")
        shutil.rmtree(tree, ignore_errors=True)
        os.makedirs(tree)
        for name in ("chip_smoke.py", "chip_diagnose.py"):
            shutil.copy(os.path.join(here, name), tree)
        shutil.copytree(os.path.join(here, "viennaray_tpu_torch"),
                        os.path.join(tree, "viennaray_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        header = os.path.join(tree, "viennaray_tpu_torch", "csrc",
                              "histogram_cluster.cuh")
        with open(header) as f:
            text = f.read()
        rule = re.compile(r"(inline int small_cluster_shift\([^)]*\) \{)"
                          r".*?(\n  return )", re.S)
        text, found = rule.subn(
            r"\1\n  int c = " + str(s) + r";\n  while (c < kMaxClusterShift"
            r" && slice_bins(n_bins, c) * words * 8 > kSliceBytes) ++c;\2",
            text)
        if found != 1:
            raise RuntimeError("small_cluster_shift not found in " + header)
        with open(header, "w") as f:
            f.write(text)
        trees.append(tree)
    build = "import sys; sys.path.insert(0, sys.argv[1]); " \
            "from viennaray_tpu_torch import _build; _build.library()"
    procs = [subprocess.Popen([sys.executable, "-c", build, tree])
             for tree in trees]
    if any(p.wait() for p in procs):
        raise RuntimeError("a copy's kernels did not build")
    for r in range(rounds):
        launch_times(trees if r % 2 == 0 else trees[::-1], SMALL_SWEEP)


def launch_times(trees, script=None, *args):
    """One fresh process per tree, in the order given: ``script``
    (``LAUNCH_TIMES`` by default) with the tree and ``args``."""
    for tree in trees:
        subprocess.run([sys.executable, "-c", script or LAUNCH_TIMES, tree,
                        *args], check=True)


def kernel_sass(trees, source, kernel, ops):
    """What nvcc made of each tree's ``csrc/<source>.cu``: compiled to a
    cubin with ``-Xptxas -v``, disassembled by ``cuobjdump -sass`` into
    ``build/sass/<source>_<n>.sass``; per kernel whose name holds
    ``kernel``, its instructions matching the regular expression ``ops``
    (memory operations by width, atomics by space) and their counts."""
    from viennaray_tpu_torch import _build

    out = os.path.join("build", "sass")
    os.makedirs(out, exist_ok=True)
    for n, tree in enumerate(trees):
        src = os.path.join(tree, "viennaray_tpu_torch", "csrc",
                           source + ".cu")
        cubin = os.path.join(out, f"{source}_{n}.cubin")
        sass = os.path.join(out, f"{source}_{n}.sass")
        built = subprocess.run(
            [_build._find_nvcc(), *_build.NVCC_FLAGS, "-cubin", src, "-o",
             cubin], capture_output=True, text=True, check=True)
        cuobjdump = os.path.join(os.path.dirname(_build._find_nvcc()),
                                 "cuobjdump")
        if not os.path.exists(cuobjdump):
            print(json.dumps({"phase": "sass", "tree": tree,
                              "sass": "no cuobjdump in the toolkit",
                              "ptxas": built.stderr.splitlines()}),
                  flush=True)
            continue
        dump = subprocess.run([cuobjdump, "-sass", cubin],
                              capture_output=True, text=True, check=True)
        with open(sass, "w") as f:
            f.write(dump.stdout)
        kernels, name = {}, None
        for line in dump.stdout.splitlines():
            fn = re.search(r"Function : (\S+)", line)
            if fn:
                name = fn.group(1)
                kernels[name] = {}
                continue
            op = re.search(ops, line)
            if name and kernel in name and op:
                kernels[name][op.group(1)] = kernels[name].get(op.group(1),
                                                               0) + 1
        print(json.dumps({
            "phase": "sass", "tree": tree, "sass": sass,
            "ptxas": [l.strip() for l in built.stderr.splitlines()
                      if kernel in l or "registers" in l or "spill" in l],
            "ops_by_kernel": {k: v for k, v in kernels.items()
                              if kernel in k}}), flush=True)


def f64_tails(rounds):
    """The float32 and float64 unfused paths of the disk and triangle
    flagships in turns, with the tail of each batch (``--f64``)."""
    from viennaray_tpu_torch.io import fixtures
    from viennaray_tpu_torch.trace import kernel as TK

    tracers = {
        "disks": make_tracer(*fixtures.create_trench_grid_3d(**FLAGSHIP),
                             rays_per_point=cs.RAYS_PER_POINT // 4,
                             fused=False),
        "triangles": make_tri_tracer(
            *fixtures.create_trench_mesh_3d(**FLAGSHIP),
            rays_per_point=cs.RAYS_PER_POINT // 8, fused=False),
    }
    real = TK.bounce_step
    tail = []

    def step(state, *args, **kwargs):
        out = real(state, *args, **kwargs)
        alive = out[0].alive
        n = int(alive.sum())
        if 0 < n <= 8:
            tail.append({
                "width": state.org.shape[0], "alive": n,
                "boundary_hits": out[0].n_bdry[alive].tolist(),
                "reflections": out[0].n_refl[alive].tolist(),
                "dir_z": out[0].dirn[alive, 2].tolist(),
                "weight": out[0].weight[alive].tolist()})
        return out

    for tracer in tracers.values():
        tracer.apply()  # the areas, and the kernels warm
    TK.bounce_step = step
    try:
        for r in range(rounds):
            for name, tracer in tracers.items():
                order = ((torch.float32, torch.float64) if r % 2 == 0
                         else (torch.float64, torch.float32))
                for dtype in order:
                    tail.clear()
                    before = dict(telemetry.COUNTS)
                    _, counters, seconds = cs.trace_unfused(tracer, dtype)
                    launches = launches_since(before)
                    print(json.dumps({
                        "phase": "f64_tail", "geometry": name,
                        "dtype": str(dtype), "round": r, "seconds": seconds,
                        "launches": {k: v for k, v in launches.items() if v},
                        "total_traces": counters["total_traces"],
                        "tail_first": tail[:1], "tail_last": tail[-2:],
                        "tail_iterations": len(tail)}), flush=True)
    finally:
        TK.bounce_step = real


# the trench's grid deltas of the crossover (--grid), and their names
GRID_SIZES = ((0.25, "disk3k"), (0.18, "disk5k"), (0.14, "disk9k"),
              (0.1, "disk18k"), (0.05, "disk72k"), (0.016, "disk1m"))


def grid_crossover(rounds):
    """Kernel 1 and kernel 4 with the chunk search and with the grid walk on
    the trench at each size of ``GRID_SIZES``, in rounds whose order of the
    two alternates; milliseconds by CUDA events."""
    from viennaray_tpu_torch.geometry.disk_geometry import DiskGeometry
    from viennaray_tpu_torch.io import fixtures
    from viennaray_tpu_torch.ops import grid_traverse as GT
    from viennaray_tpu_torch.ops import nearest_hit as NH

    settings = cs.bounce_settings()
    for gd, name in GRID_SIZES:
        pts, nrm = fixtures.create_trench_grid_3d(**dict(FLAGSHIP,
                                                         grid_delta=gd))
        geo = DiskGeometry.build(pts, nrm, gd).with_neighbor_pack()
        bbox = cs.adjusted_bbox(geo)
        walls = B.make_walls(bbox, geo, settings)
        runs = {}
        for kind in ("source", "interior"):
            org, dirn = cs.make_rays(geo, bbox, 1 << 20, kind, seed=7)
            runs[f"kernel1_{kind}_2^20"] = {
                "chunks": lambda o=org, d=dirn: NH.disk_nearest_hit(
                    o, d, geo.prims_soa, geo.soa_perm, geo.soa_chunk_bbs),
                "grid": lambda o=org, d=dirn: GT.disk_grid_nearest_hit(
                    o, d, geo.prims_soa, geo.soa_perm, geo.grid)}
        for n_rays, n_sub in ((1 << 20, 1), (16384, 4), (512, 16)):
            state, uni = cs.make_state(geo, bbox, n_rays, "interior", n_sub,
                                       settings, seed=13)
            args = (state, uni, geo, walls, settings)
            runs[f"kernel4_{n_rays}x{n_sub}"] = {
                "chunks": lambda a=args, k=n_sub: B.fused_bounce(
                    *a, n_sub=k),
                "grid": lambda a=args, k=n_sub: B.fused_bounce(
                    *a, n_sub=k, grid=geo.grid)}
        ms = {key: {"chunks": [], "grid": []} for key in runs}
        for r in range(rounds):
            order = ("chunks", "grid") if r % 2 == 0 else ("grid", "chunks")
            for key, fns in runs.items():
                reps = 3 if key.endswith("2^20") or "1048576" in key else 20
                for mode in order:
                    ms[key][mode].append(cs.time_cuda(fns[mode], reps))
        print(json.dumps({
            "phase": "grid_crossover", "geometry": name, "grid_delta": gd,
            "disks": geo.num_primitives,
            "chunks": geo.soa_chunk_bbs.shape[0],
            "grid_cells": list(geo.grid.walk_dims),
            "grid_slots": geo.grid.walk_slots, "ms": ms}), flush=True)
        del geo, runs, walls
        torch.cuda.empty_cache()


def grid_disk1m(n):
    """disk1m through ``TraceDisk`` with its grid and without, in turns:
    ``repeats`` and ``kernel_spans`` of each."""
    from viennaray_tpu_torch.bench import perf_sweep
    from viennaray_tpu_torch.geometry.disk_geometry import DiskGeometry

    gd = perf_sweep.CELLS["disk1m"][1]
    geo = DiskGeometry.build(*perf_sweep.fixture("disk1m"), gd, dim=3,
                             pack_neighbors=False).with_neighbor_pack()
    tracers = {}
    for mode, g in (("chunks", geo.replace(grid=None)), ("grid", geo)):
        tracers[mode] = perf_sweep.make_tracer("disk1m", None)
        tracers[mode].geometry = g
        tracers[mode].apply()  # warm-up
    for i in range(2):
        for mode in ("chunks", "grid") if i == 0 else ("grid", "chunks"):
            print(json.dumps({"mode": mode, **repeats(tracers[mode], n,
                                                      f"fused, {mode}")}),
                  flush=True)
            print(json.dumps({"mode": mode, **kernel_spans(
                tracers[mode], f"fused, {mode}")}), flush=True)


# the geometries of ``--resort``: (name, primitive kind, grid delta of the
# trench, rays per primitive)
RESORT_GEOMETRIES = (
    ("triangle flagship", "triangle", 0.25, cs.RAYS_PER_POINT),
    ("disk18k", "disk", 0.1, cs.GRID_RAYS_PER_POINT),
    ("disk1m", "disk", 0.016, cs.DISK1M_RAYS_PER_POINT),
    ("trench_mesh_0.1", "triangle", 0.1, 100),
)


def resort_spans(tracer):
    """One apply with CUDA events around the bounce and histogram kernels,
    around every resort (``TK.resort``: key, sort and permutation) and around
    the keys and permutations outside it (source sort, compactions); wall
    and CPU seconds."""
    from viennaray_tpu_torch.trace import kernel as TK

    spans = {"fused_bounce": [], "flux_histogram": [], "resort": [],
             "coherence_key": [], "permute_state": []}
    inside = [False]

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            if name in ("coherence_key", "permute_state") and inside[0]:
                return fn(*args, **kwargs)  # inside a resort's span
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            inside[0] = name == "resort"
            a.record()
            out = fn(*args, **kwargs)
            b.record()
            inside[0] = False
            spans[name].append((a, b))
            return out
        return wrapper

    real = {name: getattr(TK, name) for name in spans}
    for name, fn in real.items():
        setattr(TK, name, timed(name, fn))
    try:
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.process_time()
        tracer.apply()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cpu = time.process_time() - c0
    finally:
        for name, fn in real.items():
            setattr(TK, name, fn)
    seconds = {name: sum(a.elapsed_time(b) for a, b in evs) / 1e3
               for name, evs in spans.items()}
    info = tracer.get_ray_trace_info()
    return {
        "seconds": wall, "cpu_seconds": cpu,
        "kernel4_span_seconds": seconds["fused_bounce"],
        "share_outside_kernels": 1.0 - sum(seconds.values()) / wall,
        "search_steps_a_search": info.chunks_swept
        / max(info.tile_bounces, 1),
        "resorts": len(spans["resort"]),
        "resort_span_seconds": seconds["resort"],
        "other_permutations": len(spans["permute_state"]),
        "other_permutation_span_seconds": seconds["permute_state"],
        "compaction_keys": len(spans["coherence_key"]),
        "compaction_key_span_seconds": seconds["coherence_key"],
        "histogram_span_seconds": seconds["flux_histogram"],
    }


def resort_ab(rounds):
    """The resort's A/B on ``RESORT_GEOMETRIES``: two tracers per geometry
    on one built geometry, with the resort and without, warmed up, then
    ``rounds`` rounds of one apply each in alternating order (the two trace
    the same rays in a round: each apply is a new run number on both)."""
    import viennaray_tpu_torch as vrt
    from viennaray_tpu_torch.geometry.disk_geometry import DiskGeometry
    from viennaray_tpu_torch.geometry.triangle_geometry import TriangleGeometry
    from viennaray_tpu_torch.io import fixtures
    from viennaray_tpu_torch.trace.kernel import dirbins_for, grid_for

    for name, kind, gd, rays in RESORT_GEOMETRIES:
        trench = dict(FLAGSHIP, grid_delta=gd)
        if kind == "triangle":
            geo = TriangleGeometry.build(
                *fixtures.create_trench_mesh_3d(**trench), gd)
            cls = vrt.TraceTriangle
        else:
            geo = DiskGeometry.build(
                *fixtures.create_trench_grid_3d(**trench), gd,
                pack_neighbors=False).with_neighbor_pack()
            cls = vrt.TraceDisk
        tracers = {}
        for mode in ("resort", "no_resort"):
            tracer = cls(dim=3, bounce_sort=mode == "resort")
            tracer.geometry = geo
            tracers[mode] = cs.configure(tracer, rays)
            tracers[mode].apply()  # warm-up
        n_chunks = geo.soa_chunk_bbs.shape[0]
        config = tracers["resort"]._make_config()
        for r in range(rounds):
            order = ("resort", "no_resort") if r % 2 == 0 else (
                "no_resort", "resort")
            for mode in order:
                print(json.dumps({
                    "phase": "resort_ab", "geometry": name, "mode": mode,
                    "round": r, "primitives": geo.num_primitives,
                    "chunks": n_chunks, "dirbins": dirbins_for(n_chunks),
                    "grid": grid_for(geo, config) is not None,
                    "num_rays": config.total_rays(geo.num_primitives),
                    **resort_spans(tracers[mode])}), flush=True)
        del tracers, geo
        torch.cuda.empty_cache()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--launch-times", nargs="+", metavar="TREE", default=None,
        help="only time the closest-hit and bounce kernels' flagship "
             "launches of each checkout named, one process each, in the "
             "order given",
    )
    parser.add_argument(
        "--groups", action="store_true",
        help="only time the bounce kernel under every group size G at every "
             "width of the ladder",
    )
    parser.add_argument(
        "--paths", action="store_true",
        help="only time the histogram kernel's two paths and index_add_ by "
             "number of entries",
    )
    parser.add_argument(
        "--small-sweep", action="store_true",
        help="with --paths: time the small path at every cluster size C on "
             "copies of this tree, each built with its C",
    )
    parser.add_argument(
        "--grad", action="store_true",
        help="only time and profile the gradient paths",
    )
    parser.add_argument(
        "--f64", action="store_true",
        help="only trace the disk and triangle flagships unfused in float32 "
             "and float64 in turns, with each batch's last survivors",
    )
    parser.add_argument(
        "--grid", action="store_true",
        help="only time the chunk search against the grid walk at six "
             "sizes, and disk1m's applies and spans with and without grid",
    )
    parser.add_argument(
        "--resort", action="store_true",
        help="only weigh the per-bounce resort: applies with it and without "
             "in turns on the triangle flagship, disk18k, disk1m and the "
             "36,000-triangle trench",
    )
    parser.add_argument("--repeats", type=int, default=None,
                        help="applies or rounds (default 5; --resort 2)")
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
        "--disk1m", action="store_true",
        help="the sweep's disk1m cell (704,250 disks, 4 rays per point, "
             "built without the neighbor records; "
             "viennaray_tpu_torch/bench/perf_sweep.py)",
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
    if args.repeats is None:
        args.repeats = 2 if args.resort else 5
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
        if args.grid:
            launch_times(args.launch_times, GRID_TIMES)
        elif args.paths:
            kernel_sass(list(dict.fromkeys(args.launch_times)),
                        "flux_histogram", "histogram",
                        r"\b((?:ATOM|RED|LDG|STG|LDS|STS|MATCH)\S*)")
            launch_times(args.launch_times, HIST_TIMES)
        elif args.resort:
            kernel_sass(list(dict.fromkeys(args.launch_times)), "permute",
                        "permute_state", r"\b((?:LDG|STG)\S*)")
            launch_times(args.launch_times, PERMUTE_TIMES)
        else:
            launch_times(args.launch_times)
        return 0
    if args.grad:
        grad_runs(args.repeats)
        return 0
    if args.f64:
        f64_tails(args.repeats)
        return 0
    if args.resort:
        resort_ab(args.repeats)
        return 0
    if args.grid:
        grid_crossover(args.repeats)
        grid_disk1m(args.repeats)
        return 0
    if args.small_sweep:
        small_sweep()
        return 0
    if args.groups or args.paths:
        if args.groups:
            group_ab()
        if args.paths:
            histogram_paths()
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
    elif args.disk1m:
        from viennaray_tpu_torch.bench import perf_sweep

        make = lambda **kwargs: perf_sweep.make_tracer("disk1m", None,
                                                       **kwargs)
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
    # the fused body's spans at one thread per ray and at the default G, on
    # fresh tracers (the same rays), in turns (not on disk1m: each fresh
    # tracer builds 704,250 disks on the host)
    for group in () if args.disk1m else (1, None, None, 1):
        spans = kernel_spans(make(), "fused, first apply", group=group)
        print(json.dumps(spans), flush=True)
    if args.triangles or args.window:
        print(json.dumps(deposit_policy(make, args.repeats)), flush=True)
    if args.profile:
        profile_apply(tracers["fused"], args.profile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
