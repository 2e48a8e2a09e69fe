#!/usr/bin/env python3
"""Where a configuration's time goes on a GPU: the diagnostics behind PERF.md.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_diagnose.py [--triangles | --lines | --ion | --window]
                             [--unfused] [--profile FILE]
    python3 chip_diagnose.py --groups | --paths | --grad | --f64

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
2^20 on the flagship's 2,993 bins: the measurement behind
``ops/histogram.py:SMALL_ENTRIES``.

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

import functools

import torch

import chip_smoke as cs
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


def launch_times(trees):
    """One fresh process per tree, in the order given."""
    for tree in trees:
        subprocess.run([sys.executable, "-c", LAUNCH_TIMES, tree], check=True)


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
                    reset_launches()
                    _, counters, seconds = cs.trace_unfused(tracer, dtype)
                    launches = read_launches()
                    print(json.dumps({
                        "phase": "f64_tail", "geometry": name,
                        "dtype": str(dtype), "round": r, "seconds": seconds,
                        "launches": {k: v for k, v in launches.items() if v},
                        "total_traces": counters["total_traces"],
                        "tail_first": tail[:1], "tail_last": tail[-2:],
                        "tail_iterations": len(tail)}), flush=True)
    finally:
        TK.bounce_step = real


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
        "--grad", action="store_true",
        help="only time and profile the gradient paths",
    )
    parser.add_argument(
        "--f64", action="store_true",
        help="only trace the disk and triangle flagships unfused in float32 "
             "and float64 in turns, with each batch's last survivors",
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
    if args.grad:
        grad_runs(args.repeats)
        return 0
    if args.f64:
        f64_tails(args.repeats)
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
    # fresh tracers (the same rays), in turns
    for group in (1, None, None, 1):
        spans = kernel_spans(make(), "fused, first apply", group=group)
        print(json.dumps(spans), flush=True)
    if args.triangles or args.window:
        print(json.dumps(deposit_policy(make, args.repeats)), flush=True)
    if args.profile:
        profile_apply(tracers["fused"], args.profile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
