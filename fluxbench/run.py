"""Runs one cell of the port's benchmark once and prints its result line.

    python3 -m fluxbench.run --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, this folder and
``viennaray_tpu_torch``. Set-up makes the cell's seeds from ``--seed`` and,
through the configuration's set-up module (``setups/``), its clouds and the
tracer, built by the port's public API; it then runs the traffic mix's loop
body (its steps, ``steps/``) as warm-up. The window repeats that body for
``--seconds`` and takes every step's time on the host clock (each ends in a
copy of its result to the host or a synchronise). With ``--trace 1`` a
``torch.profiler`` trace covers the window and the per-layer metrics are
read from it; with ``--trace 0`` the end-to-end ones. After the window, the
peak device memory is read, the program's state freed, and the plain
reference (the set-up's) traces the same cloud on the card, the steps'
reference sides turn that into the loop body's output, and ``compare``
decides ``correct``.

Without a CUDA device, or with fewer than the cell asks for, it exits 2 and
prints no result. It exits 3, printing none, where the process holds JAX or
the JAX package once the window has closed. The last line of stdout is the
result; the compared numbers and their limits end stderr.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
from contextlib import nullcontext  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

from . import spec as spec_mod  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "viennaray_tpu")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules():
    """Top-level names in ``sys.modules`` that are JAX or the JAX package,
    compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Iteration:
    """One pass of the loop body: its steps' host-clock spans [(step,
    start, end)], its cloud, the rays its applies launched, their counters
    summed (geometry hits, rays, segments), and the output with the divisor
    that brings it to the reference's units."""

    def __init__(self):
        self.spans = []
        self.cloud = None
        self.rays = 0
        self.info = None
        self.output = None
        self.divisor = 1.0

    def add_apply(self, info, rays):
        self.info = (tuple(info) if self.info is None
                     else tuple(a + b for a, b in zip(self.info, info)))
        self.rays += rays

    @property
    def end(self):
        return max(e for _, _, e in self.spans)


class Run:
    """What the metric readers read: the cell's configuration and mix,
    ``setup_s``, the window's start and iterations, the card's peaks
    (``peaks.json``) and with ``--trace 1`` the profile
    (``devtrace.Trace``)."""

    def __init__(self, config, traffic):
        self.config = config
        self.traffic = traffic
        self.setup_s = None
        self.window_start = None
        self.iterations = []
        self.trace = None
        self.peaks = None


class Program:
    """The port driven through its public API: the configuration's set-up
    module (``setups/<setup>.py``) builds the tracer and the mix's cycle of
    clouds, and an iteration runs the mix's steps (``steps/<step>.py``) in
    order."""

    def __init__(self, spec, config, traffic, seed, device):
        self.config = config
        self.device = device
        self.setup = spec.setup(config["setup"])
        self.steps = [(name, spec.step(name)) for name in traffic["loop"]]
        self.clouds = self.setup.clouds(config, traffic)
        self.tracer = self.setup.program(config, seed, device)
        self.next_cloud = 0
        self.set_geometry()

    def set_geometry(self):
        """The next cloud of the cycle."""
        self.setup.set_geometry(self.tracer, self.config,
                                self.clouds[self.next_cloud])
        self.cloud = self.next_cloud
        self.next_cloud = (self.next_cloud + 1) % len(self.clouds)

    def sync(self):
        sync(self.device)

    def iteration(self, record=None):
        """One pass of the loop body, each step a host-clock span and, where
        ``record`` is ``torch.profiler.record_function``, a profiler
        range."""
        it = Iteration()
        for name, step in self.steps:
            with record(f"fluxbench.{name}") if record else nullcontext():
                t0 = time.perf_counter()
                step.run(self, it)
                it.spans.append((name, t0, time.perf_counter()))
        it.cloud = self.cloud
        return it


def reference_check(spec, config, traffic, clouds, cloud_index, ref_seed,
                    device):
    """The reference's ``compare.Reference`` of cloud ``cloud_index``: the
    set-up's reference trace at the configuration's ``check`` sizes, in its
    ``dtype``, turned into the loop body's output run by run."""
    import torch

    from . import compare

    check = config["check"]
    traced = spec.setup(config["setup"]).reference(
        config, clouds[cloud_index], int(check["reference_rays_per_point"]),
        ref_seed, device, int(check["chunks"]), getattr(torch, config["dtype"]))
    return compare.Reference(observed(spec, traffic, traced), traced.rays,
                             traced.hits, traced.hits_sq)


def observed(spec, traffic, traced):
    """The loop body's output from the reference's trace: each step's
    reference side in the mix's order, (runs, N) float64."""
    values = None
    for name in traffic["loop"]:
        values = spec.step(name).reference(traced, values)
    return values


def program_output(it):
    """An iteration's output in the reference's units."""
    import numpy as np

    return np.asarray(it.output, np.float64) / it.divisor


def emit(result, numbers):
    """The compared numbers on stderr's last lines, then the result line."""
    for name, (value, limit) in numbers.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def log(what):
    """A line of progress on stderr: seconds since the process started."""
    print(f"fluxbench: {what} at {time.perf_counter() - PROCESS_START:.3f} s",
          file=sys.stderr, flush=True)


def finite(x):
    return x if math.isfinite(x) else 1e308


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    args = parse(argv)
    spec = spec_mod.Spec()
    cell = spec.cell(args.workload)

    import torch

    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < int(cell["chips"]):
        print(f"fluxbench: the cell needs {cell['chips']} CUDA device(s); "
              f"this process sees {seen}", file=sys.stderr)
        return 2
    result, numbers = execute(spec, args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"fluxbench: the process holds {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    emit(result, numbers)
    return 0


def execute(spec, workload, seed, seconds, trace, device):
    """One run of ``workload`` on ``device``: (the result object, the
    compared numbers {name: (value, limit)})."""
    import torch

    from . import compare, devtrace, inputs

    cell = spec.cell(workload)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    limits = spec.limits(cell["name"])
    cuda = device.type == "cuda"
    run = Run(config, traffic)
    prog_seed, ref_seed, draw = inputs.seeds(seed)
    prog = Program(spec, config, traffic, prog_seed, device)
    clouds = prog.clouds
    compared_cloud = draw % len(clouds)
    for _ in range(int(traffic["warmup_iterations"])):
        prog.iteration()
    sync(device)
    run.setup_s = time.perf_counter() - PROCESS_START
    log("set-up done")

    prof = None
    record = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if cuda:
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.__enter__()
        record = record_function
    attempted = failed = 0
    with record("fluxbench.window") if record else nullcontext():
        run.window_start = time.perf_counter()
        while time.perf_counter() - run.window_start < seconds:
            attempted += 1
            try:
                it = prog.iteration(record)
            except Exception as exc:  # the program failed: counted, not run on
                failed += 1
                print(f"fluxbench: iteration {attempted} raised {exc!r}",
                      file=sys.stderr)
                break
            if it.cloud != compared_cloud:
                it.output = None
            run.iterations.append(it)
    log(f"window done, {len(run.iterations)} iterations")
    for name in dict(prog.steps):
        times = " ".join(f"{e - s:.4f}" for it in run.iterations
                         for n, s, e in it.spans if n == name)
        print(f"fluxbench: {name} seconds {times}", file=sys.stderr)
    if prof is not None:
        prof.__exit__(None, None, None)
        run.trace = devtrace.Trace.collect(prof)
        del prof
        log("trace collected")
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    run.peaks = peaks_for(kind, spec)
    memory_peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0

    metrics = {}
    for m in spec.metrics(cell["name"], trace):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    log("metrics read")
    outputs = [(program_output(it), it.info[0] / it.info[1], it.rays)
               for it in run.iterations if it.output is not None]
    del prog
    for it in run.iterations:
        it.output = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = reference_check(spec, config, traffic, clouds, compared_cloud,
                          ref_seed, device)
    ok, numbers = compare.judge(ref, outputs, limits)
    log(f"reference done, {len(outputs)} outputs compared")
    result = {
        "correct": bool(ok and failed == 0), "attempted": attempted,
        "failed": failed, "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": memory_peak},
    }
    if run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace.top_device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
        log("breakdown done")
        result["device"]["busy_s"] = run.trace.busy_s()
        result["device"]["window_s"] = run.trace.window_s
    result["check"] = {n: {"value": finite(v), "limit": lim}
                       for n, (v, lim) in numbers.items()}
    return result, numbers


def peaks_for(kind, spec):
    """The card's row of ``peaks.json`` (the first whose key its name
    starts with), or None."""
    table = spec_mod.load_json(spec.bench / "peaks.json")
    for key, row in table.items():
        if kind.startswith(key):
            return row
    return None


if __name__ == "__main__":
    raise SystemExit(main())
