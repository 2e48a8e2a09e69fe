"""What the benchmark programs share: the device and the card they run on,
timing that ends in a synchronise, peak device memory, rel-L2 against a
golden, and one JSON line per result to stdout or a file."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from ..device import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
GOLDEN_DIR = os.path.join(ROOT, "benchmarks", "golden")
PORT_GOLDEN_DIR = os.path.join(ROOT, "viennaray_tpu_torch", "io", "golden")
# the flagship's cloud (bench.py:30-93)
FLAGSHIP = dict(grid_delta=0.25, extent=5.0, trench_width=4.0,
                trench_depth=4.0)
GOLDEN_TOL = 0.05  # bench.py's certification: two 2,000-rays/pt runs differ by 1-2 %


def parser(description):
    """The benchmarks' common arguments: ``--device`` (the CUDA device unless
    ``cpu`` is named) and ``--out`` (a file the JSON lines are appended to,
    besides stdout)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default=None,
                   help="the device to run on: the CUDA device by default; "
                        "'cpu' runs the kernels' plain versions")
    p.add_argument("--out", default=None,
                   help="also append the JSON lines to this file")
    return p


def device_record(device):
    """The device a result was taken on: for a CUDA device the card's name
    and power limit as ``nvidia-smi`` reports them, torch's name and the
    device count; for the CPU only its name."""
    if device.type != "cuda":
        return {"type": device.type}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[device.index or 0]
    return {"type": "cuda", "nvidia_smi": smi,
            "kind": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda}


def setup(args):
    """(device, its record) for ``args.device``; ``None`` is the CUDA
    device, and without one this raises."""
    device = resolve_device(args.device)
    return device, device_record(device)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device):
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device):
    """Peak device memory since ``reset_peak``: None on the CPU."""
    if device.type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(device))


def timed(fn, device):
    """(result, wall seconds, process CPU seconds) of ``fn()``, the device
    synchronised before and after."""
    sync(device)
    t0, c0 = time.perf_counter(), time.process_time()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0, time.process_time() - c0


def rel_l2(a, golden):
    g = np.asarray(golden, np.float64)
    a = np.asarray(a, np.float64)
    return float(np.linalg.norm(a - g) / max(np.linalg.norm(g), 1e-12))


def emit(obj, out=None):
    """One JSON line to stdout, and appended to ``out`` when given (never a
    file under ``benchmarks/``, which holds the JAX package's records)."""
    if out is not None and os.path.abspath(out).startswith(
            os.path.join(ROOT, "benchmarks") + os.sep):
        raise ValueError(f"the port's benchmarks write nothing under "
                         f"benchmarks/: {out}")
    line = json.dumps(obj)
    print(line, flush=True)
    if out is not None:
        with open(out, "a") as f:
            f.write(line + "\n")

