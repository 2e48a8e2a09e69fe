#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It imports only ``viennaray_tpu_torch`` and, in order:

1. prints the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and asserts that TF32 matrix products are off;
2. builds the CUDA kernels from ``viennaray_tpu_torch/csrc`` with ``nvcc``,
   prints the registers and spills of kernel 4's grid search, the grid
   kernel, the permutation, the resort's key and kernel 2's two paths, and
   fails on a spill in any of them;
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes the configurations give it: 2,993 disks, 5,760 triangles and 782
   line segments (and at the 18,180-disk and 9,000-triangle trenches, and
   the bounce kernel on a 2D trench of disks and on an extruded 2D line mesh
   too); the bounce kernel also with sticking per lane, with the
   coned-cosine reflection and with gas scattering on every kind, and in its
   window form (the window flux model's deposits) on disks; the bounce
   kernel's group mapping (a warp per ray) at 512 x 16, 1,000 x 16, 2,048 x
   16, 16,384 x 4 and 65,536 x 1 on every kind, both kFull values, the window
   form and tie-heavy rays (straight down onto packed flat faces and shared
   triangle edges), and every instantiated group size at 2,048 x 16; the
   closest-hit kernels (disks, triangles, lines; the division-free reject
   before the exact test on disks and triangles) at 512, 1,000, 2,048,
   16,384, 65,536 and 2^20 rays on source, interior, tie-heavy and rim rays
   (aimed a hair inside and outside disk rims and triangle edges, a quarter
   grazing), hit, prim and t bit for bit, and past 2^27 rays (where the
   warp per ray's thread index passes 2^32) at both ends of the batch; the
   histogram kernel's small path (one launch of one thread-block cluster)
   and its large path's cluster and global branches bit for bit against
   each other wherever the input admits them (one entry either side of the
   paths' threshold too; 2,993, 18,180 and 300,000 bins, where the cluster
   takes 16 blocks, and disk1m's shape, 45,088,768 entries on 704,250 bins;
   the small path's shapes, 6,144 entries and one below the threshold, on
   2,993 and 18,180 bins; float64 on 2,993 and 18,180 bins); and times
   kernel (the histogram on the device alone, each branch), plain version
   and, for the histogram, one ``index_add_`` call (at 6,144, 65,536, 2^20
   and 12,582,912 entries);
4. drives the flagship through the default ``TraceDisk`` (the fused bounce
   kernel): 2,993 disks, 2,000 rays per point, periodic walls, diffuse
   particle with sticking 0.1, seed 42, mega-batches of 2^20 rays; checks the
   normalized flux against the two golden files (rel-L2 < 0.05), that the
   bounce and histogram kernels were launched, and that two same-seed runs
   are bitwise equal;
5. drives the same flagship through ``TraceDisk(fused=False)`` (the unfused
   body around the closest-hit and histogram kernels) at 500 rays per
   point, against the same goldens;
6. drives the triangle flagship through the default ``TraceTriangle``:
   5,760 triangles, 2,000 rays per triangle, the same physics; checks the
   normalized flux against the oracle golden
   ``viennaray_tpu_torch/io/golden/tri3d_trench_oracle.npy`` and the
   geometry hits per ray against the oracle's (within 2 %), that the bounce
   kernel was launched, and that two same-seed runs are bitwise equal; then
   through ``TraceTriangle(fused=False)`` (the triangle closest-hit kernel
   and the histogram kernel on every bounce) at 250 rays per triangle;
7. drives the line configuration through the default ``TraceLine``: the 2D
   trench as 782 segments of two materials, diffuse particle with sticking
   0.5 / 0.1 by material, 2,000 rays per segment, against
   ``line2d_trench_oracle.npy`` with the same checks, the bounce kernel the
   only kernel launched; then ``TraceLine(fused=False)`` at 500 rays per
   segment (the line closest-hit and histogram kernels); then the same mesh
   as triangle pairs through ``TraceTriangle(dim=2)``, whose flux per line
   must agree with the line run's within the two runs' noise;
8. drives the ion configuration through ``TraceDisk``: the flagship's disks
   under a coned-cosine particle (sticking 0.5, cone angle pi/6, source
   power 100), fused at 2,000 rays per point against
   ``ion3d_trench_oracle.npy`` and unfused at 500; then a gas-scattering run
   (mean free path of one trench depth) at 200 rays per point against
   ``gas3d_trench_oracle.npy``, scatter events per ray included;
9. drives the flagship under the window flux model: fused at 2,000 rays per
   point (the bounce kernel's window form on every launch, no other kernel)
   and unfused at 500, against ``window3d_trench_jax.npy`` (the JAX
   package's unfused window body on the CPU), and the fused window flux
   against the fused neighbor flux of step 4 (same seed, same rays: they
   must part by about what the JAX package's two models part by); then 1/
   distance weighting (``set_use_wdist``, which runs the unfused body:
   kernels 1 and 2, no bounce kernel) at 500 rays per point against
   ``wdist3d_trench_oracle.npy``; then the grid source (2,809 points from
   ``create_source_grid``) at 2,000 rays per point against
   ``bench_disk3d.npy``, and the surface source (every disk along its
   normal) at 2,000 rays per point against ``surface3d_trench_jax.npy``;
10. drives the JAX package's ``disk2d_trench`` configuration through
    ``TraceDisk(dim=2)`` (180 disks, 200,000 rays in batches of 16,384)
    fused, and unfused at a quarter of the rays, against the oracle's
    ``disk2d_trench_oracle.npy``;
11. drives custom particles at full width (``phase_hook_paths``), each
    hooked apply timed beside the built-in apply of the same rays, with the
    share of its wall time outside the kernels' spans: the JAX package's
    ``examples/multi_channel.py`` (two labelled channels on the 2,993
    disks, 500 rays per point: the ion channel equals the built-in unfused
    apply bit for bit, both channels against ``multichannel3d_trench_jax``
    and its energy ratio within 2 %); hooks that reimplement the built-in
    deposit and diffuse reflection (the built-in unfused apply's flux and
    counters bit for bit); the energy-carrying ion of
    ``viennaray_tpu_torch/examples/stateful_ion.py`` against
    ``stateful3d_trench_jax`` and its deposit per hit within 2 %, its data
    log counting every ray; the 5,760 triangles (250 rays each) and the 782
    lines with a two-channel collision hook and the reimplemented
    reflection (channel 0 the built-in apply's bits); an all-zero
    ``init_dir_fn`` with a ``log_fn`` on the fused body (the unhooked fused
    apply's bits, the log adding up over two applies); and the JAX package's
    ``examples/multi_species.py`` through ``apply_particles`` (each species
    equal to its own apply on a fresh tracer). The hooked disk, triangle
    and line paths must launch kernel 1, 3 or the line search and kernel 2,
    never the bounce kernel; the ``init_dir_fn`` / ``log_fn`` and
    multi-species paths the bounce kernel;
12. drives the sharded trace (``phase_sharded_path``,
    ``viennaray_tpu_torch.parallel``) at full width on the disk flagship:
    a one-rank NCCL process group on cuda:0 and a 4-shard mesh on cuda:0
    in it, each equal in flux and counters, bit for bit, to
    ``TraceDisk.apply`` of the same seed at 5,986,000 rays, with the bounce
    and histogram kernels' launches of every sub-batch equal to the
    tracer's batch of that index; then the differentiable leg (loss =
    sum(flux^2) of a ``differentiable=True`` trace, 2^17 rays, 4 bounces)
    at 1 and 4 shards, finite and bit for bit equal;
13. prints the peak device memory;
14. drives the differentiable trace (``phase_grad_paths``,
    ``viennaray_tpu_torch.diff``): BASELINE config 5 at full width
    (d sum(flux) / d sticking of 10,000,000 rays on the 2,993 disks, 8
    bounces, batches of 2^19, seed 13) timed with its peak memory and share
    outside kernel spans, kernels 1 and 2 forward 8 times a batch and the
    histogram's backward 7 times (the first bounce's deposits do not depend
    on the sticking) and no other kernel; a second same-seed run
    bit for bit; flux and d / d sticking per ray against
    ``grad3d_trench_jax`` (the JAX package's gradient driver on the CPU);
    central differences (rtol 5e-3); one batch through the kernels and
    through their plain versions bit for bit (d / d sticking, and d / d
    points under 1/distance weighting); d / d points and d / d normals at
    2^21 rays, finite and not all zero; the 5,760 triangles' d / d sticking
    at 2^21 rays against central differences and one batch against the
    plain versions. The histogram's backward kernel is held bit for bit to
    ``index_select`` and timed beside it with the other kernel checks.

15. right after the kernel checks of step 3, the uniform grid
    (``phase_grid_path``): the grid closest-hit kernels (disks, triangles;
    float32 and float64) against their plain versions and against kernels 1
    and 3 at 2^20 source and interior rays on the 18,180-disk trench and the
    36,000-triangle trench (grid delta 0.1), and on rim and tie rays; kernel
    4 with the grid search against kernel 4 with the chunk search on one
    state at 2^20 x 1, 16,384 x 4 and 512 x 16 on the disks, at 2^20 x 1 and
    512 x 16 on the triangles, and at 2^20 x 1 on disk1m (704,250 disks),
    where the grid kernel runs too; the grid kernel's counts of cells and
    pairs equal the plain walk's, and it prints the pairs it tested past
    each walk's stopping cell;
    then fused applies of disk18k (200 rays per point) and disk1m (4 rays
    per point, 2,817,000 rays) and unfused applies of disk18k and the
    triangles, each with the geometry's grid (the trace walks it: above
    ``TraceConfig.grid_min_prims``) and without it, flux and event counters
    bit for bit, with seconds, cells or chunks a search, and the grid's host
    build seconds and table bytes (padded and compact); kernel 4's
    operations bounds count the pairs the searches test (chunk counters; the
    plain walk's slots), the grid's bound is the larger of that and its
    bytes.
16. right after the flagships' fused and unfused paths, the per-bounce
    coherence resort (``phase_resort_path``; the tracers run it only when
    asked, ``bounce_sort=True``): the resort's key (``vr_coherence_key``) at
    8, 32 and 64 direction bins (also at 2^20 - 3 lanes, past the last quad
    of four, and on a state viewed at an offset of one lane, whose arrays
    are not aligned for the quads) and the state's permutation
    (``vr_permute_state``) with and without an aux of two columns, taking
    2^20 and 2^19 lanes, each at 2^20 lanes against its plain version bit
    for bit in float32 and float64, timed beside its bytes bound (the
    permutation also beside ``index_select`` per array); the triangle
    flagship with the resort against its oracle golden, same seed and one
    thread per ray bit for bit, a key before every launch; the disk flagship
    with the resort asked for launching what its default run launched (6
    chunks); the triangle flagship in float64 with the resort (the float64
    forms); disk18k with the resort on its grid and on the chunk search bit
    for bit, and against the same seed without the resort within 1.45 times
    two seeds' rel-L2. Every path of a batch of 2,048 rays or more launches
    the permutation (source sort, compactions) and the key (compactions).

Every path of the bounce kernel runs once more from a fresh tracer with
every launch at one thread per ray (``fused_bounce``'s private ``group=1``),
and its flux and counters must equal the default run's bit for bit.

Every phase prints one JSON object on a line of its own. The line before the
last lists the kernels; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failing phase raises and the script exits non-zero. Without a CUDA device
it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from viennaray_tpu_torch.utils import telemetry

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12  # H100 SXM data sheet, float32 outside the tensor cores
F64_FLOPS = 34e12  # H100 SXM data sheet, float64 outside the tensor cores
# float32 arithmetic operations of one (ray, primitive) test. A disk
# (csrc/disk_hit.cuh): two dot products (5 each), the plane time (2), the hit
# offset (9) and its squared length (5). A triangle (csrc/tri_hit.cuh): two
# cross products (9 each), three dot products (5 each), the offset from v0
# (3), three quotients and u + v. A line segment (csrc/line_hit.cuh): the
# offset from p0 (2), three two-by-two determinants (3 each), two quotients.
# Comparisons are not counted, and the bound takes every ray against every
# real primitive (what the function computes), not the pairs that are left
# after the kernel's chunk skip.
OPS_PER_PAIR = {"disk": 26, "triangle": 45, "line": 13}
FLAGSHIP = dict(grid_delta=0.25, extent=5.0, trench_width=4.0, trench_depth=4.0)
RAYS_PER_POINT = 2000
SEED = 42
GOLDEN_TOL = 0.05
ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(ROOT, "benchmarks", "golden")
PORT_GOLDEN_DIR = os.path.join(ROOT, "viennaray_tpu_torch", "io", "golden")
# the 2D line configuration (benchmarks/perf_sweep.py:168-207 on the trench
# of io/fixtures.py:create_trench_line_mesh) and the ion configuration
# (benchmarks/perf_sweep.py:113-124 on the flagship's disks)
LINE_TRENCH = dict(FLAGSHIP, grid_delta=0.023)
LINE_STICKING = [0.5, 0.1]
ION = dict(sticking=0.5, cone_angle=float(np.pi / 6), source_power=100.0)
GAS_MEAN_FREE_PATH = 4.0  # one trench depth
# the grid source's points: create_source_grid(adjusted bbox, 2993, 0.25, +z)
GRID_POINTS = 2993
SURFACE = dict(offset=0.01, area=100.0)  # every disk along its normal
# the JAX package's disk2d_trench (benchmarks/make_goldens.py:48-63)
DISK2D = dict(grid_delta=0.1, rays=200_000, batch=16384, seed=12345)


def emit(obj):
    print(json.dumps(obj), flush=True)


def device_ms(fn, reps):
    """Milliseconds per call of ``fn`` over ``reps`` calls, by CUDA events,
    with the calls queued behind a sleep of the stream (about 50 ms) so that
    the events time the device alone: issuing a narrow call can take the
    host longer than its kernels take the card."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_cuda(fn, reps):
    """Milliseconds per call of ``fn`` over ``reps`` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_name():
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_card():
    smi = card_name()
    print(smi, flush=True)
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    emit({
        "phase": "card", "nvidia_smi": smi, "torch": torch.__version__,
        "cuda": torch.version.cuda, "allow_tf32": allow_tf32,
    })
    if allow_tf32:
        raise RuntimeError("TF32 matrix products must be off")


def ptxas_kernels(log):
    """Each kernel's registers and spills from ``ptxas -v``'s lines in the
    build's log: [{"entry", "registers", "spill_stores", "spill_loads"}]."""
    kernels = []
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            kernels.append({"entry": entry.group(1)})
            continue
        if not kernels:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if spill:
            kernels[-1]["spill_stores"] = int(spill.group(1))
            kernels[-1]["spill_loads"] = int(spill.group(2))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            kernels[-1]["registers"] = int(regs.group(1))
    return kernels


# the kernels whose registers and spills the build's line reports by name:
# kernel 4 with the grid search, the grid kernel, the permutation, the
# resort's key and kernel 2's two paths (the large path's launch B, the
# small path's one cluster)
WATCHED_KERNELS = {"kernel4_grid": ("bounce_grid_kernel",),
                   "grid_hit": ("grid_hit_kernel",),
                   "permute_state": ("permute_state_kernel",),
                   "coherence_key": ("coherence_key_kernel",),
                   "histogram_cluster": ("cluster_histogram_kernel",),
                   "histogram_small": ("small_cluster_histogram_kernel",),
                   "neighborhood_rows": ("rows_kernel",)}
BUILD_REGISTERS = {}  # phase_build's report of WATCHED_KERNELS


def phase_build():
    from viennaray_tpu_torch import _build

    _build.library()
    kernels = ptxas_kernels(_build.build_log)
    watched = {name: [k for k in kernels if all(p in k["entry"] for p in pat)]
               for name, pat in WATCHED_KERNELS.items()}
    emit({
        "phase": "build", "nvcc_seconds": round(_build.build_seconds, 3),
        "sources": sorted(p.name for p in _build.CSRC.iterdir()),
        # registers, shared memory and spills of each kernel
        "ptxas": [line for line in _build.build_log.splitlines()
                  if "registers" in line or "spill" in line
                  or "Compiling entry" in line],
    })
    BUILD_REGISTERS.update(watched)
    emit({"phase": "registers", **watched})
    spills = [e["entry"] for found in watched.values() for e in found
              if e.get("spill_stores", 0) or e.get("spill_loads", 0)]
    if spills or not all(watched.values()):
        raise RuntimeError(f"spills in {spills}, or a watched kernel not "
                           f"built: {watched}")


def make_rays(geometry, bbox, n, kind, seed):
    """Seeded rays at the flagship's geometry: ``source`` = what the trace's
    first bounce sees (source plane, cosine lobe), ``interior`` = origins
    anywhere in the box with directions all over the sphere, as after
    diffuse bounces, ``flat`` = the same in the plane z = 0 of a 2D run,
    ``flat_source`` = what a 2D trace's first bounce sees (+y face, the
    cosine lobe flattened into the plane), ``ties`` = straight down from the
    top face through points on the grid of half the grid spacing, so that
    rays meet a flat face where packed disks overlap (the same t on several
    disks) or a mesh's shared edges and vertices (the same t on two or more
    triangles): the selection's tie rule decides them; ``rims`` = rays
    aimed at points a hair inside and outside disk rims or triangle edges
    (``rim_rays``), a quarter of them grazing."""
    from viennaray_tpu_torch.ops import sampling

    dev = geometry.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if kind == "rims":
        return rim_rays(geometry, n, gen)
    u = torch.rand((4, n), generator=gen, device=dev)
    lo, hi = bbox[0], bbox[1]
    org = lo + (hi - lo) * torch.stack([u[0], u[1], u[2]], dim=1)
    if kind == "ties":
        half = 0.5 * geometry.grid_delta
        org[:, :2] = torch.round(org[:, :2] / half) * half
        org[:, 2] = hi[2]
        dirn = torch.zeros_like(org)
        dirn[:, 2] = -1.0
        return org.contiguous(), dirn.contiguous()
    if kind in ("source", "flat_source"):
        lobe = sampling.power_cosine_direction(u[2], u[3], 1.0)
        if kind == "source":
            org[:, 2] = hi[2]
            dirn = torch.stack([lobe[:, 0], lobe[:, 1], -lobe[:, 2]], dim=1)
        else:
            org[:, 1] = hi[1]
            dirn = torch.stack([lobe[:, 0], -lobe[:, 2], lobe[:, 1]], dim=1)
    else:
        dirn = sampling.unit_sphere(u[3], torch.rand(n, generator=gen, device=dev))
    if kind in ("flat", "flat_source"):
        org[:, 2] = 0.0
        dirn[:, 2] = 0.0
        dirn = dirn / torch.linalg.norm(dirn, dim=1, keepdim=True)
    return org.contiguous(), dirn.contiguous()


def _unit(v):
    return v / torch.linalg.norm(v, dim=1, keepdim=True)


def rim_rays(geometry, n, gen):
    """Rays through points a hair inside and outside the rims of random
    disks (r (1 +- 1e-6), r (1 +- 1e-7)) or on and a hair off the edges and
    vertices of random triangles (u = 0, v = 0, u + v = 1, scaled by 1 +-
    1e-6), from 0.01 to 3 units before the point; a quarter of them graze
    the primitive's plane (tilts of 1e-6 to 1e-2), the rest come from any
    side. An over-eager reject before the exact test shows here first."""
    dev = geometry.device
    soa = geometry.prims_soa
    lane = torch.randint(0, geometry.num_primitives, (n,), generator=gen,
                         device=dev)
    col = soa[:, lane].T  # (n, rows)
    u = torch.rand((6, n), generator=gen, device=dev)
    if geometry.kind == "disk":
        normal = col[:, 3:6]
        helper = torch.where(normal[:, :1].abs() < 0.9,
                             torch.tensor([1.0, 0.0, 0.0], device=dev),
                             torch.tensor([0.0, 1.0, 0.0], device=dev))
        a = _unit(torch.linalg.cross(normal, helper))
        b = torch.linalg.cross(normal, a)
        ang = (2 * np.pi * u[0])[:, None]
        frac = torch.tensor([1 - 1e-6, 1 + 1e-6, 1 - 1e-7, 1 + 1e-7],
                            device=dev)[(u[1] * 4).long().clamp(max=3)]
        radius = col[:, 6].sqrt() * frac
        target = col[:, 0:3] + radius[:, None] * (torch.cos(ang) * a
                                                  + torch.sin(ang) * b)
    else:
        normal = col[:, 9:12]
        a, b = _unit(col[:, 3:6]), _unit(col[:, 6:9])
        off = torch.tensor([0.0, 1e-6, -1e-6], device=dev)[
            (u[1] * 3).long().clamp(max=2)]
        # which place: u = 0, v = 0, u + v = 1 or a vertex
        edge = (u[2] * 4).long().clamp(max=3)
        w = u[3]
        bu = torch.where(edge == 0, off, torch.where(edge == 1, w, w))
        bv = torch.where(edge == 0, w, torch.where(edge == 1, off,
                                                   (1 - w) * (1 + off)))
        vert = edge == 3
        bu = torch.where(vert, (w > 0.5).float(), bu)
        bv = torch.where(vert, ((w > 0.25) & (w <= 0.5)).float(), bv)
        target = (col[:, 0:3] + bu[:, None] * col[:, 3:6]
                  + bv[:, None] * col[:, 6:9])
        b = _unit(torch.linalg.cross(normal, a))
    ang = (2 * np.pi * u[4])[:, None]
    tilt = torch.tensor([1e-6, 1e-4, 1e-2], device=dev)[
        (u[5] * 3).long().clamp(max=2)][:, None]
    grazing = _unit(torch.cos(ang) * a + torch.sin(ang) * b + tilt * normal)
    anyway = _unit(torch.randn((n, 3), generator=gen, device=dev))
    dirn = torch.where((u[5] < 0.25)[:, None], grazing, anyway)
    dist = 0.01 + 3.0 * torch.rand((n, 1), generator=gen, device=dev)
    return (target - dist * dirn).contiguous(), dirn.contiguous()


def check_nearest_hit(geometry, bbox, n_rays, kind, reps):
    """The closest-hit kernel of the geometry's kind (disks, triangles or
    lines) against its plain version; the float64 form for a geometry
    widened by ``to(torch.float64)`` (the rays widened too)."""
    from viennaray_tpu_torch.ops import nearest_hit as NH

    f64 = geometry.dtype == torch.float64
    name = f"{geometry.kind}_nearest_hit"
    kernel, plain = getattr(NH, name), getattr(NH, name + "_ref")
    org, dirn = make_rays(geometry, bbox, n_rays, kind, seed=7)
    org, dirn = org.to(geometry.dtype), dirn.to(geometry.dtype)
    args = (org, dirn, geometry.prims_soa, geometry.soa_perm,
            geometry.soa_chunk_bbs)
    t_k, p_k, h_k = kernel(*args, t_near=1e-4)
    torch.cuda.synchronize()
    t_p, p_p, h_p = plain(*args, t_near=1e-4)
    hit_equal = bool(torch.equal(h_k, h_p))
    prim_equal = bool(torch.equal(p_k, p_p))
    max_abs_err = float((t_k - t_p)[h_p].abs().max()) if bool(h_p.any()) else 0.0
    t_equal = bool(torch.equal(t_k, t_p))
    ms = time_cuda(lambda: kernel(*args, t_near=1e-4), reps)
    plain_ms = time_cuda(lambda: plain(*args, t_near=1e-4), 1)
    n_real = geometry.num_primitives
    rows, npad = geometry.prims_soa.shape
    word = 8 if f64 else 4
    op_ms = (n_rays * n_real * OPS_PER_PAIR[geometry.kind]
             / (F64_FLOPS if f64 else F32_FLOPS) * 1e3)
    n_bytes = (n_rays * (6 * word + word + 5) + npad * (rows * word + 4)
               + geometry.soa_chunk_bbs.numel() * word)
    byte_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    res = {
        "phase": "kernel_check", "kernel": name + ("_f64" if f64 else ""),
        "shape": f"R={n_rays} ({kind} rays), Npad={npad}, "
                 f"C={geometry.soa_chunk_bbs.shape[0]}",
        "tolerance": "hit, prim and t equal bit for bit on every lane (the "
                     "exact test: no fused multiply-add, IEEE division, same "
                     "order; the reject before it drops only pairs it would "
                     "not select)",
        "hit_equal": hit_equal, "prim_equal": prim_equal, "t_equal": t_equal,
        "hit_fraction": float(h_p.float().mean()),
        "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(op_ms, byte_ms),
        "bound_by": "operations" if op_ms >= byte_ms else "bytes",
        "library_ms": None,
    }
    emit(res)
    if not (hit_equal and prim_equal and t_equal and max_abs_err == 0.0):
        raise RuntimeError(f"{name} disagrees with its plain version: {res}")
    return res


SEARCH_WIDTHS = (512, 1000, 2048, 16384, 65536, 1 << 20)


def check_search_widths(geometry, bbox, kind, widths=SEARCH_WIDTHS):
    """The closest-hit kernel of the geometry's kind at every width of
    ``widths`` on ``kind`` rays, each held bit for bit (hit, prim, t) to one
    plain run; one JSON object per width with the kernel's time (few
    repeats) beside the bound."""
    from viennaray_tpu_torch.ops import nearest_hit as NH

    name = f"{geometry.kind}_nearest_hit"
    kernel, plain = getattr(NH, name), getattr(NH, name + "_ref")
    for n_rays in widths:
        org, dirn = make_rays(geometry, bbox, n_rays, kind, seed=11)
        args = (org, dirn, geometry.prims_soa, geometry.soa_perm,
                geometry.soa_chunk_bbs)
        want = plain(*args, t_near=1e-4)
        got = kernel(*args, t_near=1e-4)
        torch.cuda.synchronize()
        equal = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
        ms = time_cuda(lambda: kernel(*args, t_near=1e-4),
                       2 if n_rays >= 65536 else 5)
        op_ms = (n_rays * geometry.num_primitives
                 * OPS_PER_PAIR[geometry.kind] / F32_FLOPS * 1e3)
        res = {
            "phase": "search_widths", "kernel": name, "rays": kind,
            "width": n_rays, "chunks": geometry.soa_chunk_bbs.shape[0],
            "bitwise_equal": equal, "ms": ms,
            "hit_fraction": float(want[2].float().mean()),
            "bound_ms": op_ms, "bound_by": "operations",
        }
        emit(res)
        if not equal:
            raise RuntimeError(f"{name} disagrees with its plain version: "
                               f"{res}")


def check_search_wide_index(geometry, bbox, edge=8192):
    """The closest-hit kernel on 2^27 + ``edge`` rays, past the width at
    which a warp per ray's thread index passes 2^32: the batch is one block
    of interior rays repeated, with fresh rays in its first and last
    ``edge`` places, and both ends must equal the plain version on those
    rays bit for bit (a wrapped index would put the last rays' results in
    the first places and leave the last unwritten)."""
    from viennaray_tpu_torch.ops import nearest_hit as NH

    name = f"{geometry.kind}_nearest_hit"
    kernel, plain = getattr(NH, name), getattr(NH, name + "_ref")
    n_rays = (1 << 27) + edge
    head = make_rays(geometry, bbox, edge, "interior", seed=21)
    tail = make_rays(geometry, bbox, edge, "interior", seed=22)
    fill = make_rays(geometry, bbox, edge, "interior", seed=23)
    org, dirn = (f.repeat(n_rays // edge, 1) for f in fill)
    for big, h, t in zip((org, dirn), head, tail):
        big[:edge] = h
        big[-edge:] = t
    geo = (geometry.prims_soa, geometry.soa_perm, geometry.soa_chunk_bbs)
    start = time.perf_counter()
    got = kernel(org, dirn, *geo, t_near=1e-4)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    equal = {}
    for end, rays, part in (("first", head, slice(0, edge)),
                            ("last", tail, slice(n_rays - edge, n_rays))):
        want = plain(*rays, *geo, t_near=1e-4)
        equal[end] = all(bool(torch.equal(a[part], b))
                         for a, b in zip(got, want))
    res = {"phase": "search_wide_index", "kernel": name, "width": n_rays,
           "bitwise_equal": equal, "seconds": seconds}
    emit(res)
    del org, dirn, got
    torch.cuda.empty_cache()
    if not all(equal.values()):
        raise RuntimeError(f"{name} disagrees past 2^27 rays: {res}")


def make_deposits(geometry, n_rays, n_bins, seed, slots=None):
    """Seeded (ids, w) shaped like one bounce's deposits. Disks: per ray the
    hit disk and its K neighbour slots; about half the rays deposit, and a
    few of a depositing ray's neighbour slots carry its weight. Triangles:
    per ray the hit triangle alone. ``slots``: that many entries a ray, on
    bins drawn at random (disk1m's K + 1 = 43 on its 704,250 bins)."""
    dev = geometry.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    k = geometry.neighbors.shape[1] if geometry.kind == "disk" else 0
    if slots is not None:
        k = slots - 1
    if k == 0:
        ids = torch.randint(n_bins, (n_rays, 1), generator=gen, device=dev,
                            dtype=torch.int32)
    elif n_bins == geometry.num_primitives and slots is None:
        prim = torch.randint(n_bins, (n_rays,), generator=gen, device=dev)
        nbrs = torch.clamp(geometry.neighbors[prim], 0, n_bins - 1)
        ids = torch.cat([prim[:, None].to(torch.int32), nbrs], dim=1)
    else:
        ids = torch.randint(
            n_bins, (n_rays, k + 1), generator=gen, device=dev,
            dtype=torch.int32,
        )
    weight = 0.1 + 0.9 * torch.rand(n_rays, generator=gen, device=dev)
    collide = torch.rand(n_rays, generator=gen, device=dev) < 0.5
    mask = torch.rand((n_rays, k + 1), generator=gen, device=dev) < 0.25
    mask[:, 0] = True
    mask &= collide[:, None]
    w = torch.where(mask, weight[:, None], torch.zeros((), device=dev))
    return ids.reshape(-1).contiguous(), w.reshape(-1).contiguous()


def check_histogram(geometry, n_rays, n_bins, reps, n_entries=None,
                    dtype=torch.float32, slots=None):
    """Kernel 2 on one bounce's worth of deposits (the first ``n_entries``
    of them where given; ``slots`` as ``make_deposits``) against its plain
    version, on the path and branch the wrapper picks; every other branch
    the input admits (the small path, the large path's cluster branch, its
    global branch) must give the same bits. Times each on the device
    alone, the plain version and one ``index_add_`` call. ``dtype``
    float64: the float64 form on the weights widened, held bit for bit to
    its plain version (the same integer sums)."""
    from viennaray_tpu_torch.ops import histogram as H

    f64 = dtype == torch.float64
    ids, w = make_deposits(geometry, n_rays, n_bins, seed=11, slots=slots)
    w = w.to(dtype)
    if n_entries is not None:
        ids, w = ids[:n_entries].contiguous(), w[:n_entries].contiguous()
    path = H.path_for(ids.numel(), n_bins, dtype)
    cluster = H.cluster_for(n_bins, dtype)
    branch = "small" if path == "small" else H.branch_for(
        ids.numel(), n_bins, dtype, H._sm_count(w.get_device()))
    calls = {"global": lambda: H.flux_histogram(ids, w, n_bins, path="large",
                                                branch="global")}
    if cluster:
        calls["cluster"] = lambda: H.flux_histogram(
            ids, w, n_bins, path="large", branch="cluster")
    if n_bins <= H.small_max_bins(dtype) and ids.numel() < 2**31:
        calls["small"] = lambda: H.flux_histogram(ids, w, n_bins,
                                                  path="small")
    outs = {b: call() for b, call in calls.items()}
    out_1 = H.flux_histogram(ids, w, n_bins)
    out_2 = H.flux_histogram(ids, w, n_bins)
    torch.cuda.synchronize()
    ref = H.flux_histogram_ref(ids, w, n_bins)
    bitwise = bool(torch.equal(out_1, out_2))
    branches_equal = all(torch.equal(o, out_1) for o in outs.values())
    max_abs_err = float((out_1 - ref).abs().max())
    tol = 0.0 if f64 else float(ref.abs().max()) * 2.0 ** -22
    ms_by_branch = {b: device_ms(call, reps) for b, call in calls.items()}
    plain_ms = device_ms(lambda: H.flux_histogram_ref(ids, w, n_bins), reps)
    ids64 = ids.long()
    library_ms = device_ms(
        lambda: torch.zeros(n_bins, dtype=dtype,
                            device=w.device).index_add_(0, ids64, w),
        reps,
    )
    # ids and w read once, the bins written once (float64: two words a bin)
    byte_ms = ((ids.numel() * (12 if f64 else 8) + n_bins * (16 if f64 else 4))
               / HBM_BYTES_PER_S * 1e3)
    # one addition per entry that carries weight
    op_ms = float((w != 0).sum()) / (F64_FLOPS if f64 else F32_FLOPS) * 1e3
    res = {
        "phase": "kernel_check",
        "kernel": "flux_histogram" + ("_f64" if f64 else ""),
        "shape": f"E={ids.numel()}, n={n_bins}, "
                 f"nonzero={float((w != 0).float().mean()):.3f}",
        "path": path, "branch": branch, "cluster": cluster,
        "small_cluster": H.small_cluster_for(n_bins, dtype),
        "threshold": H.SMALL_ENTRIES,
        "tolerance": "bit for bit against the plain version (the same "
                     "integer sums of two fixed-point words an entry) and "
                     "between the branches" if f64 else
                     "|kernel - plain| <= 2^-22 * max|plain| (the plain "
                     "version sums in float64; both round once to float32); "
                     "every branch bit for bit",
        "tolerance_abs": tol, "max_abs_err": max_abs_err,
        "bitwise_repeatable": bitwise, "branches_bitwise_equal":
            branches_equal,
        "ms": ms_by_branch[branch], "ms_by_branch": ms_by_branch,
        "plain_ms": plain_ms,
        "bound_ms": max(op_ms, byte_ms),
        "bound_by": "operations" if op_ms > byte_ms else "bytes",
        "library_ms": library_ms,
    }
    emit(res)
    if not (bitwise and branches_equal and max_abs_err <= tol):
        raise RuntimeError(f"flux_histogram fails its check: {res}")
    del ids, w, ids64, ref
    torch.cuda.empty_cache()
    return res


def ion_particle():
    import viennaray_tpu_torch as vrt

    return vrt.ConedCosineParticle(
        ION["sticking"], ION["cone_angle"], ION["source_power"]
    )


def gas_particle():
    import dataclasses

    import viennaray_tpu_torch as vrt

    return dataclasses.replace(
        vrt.DiffuseParticle(0.1), mean_free_path=GAS_MEAN_FREE_PATH
    )


def bounce_settings(specular=False, walls="PERIODIC", dim=3, particle=None,
                    flux_model="neighbor"):
    """The flagship's settings of a bounce (diffuse, periodic walls, sticking
    0.1), or a specular particle, or another particle, or other walls, or
    the window flux model; in 2D the source lies on the +y face."""
    import viennaray_tpu_torch as vrt
    from viennaray_tpu_torch.ops.bounce import BounceSettings

    bc = vrt.BoundaryCondition[walls]
    if particle is None:
        particle = (vrt.SpecularParticle(0.1, 1.0) if specular
                    else vrt.DiffuseParticle(0.1))
    direction = vrt.TraceDirection.POS_Z if dim == 3 else vrt.TraceDirection.POS_Y
    return BounceSettings.from_config(
        vrt.TraceConfig(dim=dim, boundary_conditions=(bc,) * 3,
                        source_direction=direction, flux_model=flux_model),
        particle,
    )


def adjusted_bbox(geometry, dim=3):
    """The source-adjusted bounding box of a geometry, on its device; the
    source lies on the +z face in 3D and on the +y face in 2D."""
    from viennaray_tpu_torch.config import TraceDirection, adjust_bounding_box

    direction = TraceDirection.POS_Z if dim == 3 else TraceDirection.POS_Y
    margin = (geometry.disk_radius if geometry.kind == "disk"
              else geometry.grid_delta)
    return torch.tensor(
        adjust_bounding_box(geometry.bbox.cpu().numpy(), direction,
                            margin, dim),
        dtype=torch.float32, device=geometry.device,
    )


def trench_2d_lines():
    """The same 2D trench as a ``LineMesh`` (segments of length 0.05 along
    shelf, wall, floor, wall, shelf, left-hand normals into the open side),
    extruded to triangles as ``TraceTriangle(dim=2)`` does, and its
    source-adjusted box."""
    from viennaray_tpu_torch.geometry.mesh import LineMesh
    from viennaray_tpu_torch.geometry.triangle_geometry import TriangleGeometry
    from viennaray_tpu_torch.io import fixtures

    step = 0.05
    nodes, lines = fixtures.create_trench_line_mesh(
        grid_delta=step, extent=3.0, trench_width=2.0, trench_depth=2.0
    )
    geometry = TriangleGeometry.from_line_mesh(
        LineMesh(nodes, lines, grid_delta=step)
    )
    return geometry, adjusted_bbox(geometry, dim=2)


def line_trench():
    """The line configuration's mesh and material ids: the 2D trench at
    ``grid_delta`` 0.023 (782 segments in 2 chunks of 512 lanes), material 1
    on the second half of the segments."""
    from viennaray_tpu_torch.geometry.mesh import LineMesh
    from viennaray_tpu_torch.io import fixtures

    nodes, lines = fixtures.create_trench_line_mesh(**LINE_TRENCH)
    mesh = LineMesh(nodes, lines, grid_delta=LINE_TRENCH["grid_delta"])
    material_ids = np.zeros(len(mesh.lines), np.int32)
    material_ids[len(material_ids) // 2:] = 1
    return mesh, material_ids


def trench_2d(device=None):
    """A 2D trench of disks (a polyline in the plane z = 0: shelf, wall,
    floor, wall, shelf at spacing 0.05, normals into the open side), and its
    source-adjusted box: the kernel's 2D branches have no other caller on
    the card yet."""
    from viennaray_tpu_torch.geometry.disk_geometry import DiskGeometry

    step = 0.05
    xs = np.arange(-2.0, -1.0, step)
    ys = np.arange(0.0, -2.0, -step)
    floor = np.arange(-1.0, 1.0, step)
    parts = [
        (np.stack([xs, 0 * xs], 1), (0.0, 1.0)),
        (np.stack([0 * ys - 1.0, ys], 1), (1.0, 0.0)),
        (np.stack([floor, 0 * floor - 2.0], 1), (0.0, 1.0)),
        (np.stack([0 * ys + 1.0, ys[::-1]], 1), (-1.0, 0.0)),
        (np.stack([xs + 3.0 + step, 0 * xs], 1), (0.0, 1.0)),
    ]
    pts = np.concatenate([np.c_[p, np.zeros(len(p))] for p, _ in parts])
    nrm = np.concatenate(
        [np.tile((*n, 0.0), (len(p), 1)) for p, n in parts]
    )
    geometry = DiskGeometry.build(pts, nrm, step, dim=2, device=device)
    return geometry, adjusted_bbox(geometry, dim=2)


def make_state(geometry, bbox, n_rays, kind, n_sub, settings, seed):
    """Seeded state and uniforms on the card: rays from ``make_rays``, a
    twentieth of the lanes dead, a tenth that have passed a disk from behind,
    weights from w0 down to the roulette threshold, boundary-hit counts up to
    the cap. A coned-cosine particle's column 0 of every sub-bounce carries a
    sampled theta, as the trace hands it over."""
    from viennaray_tpu_torch.config import ReflectionKind
    from viennaray_tpu_torch.ops import sampling
    from viennaray_tpu_torch.ops.bounce import RayState

    dev = geometry.device
    org, dirn = make_rays(geometry, bbox, n_rays, kind, seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    u = torch.rand((4, n_rays), generator=gen, device=dev)
    w0 = torch.ones(n_rays, device=dev)
    levels = torch.tensor([1.0, 0.6, 0.25, 0.12, 0.105], device=dev)
    weight = levels[(u[0] * 5).long().clamp(max=4)]
    n_bdry = (u[3] * (settings.max_boundary_hits + 1)).to(torch.int32)
    state = RayState(
        org, dirn, weight.contiguous(), w0, u[1] > 0.05, u[2] < 0.1,
        torch.zeros(n_rays, dtype=torch.int32, device=dev),
        n_bdry.clamp(max=settings.max_boundary_hits).contiguous(),
    )
    n_uni = settings.n_uni
    uniforms = torch.rand((n_rays, n_uni * n_sub), generator=gen, device=dev)
    if settings.refl_kind == ReflectionKind.CONED_COSINE:
        shape = (n_rays, n_sub)
        uniforms[:, 0::n_uni] = sampling.coned_cosine_theta(
            lambda i: (torch.rand(shape, generator=gen, device=dev),
                       torch.rand(shape, generator=gen, device=dev)),
            shape, settings.cone_angle, dev,
        )
    return state, uniforms


def check_bounce(geometry, bbox, n_rays, kind, n_sub, in_kernel, settings,
                 reps, particle=None, group=None, time_plain=True):
    """The bounce kernel against its plain version on one seeded state.
    ``particle``: the particle whose per-material table gives the launch its
    per-lane sticking (none: the settings' one value); ``group``: the threads
    per ray (none: the wrapper's choice for the width); ``time_plain``: also
    time the plain version (else its time is null)."""
    from viennaray_tpu_torch.ops import bounce as B

    window = settings.deposit_kind(geometry) == "window"
    if window:
        geometry = geometry.with_window_list()
    walls = B.make_walls(bbox, geometry, settings)
    state, uniforms = make_state(
        geometry, bbox, n_rays, kind, n_sub, settings, seed=13
    )
    stick_lanes = (None if particle is None
                   else B.sticking_lanes(particle, geometry))
    args = (state, uniforms, geometry, walls, settings)
    kw = dict(n_sub=n_sub, deposit_in_kernel=in_kernel,
              stick_lanes=stick_lanes)
    g = (B.group_for(n_rays, geometry.soa_chunk_bbs.shape[0]) if group is None
         else group)
    res = B.fused_bounce(*args, **kw, group=g)
    again = B.fused_bounce(*args, **kw, group=g)
    torch.cuda.synchronize()
    ref = B.fused_bounce_ref(*args, **kw)

    st, rs = res.state, ref.state
    flags_same = (
        (st.alive == rs.alive) & (st.hfb == rs.hfb)
        & (st.n_refl == rs.n_refl) & (st.n_bdry == rs.n_bdry)
    )
    if not in_kernel:
        flags_same &= (res.hit_prim == ref.hit_prim) & (res.wdep == ref.wdep)
        if window:
            flags_same &= res.t_hit == ref.t_hit
    lanes_equal = float(flags_same.float().mean())
    # a dead lane's origin and direction are of no use to anyone; compare
    # them on the lanes both versions leave alive
    live = flags_same & rs.alive
    def worst(diff, lanes):
        picked = diff[lanes]
        return float(picked.abs().max()) if picked.numel() else 0.0

    err = {
        "org": worst(st.org - rs.org, live),
        "dirn": worst(st.dirn - rs.dirn, live),
        "weight": worst(st.weight - rs.weight, flags_same),
    }
    # the plain version sweeps no chunks: the kernel's two search counts are
    # held to what they must be instead. A group of threads runs a
    # sub-bounce for each alive ray (one search each); a warp (G = 1) runs
    # one where any of its 32 rays is alive. Either sweeps a chunk at most
    # once a sub-bounce
    n_events = B.N_EVENTS + 1
    counts, ref_counts = (res.counts[:n_events].tolist(),
                          ref.counts[:n_events].tolist())
    swept, tiles = res.counts[n_events:].tolist()
    n_chunks = geometry.soa_chunk_bbs.shape[0]
    if g > 1:
        tiles_ok = tiles == counts[3]
    else:
        tiles_ok = -(-counts[3] // 32) <= tiles <= n_sub * -(-n_rays // 32)
    search_counts_ok = tiles_ok and 0 <= swept <= tiles * n_chunks
    bitwise = all(
        torch.equal(a, b) for a, b in zip(res.state, again.state)
    ) and torch.equal(res.counts, again.counts)
    if in_kernel:
        bitwise = bitwise and torch.equal(res.flux, again.flux)
        flux_err = float((res.flux - ref.flux).abs().max())
        flux_max = float(ref.flux.abs().max())
    else:
        bitwise = bitwise and torch.equal(res.hit_prim, again.hit_prim)
        flux_err, flux_max = 0.0, 0.0

    # Last bits: the kernel repeats the plain version's float32 operations
    # one by one, and its sinf / cosf (diffuse and coned-cosine reflection,
    # scattering direction) and expf (scattering probability) are the
    # functions PyTorch's own kernels call, so nothing is left to differ,
    # whatever n_sub: every branch is held to equality.
    tolerance = (
        "flags, counters, hit prim and deposit weight equal on every lane; "
        "origin, direction and weight bit for bit on the lanes left alive; "
        "counts equal; flux within 2^-22 of the largest bin (the plain "
        "version sums in float64; both round once to float32)"
    )
    ok = (
        lanes_equal == 1.0 and max(err.values()) == 0.0
        and counts == ref_counts and flux_err <= flux_max * 2.0 ** -22
        and search_counts_ok
    )

    ms = time_cuda(lambda: B.fused_bounce(*args, **kw, group=g), reps)
    plain_ms = (time_cuda(lambda: B.fused_bounce_ref(*args, **kw), 1)
                if time_plain else None)
    n_real = geometry.num_primitives
    rows, npad = geometry.prims_soa.shape
    k_nbrs = geometry.neighbors.shape[1] if geometry.kind == "disk" else 0
    if window:
        k_nbrs = geometry.window_ids.shape[1]
    # operations: every search of this run (a lane alive at a sub-bounce)
    # against every real primitive, and under the window model every window
    # record a colliding ray re-tests (W a collision, in the kernel or by the
    # caller); bytes: state and uniforms in, state and the flux or the (hit,
    # weight) pair out, the geometry tables once
    traces = ref_counts[3]
    pairs = traces * n_real + (ref_counts[0] * k_nbrs if window else 0)
    op_ms = pairs * OPS_PER_PAIR[geometry.kind] / F32_FLOPS * 1e3
    n_bytes = (
        n_rays * (66 + 4 * settings.n_uni * n_sub + 62)
        + npad * (rows + 1 + (stick_lanes is not None)) * 4
        + geometry.soa_chunk_bbs.numel() * 4 + n_real * k_nbrs * 36
        + (n_real * 4 if in_kernel else n_rays * 8)
    )
    byte_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    res_out = {
        "phase": "kernel_check", "kernel": "fused_bounce",
        "shape": f"{geometry.kind}s, R={n_rays} ({kind} rays), n_sub={n_sub}, "
                 f"G={g}, deposits "
                 f"{'in the kernel' if in_kernel else 'handed out'}, "
                 f"{('diffuse', 'specular', 'coned-cosine')[settings.refl_kind]}, "
                 f"{'sticking per lane, ' if stick_lanes is not None else ''}"
                 f"{'gas scattering, ' if settings.n_uni == 6 else ''}"
                 f"{'window flux model, ' if window else ''}"
                 f"{('reflective', 'periodic', 'ignore')[settings.bc1]}, "
                 f"dim={settings.dim}, "
                 f"Npad={npad}, C={geometry.soa_chunk_bbs.shape[0]}, "
                 f"{'W' if window else 'K'}={k_nbrs}",
        "tolerance": tolerance, "lanes_equal": lanes_equal,
        "max_abs_err_state": err, "counts": counts, "plain_counts": ref_counts,
        "group": g, "chunks_swept": swept, "tile_bounces": tiles,
        "flux_max_abs_err": flux_err, "flux_max": flux_max,
        "bitwise_repeatable": bool(bitwise),
        "max_abs_err": max(max(err.values()), flux_err),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(op_ms, byte_ms),
        "bound_by": "operations" if op_ms >= byte_ms else "bytes",
        "library_ms": None,
    }
    emit(res_out)
    if not (ok and bitwise):
        raise RuntimeError(f"fused_bounce fails its check: {res_out}")
    return res_out


def make_tracer(pts, nrm, rays_per_point=RAYS_PER_POINT, fused=True,
                particle=None, flux_model="neighbor", use_wdist=False,
                source=None, bounce_sort=False):
    """The disk flagship through ``TraceDisk``, or with another particle,
    the window flux model, 1/distance weighting, ``source(tracer)`` (the
    grid or the surface source of the flagship) in place of the random one,
    or the per-bounce resort asked for."""
    import viennaray_tpu_torch as vrt

    # device=None: the CUDA device, or raises
    tracer = vrt.TraceDisk(dim=3, fused=fused, bounce_sort=bounce_sort)
    tracer.set_geometry(pts, nrm, FLAGSHIP["grid_delta"])
    tracer.set_flux_model(flux_model)
    tracer.set_use_wdist(use_wdist)
    if source is not None:
        tracer.set_source(source(tracer))
    return configure(tracer, rays_per_point, particle)


def grid_source(tracer):
    """The flagship's grid source: ``create_source_grid`` on the +z face of
    the adjusted box, asked for 2,993 points (it lays 53 x 53 = 2,809),
    cosine lobe."""
    import viennaray_tpu_torch as vrt
    from viennaray_tpu_torch.io import fixtures

    bbox = adjusted_bbox(tracer.geometry).cpu().numpy()
    grid = fixtures.create_source_grid(
        bbox, GRID_POINTS, FLAGSHIP["grid_delta"], vrt.TraceDirection.POS_Z)
    return vrt.GridSource.build(bbox, grid, 1.0, vrt.TraceDirection.POS_Z)


def surface_source(tracer):
    """The flagship's surface source: every disk centre along its normal,
    offset 0.01, unit weights, source area 100, cosine lobe."""
    import viennaray_tpu_torch as vrt

    geometry = tracer.geometry
    return vrt.SurfaceSource.build(
        geometry.points.cpu().numpy(), geometry.normals.cpu().numpy(),
        cosine_power=1.0, device=geometry.device, **SURFACE)


def line_particle():
    import viennaray_tpu_torch as vrt

    return vrt.DiffuseParticle(0.5, "flux", material_sticking=LINE_STICKING)


def make_line_tracer(rays_per_point=RAYS_PER_POINT, fused=True):
    """The line configuration through ``TraceLine`` on the default device:
    per-material sticking, periodic walls, source on the +y face."""
    import viennaray_tpu_torch as vrt

    mesh, material_ids = line_trench()
    tracer = vrt.TraceLine(fused=fused)
    tracer.set_geometry(mesh, material_ids=material_ids)
    return configure(tracer, rays_per_point, line_particle())


def make_ribbon_tracer(num_rays):
    """The same mesh, materials and physics through ``TraceTriangle(dim=2)``,
    which extrudes every segment to a pair of triangles."""
    import viennaray_tpu_torch as vrt

    mesh, material_ids = line_trench()
    tracer = vrt.TraceTriangle(dim=2)
    tracer.set_geometry(mesh)
    tracer.set_material_ids(np.repeat(material_ids, 2))
    configure(tracer, 0, line_particle())
    tracer.set_number_of_rays_fixed(num_rays)
    return tracer


def make_tri_tracer(verts, tris, rays_per_point=RAYS_PER_POINT, fused=True,
                    bounce_sort=False):
    import viennaray_tpu_torch as vrt

    tracer = vrt.TraceTriangle(dim=3, fused=fused, bounce_sort=bounce_sort)
    tracer.set_geometry(verts, tris, FLAGSHIP["grid_delta"])
    return configure(tracer, rays_per_point)


def configure(tracer, rays_per_point, particle=None):
    """The flagships' physics: periodic walls, diffuse particle with sticking
    0.1 (or ``particle``), a fixed seed."""
    import viennaray_tpu_torch as vrt

    tracer.set_boundary_conditions([vrt.BoundaryCondition.PERIODIC] * 3)
    tracer.set_particle_type(particle or vrt.DiffuseParticle(0.1, "flux"))
    tracer.set_number_of_rays_per_point(rays_per_point)
    tracer.set_rng_seed(SEED)
    return tracer


def rel_l2(a, golden):
    g = np.asarray(golden, np.float64)
    return float(np.linalg.norm(a - g) / max(np.linalg.norm(g), 1e-12))


def disk_goldens():
    return {
        "rel_l2_golden": np.load(os.path.join(GOLDEN_DIR, "bench_disk3d.npy")),
        "rel_l2_oracle": np.load(
            os.path.join(GOLDEN_DIR, "bench_disk3d_oracle.npy")
        ),
    }


def oracle_golden(name):
    """A golden of ``viennaray_tpu_torch/io/golden`` (the scalar oracle's,
    or the JAX package's on the CPU), its record, and the bound the flux is
    held to: rel-L2 < 0.05, or 1.45 times the golden's own noise (the rel-L2
    between its two seeds) where that noise is above 0.035."""
    path = os.path.join(PORT_GOLDEN_DIR, name)
    golden = np.load(path + ".npy")
    with open(path + ".json") as f:
        record = json.load(f)
    noise = record["rel_l2_between_seeds"]
    tol = GOLDEN_TOL if noise <= 0.035 else 1.45 * noise
    return golden, record, tol


# the registry's counts of kernel launches (``utils.telemetry``): the bounce
# and histogram kernels' under the names an apply span carries, every other
# kernel's as ``<wrapper>.launches`` and ``<wrapper>.launches_f64``, and the
# bounce kernel's launches with the grid search
LAUNCHES = re.compile(
    r"(bounce|histogram)_launches(_f64)?|\w+\.launches(_f64|_grid)?")
# what every trace of a batch of at least 2,048 rays launches besides its
# bounce kernels: the state's permutation at the source sort and at every
# compaction, and the coherence key at the compactions (and, where the
# per-bounce resort is asked for and engages, before every launch)
SORTS = ("permute_state.launches", "coherence_key.launches")
# the registry's names of the launches the checks and the kernels line read
BOUNCE, GRID, HIST, HIST_GRAD = (
    "bounce_launches", "fused_bounce.launches_grid", "histogram_launches",
    "flux_histogram_grad.launches")
DISK, TRI, LINE = (f"{kind}_nearest_hit.launches"
                   for kind in ("disk", "triangle", "line"))


def launches_since(before):
    """The kernels' launches (``LAUNCHES``) since ``before``, a snapshot
    ``dict(telemetry.COUNTS)``, by the registry's names."""
    return {name: n for name, n in telemetry.since(before).items()
            if LAUNCHES.fullmatch(name)}


def timed_apply(tracer, goldens, tol=GOLDEN_TOL):
    """One apply with the registry's counts read just before and just
    after, its normalized flux held to ``goldens`` (result key -> array) with
    rel-L2 < ``tol``; returns (result fields, ok, launches)."""
    before = dict(telemetry.COUNTS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flux = tracer.apply()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launches_since(before)
    counts = telemetry.since(before)
    info = tracer.get_ray_trace_info()
    norm = np.asarray(tracer.normalize_flux(flux), np.float64)
    n_prims = tracer.geometry.num_primitives
    errors = {key: rel_l2(norm, g) for key, g in goldens.items()}
    fields = {
        f"{tracer.geometry.kind}s": n_prims, "num_rays": info.num_rays,
        "batch": tracer._ray_batch_size, "seconds": seconds,
        "rays_per_s": info.num_rays / seconds,
        "total_rays_traced": info.total_rays_traced,
        "geometry_hits": info.geometry_hits,
        "particle_hits": info.particle_hits,
        "non_geometry_hits": info.non_geometry_hits,
        "boundary_hits": info.boundary_hits,
        "geometry_hits_per_ray": info.geometry_hits / info.num_rays,
        **errors, "rel_l2_bound": tol,
        "launches": launches,
        "counts": {k: n for k, n in counts.items() if n},
        "bounces": counts["fused_bounce.sub_bounces"] or launches[DISK]
        or launches[TRI] or launches[LINE],
    }
    ok = (
        np.isfinite(norm).all() and norm.shape == (n_prims,)
        and norm.max() > 0 and all(e < tol for e in errors.values())
    )
    return fields, ok, launches, norm


def only_launched(launches, *names):
    """Every kernel of ``names`` was launched and no other."""
    return all((count > 0) == (name in names)
               for name, count in launches.items())


def hits_per_ray_ok(fields, record):
    """``geometry_hits / num_rays`` within 2 % of the oracle's."""
    want = record["geometry_hits_per_ray"]
    fields["oracle_geometry_hits_per_ray"] = want
    return abs(fields["geometry_hits_per_ray"] - want) <= 0.02 * want


INFO_COUNTERS = ("num_rays", "total_rays_traced", "non_geometry_hits",
                 "geometry_hits", "particle_hits", "boundary_hits",
                 "reflections")


def apply_with_group_one(tracer):
    """One apply with every launch of the bounce kernel at one thread per
    ray (``fused_bounce``'s private ``group=1``, put in the trace module's
    place for this apply); returns the flux and the run's TraceInfo."""
    from viennaray_tpu_torch.ops import bounce as B
    from viennaray_tpu_torch.trace import kernel as TK

    TK.fused_bounce = functools.partial(B.fused_bounce, group=1)
    try:
        flux = tracer.apply()
    finally:
        TK.fused_bounce = B.fused_bounce
    return flux, tracer.get_ray_trace_info()


def run_path(label, make, goldens, tol, kernels, record=None, same_seed=False,
             extra=None):
    """One path of a configuration: a warm-up apply of ``make()``'s tracer,
    then the timed apply (its second, so its run number is 2), printed as one
    ``main_path`` object with ``label``'s fields. Raises unless the flux is
    within ``tol`` of ``goldens``, the hits per ray within 2 % of the oracle
    ``record``'s (where one is given), exactly ``kernels`` were launched,
    with ``same_seed`` a fresh tracer's first apply is bitwise equal to the
    warm-up, a path of the bounce kernel gives the warm-up's flux and
    counters bit for bit with every launch at one thread per ray (a fresh
    tracer's first apply; the two search counts differ by design), and
    ``extra(fields, norm) -> (more fields, ok)`` holds. In one process, so
    that the paths' times can be compared. Returns (fields, launches,
    normalized flux)."""
    import dataclasses

    t0 = time.perf_counter()
    tracer = make()  # the geometry's build on the host
    build_seconds = time.perf_counter() - t0
    first = tracer.apply()
    first_info = dataclasses.asdict(tracer.get_ray_trace_info())
    fields, ok, launches, norm = timed_apply(tracer, goldens, tol)
    if record is not None:
        ok = ok and hits_per_ray_ok(fields, record)
    res = {"phase": "main_path", **label, **fields,
           "tracer_build_seconds": build_seconds}
    if same_seed:
        bitwise = bool(np.array_equal(first, make().apply()))
        res["same_seed_bitwise_equal"] = bitwise
        ok = ok and bitwise
    if launches[BOUNCE]:
        one, one_info = apply_with_group_one(make())
        one_info = dataclasses.asdict(one_info)
        equal = bool(np.array_equal(first, one)) and all(
            first_info[k] == one_info[k] for k in INFO_COUNTERS)
        res["group_one_bitwise_equal"] = equal
        res["search_counts"] = {
            k: first_info[k] for k in ("chunks_swept", "tile_bounces")}
        res["search_counts_group_one"] = {
            k: one_info[k] for k in ("chunks_swept", "tile_bounces")}
        res["seconds_group_one_first_apply"] = one_info["time"]
        res["seconds_first_apply"] = first_info["time"]
        ok = ok and equal
    if extra is not None:
        more, extra_ok = extra(fields, norm)
        res.update(more)
        ok = ok and extra_ok
    emit(res)
    if not (ok and only_launched(launches, *kernels)):
        raise RuntimeError(f"path failed its checks: {res}")
    return fields, launches, norm


def phase_disk_paths(pts, nrm):
    """The flagship at full width through the default tracer, whose body is
    the fused bounce kernel (its wide launches hand their deposits to the
    histogram kernel); then the unfused body around the closest-hit and
    histogram kernels at a quarter of the depth, 500 rays per point (twice
    the noise, so twice the bound)."""
    make = functools.partial(make_tracer, pts, nrm)
    _, launches, norm = run_path(
        {"body": "fused"}, make, disk_goldens(), GOLDEN_TOL,
        (BOUNCE, HIST, *SORTS), same_seed=True)
    _, unfused_launches, _ = run_path(
        {"body": "unfused"},
        functools.partial(make, rays_per_point=RAYS_PER_POINT // 4, fused=False),
        disk_goldens(), 2.0 * GOLDEN_TOL,
        (DISK, HIST, *SORTS))
    return launches, unfused_launches, norm


def phase_triangle_paths(verts, tris):
    """The triangle flagship at full width through the default
    ``TraceTriangle``: the fused bounce kernel's triangle instantiation and
    no other kernel; then the unfused body (the triangle closest-hit kernel
    and the histogram kernel on every bounce) at an eighth of the depth, 250
    rays per triangle: 2.8 times the Monte Carlo noise, so three times the
    bound."""
    golden, record, tol = oracle_golden("tri3d_trench_oracle")
    goldens = {"rel_l2_oracle": golden}
    make = functools.partial(make_tri_tracer, verts, tris)
    label = {"geometry": "triangles"}
    _, launches, _ = run_path(
        {**label, "body": "fused"}, make, goldens, tol,
        (BOUNCE, *SORTS), record, same_seed=True)
    _, unfused_launches, _ = run_path(
        {**label, "body": "unfused"},
        functools.partial(make, rays_per_point=RAYS_PER_POINT // 8, fused=False),
        goldens, 3.0 * tol,
        (TRI, HIST, *SORTS), record)
    return launches, unfused_launches


def phase_line_paths():
    """The line configuration at full width through the default
    ``TraceLine`` (782 segments, 2,000 rays per segment, per-material
    sticking): the fused bounce kernel's line instantiation and no other
    kernel; then ``TraceLine(fused=False)`` at a quarter of the rays (the
    line closest-hit kernel and the histogram kernel on every bounce, twice
    the noise, so twice the bound); then the same mesh through
    ``TraceTriangle(dim=2)`` with as many rays as the line run, each line's
    flux the mean of its pair's. The two are independent runs that are each
    allowed the golden bound, so they are held to sqrt(2) times it, and
    their hits per ray to 2 % of each other. They agree within noise and not
    exactly: the line test clips 1e-5 of a segment at each end."""
    golden, record, tol = oracle_golden("line2d_trench_oracle")
    goldens = {"rel_l2_oracle": golden}
    label = {"geometry": "lines"}
    fields, launches, line_norm = run_path(
        {**label, "body": "fused"}, make_line_tracer, goldens, tol,
        (BOUNCE, *SORTS), record, same_seed=True)
    _, unfused_launches, _ = run_path(
        {**label, "body": "unfused"},
        functools.partial(make_line_tracer,
                          rays_per_point=RAYS_PER_POINT // 4, fused=False),
        goldens, 2.0 * tol, (LINE, HIST, *SORTS),
        record)

    def against_line_run(pair_fields, pair_norm):
        per_line = 0.5 * (pair_norm[0::2] + pair_norm[1::2])
        apart = rel_l2(per_line, line_norm)
        hits_apart = abs(pair_fields["geometry_hits_per_ray"]
                         / fields["geometry_hits_per_ray"] - 1)
        bound = float(np.sqrt(2.0)) * tol
        return {
            "rel_l2_per_line_against_oracle": rel_l2(per_line, golden),
            "rel_l2_against_line_run": apart,
            "rel_l2_against_line_run_bound": bound,
            "hits_per_ray_apart": hits_apart,
        }, apart < bound and hits_apart <= 0.02

    # each triangle of a pair is held to its line's golden value, loosely:
    # the check that counts is the per-line one of ``against_line_run``
    run_path(
        {"geometry": "lines as triangle pairs (2D)", "body": "fused"},
        functools.partial(make_ribbon_tracer, fields["num_rays"]),
        {"rel_l2_oracle": np.repeat(golden, 2)}, 1.0,
        (BOUNCE, *SORTS), extra=against_line_run)
    return launches, unfused_launches


def phase_ion_paths(pts, nrm):
    """The ion configuration at full width: the flagship's 2,993 disks under
    a coned-cosine particle (sticking 0.5, cone angle pi/6, source power
    100), 2,000 rays per point through the default ``TraceDisk``: the bounce
    kernel's coned-cosine branch on every launch, deposits in the kernel (a
    launch hands out only for a diffuse particle), no other kernel. Then
    ``TraceDisk(fused=False)`` at 500 rays per point with twice the bound."""
    golden, record, tol = oracle_golden("ion3d_trench_oracle")
    goldens = {"rel_l2_oracle": golden}
    make = functools.partial(make_tracer, pts, nrm, particle=ion_particle())
    label = {"geometry": "disks", "particle": "ion"}
    _, launches, _ = run_path(
        {**label, "body": "fused"}, make, goldens, tol,
        (BOUNCE, *SORTS), record, same_seed=True)
    _, unfused_launches, _ = run_path(
        {**label, "body": "unfused"},
        functools.partial(make, rays_per_point=RAYS_PER_POINT // 4, fused=False),
        goldens, 2.0 * tol, (DISK, HIST, *SORTS),
        record)
    return launches, unfused_launches


def phase_gas_path(pts, nrm):
    """Gas scattering end to end at a tenth of the flagship's rays: the
    flagship's disks and diffuse particle with a mean free path of one
    trench depth, 200 rays per point. A tenth of the rays is 3.2 times the
    noise of a full run (0.016 measured on the flagship), beside the
    golden's own: the flux is held to twice the golden bound, the hits per
    ray to 2 % of the oracle's, and the scatter events per ray to 2 % of
    the oracle's."""
    golden, record, tol = oracle_golden("gas3d_trench_oracle")
    want = float(np.mean([c["scattered"] for c in record["counters"]])
                 / record["rays_per_seed"])

    def scatter_events(fields, _):
        got = fields["particle_hits"] / fields["num_rays"]
        return ({"particle_hits_per_ray": got,
                 "oracle_particle_hits_per_ray": want},
                fields["particle_hits"] > 0 and abs(got - want) <= 0.02 * want)

    _, launches, _ = run_path(
        {"geometry": "disks", "particle": "diffuse with gas scattering",
         "body": "fused"},
        functools.partial(make_tracer, pts, nrm,
                          rays_per_point=RAYS_PER_POINT // 10,
                          particle=gas_particle()),
        {"rel_l2_oracle": golden}, 2.0 * tol,
        (BOUNCE, HIST, *SORTS), record,
        extra=scatter_events)
    return launches


def phase_window_paths(pts, nrm, neighbor_norm):
    """The flagship under the window flux model at full width through the
    default ``TraceDisk``: the bounce kernel's window form on every launch
    (window deposits never hand out) and no other kernel; then the unfused
    body at 500 rays per point (kernels 1 and 2, twice the bound). Both
    against the JAX package's window golden. Beside it the fused window flux
    against ``neighbor_norm``, the fused neighbor run's flux of the same seed
    (the same rays, the same events): the two models part by what the JAX
    package's part by on its two seeds (``rel_l2_window_vs_neighbor_by_seed``
    of the golden's record), within a factor of two either way; a window run
    that fell back to neighbor deposits would part by 0."""
    golden, record, tol = oracle_golden("window3d_trench_jax")
    goldens = {"rel_l2_jax_window": golden}
    want = float(np.mean(record["rel_l2_window_vs_neighbor_by_seed"]))

    def against_neighbor(fields, norm):
        apart = rel_l2(norm, neighbor_norm)
        return ({"rel_l2_against_neighbor_run": apart,
                 "jax_rel_l2_window_vs_neighbor": want},
                0.5 * want < apart < 2.0 * want)

    make = functools.partial(make_tracer, pts, nrm, flux_model="window")
    label = {"geometry": "disks", "flux_model": "window"}
    _, launches, _ = run_path(
        {**label, "body": "fused"}, make, goldens, tol,
        (BOUNCE, *SORTS), record, same_seed=True,
        extra=against_neighbor)
    _, unfused_launches, _ = run_path(
        {**label, "body": "unfused"},
        functools.partial(make, rays_per_point=RAYS_PER_POINT // 4, fused=False),
        goldens, 2.0 * tol, (DISK, HIST, *SORTS),
        record)
    return launches, unfused_launches


def phase_wdist_path(pts, nrm):
    """1/distance weighting through the default ``TraceDisk`` (fused=True)
    at 500 rays per point: the reference's rule sends it to the unfused
    body, so kernels 1 and 2 run and the bounce kernel does not; against the
    oracle's ``wdist3d_trench_oracle`` with twice the bound."""
    golden, record, tol = oracle_golden("wdist3d_trench_oracle")
    _, launches, _ = run_path(
        {"geometry": "disks", "use_wdist": True, "body": "fused=True"},
        functools.partial(make_tracer, pts, nrm, use_wdist=True,
                          rays_per_point=RAYS_PER_POINT // 4),
        {"rel_l2_oracle": golden}, 2.0 * tol,
        (DISK, HIST, *SORTS), record,
        same_seed=True)
    return launches


def make_disk2d_tracer(fused=True, rays=DISK2D["rays"]):
    """The JAX package's ``disk2d_trench`` configuration
    (``benchmarks/make_goldens.py:config_disk2d_trench``) through
    ``TraceDisk(dim=2)``: ``create_trench_grid_2d`` at grid delta 0.1 (180
    disks), periodic walls, diffuse particle with sticking 0.1, source on the
    +y face, 200,000 rays (or ``rays``) in batches of 16,384, seed 12345."""
    import viennaray_tpu_torch as vrt
    from viennaray_tpu_torch.io import fixtures

    tracer = vrt.TraceDisk(dim=2, fused=fused)
    tracer.set_geometry(*fixtures.create_trench_grid_2d(
        grid_delta=DISK2D["grid_delta"]), DISK2D["grid_delta"])
    tracer.set_boundary_conditions([vrt.BoundaryCondition.PERIODIC] * 2)
    tracer.set_particle_type(vrt.DiffuseParticle(0.1, "flux"))
    tracer.set_source_direction(vrt.TraceDirection.POS_Y)
    tracer.set_number_of_rays_fixed(rays)
    tracer.set_rng_seed(DISK2D["seed"])
    tracer.set_ray_batch_size(DISK2D["batch"])
    return tracer


def phase_disk2d_paths():
    """The 2D disk trench end to end through ``TraceDisk(dim=2)``: fused at
    the configuration's full depth (every launch of its ladder, from 16,384
    rays down, runs the bounce kernel's group mapping), then unfused
    (kernels 1 and 2, bound by the host) at a quarter of the rays with twice
    the bound; each against the oracle's ``disk2d_trench_oracle`` and its
    hits per ray."""
    golden, record, tol = oracle_golden("disk2d_trench_oracle")
    goldens = {"rel_l2_oracle": golden}
    label = {"geometry": "disks (2D)"}
    _, launches, _ = run_path(
        {**label, "body": "fused"}, make_disk2d_tracer, goldens, tol,
        (BOUNCE, *SORTS), record, same_seed=True)
    _, unfused_launches, _ = run_path(
        {**label, "body": "unfused"},
        functools.partial(make_disk2d_tracer, fused=False,
                          rays=DISK2D["rays"] // 4),
        goldens, 2.0 * tol, (DISK, HIST, *SORTS),
        record)
    return launches, unfused_launches


def phase_source_paths(pts, nrm):
    """The flagship from the grid source (2,809 points) at 2,000 rays per
    point against ``bench_disk3d.npy`` (a uniform grid of origins has the
    random source's expectation up to a quadrature error far below the
    noise) and its hits per ray; then from the surface source (every disk
    along its normal) at 2,000 rays per point against the JAX package's
    ``surface3d_trench_jax``. Both fused: the bounce kernel, and the
    histogram kernel for the wide diffuse launches' deposits."""
    with open(os.path.join(GOLDEN_DIR, "bench_disk3d.json")) as f:
        bench = json.load(f)
    bench_record = {"geometry_hits_per_ray":
                    bench["geometry_hits"] / bench["num_rays"]}
    make = functools.partial(make_tracer, pts, nrm, source=grid_source)
    _, grid_launches, _ = run_path(
        {"geometry": "disks", "source": "grid", "body": "fused",
         "grid_points": make()._custom_source.num_points},
        make, {"rel_l2_golden": disk_goldens()["rel_l2_golden"]}, GOLDEN_TOL,
        (BOUNCE, HIST, *SORTS), bench_record,
        same_seed=True)
    golden, record, tol = oracle_golden("surface3d_trench_jax")
    _, surface_launches, _ = run_path(
        {"geometry": "disks", "source": "surface", "body": "fused"},
        functools.partial(make_tracer, pts, nrm, source=surface_source),
        {"rel_l2_jax_surface": golden}, tol,
        (BOUNCE, HIST, *SORTS), record, same_seed=True)
    return grid_launches, surface_launches


# ---- custom particles and multi-species runs -----------------------------------
HOOK_RAYS = 500  # rays per point of the hooked applies
HOOK_LABELS = ("ionFlux", "energyFlux")


@contextlib.contextmanager
def kernel_spans(kind):
    """CUDA events around every launch of a kernel wrapper while the block
    runs: the trace's own (the bounce kernel, the closest-hit search of the
    geometry ``kind``, the histogram, the resort's key and the state's
    permutation), the histogram the hooks call, and the histogram's
    backward. Yields the list of (start, end) event pairs."""
    from viennaray_tpu_torch.ops import histogram as H
    from viennaray_tpu_torch.trace import kernel as TK

    spans = []

    def timed(fn):
        def wrapper(*args, **kwargs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kwargs)
            b.record()
            spans.append((a, b))
            return out
        return wrapper

    real = (TK.fused_bounce, TK._SEARCH[kind], TK.flux_histogram,
            H.flux_histogram, H.flux_histogram_grad, TK.coherence_key,
            TK.permute_state)

    def install(bounce, search, trace_hist, hist, hist_grad, key, permute):
        TK.fused_bounce, TK._SEARCH[kind] = bounce, search
        TK.flux_histogram, H.flux_histogram = trace_hist, hist
        H.flux_histogram_grad = hist_grad
        TK.coherence_key, TK.permute_state = key, permute

    hist = timed(real[3])
    install(timed(real[0]), timed(real[1]), hist, hist, timed(real[4]),
            timed(real[5]), timed(real[6]))
    try:
        yield spans
    finally:
        install(*real)


def span_apply(tracer):
    """One apply with the registry's counts read just before and just
    after, inside ``kernel_spans``. Returns (flux, fields, launches);
    ``share_outside_kernels`` is 1 minus the events' spans over the apply's
    wall time."""
    before = dict(telemetry.COUNTS)
    with kernel_spans(tracer.geometry.kind) as spans:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flux = tracer.apply()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = launches_since(before)
    info = tracer.get_ray_trace_info()
    in_kernels = sum(a.elapsed_time(b) for a, b in spans) / 1e3
    fields = {
        "num_rays": info.num_rays, "seconds": seconds,
        "rays_per_s": info.num_rays / seconds,
        "seconds_in_kernels": in_kernels,
        "share_outside_kernels": 1.0 - in_kernels / seconds,
        **{k: getattr(info, k) for k in INFO_COUNTERS[1:]},
        "launches": launches,
    }
    return flux, fields, launches


def same_counters(a, b):
    return all(getattr(a, k) == getattr(b, k) for k in INFO_COUNTERS)


def builtin_hooks(particle, dim, device):
    """A collision_fn and a reflection_fn that do what the built-in deposit
    and diffuse reflection do (sticking by material where the particle has a
    table), and a two-channel variant of the collision_fn whose channel 0
    is the built-in deposit and channel 1 half of it."""
    from viennaray_tpu_torch.ops import histogram as H
    from viennaray_tpu_torch.physics import reflection

    table = torch.tensor(particle.material_sticking or [particle.sticking],
                         dtype=torch.float32, device=device)

    def deposit(flux, ids, w):
        return flux + H.flux_histogram(ids.reshape(-1), w.reshape(-1),
                                       flux.shape[-1])

    def collision_fn(flux, ids, w, dirn, normal, mat, rng):
        return deposit(flux, ids, w)

    def two_channels(flux, ids, w, dirn, normal, mat, rng):
        return torch.stack([deposit(flux[0], ids, w),
                            deposit(flux[1], ids, 0.5 * w)])

    def reflection_fn(rng, dirn, normal, prim, mat, weight):
        sticking = table[torch.clamp(mat, 0, len(table) - 1).long()]
        return sticking, reflection.diffuse(*rng.reflect_uniforms, normal, dim)

    return collision_fn, two_channels, reflection_fn


def phase_hook_paths(pts, nrm, verts, tris):
    """Custom particles at full width, each hooked apply beside the built-in
    apply of the same rays (timed alike, ``span_apply``), each printed as
    one ``hook_path`` object; a failed check raises. Returns the launches of
    each hooked path by name."""
    import viennaray_tpu_torch as vrt
    from viennaray_tpu_torch.examples import (
        multi_channel, multi_species, stateful_ion,
    )

    out = {}

    timing = ("seconds", "rays_per_s", "share_outside_kernels")

    def report(name, fields, builtin, checks, launches, kernels, rerun=None):
        """Print one path, raise if a check failed. ``rerun`` = (built-in
        tracer, hooked tracer): after the checks each runs a second apply,
        hooked first, so that the call times built-in, hooked, hooked,
        built-in and the first apply's warm-up shows on both sides."""
        checks = {**checks, "launched_" + "_and_".join(kernels):
                  only_launched(launches, *kernels)}
        if rerun is not None:
            second = span_apply(rerun[1])[1]
            fields["second_apply"] = {k: second[k] for k in timing}
            second = span_apply(rerun[0])[1]
            builtin["second_apply"] = {k: second[k] for k in timing}
        res = {"phase": "hook_path", "path": name, **fields,
               "builtin": builtin, "checks": checks}
        emit(res)
        if not all(checks.values()):
            raise RuntimeError(f"hook path {name} failed its checks: {res}")
        out[name] = launches

    def builtin_fields(fields):
        return {k: fields[k] for k in timing + ("launches",)}

    # 1. two labelled channels on the disk flagship (the JAX package's
    # examples/multi_channel.py): kernels 1 and 2, never the bounce kernel
    golden, record, tol = oracle_golden("multichannel3d_trench_jax")
    plain = multi_channel.make_tracer(HOOK_RAYS, fused=False)
    plain.set_custom_functions()
    plain.set_particle_type(vrt.SpecularParticle(0.4, 100.0))
    want, plain_fields, _ = span_apply(plain)
    tracer = multi_channel.make_tracer(HOOK_RAYS)
    flux, fields, launches = span_apply(tracer)
    norm = np.stack([tracer.normalize_flux(f) for f in flux])
    errors = [rel_l2(norm[c], golden[c]) for c in range(2)]
    ratio = float(flux[1].sum() / flux[0].sum())
    fields.update(rel_l2_jax_by_channel=errors, rel_l2_bound=tol,
                  energy_ratio=ratio, jax_energy_ratio=record["energy_ratio"])
    report("multi_channel_disks", fields, builtin_fields(plain_fields), {
        "shape": flux.shape == (2, len(pts)),
        "ion_channel_bitwise_equal_builtin": bool(np.array_equal(flux[0],
                                                                 want)),
        "counters_equal_builtin": same_counters(
            tracer.get_ray_trace_info(), plain.get_ray_trace_info()),
        "rel_l2_both_channels": all(e < tol for e in errors),
        "energy_ratio_within_2_percent":
            abs(ratio / record["energy_ratio"] - 1.0) <= 0.02,
    }, launches, (DISK, HIST, *SORTS),
        rerun=(plain, tracer))

    # 2. hooks that reimplement the built-in deposit and diffuse reflection
    # on the disk flagship: the built-in unfused apply's bits
    plain = make_tracer(pts, nrm, HOOK_RAYS, fused=False)
    want, plain_fields, _ = span_apply(plain)
    tracer = make_tracer(pts, nrm, HOOK_RAYS)  # fused asked, unfused run
    collide, _, reflect = builtin_hooks(tracer._particle, 3,
                                        tracer.geometry.device)
    tracer.set_custom_functions(collision_fn=collide, reflection_fn=reflect)
    flux, fields, launches = span_apply(tracer)
    report("builtin_reimplemented_disks", fields, builtin_fields(plain_fields), {
        "flux_bitwise_equal_builtin": bool(np.array_equal(flux, want)),
        "counters_equal_builtin": same_counters(
            tracer.get_ray_trace_info(), plain.get_ray_trace_info()),
    }, launches, (DISK, HIST, *SORTS),
        rerun=(plain, tracer))

    # 3. the energy-carrying ion (aux through the sort and the compactions)
    golden, record, tol = oracle_golden("stateful3d_trench_jax")
    plain = stateful_ion.make_tracer(HOOK_RAYS, fused=False)
    plain.set_custom_functions()
    plain.set_data_log_fn(None)
    _, plain_fields, _ = span_apply(plain)
    tracer = stateful_ion.make_tracer(HOOK_RAYS)
    flux, fields, launches = span_apply(tracer)
    info = tracer.get_ray_trace_info()
    error = rel_l2(tracer.normalize_flux(flux), golden)
    per_hit = float(flux.sum() / info.geometry_hits)
    logged = float(tracer.get_data_log().data[0].sum())
    fields.update(rel_l2_jax=error, rel_l2_bound=tol, deposit_per_hit=per_hit,
                  jax_deposit_per_hit=record["deposit_per_hit"],
                  logged_rays=logged)
    report("stateful_ion_disks", fields, builtin_fields(plain_fields), {
        "finite": bool(np.isfinite(flux).all() and flux.max() > 0),
        "rel_l2": error < tol,
        "deposit_per_hit_within_2_percent":
            abs(per_hit / record["deposit_per_hit"] - 1.0) <= 0.02,
        "log_counts_every_ray": logged == info.num_rays,
    }, launches, (DISK, HIST, *SORTS),
        rerun=(plain, tracer))

    # 4. triangles and lines: the two-channel collision_fn with the
    # reimplemented reflection; channel 0 is the built-in apply's bits
    for name, make, rays, search, dim in (
        ("triangles", functools.partial(make_tri_tracer, verts, tris),
         RAYS_PER_POINT // 8, TRI, 3),
        ("lines", make_line_tracer, HOOK_RAYS, LINE, 2),
    ):
        plain = make(rays_per_point=rays, fused=False)
        want, plain_fields, _ = span_apply(plain)
        tracer = make(rays_per_point=rays)
        particle = tracer._particle.replace(data_labels=HOOK_LABELS)
        tracer.set_particle_type(particle)
        _, two, reflect = builtin_hooks(particle, dim, tracer.geometry.device)
        tracer.set_custom_functions(collision_fn=two, reflection_fn=reflect)
        flux, fields, launches = span_apply(tracer)
        report(f"two_channels_builtin_reimplemented_{name}", fields,
               builtin_fields(plain_fields), {
                   "channel_0_bitwise_equal_builtin":
                       bool(np.array_equal(flux[0], want)),
                   "channel_1_half_of_channel_0":
                       bool(np.array_equal(flux[1], 0.5 * flux[0])),
                   "counters_equal_builtin": same_counters(
                       tracer.get_ray_trace_info(),
                       plain.get_ray_trace_info()),
               }, launches, (search, HIST, *SORTS),
               rerun=(plain, tracer))

    # 5. an all-zero init_dir_fn and a log_fn on the fused body (the
    # reference's tests/test_round2_features.py:85-119): the bounce kernel
    plain = make_tracer(pts, nrm, RAYS_PER_POINT)
    want, plain_fields, _ = span_apply(plain)
    tracer = make_tracer(pts, nrm, RAYS_PER_POINT)
    tracer.set_custom_functions(
        init_dir_fn=lambda rng, idx: torch.zeros((idx.shape[0], 3),
                                                 device=idx.device))
    tracer.set_data_log_fn(lambda rng, aux, idx, valid: [
        torch.bincount((rng.uniform(idx.shape[0]) * 8).long()[valid],
                       minlength=8)])
    flux, fields, launches = span_apply(tracer)
    first_log = float(tracer.get_data_log().data[0].sum())
    tracer.apply()
    second_log = float(tracer.get_data_log().data[0].sum())
    fields.update(logged_rays=[first_log, second_log])
    report("init_dir_and_log_fused_disks", fields, builtin_fields(plain_fields), {
        "flux_bitwise_equal_builtin": bool(np.array_equal(flux, want)),
        "log_counts_every_ray": first_log == fields["num_rays"],
        "log_adds_up": second_log == 2 * fields["num_rays"],
    }, launches, (BOUNCE, HIST, *SORTS),
        rerun=(plain, tracer))

    # 6. two species through apply_particles (the JAX package's
    # examples/multi_species.py), each against its own apply on a fresh
    # tracer at the same run number
    tracer = multi_species.make_tracer(HOOK_RAYS)
    before = dict(telemetry.COUNTS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flux, infos = vrt.apply_particles(tracer, multi_species.species())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launches_since(before)
    alone, alone_seconds = [], []
    for k, particle in enumerate(multi_species.species()):
        fresh = multi_species.make_tracer(HOOK_RAYS, seed=3 + k)
        fresh.set_particle_type(particle)
        f, alone_fields, _ = span_apply(fresh)
        alone.append(f)
        alone_seconds.append(alone_fields["seconds"])
    data = tracer.get_local_data()
    labels = [data.get_vector_data_label(i) for i in range(data.num_vector_data)]
    num_rays = sum(i.num_rays for i in infos)
    report("multi_species_disks", {
        "num_rays": num_rays, "seconds": seconds,
        "rays_per_s": num_rays / seconds,
        "seconds_by_species": [i.time for i in infos],
        "geometry_hits_by_species": [i.geometry_hits for i in infos],
        "launches": launches, "channels": labels,
    }, {"seconds_by_species_alone": alone_seconds}, {
        "species_bitwise_equal_own_apply": all(
            np.array_equal(flux[k], alone[k]) for k in range(2)),
        "channels": labels == ["ionFlux", "neutralFlux"],
        "finite": bool(np.isfinite(flux).all() and (flux.max(axis=1) > 0).all()),
    }, launches, (BOUNCE, HIST, *SORTS))
    return out


# BASELINE config 5 (benchmarks/grad_bench.py:33-75): d sum(flux) / d
# sticking of 10^7 rays on the flagship's 2,993 disks, 8 bounces, mega-batches
# of 2^19, seed 13; the points, normals and triangle runs at 2^21 rays
GRAD = dict(rays=10_000_000, batch=1 << 19, bounces=8, seed=13, sticking=0.1)
GRAD_SIDE_RAYS = 1 << 21
FD_EPS = 3e-3
FD_RTOL = 5e-3  # tests/test_diff.py:78
# d sum(flux) / d sticking per ray against the golden: 1.45 times the
# golden's two seeds' relative difference, at least this. One difference of
# two draws can land near 0; a gradient that drops a bounce's term or keeps
# the roulette's renewal moves by whole percents
GRAD_TOL_FLOOR = 0.005


def check_histogram_grad(geometry, n_rays, reps, dtype=torch.float32):
    """The histogram's backward (``vr_flux_histogram_grad``, or its float64
    form for ``dtype`` float64) on one bounce's worth of deposit ids (a
    ray's hit disk and its K neighbours) against its plain version,
    ``index_select``: a gather, so bit for bit. Times the kernel, the plain
    version and one ``index_select`` call on int64 ids."""
    from viennaray_tpu_torch.ops import histogram as H

    f64 = dtype == torch.float64
    n_bins = geometry.num_primitives
    ids, _ = make_deposits(geometry, n_rays, n_bins, seed=12)
    gen = torch.Generator(device=geometry.device)
    gen.manual_seed(13)
    grad_out = torch.randn(n_bins, generator=gen, device=geometry.device,
                           dtype=dtype)
    out_1 = H.flux_histogram_grad(grad_out, ids)
    out_2 = H.flux_histogram_grad(grad_out, ids)
    ref = H.flux_histogram_grad_ref(grad_out, ids)
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(out_1, ref) and torch.equal(out_1, out_2))
    ms = time_cuda(lambda: H.flux_histogram_grad(grad_out, ids), reps)
    plain_ms = time_cuda(lambda: H.flux_histogram_grad_ref(grad_out, ids), reps)
    ids64 = ids.long()
    library_ms = time_cuda(lambda: grad_out.index_select(0, ids64), reps)
    # ids read and the gradient written once, the bins read once; no
    # arithmetic
    word = 8 if f64 else 4
    byte_ms = (ids.numel() * (4 + word) + n_bins * word) / HBM_BYTES_PER_S * 1e3
    res = {
        "phase": "kernel_check",
        "kernel": "flux_histogram_grad" + ("_f64" if f64 else ""),
        "shape": f"E={ids.numel()}, n={n_bins}",
        "tolerance": "bit for bit against index_select (a gather)",
        "max_abs_err": float((out_1 - ref).abs().max()),
        "bitwise_equal": bitwise, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": byte_ms, "bound_by": "bytes", "library_ms": library_ms,
    }
    emit(res)
    if not bitwise:
        raise RuntimeError(f"flux_histogram_grad fails its check: {res}")
    return res


def grad_problem(geometry, **config_changes):
    """BASELINE config 5's physics on ``geometry``: the random source on the
    +z face with the cosine lobe, ``DiffuseParticle(0.1)``, periodic walls,
    roulette off, mega-batches of 2^19. Returns (source, particle, bbox,
    config)."""
    import viennaray_tpu_torch as vrt
    from viennaray_tpu_torch.config import get_trace_settings

    bbox = adjusted_bbox(geometry)
    config = vrt.TraceConfig(
        dim=3, source_direction=vrt.TraceDirection.POS_Z,
        boundary_conditions=(vrt.BoundaryCondition.PERIODIC,) * 3,
        ray_batch_size=GRAD["batch"], rng_seed=GRAD["seed"],
        use_random_seed=False, roulette=False, **config_changes)
    s = get_trace_settings(config.source_direction)
    source = vrt.RandomSource(
        bbox=bbox, cosine_power=1.0, ray_dir=s[0], first_dir=s[1],
        second_dir=s[2], min_max=s[3], pos_neg=float(s[4]), dim=3,
        num_points=geometry.num_primitives)
    return (source, vrt.DiffuseParticle(GRAD["sticking"], "flux"), bbox,
            config)


def grad_rng(geometry):
    from viennaray_tpu_torch.rng import GeneratorRNG

    return GeneratorRNG(GRAD["seed"], geometry.device)


def grad_sticking(geometry, problem, rays):
    """``flux_and_grad_sticking_batched`` at seed 13: (flux (N,) float64,
    d sum(flux) / d sticking)."""
    from viennaray_tpu_torch import diff

    source, particle, bbox, config = problem
    return diff.flux_and_grad_sticking_batched(
        geometry, source, particle, bbox, grad_rng(geometry), rays, config,
        num_bounces=GRAD["bounces"])


def grad_geometry(geometry, problem, rays, field):
    """``flux_and_grad_points_batched`` or ``..._normals_batched``."""
    from viennaray_tpu_torch import diff

    source, particle, bbox, config = problem
    batched = getattr(diff, f"flux_and_grad_{field}_batched")
    return batched(geometry, source, particle, bbox, grad_rng(geometry), rays,
                   config, num_bounces=GRAD["bounces"])


def flux_total(geometry, problem, rays, sticking):
    """sum(flux) of the same rays and batches as ``grad_sticking`` at another
    sticking, forward only (``trace_flux`` without a graph), summed in
    float64."""
    from viennaray_tpu_torch import diff

    source, particle, bbox, config = problem
    particle = particle.replace(sticking=sticking)
    rng = grad_rng(geometry)
    batch = config.ray_batch_size
    total = 0.0
    with torch.no_grad():
        for b in range(-(-rays // batch)):
            idx = torch.arange(b * batch, (b + 1) * batch,
                               device=geometry.device)
            flux = diff.trace_flux(
                geometry, source, particle, bbox, rng, idx, idx < rays,
                config, num_bounces=GRAD["bounces"], batch_index=b)
            total += float(flux.double().sum())
    return total


def finite_difference(geometry, problem, rays, grad):
    """Central differences of sum(flux) at sticking 0.1 +- 3e-3 on the same
    rays against ``grad`` (rtol 5e-3, tests/test_diff.py:78)."""
    plus = flux_total(geometry, problem, rays, GRAD["sticking"] + FD_EPS)
    minus = flux_total(geometry, problem, rays, GRAD["sticking"] - FD_EPS)
    fd = (plus - minus) / (2 * FD_EPS)
    rel = abs(grad - fd) / abs(fd)
    return {"fd_d_flux_d_sticking": fd, "fd_rel_err": rel,
            "fd_rtol": FD_RTOL}, bool(rel <= FD_RTOL)


@contextlib.contextmanager
def plain_versions(kind):
    """The trace's closest-hit search and histogram replaced by their plain
    versions (``*_nearest_hit_ref``, ``flux_histogram_ref``, whose backward
    is then ``index_add_``'s own gather) while the block runs."""
    from viennaray_tpu_torch.ops import histogram as H
    from viennaray_tpu_torch.ops import nearest_hit as NH
    from viennaray_tpu_torch.trace import kernel as TK

    saved = TK._SEARCH[kind], TK.flux_histogram
    TK._SEARCH[kind] = getattr(NH, f"{kind}_nearest_hit_ref")
    TK.flux_histogram = H.flux_histogram_ref
    try:
        yield
    finally:
        TK._SEARCH[kind], TK.flux_histogram = saved


def against_plain(geometry, run):
    """``run()`` -> (flux, gradient) through the kernels and through their
    plain versions on the card: bit for bit?"""
    flux, grad = run()
    with plain_versions(geometry.kind):
        plain_flux, plain_grad = run()
    return bool(np.array_equal(flux, plain_flux)
                and np.array_equal(grad, plain_grad))


def timed_grad(geometry, run):
    """``run()`` with the registry's counts read just before and just
    after, inside ``kernel_spans``, on a fresh peak of device memory.
    Returns (result, fields, launches)."""
    before = dict(telemetry.COUNTS)
    torch.cuda.reset_peak_memory_stats()
    with kernel_spans(geometry.kind) as spans:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = launches_since(before)
    in_kernels = sum(a.elapsed_time(b) for a, b in spans) / 1e3
    return out, {
        "seconds": seconds, "seconds_in_kernels": in_kernels,
        "share_outside_kernels": 1.0 - in_kernels / seconds,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches,
    }, launches


def phase_grad_paths(pts, nrm, verts, tris):
    """The differentiable trace and its drivers (``viennaray_tpu_torch.diff``)
    on kernels 1, 2 and 3 and the histogram's backward, each run printed as
    one ``grad_path`` object; a failed check raises. (a) BASELINE config 5
    at full width: d sum(flux) / d sticking of 10^7 rays, timed, with its
    launches (8 a batch of kernels 1 and 2 forward, 7 of the backward, no
    other kernel); (e) a second run of the same seed, bit for bit; (b) flux
    and d / d sticking per ray against ``grad3d_trench_jax``; (c) central
    differences on the same rays; (d) one batch through the kernels and
    through their plain versions: flux, d / d sticking and, under
    1/distance weighting, d / d points bit for bit; (f) d / d points and
    d / d normals at 2^21 rays under 1/distance weighting, finite and not
    all zero; (g) the 5,760 triangles at 2^21 rays: d / d sticking against
    central differences and one batch bit for bit against the plain
    versions. Returns the launches of each timed run by name."""
    from viennaray_tpu_torch.geometry.disk_geometry import DiskGeometry
    from viennaray_tpu_torch.geometry.triangle_geometry import TriangleGeometry

    geometry = DiskGeometry.build(pts, nrm, FLAGSHIP["grid_delta"])
    problem = grad_problem(geometry)
    rays = GRAD["rays"]
    n_batches = -(-rays // GRAD["batch"])
    out = {}

    # (a) and (e): the warm-up run, then the timed run of the same seed
    first = grad_sticking(geometry, problem, rays)
    (flux, grad), fields, launches = timed_grad(
        geometry, lambda: grad_sticking(geometry, problem, rays))
    out["grad"] = launches
    same_seed = bool(np.array_equal(first[0], flux) and first[1] == grad)
    want = GRAD["bounces"] * n_batches
    # the first bounce deposits the source's weights, which do not depend on
    # the sticking: its histogram has no backward
    want_backward = (GRAD["bounces"] - 1) * n_batches
    launches_ok = (
        launches[DISK] == want
        and launches[HIST] == want
        and launches[HIST_GRAD] == want_backward
        and only_launched(launches, DISK, HIST, HIST_GRAD))
    # (b) per ray against the JAX package's golden
    golden, record, tol = oracle_golden("grad3d_trench_jax")
    per_ray = flux / rays
    flux_err = rel_l2(per_ray, golden)
    grad_per_ray = grad / rays
    grad_err = abs(grad_per_ray - record["grad_per_ray"]) / abs(
        record["grad_per_ray"])
    grad_tol = max(1.45 * record["grad_rel_diff_between_seeds"],
                   GRAD_TOL_FLOOR)
    with open(os.path.join(ROOT, "benchmarks", "grad_bench.json")) as f:
        tpu = json.load(f)
    # (c) central differences on the same rays and batches
    fd_fields, fd_ok = finite_difference(geometry, problem, rays, grad)
    res = {
        "phase": "grad_path", "config": "grad_1e7 (BASELINE config 5)",
        "disks": geometry.num_primitives, "num_rays": rays,
        "batch": GRAD["batch"], "bounces": GRAD["bounces"],
        "seed": GRAD["seed"], **fields,
        "rays_per_s_fwd_bwd": rays / fields["seconds"],
        "flux_sum": float(flux.sum()), "d_flux_d_sticking": grad,
        "finite": bool(np.isfinite(flux).all() and np.isfinite(grad)),
        "same_seed_bitwise_equal": same_seed,
        "expected_launches": want, "expected_backward_launches":
        want_backward, "launches_ok": launches_ok,
        "rel_l2_golden": flux_err, "rel_l2_bound": tol,
        "d_flux_d_sticking_per_ray": grad_per_ray,
        "golden_d_flux_d_sticking_per_ray": record["grad_per_ray"],
        "d_flux_d_sticking_rel_err": grad_err,
        "d_flux_d_sticking_bound": grad_tol,
        # a cross-check only: another RNG, another code, taken on a TPU v5e
        "tpu_v5e_grad_bench_json": {k: tpu[k] for k in (
            "d_flux_d_sticking", "flux_sum", "total_rays", "num_bounces")},
        **fd_fields,
    }
    emit(res)
    if not (res["finite"] and same_seed and launches_ok and flux_err < tol
            and grad_err <= grad_tol and fd_ok):
        raise RuntimeError(f"grad path failed its checks: {res}")

    # (d) one batch: the kernels against their plain versions
    batch = GRAD["batch"]
    wdist = grad_problem(geometry, use_wdist=True)
    sticking_equal = against_plain(
        geometry, lambda: grad_sticking(geometry, problem, batch))
    points_equal = against_plain(
        geometry, lambda: grad_geometry(geometry, wdist, batch, "points"))
    res = {"phase": "grad_path", "check": "kernels against plain versions",
           "num_rays": batch, "d_sticking_bitwise_equal": sticking_equal,
           "d_points_wdist_bitwise_equal": points_equal}
    emit(res)
    if not (sticking_equal and points_equal):
        raise RuntimeError(f"grad path failed its checks: {res}")

    # (f) geometry gradients under 1/distance weighting
    for field in ("points", "normals"):
        (flux_f, grad_f), fields, launches = timed_grad(
            geometry,
            lambda field=field: grad_geometry(geometry, wdist,
                                              GRAD_SIDE_RAYS, field))
        out[f"grad_{field}"] = launches
        res = {"phase": "grad_path", "field": field, "use_wdist": True,
               "num_rays": GRAD_SIDE_RAYS, **fields,
               "finite": bool(np.isfinite(flux_f).all()
                              and np.isfinite(grad_f).all()),
               "grad_abs_max": float(np.abs(grad_f).max()),
               "grad_nonzero_rows": int((np.abs(grad_f).sum(1) > 0).sum())}
        emit(res)
        if not (res["finite"] and res["grad_abs_max"] > 0
                and only_launched(launches, DISK, HIST, HIST_GRAD)):
            raise RuntimeError(f"grad path failed its checks: {res}")

    # (g) triangles (kernel 3)
    mesh = TriangleGeometry.build(verts, tris, FLAGSHIP["grid_delta"])
    tri_problem = grad_problem(mesh)
    (flux_t, grad_t), fields, launches = timed_grad(
        mesh, lambda: grad_sticking(mesh, tri_problem, GRAD_SIDE_RAYS))
    out["grad_triangles"] = launches
    fd_fields, fd_ok = finite_difference(mesh, tri_problem, GRAD_SIDE_RAYS,
                                         grad_t)
    tri_equal = against_plain(
        mesh, lambda: grad_sticking(mesh, tri_problem, GRAD["batch"]))
    res = {"phase": "grad_path", "triangles": mesh.num_primitives,
           "num_rays": GRAD_SIDE_RAYS, **fields,
           "d_flux_d_sticking": grad_t, "flux_sum": float(flux_t.sum()),
           "finite": bool(np.isfinite(flux_t).all() and np.isfinite(grad_t)),
           **fd_fields, "one_batch_bitwise_equal_plain": tri_equal}
    emit(res)
    if not (res["finite"] and fd_ok and tri_equal
            and only_launched(launches, TRI, HIST, HIST_GRAD)):
        raise RuntimeError(f"grad path failed its checks: {res}")
    return out


# ---- the compiled host geometry build -------------------------------------
HOST_BUILD_DELTAS = (0.25, 0.1)  # the flagship's 2,993 disks and 18,180


@contextlib.contextmanager
def neighborhood_path(mode):
    """``geometry.neighborhood.build_neighborhood`` held to one path while
    the block runs (every caller reads it through the module): "numpy" the
    numpy path and "helper" the compiled host helper, both on the points
    copied to the host (a CUDA build hands its points on the card), their
    tables copied back where the points were; "card" the default, which
    builds on the card for CUDA points."""
    from viennaray_tpu_torch.geometry import neighborhood

    saved = neighborhood.build_neighborhood
    host_fn = {"numpy": neighborhood.build_neighborhood_numpy,
               "helper": saved, "card": None}[mode]

    def on_host(points, distance, dim=3):
        on_card = isinstance(points, torch.Tensor)
        got = host_fn(points.cpu().numpy() if on_card else points, distance,
                      dim)
        return (tuple(torch.from_numpy(t).to(points.device) for t in got)
                if on_card else got)

    if host_fn is not None:
        neighborhood.build_neighborhood = on_host
    try:
        yield
    finally:
        neighborhood.build_neighborhood = saved


def phase_host_build():
    """The geometry build's neighbor tables by the compiled host helper
    (``native/host_accel.cpp``; it must load on this machine), by the numpy
    path and by the card (``csrc/neighborhood.cu``, the default on CUDA).
    At 2,993 and 18,180 disks, ``DiskGeometry.build`` and
    ``with_window_list`` by each path, in turns (numpy, helper, card, card,
    helper, numpy), their seconds printed, and every table (neighbors,
    neighbor records, window ids and records) equal; beside them the
    neighborhood alone (``build_neighborhood`` at the disk diameter, the
    card's ending in a synchronise)."""
    from viennaray_tpu_torch.config import disk_factor
    from viennaray_tpu_torch.geometry import neighborhood
    from viennaray_tpu_torch.geometry.disk_geometry import DiskGeometry
    from viennaray_tpu_torch.io import fixtures
    from viennaray_tpu_torch.utils import native

    t0 = time.perf_counter()
    lib = native.load()
    load_seconds = time.perf_counter() - t0
    if lib is None:
        raise RuntimeError("the compiled host helper did not load")
    modes = ("numpy", "helper", "card", "card", "helper", "numpy")
    for delta in HOST_BUILD_DELTAS:
        pts, nrm = fixtures.create_trench_grid_3d(**dict(FLAGSHIP,
                                                          grid_delta=delta))
        pts_card = torch.from_numpy(pts).cuda()

        def build():
            t0 = time.perf_counter()
            geometry = DiskGeometry.build(pts, nrm, delta)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            windowed = geometry.with_window_list()
            torch.cuda.synchronize()
            return windowed, t1 - t0, time.perf_counter() - t1

        # the neighborhood alone (the disk table's: pairs within the disk
        # diameter)
        radius = 2.0 * delta * disk_factor(3)
        nbr_seconds = {m: [] for m in modes}
        nbr_tables = {}
        for mode in modes:
            t0 = time.perf_counter()
            if mode == "numpy":
                got = neighborhood.build_neighborhood_numpy(pts, radius, 3)
            elif mode == "helper":
                got = neighborhood.build_neighborhood(pts, radius, 3)
            else:
                got = neighborhood.build_neighborhood(pts_card, radius, 3)
                torch.cuda.synchronize()
                got = tuple(t.cpu().numpy() for t in got)
            nbr_seconds[mode].append(time.perf_counter() - t0)
            nbr_tables[mode] = got
        nbr_equal = all(np.array_equal(a, b) for m in ("helper", "card")
                        for a, b in zip(nbr_tables["numpy"], nbr_tables[m]))
        runs = {m: [] for m in modes}
        tables = {}
        for mode in modes:
            with neighborhood_path(mode):
                geometry, build_s, window_s = build()
            runs[mode].append((build_s, window_s))
            tables[mode] = geometry
        equal = all(torch.equal(getattr(tables[m], f), getattr(
            tables["numpy"], f)) for m in ("helper", "card") for f in (
            "neighbors", "neighbor_pack", "window_ids", "window_pack"))
        best = {m: (min(r[0] for r in v), min(r[1] for r in v))
                for m, v in runs.items()}
        a = tables["card"]
        res = {
            "phase": "host_build", "disks": a.num_primitives,
            "neighborhood_seconds": nbr_seconds,
            "neighborhood_speedup_helper": min(nbr_seconds["numpy"])
            / min(nbr_seconds["helper"]),
            "neighborhood_speedup_card": min(nbr_seconds["helper"])
            / min(nbr_seconds["card"]),
            "neighbors_k": a.neighbors.shape[1],
            "window_w": a.window_ids.shape[1],
            "build_seconds": {m: [r[0] for r in v] for m, v in runs.items()},
            "window_list_seconds": {m: [r[1] for r in v]
                                    for m, v in runs.items()},
            "build_speedup_card": best["helper"][0] / best["card"][0],
            "window_list_speedup": best["numpy"][1] / best["helper"][1],
            "tables_equal": equal and nbr_equal,
            "helper_load_seconds": load_seconds,
            "helper_gxx_seconds": native.build_seconds,
        }
        emit(res)
        if not (equal and nbr_equal):
            raise RuntimeError(f"the neighbor tables differ: {res}")


def neighborhood_pair_tests(pts, distance, dim):
    """The pair tests one pass of ``vr_neighborhood_rows`` makes, from its
    inputs: for every point, the members of each cell at a deduplicated
    offset from its own (inside the grid), itself left out."""
    import itertools

    p = np.asarray(pts, np.float64)[:, :dim]
    cx = np.floor((p - p.min(0)) * (1.0 / distance)).astype(np.int64)
    span = cx.max(0) + 1
    strides = np.ones(dim, np.int64)
    for d in range(dim - 2, -1, -1):
        strides[d] = strides[d + 1] * span[d + 1]
    ids = cx @ strides
    cells, members = np.unique(ids, return_counts=True)
    offsets = np.unique(np.array(list(itertools.product((-1, 0, 1),
                                                        repeat=dim))) @ strides)
    tests = -len(p)
    for off in offsets:
        cj = ids + off
        at = np.minimum(np.searchsorted(cells, cj), len(cells) - 1)
        found = (cj >= 0) & (cj < int(np.prod(span))) & (cells[at] == cj)
        tests += int(members[at][found].sum())
    return tests


def phase_neighborhood():
    """The neighbor table on the card at the 704,250-disk trench (the
    benchmark's disk1m cloud): ``DiskGeometry.build`` on CUDA, its launches
    read from the registry just before and just after (four: the cells, the
    ids, the rows counted and filled), its table held to the host helper's
    bit for bit; ``build_neighborhood_cuda`` alone timed by CUDA events (its
    one read included) beside the helper on the host clock; the bound from
    the run's inputs: its bytes (points read, table and counts written) and
    its float64 operations (two passes of pair tests, each at least the
    first axis's difference: the tests end early, so no more is certain)."""
    from viennaray_tpu_torch.config import disk_factor
    from viennaray_tpu_torch.geometry import neighborhood
    from viennaray_tpu_torch.geometry.disk_geometry import DiskGeometry
    from viennaray_tpu_torch.io import fixtures

    pts, nrm = fixtures.create_trench_grid_3d(**DISK1M)
    distance = 2.0 * DISK1M["grid_delta"] * disk_factor(3)
    before = dict(telemetry.COUNTS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    geometry = DiskGeometry.build(pts, nrm, DISK1M["grid_delta"])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    launches = launches_since(before)
    card = geometry.neighbors.cpu().numpy()
    del geometry
    helper_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        want, counts = neighborhood.build_neighborhood(pts, distance, 3)
        helper_s.append(time.perf_counter() - t0)
    equal = card.shape == want.shape and np.array_equal(card, want)
    points = torch.from_numpy(pts).cuda()
    got = neighborhood.build_neighborhood_cuda(points, distance, 3)
    equal = equal and all(np.array_equal(a.cpu().numpy(), b)
                          for a, b in zip(got, (want, counts)))
    ms = time_cuda(lambda: neighborhood.build_neighborhood_cuda(
        points, distance, 3), 20)
    n, k = want.shape
    tests = neighborhood_pair_tests(pts, distance, 3)
    op_ms = 2 * tests / F64_FLOPS * 1e3
    n_bytes = pts.nbytes + n * k * 4 + n * 4
    byte_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    res = {
        "phase": "kernel_check", "kernel": "neighborhood",
        "shape": f"N={n}, K={k}, distance={distance}, the disk1m trench",
        "tolerance": "table and counts equal the host helper's bit for bit",
        "bitwise_equal": bool(equal), "max_abs_err": 0.0 if equal else None,
        "launches": launches, "build_s": build_s,
        "pair_tests_a_pass": tests, "bytes": n_bytes,
        "ms": ms, "plain_ms": min(helper_s) * 1e3,
        "bound_ms": max(op_ms, byte_ms),
        "bound_by": "operations" if op_ms > byte_ms else "bytes",
        "ops_bound_ms": op_ms, "bytes_bound_ms": byte_ms,
        "library_ms": None,
    }
    emit(res)
    if not equal or (launches["build_neighborhood_cuda.launches"], launches[
            "build_neighborhood_cuda.launches_f64"]) != (4, 0):
        raise RuntimeError(f"the card's neighbor table failed its checks: "
                           f"{res}")
    return res


# ---- float64 tracing -------------------------------------------------------
F64 = torch.float64


def trace_unfused(tracer, dtype, bounce_sort=False):
    """The tracer's rays (its configuration, source, seed and batches)
    through ``trace_batch``'s unfused body in ``dtype``, on its geometry
    widened by ``to(dtype)``, its source cast alike, and a ``GeneratorRNG``
    of that type: the tracers are float32 only, so this is how a user traces
    a configuration in float64. Run after one apply of the tracer (which
    builds the areas its normalization reads); ``bounce_sort`` asks for
    the per-bounce resort. Returns (raw flux (N,) float64 numpy, counters
    dict, seconds)."""
    from viennaray_tpu_torch.physics.source import RandomSource, source_box
    from viennaray_tpu_torch.rng import GeneratorRNG
    from viennaray_tpu_torch.trace.kernel import BatchCounters, trace_batch

    geometry = tracer.geometry.to(dtype)
    dev = geometry.device
    config = tracer._make_config()
    n = geometry.num_primitives
    total = config.total_rays(n)
    source = RandomSource.default(tracer.geometry, config,
                                  tracer._particle.cosine_exponent).to(dtype)
    bbox = torch.tensor(source_box(tracer.geometry, config), dtype=dtype,
                        device=dev)
    rng = GeneratorRNG(tracer._rng_seed + 1, dev, dtype=dtype)
    batch = min(config.ray_batch_size,
                max(512, 1 << (max(total, 2) - 1).bit_length()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flux = torch.zeros(n, dtype=F64, device=dev)
    totals = np.zeros(len(BatchCounters._fields), np.int64)
    for b in range(max(1, -(-total // batch))):
        idx = torch.arange(b * batch, (b + 1) * batch, device=dev)
        rng.begin_batch(b)
        batch_flux, counters = trace_batch(
            geometry, source, tracer._particle, bbox, rng, b, idx,
            idx < total, config, fused=False, bounce_sort=bounce_sort)
        flux += batch_flux.double()
        totals += np.asarray(counters, np.int64)
    out = flux.cpu().numpy()
    seconds = time.perf_counter() - t0
    return out, dict(zip(BatchCounters._fields, totals.tolist())), seconds


def f64_flagship(label, tracer, goldens, tol, kernels, record):
    """One flagship in float64 through ``trace_unfused`` beside the float32
    run of the same rays through the same loop, in turns (float32,
    float64, float64, float32), the registry's counts read around the second
    float64 run; the float32 loop must give the tracer's own unfused
    apply bit for bit. Holds the float64 flux to ``goldens`` (rel-L2 <
    ``tol``), its hits per ray to the oracle ``record``'s (2 %), the launches
    to the float64 ``kernels`` alone, and two float64 runs to the same bits."""
    applied = tracer.apply()  # the areas; the float32 unfused apply
    flux32, cnt32, s32a = trace_unfused(tracer, torch.float32)
    flux64, cnt64, s64a = trace_unfused(tracer, F64)
    before = dict(telemetry.COUNTS)
    again, cnt_again, s64b = trace_unfused(tracer, F64)
    launches = launches_since(before)
    _, _, s32b = trace_unfused(tracer, torch.float32)
    norm = np.asarray(tracer.normalize_flux(flux64), np.float64)
    errors = {key: rel_l2(norm, g) for key, g in goldens.items()}
    hits = cnt64["geometry_hits"] / tracer._make_config().total_rays(
        tracer.geometry.num_primitives)
    res = {
        "phase": "f64_path", **label, "dtype": "float64", "body": "unfused",
        "num_rays": tracer._make_config().total_rays(
            tracer.geometry.num_primitives),
        "seconds_f32_f64_f64_f32": [s32a, s64a, s64b, s32b],
        "geometry_hits_per_ray": hits,
        "oracle_geometry_hits_per_ray": record["geometry_hits_per_ray"],
        **errors, "rel_l2_bound": tol, "counters": cnt64,
        "counters_f32": cnt32, "launches": launches,
        "same_seed_bitwise_equal": bool(np.array_equal(flux64, again)
                                        and cnt64 == cnt_again),
        "f32_loop_equals_tracer": bool(np.array_equal(flux32, applied)),
    }
    emit(res)
    ok = (np.isfinite(norm).all() and all(e < tol for e in errors.values())
          and abs(hits - res["oracle_geometry_hits_per_ray"])
          <= 0.02 * res["oracle_geometry_hits_per_ray"]
          and res["same_seed_bitwise_equal"] and res["f32_loop_equals_tracer"]
          and only_launched(launches, *kernels))
    if not ok:
        raise RuntimeError(f"float64 path failed its checks: {res}")
    return launches


def normals_fd_full_width(geometry64, problem64):
    """d dot(lw, flux) / d (x of an off-centre bottom disk's normal), the
    pick of tests/test_diff.py:247-251 on the flagship's floor, at 2^21 rays
    under 1/distance weighting, 4 bounces, in float64: the batched gradient
    within 1e-3 of either one-sided difference at eps 1e-6, forward runs of
    the same rays and batches."""
    from viennaray_tpu_torch import diff
    from viennaray_tpu_torch.rng import GeneratorRNG

    source, particle, bbox, config = problem64
    pts = geometry64.points.cpu().numpy()
    pi = int(np.where((np.abs(pts[:, 2] - pts[:, 2].min()) < 1e-6)
                      & (np.abs(pts[:, 0] + 0.5) < 0.2))[0][0])
    n = geometry64.num_primitives
    lw = np.random.default_rng(5).random(n)
    rays, bounces = GRAD_SIDE_RAYS, 4

    def rng():
        return GeneratorRNG(GRAD["seed"], geometry64.device, dtype=F64)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, grad = diff.flux_and_grad_normals_batched(
        geometry64, source, particle, bbox, rng(), rays, config,
        num_bounces=bounces, loss_weights=lw)
    torch.cuda.synchronize()
    grad_seconds = time.perf_counter() - t0
    weights = torch.as_tensor(lw, device=geometry64.device)

    def loss(du):
        normals = geometry64.normals.clone()
        normals[pi, 0] += du
        geo = geometry64.replace(normals=normals)
        r = rng()
        total = 0.0
        with torch.no_grad():
            for b in range(-(-rays // config.ray_batch_size)):
                idx = torch.arange(b * config.ray_batch_size,
                                   (b + 1) * config.ray_batch_size,
                                   device=geometry64.device)
                flux = diff.trace_flux(geo, source, particle, bbox, r, idx,
                                       idx < rays, config,
                                       num_bounces=bounces, batch_index=b)
                total += float(torch.dot(weights, flux))
        return total

    eps = 1e-6
    f0 = loss(0.0)
    fwd = (loss(eps) - f0) / eps
    bwd = (f0 - loss(-eps)) / eps
    g = float(grad[pi, 0])
    err = min(abs(g - fwd) / max(abs(fwd), 1e-12),
              abs(g - bwd) / max(abs(bwd), 1e-12))
    res = {"phase": "f64_path", "check": "normals finite differences",
           "disks": n, "disk": pi, "num_rays": rays, "bounces": bounces,
           "use_wdist": True, "eps": eps, "d_loss_d_normal_x": g,
           "fd_forward": fwd, "fd_backward": bwd, "rel_err": err,
           "bound": 1e-3, "grad_seconds": grad_seconds}
    emit(res)
    if not (np.isfinite(g) and g != 0.0 and err < 1e-3):
        raise RuntimeError(f"the float64 normals gradient fails: {res}")


def phase_f64_paths(pts, nrm, verts, tris):
    """Float64 tracing: the float64 forms of kernels 1, 3, the line search,
    kernel 2 (both paths) and its backward against their plain versions bit
    for bit at 2^20 source rays and 512 (kernel 2 at 2^19 x 12 and 6,144
    entries, and on the small path one entry below its threshold and 6,144
    entries on 18,180 bins); the disk flagship (500 rays per point), the
    triangle flagship (250 per triangle) and the lines (500 per segment)
    through ``trace_batch``'s unfused body in float64 beside float32;
    ``grad_1e7`` in float64 against ``grad3d_trench_jax``; the normals'
    finite differences at full width. Returns (kernel results, launches by
    path)."""
    from viennaray_tpu_torch.geometry.disk_geometry import DiskGeometry
    from viennaray_tpu_torch.geometry.line_geometry import LineGeometry
    from viennaray_tpu_torch.geometry.triangle_geometry import TriangleGeometry
    from viennaray_tpu_torch.ops import histogram as H

    geometry = DiskGeometry.build(pts, nrm, FLAGSHIP["grid_delta"])
    bbox = adjusted_bbox(geometry)
    mesh = TriangleGeometry.build(verts, tris, FLAGSHIP["grid_delta"])
    mesh_bbox = adjusted_bbox(mesh)
    line_mesh, line_materials = line_trench()
    lines = LineGeometry.from_mesh(line_mesh, material_ids=line_materials)
    lines_bbox = adjusted_bbox(lines, dim=2)
    g64, mesh64, lines64 = (g.to(F64) for g in (geometry, mesh, lines))
    kernels = {
        "disk": check_nearest_hit(g64, bbox, 1 << 20, "source", reps=5),
        "triangle": check_nearest_hit(mesh64, mesh_bbox, 1 << 20, "source",
                                      reps=3),
        "line": check_nearest_hit(lines64, lines_bbox, 1 << 20,
                                  "flat_source", reps=5),
    }
    narrow = {
        "disk": check_nearest_hit(g64, bbox, 512, "interior", reps=100),
        "triangle": check_nearest_hit(mesh64, mesh_bbox, 512, "interior",
                                      reps=50),
        "line": check_nearest_hit(lines64, lines_bbox, 512, "flat", reps=100),
    }
    kernels["histogram"] = check_histogram(geometry, 1 << 19, len(pts),
                                           reps=50, dtype=F64)
    # disk18k's bins: the cluster branch at C = 16 in float64
    kernels["histogram_18180"] = check_histogram(geometry, 1 << 19, 18180,
                                                 reps=20, dtype=F64)
    narrow["histogram"] = check_histogram(geometry, 512, len(pts), reps=200,
                                          dtype=F64)
    # the small path's other shapes in float64: one entry below the
    # threshold, and 6,144 entries on disk18k's bins
    narrow["histogram_threshold"] = check_histogram(
        geometry, 1 << 19, len(pts), reps=100, dtype=F64,
        n_entries=H.SMALL_ENTRIES - 1)
    narrow["histogram_18180"] = check_histogram(geometry, 512, 18180,
                                                reps=200, dtype=F64)
    kernels["histogram_grad"] = check_histogram_grad(geometry, 1 << 19,
                                                     reps=50, dtype=F64)
    narrow["histogram_grad"] = check_histogram_grad(geometry, 512, reps=200,
                                                    dtype=F64)

    launches = {}
    disk_kernels = ("disk_nearest_hit.launches_f64", "histogram_launches_f64",
                    "permute_state.launches_f64", "coherence_key.launches_f64")
    launches["disks_f64"] = f64_flagship(
        {"geometry": "disks"},
        make_tracer(pts, nrm, rays_per_point=RAYS_PER_POINT // 4,
                    fused=False),
        disk_goldens(), 2.0 * GOLDEN_TOL, disk_kernels,
        {"geometry_hits_per_ray": 1.6957})
    golden, record, tol = oracle_golden("tri3d_trench_oracle")
    launches["triangles_f64"] = f64_flagship(
        {"geometry": "triangles"},
        make_tri_tracer(verts, tris, rays_per_point=RAYS_PER_POINT // 8,
                        fused=False),
        {"rel_l2_oracle": golden}, 3.0 * tol,
        ("triangle_nearest_hit.launches_f64", "histogram_launches_f64",
         "permute_state.launches_f64", "coherence_key.launches_f64"), record)
    golden, record, tol = oracle_golden("line2d_trench_oracle")
    launches["lines_f64"] = f64_flagship(
        {"geometry": "lines"},
        make_line_tracer(rays_per_point=RAYS_PER_POINT // 4, fused=False),
        {"rel_l2_oracle": golden}, 2.0 * tol,
        ("line_nearest_hit.launches_f64", "histogram_launches_f64",
         "permute_state.launches_f64", "coherence_key.launches_f64"), record)

    # grad_1e7 in float64: the warm-up run, then the timed run of the seed
    source, particle, box, config = grad_problem(geometry)
    problem64 = (source.to(F64), particle, box.to(F64), config)
    rays = GRAD["rays"]
    n_batches = -(-rays // GRAD["batch"])

    def grad64(rays=rays):
        from viennaray_tpu_torch import diff
        from viennaray_tpu_torch.rng import GeneratorRNG

        return diff.flux_and_grad_sticking_batched(
            g64, *problem64[:3], GeneratorRNG(GRAD["seed"], g64.device,
                                              dtype=F64),
            rays, problem64[3], num_bounces=GRAD["bounces"])

    first = grad64()
    (flux, grad), fields, grad_launches = timed_grad(g64, grad64)
    launches["grad_f64"] = grad_launches
    golden, grec, gtol = oracle_golden("grad3d_trench_jax")
    flux_err = rel_l2(flux / rays, golden)
    grad_err = abs(grad / rays - grec["grad_per_ray"]) / abs(
        grec["grad_per_ray"])
    grad_tol = max(1.45 * grec["grad_rel_diff_between_seeds"],
                   GRAD_TOL_FLOOR)
    want = GRAD["bounces"] * n_batches
    launches_ok = (
        grad_launches["disk_nearest_hit.launches_f64"] == want
        and grad_launches["histogram_launches_f64"] == want
        and grad_launches["flux_histogram_grad.launches_f64"]
        == (GRAD["bounces"] - 1) * n_batches
        and only_launched(grad_launches, "disk_nearest_hit.launches_f64",
                          "histogram_launches_f64",
                          "flux_histogram_grad.launches_f64"))
    res = {"phase": "f64_path", "config": "grad_1e7 (BASELINE config 5)",
           "dtype": "float64", "num_rays": rays, **fields,
           "rays_per_s_fwd_bwd": rays / fields["seconds"],
           "d_flux_d_sticking_per_ray": grad / rays,
           "golden_d_flux_d_sticking_per_ray": grec["grad_per_ray"],
           "d_flux_d_sticking_rel_err": grad_err,
           "d_flux_d_sticking_bound": grad_tol, "rel_l2_golden": flux_err,
           "rel_l2_bound": gtol, "launches_ok": launches_ok,
           "same_seed_bitwise_equal": bool(
               np.array_equal(first[0], flux) and first[1] == grad),
           "flux_dtype": str(flux.dtype)}
    emit(res)
    if not (np.isfinite(flux).all() and np.isfinite(grad) and launches_ok
            and flux_err < gtol and grad_err <= grad_tol
            and res["same_seed_bitwise_equal"]):
        raise RuntimeError(f"float64 grad path failed its checks: {res}")

    wdist = grad_problem(geometry, use_wdist=True)
    normals_fd_full_width(g64, (wdist[0].to(F64), wdist[1],
                                wdist[2].to(F64), wdist[3]))
    return kernels, narrow, launches


def f64_kernel_entries(results, narrow, launches, keys):
    """The ``kernels`` line's entries of the float64 forms: each replaces the
    TPU kernel of its float32 form; launches from the float64 paths' timed
    runs (``phase_f64_paths``), times at 2^20 rays (kernel 2 at 2^19 x 12
    entries, and on 18,180 bins) and, under ``narrow``, at 512 rays (6,144
    entries)."""
    def count(counted, *paths):
        by_path = {p: launches[p][counted] for p in paths}
        return {"launches": sum(by_path.values()),
                "launches_by_path": by_path}

    entries = []
    for name, counted, key, source, replaces, paths in (
        ("disk_nearest_hit_f64", "disk_nearest_hit.launches_f64", "disk",
         "nearest_hit.cu", "viennaray_tpu/ops/pallas_intersect.py:166",
         ("disks_f64", "grad_f64")),
        ("triangle_nearest_hit_f64", "triangle_nearest_hit.launches_f64",
         "triangle", "nearest_hit.cu",
         "viennaray_tpu/ops/pallas_intersect.py:359", ("triangles_f64",)),
        ("line_nearest_hit_f64", "line_nearest_hit.launches_f64", "line",
         "nearest_hit.cu", "viennaray_tpu/ops/intersect.py:172",
         ("lines_f64",)),
        ("flux_histogram_f64", "histogram_launches_f64", "histogram",
         "flux_histogram.cu", "viennaray_tpu/ops/pallas_histogram.py:39",
         ("disks_f64", "triangles_f64", "lines_f64", "grad_f64")),
        ("flux_histogram_grad_f64", "flux_histogram_grad.launches_f64",
         "histogram_grad", "flux_histogram.cu",
         "viennaray_tpu/trace/kernel.py:161", ("grad_f64",)),
    ):
        entries.append({
            "name": name, "route": "cuda",
            "source": f"viennaray_tpu_torch/csrc/{source}",
            "replaces": replaces, **count(counted, *paths),
            **{k: results[key][k] for k in keys},
            "narrow": {k: narrow[key][k] for k in keys},
        })
    # kernel 2's float64 form on disk18k's bins (its cluster branch, C = 16),
    # and its small path's other shapes
    entries[3]["n_18180"] = {k: results["histogram_18180"][k]
                             for k in keys + ("branch", "ms_by_branch")}
    for name in ("histogram_threshold", "histogram_18180"):
        entries[3]["narrow_" + name] = {
            k: narrow[name][k] for k in keys + ("path", "small_cluster",
                                                "ms_by_branch")}
    return entries


# the sharded path's differentiable leg (``__graft_entry__.py:
# dryrun_multichip``'s first leg at the flagship's cloud): 2^17 rays in
# sub-batches of 2^15, 4 bounces, roulette off
SHARDED_GRAD = dict(rays=1 << 17, batch=1 << 15, bounces=4, seed=3)


@contextlib.contextmanager
def launches_by_batch(module):
    """The launches of the bounce and histogram kernels in each
    ``trace_batch`` call made through ``module.trace_batch``, by batch
    index: {batch: (bounce kernel, histogram kernel)}."""
    real = module.trace_batch
    seen = {}
    counts = telemetry.COUNTS

    def wrapper(geometry, source, particle, bbox, rng, batch_index, *args,
                **kwargs):
        k4, k2 = counts[BOUNCE], counts[HIST]
        out = real(geometry, source, particle, bbox, rng, batch_index, *args,
                   **kwargs)
        seen[int(batch_index)] = (counts[BOUNCE] - k4, counts[HIST] - k2)
        return out

    module.trace_batch = wrapper
    try:
        yield seen
    finally:
        module.trace_batch = real


def sharded_flagship(geometry, **config_changes):
    """The flagship as ``trace_sharded`` takes it, built as a user would:
    (source, particle, bbox, config) of ``TraceDisk``'s flagship apply (the
    random source on the +z face, cosine lobe; mega-batches of 2^20)."""
    import viennaray_tpu_torch as vrt

    config = vrt.TraceConfig(**{**dict(
        dim=3, num_rays_per_point=RAYS_PER_POINT, rng_seed=SEED,
        use_random_seed=False, ray_batch_size=1 << 20,
        boundary_conditions=(vrt.BoundaryCondition.PERIODIC,) * 3),
        **config_changes})
    source = vrt.RandomSource.default(geometry, config)
    return source, vrt.DiffuseParticle(0.1, "flux"), source.bbox, config


def phase_sharded_path(pts, nrm):
    """The sharded trace (``viennaray_tpu_torch.parallel``) at full width on
    the disk flagship (2,993 disks, 5,986,000 rays), printed as one
    ``sharded_path`` object; a failed check raises. ``TraceDisk``'s warm
    and timed applies (base seeds 43 and 44), then (a) a one-rank NCCL
    process group on cuda:0 and (b) a 4-shard mesh on cuda:0 in that group:
    each a warm run (seed 43) and a timed one (seed 44), flux and counters
    bit for bit against the tracer's apply of the same seed; (d) the bounce
    and histogram kernels' launches of every sub-batch equal the tracer's
    batch of that index (the mesh's extra sub-batches hold no live ray and
    launch nothing); (c) the differentiable leg, loss = sum(flux^2) of a
    ``differentiable=True`` trace of 2^17 rays and 4 bounces, at 1 and 4
    shards (1, 4, then 1 again, timed: the first leg of a process runs its
    first backward): loss, flux and d loss / d sticking finite and bit for
    bit equal. Returns the launches of the 4-shard timed run and of the
    4-shard differentiable leg."""
    import torch.distributed as dist

    import viennaray_tpu_torch as vrt
    from viennaray_tpu_torch.parallel import mesh as ray_mesh
    from viennaray_tpu_torch.trace import tracer as tracer_module

    tracer = make_tracer(pts, nrm)
    warm_want = tracer.apply()
    before = dict(telemetry.COUNTS)
    with launches_by_batch(tracer_module) as tracer_batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = tracer.apply()
        torch.cuda.synchronize()
        tracer_seconds = time.perf_counter() - t0
    tracer_launches = launches_since(before)
    info = tracer.get_ray_trace_info()
    want_counters = [info.total_rays_traced, info.non_geometry_hits,
                     info.geometry_hits, info.particle_hits,
                     info.boundary_hits, info.reflections]
    geometry = tracer.geometry
    source, particle, bbox, config = sharded_flagship(geometry)
    total = config.total_rays(geometry.num_primitives)

    ray_mesh.initialize_distributed("cuda")
    try:
        meshes = {"nccl_one_rank": ray_mesh.make_ray_mesh(),
                  "four_shards": ray_mesh.make_ray_mesh(["cuda:0"] * 4)}
        runs, launches = {}, {}
        for name, mesh in meshes.items():
            warm, _ = ray_mesh.trace_sharded(
                geometry, source, particle, bbox, config,
                vrt.GeneratorRNG(SEED + 1, geometry.device), total, mesh)
            before = dict(telemetry.COUNTS)
            with launches_by_batch(ray_mesh) as batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                flux, counters = ray_mesh.trace_sharded(
                    geometry, source, particle, bbox, config,
                    vrt.GeneratorRNG(SEED + 2, geometry.device), total, mesh)
                flux = flux.cpu().numpy()
                seconds = time.perf_counter() - t0
            launches[name] = launches_since(before)
            live = {b: n for b, n in batches.items() if b in tracer_batches}
            extra = {b: n for b, n in batches.items()
                     if b not in tracer_batches}
            runs[name] = {
                "shards": mesh.size, "world_size": mesh.world_size,
                "backend": dist.get_backend(mesh.group), "seconds": seconds,
                "rays_per_s": total / seconds,
                "warm_bitwise_equal": bool(np.array_equal(
                    warm.cpu().numpy(), warm_want)),
                "bitwise_equal": bool(np.array_equal(flux, want)),
                "counters": counters[:6].tolist(),
                "counters_equal": counters[:6].tolist() == want_counters,
                "sub_batches": len(batches),
                "launches": launches[name],
                "launches_by_sub_batch_equal": live == tracer_batches,
                "extra_sub_batches_launch_nothing": all(
                    n == (0, 0) for n in extra.values()),
            }

        # (c) the differentiable leg at 1 and 4 shards
        _, _, _, grad_config = sharded_flagship(
            geometry, num_rays_fixed=SHARDED_GRAD["rays"],
            ray_batch_size=SHARDED_GRAD["batch"], roulette=False)
        legs = {}
        for n in (1, 4, 1):  # the first leg warms the process's autograd up
            sticking = torch.tensor(0.1, device=geometry.device,
                                    requires_grad=True)
            before = dict(telemetry.COUNTS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            flux, _ = ray_mesh.trace_sharded(
                geometry, source, particle.replace(sticking=sticking), bbox,
                grad_config,
                vrt.GeneratorRNG(SHARDED_GRAD["seed"], geometry.device),
                SHARDED_GRAD["rays"],
                ray_mesh.make_ray_mesh(["cuda:0"] * n), differentiable=True,
                num_bounces=SHARDED_GRAD["bounces"])
            loss = (flux * flux).sum()
            loss.backward()
            torch.cuda.synchronize()
            legs[n] = dict(seconds=time.perf_counter() - t0,
                           loss=loss.item(),
                           flux=flux.detach().cpu().numpy(),
                           grad=sticking.grad.item(),
                           launches=launches_since(before))
    finally:
        dist.destroy_process_group()
    one, four = legs[1], legs[4]
    grad_leg = {
        "rays": SHARDED_GRAD["rays"], "sub_batch": SHARDED_GRAD["batch"],
        "bounces": SHARDED_GRAD["bounces"],
        "seconds_1_shard": one["seconds"], "seconds_4_shards": four["seconds"],
        "loss": four["loss"], "d_loss_d_sticking": four["grad"],
        "finite": bool(np.isfinite(four["loss"])
                       and np.isfinite(four["flux"]).all()
                       and np.isfinite(four["grad"])),
        "bitwise_equal_1_4_shards": bool(
            one["loss"] == four["loss"] and one["grad"] == four["grad"]
            and np.array_equal(one["flux"], four["flux"])),
        "launches": four["launches"],
        "launches_equal_1_4_shards": one["launches"] == four["launches"],
    }
    res = {
        "phase": "sharded_path", "disks": geometry.num_primitives,
        "num_rays": total, "tracer_seconds": tracer_seconds,
        "tracer_launches": tracer_launches,
        "tracer_batches": len(tracer_batches), **runs, "grad_leg": grad_leg,
    }
    emit(res)
    ok = grad_leg["finite"] and grad_leg["bitwise_equal_1_4_shards"] and (
        grad_leg["launches_equal_1_4_shards"]) and only_launched(
        four["launches"], DISK, HIST, HIST_GRAD)
    for run in runs.values():
        ok = ok and all(run[k] for k in (
            "warm_bitwise_equal", "bitwise_equal", "counters_equal",
            "launches_by_sub_batch_equal",
            "extra_sub_batches_launch_nothing"))
    ok = ok and only_launched(launches["four_shards"], BOUNCE, HIST, *SORTS)
    if not ok:
        raise RuntimeError(f"sharded path failed its checks: {res}")
    return launches["four_shards"], four["launches"]

# ---- the uniform grid (the grid DDA) -----------------------------------------
# disk18k and the 36,000-triangle trench (grid delta 0.1), and disk1m, the
# perf sweep's cell (viennaray_tpu_torch/bench/perf_sweep.py): 704,250 disks,
# 4 rays per point, built here with its grid
GRID_FINE = dict(FLAGSHIP, grid_delta=0.1)
DISK1M = dict(FLAGSHIP, grid_delta=0.016)
DISK1M_RAYS_PER_POINT = 4
GRID_RAYS_PER_POINT = 200  # disk18k, as the perf sweep's cell
# the kernel 4 shapes of the ladder: wide, mid, tail
GRID_BOUNCE_SHAPES = ((1 << 20, 1), (16384, 4), (512, 16))


def grid_tables(build):
    """The grid's build seconds (``build()``: the JAX package's table on
    the host, the walk's on the card), the bytes of the walk's table on the
    card (compact, and what it would take padded) and of the JAX package's
    table on the host."""
    t0 = time.perf_counter()
    grid = build()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"dims": list(grid.dims), "walk_dims": list(grid.walk_dims),
            "slots": grid.cells.shape[1], "walk_slots": grid.walk_slots,
            "exact": grid.exact, "host_build_seconds": seconds,
            "device_table_bytes": grid.device_bytes,
            "padded_table_bytes": grid.padded_bytes,
            "entries": grid.cell_lanes.numel(),
            "host_table_bytes": grid.cells.nbytes}


def check_grid_hit(geometry, bbox, n_rays, kind, reps):
    """The grid closest-hit kernel of the geometry's kind against its plain
    version (the walk in tensor ops) and against the chunk search's kernel
    (kernel 1 or 3) on the same rays, bit for bit; the float64 form for a
    geometry widened by ``to(torch.float64)``. Times all three; the bound
    counts the pairs the walks tested."""
    from viennaray_tpu_torch.ops import grid_traverse as GT
    from viennaray_tpu_torch.ops import nearest_hit as NH

    f64 = geometry.dtype == torch.float64
    name = f"{geometry.kind}_grid_nearest_hit"
    kernel = getattr(GT, name)
    chunk = getattr(NH, f"{geometry.kind}_nearest_hit")
    org, dirn = make_rays(geometry, bbox, n_rays, kind, seed=7)
    org, dirn = org.to(geometry.dtype), dirn.to(geometry.dtype)
    args = (org, dirn, geometry.prims_soa, geometry.soa_perm, geometry.grid)
    chunk_args = (org, dirn, geometry.prims_soa, geometry.soa_perm,
                  geometry.soa_chunk_bbs)
    got = kernel(*args, t_near=1e-4)
    by_chunks = chunk(*chunk_args, t_near=1e-4)
    walk_counts = torch.zeros(3, dtype=torch.int64, device=org.device)
    kernel(*args, t_near=1e-4, walk_counts=walk_counts)
    torch.cuda.synchronize()
    t_p, lane_p, visited, tested = GT.grid_walk_ref(
        org, dirn, geometry.grid, geometry.prims_soa,
        GT.TEST[geometry.kind], 1e-4)
    plain = (t_p, geometry.soa_perm[torch.clamp(lane_p, min=0)], lane_p >= 0)
    plain_equal = all(bool(torch.equal(a, b)) for a, b in zip(got, plain))
    # the kernel's counts of the cells visited and the pairs of those cells
    # are the plain walk's
    k_visited, k_tested, k_wasted = walk_counts.tolist()
    counts_equal = (k_visited == int(visited.sum())
                    and k_tested == int(tested.sum()))
    chunk_equal = all(bool(torch.equal(a, b)) for a, b in zip(got, by_chunks))
    hit = plain[2]
    max_abs_err = max(
        float((got[0] - plain[0])[hit].abs().max()) if bool(hit.any())
        else 0.0,
        float((got[0] - by_chunks[0])[hit].abs().max()) if bool(hit.any())
        else 0.0)
    ms = time_cuda(lambda: kernel(*args, t_near=1e-4), reps)
    chunk_ms = time_cuda(lambda: chunk(*chunk_args, t_near=1e-4), reps)
    plain_ms = time_cuda(lambda: GT.grid_walk_ref(
        org, dirn, geometry.grid, geometry.prims_soa,
        GT.TEST[geometry.kind], 1e-4), 1)
    rows, npad = geometry.prims_soa.shape
    word = 8 if f64 else 4
    pairs = int(tested.sum())
    cells = int(visited.sum())
    op_ms = (pairs * OPS_PER_PAIR[geometry.kind]
             / (F64_FLOPS if f64 else F32_FLOPS) * 1e3)
    # rays in, (t, prim, hit) out, and the tables once: the SoA and its
    # permutation (as kernel 1's bound counts them) and the walk's compact
    # table, which the kernel reads
    n_bytes = (n_rays * (6 * word + word + 5) + npad * (rows * word + 4)
               + geometry.grid.device_bytes)
    byte_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    res = {
        "phase": "kernel_check", "kernel": name + ("_f64" if f64 else ""),
        "shape": f"R={n_rays} ({kind} rays), N={geometry.num_primitives}, "
                 f"cells {geometry.grid.walk_dims}, "
                 f"K={geometry.grid.walk_slots}",
        "tolerance": "hit, prim and t equal bit for bit on every lane to the "
                     "plain walk and to the chunk search's kernel; the "
                     "kernel's cells and pairs the plain walk's",
        "plain_equal": plain_equal, "chunk_kernel_equal": chunk_equal,
        "walk_counts_equal": counts_equal,
        "hit_fraction": float(hit.float().mean()),
        "cells_a_ray": cells / n_rays, "pairs_a_ray": pairs / n_rays,
        "wasted_pairs_a_ray": k_wasted / n_rays,
        "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
        "chunk_kernel_ms": chunk_ms,
        "bound_ms": max(op_ms, byte_ms),
        "bound_by": "operations" if op_ms >= byte_ms else "bytes",
        "library_ms": None,
    }
    emit(res)
    if not (plain_equal and chunk_equal and counts_equal
            and max_abs_err == 0.0):
        raise RuntimeError(f"{name} disagrees: {res}")
    return res


def check_grid_bounce(geometry, bbox, n_rays, kind, n_sub, settings, reps):
    """Kernel 4 with the grid search against kernel 4 with the chunk search
    on the same seeded state, in the kernel's deposits (and handed out at
    one bounce): state, events, survivors and flux bit for bit, each timed.
    In grid mode the search counts are the cells the walks visited and the
    searches they ran, one per live ray and sub-bounce. The operations
    bounds count the pairs the searches test: the chunk search's from its
    counters (woken chunks x lanes a chunk), the grid's from the plain walk
    of the first sub-bounce (``grid_walk_ref``: the slots of the cells it
    visits), per search, times the searches the grid counted (exact at one
    bounce a launch, an estimate at several); the grid's bound is the
    larger of that and its bytes."""
    from viennaray_tpu_torch.ops import bounce as B
    from viennaray_tpu_torch.ops import grid_traverse as GT

    walls = B.make_walls(bbox, geometry, settings)
    state, uniforms = make_state(geometry, bbox, n_rays, kind, n_sub,
                                 settings, seed=13)
    args = (state, uniforms, geometry, walls, settings)
    live = state.alive
    first_pairs = int(GT.grid_walk_ref(
        state.org[live], state.dirn[live], geometry.grid, geometry.prims_soa,
        GT.TEST[geometry.kind], settings.t_near)[3].sum())
    pairs_a_search = first_pairs / max(int(live.sum()), 1)
    lanes_a_chunk = (geometry.prims_soa.shape[1]
                     // geometry.soa_chunk_bbs.shape[0])
    op_s = OPS_PER_PAIR[geometry.kind] / F32_FLOPS
    out = {}
    for in_kernel in ((True, False) if n_sub == 1 else (True,)):
        kw = dict(n_sub=n_sub, deposit_in_kernel=in_kernel)
        chunk = B.fused_bounce(*args, **kw)
        grid = B.fused_bounce(*args, **kw, grid=geometry.grid)
        torch.cuda.synchronize()
        n_events = B.N_EVENTS + 1
        equal = (all(bool(torch.equal(a, b))
                     for a, b in zip(chunk.state, grid.state))
                 and bool(torch.equal(chunk.counts[:n_events],
                                      grid.counts[:n_events])))
        if in_kernel:
            equal = equal and bool(torch.equal(chunk.flux, grid.flux))
        else:
            equal = (equal and bool(torch.equal(chunk.hit_prim, grid.hit_prim))
                     and bool(torch.equal(chunk.wdep, grid.wdep)))
        swept, searches = grid.counts[n_events:].tolist()
        counts_ok = searches == int(grid.counts[3]) and swept >= searches
        ms = time_cuda(lambda: B.fused_bounce(*args, **kw), reps)
        grid_ms = time_cuda(
            lambda: B.fused_bounce(*args, **kw, grid=geometry.grid), reps)
        chunk_swept, chunk_tiles = chunk.counts[n_events:].tolist()
        grid_ops_ms = searches * pairs_a_search * op_s * 1e3
        chunk_bound_ms = chunk_swept * lanes_a_chunk * op_s * 1e3
        # bytes: the state read (42 bytes a ray) and written (38), its
        # uniforms, the outputs, the SoA and the compact table once (the
        # neighbor records that deposits gather are not counted)
        out_bytes = (geometry.num_primitives * 4 if in_kernel
                     else n_rays * 8)
        grid_bytes_ms = (n_rays * 80 + uniforms.numel() * 4 + out_bytes
                         + geometry.prims_soa.numel() * 4
                         + geometry.grid.device_bytes) / HBM_BYTES_PER_S * 1e3
        grid_bound_ms = max(grid_ops_ms, grid_bytes_ms)
        res = {
            "phase": "grid_bounce", "shape":
                f"{geometry.kind}s N={geometry.num_primitives}, R={n_rays} "
                f"({kind} rays), n_sub={n_sub}, deposits "
                f"{'in the kernel' if in_kernel else 'handed out'}, "
                f"G={B.GRID_GROUP} (grid), "
                f"{B.group_for(n_rays, geometry.soa_chunk_bbs.shape[0])} "
                f"(chunks)",
            "tolerance": "state, events, survivors, flux (or hit and weight) "
                         "bit for bit between the two searches",
            "bitwise_equal": equal, "grid_ms": grid_ms, "chunk_ms": ms,
            "cells_a_search": swept / max(searches, 1),
            "chunks_a_search_group": chunk_swept / max(chunk_tiles, 1),
            "search_counts_ok": counts_ok,
            "pairs_a_search_first_bounce": pairs_a_search,
            "grid_bound_ms": grid_bound_ms,
            "grid_bound_by": ("operations" if grid_ops_ms >= grid_bytes_ms
                              else "bytes"),
            "grid_ops_bound_ms": grid_ops_ms,
            "grid_bytes_bound_ms": grid_bytes_ms,
            "chunk_bound_ms": chunk_bound_ms, "chunk_bound_by": "operations",
        }
        emit(res)
        if not (equal and counts_ok):
            raise RuntimeError(f"kernel 4's grid search disagrees: {res}")
        out[in_kernel] = res
    return out


def make_grid_tracer(geometry, rays_per_point, fused=True):
    """``TraceDisk`` or ``TraceTriangle`` on a built geometry, the flagships'
    physics."""
    import viennaray_tpu_torch as vrt

    cls = vrt.TraceDisk if geometry.kind == "disk" else vrt.TraceTriangle
    tracer = cls(dim=3, fused=fused)
    tracer.geometry = geometry
    return configure(tracer, rays_per_point)


def grid_apply_pair(label, geometry, rays_per_point, fused, kernels):
    """One apply of ``geometry`` with its grid (the trace walks it: at least
    ``grid_min_prims`` primitives) and one of the same geometry without
    (the chunk search), the registry's counts read just before each and
    just after; flux and event counters bit for bit. Returns the grid run's
    launches."""
    import dataclasses

    runs = {}
    for mode, geo in (("chunks", geometry.replace(grid=None)),
                      ("grid", geometry)):
        tracer = make_grid_tracer(geo, rays_per_point, fused)
        before = dict(telemetry.COUNTS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flux = tracer.apply()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        info = dataclasses.asdict(tracer.get_ray_trace_info())
        runs[mode] = dict(flux=flux, info=info, seconds=seconds,
                          launches=launches_since(before))
        del tracer
    chunks, grid = runs["chunks"], runs["grid"]
    equal = bool(np.array_equal(chunks["flux"], grid["flux"])) and all(
        chunks["info"][k] == grid["info"][k] for k in INFO_COUNTERS)
    n = grid["info"]["num_rays"]
    res = {
        "phase": "main_path", "path": label, "fused": fused,
        f"{geometry.kind}s": geometry.num_primitives, "num_rays": n,
        "bitwise_equal": equal,
        "seconds": {m: r["seconds"] for m, r in runs.items()},
        "rays_per_s": {m: n / r["seconds"] for m, r in runs.items()},
        "geometry_hits_per_ray": grid["info"]["geometry_hits"] / n,
        "cells_a_search": grid["info"]["chunks_swept"]
        / max(grid["info"]["tile_bounces"], 1),
        "chunks_a_search_group": chunks["info"]["chunks_swept"]
        / max(chunks["info"]["tile_bounces"], 1),
        "launches": {m: {k: v for k, v in r["launches"].items() if v}
                     for m, r in runs.items()},
    }
    finite = bool(np.isfinite(grid["flux"]).all()) and grid["flux"].max() > 0
    # every launch of the bounce kernel walked the grid
    all_grid = grid["launches"][GRID] == grid["launches"][BOUNCE]
    emit(res)
    if not (equal and finite and all_grid
            and only_launched(grid["launches"], *kernels)):
        raise RuntimeError(f"grid path failed its checks: {res}")
    return grid["launches"]


def phase_grid_path():
    """The uniform grid (``geometry.grid_accel``, ``ops/grid_traverse.py``,
    kernel 4's grid search): the grid closest-hit kernels against their
    plain versions and against kernels 1 and 3 at 2^20 rays on disk18k and
    the 36,000 triangles, float32 and float64; kernel 4 with the grid
    against kernel 4 with the chunks at the ladder's three shapes on
    disk18k, disk1m and the triangles; then fused applies at disk18k and
    disk1m and unfused applies at disk18k and the triangles, each with the
    grid and without, bit for bit. Returns (kernel results, launches by
    path)."""
    from viennaray_tpu_torch.geometry import grid_accel
    from viennaray_tpu_torch.geometry.disk_geometry import DiskGeometry
    from viennaray_tpu_torch.geometry.grid_accel import GridData
    from viennaray_tpu_torch.geometry.triangle_geometry import TriangleGeometry
    from viennaray_tpu_torch.io import fixtures

    t_phase = time.perf_counter()
    emit({"phase": "grid_registers", **{
        name: BUILD_REGISTERS.get(name) for name in ("kernel4_grid",
                                                     "grid_hit")}})
    pts, nrm = fixtures.create_trench_grid_3d(**GRID_FINE)
    disks = DiskGeometry.build(pts, nrm, GRID_FINE["grid_delta"])
    disks_bbox = adjusted_bbox(disks)
    verts, tris = fixtures.create_trench_mesh_3d(**GRID_FINE)
    mesh = TriangleGeometry.build(verts, tris, GRID_FINE["grid_delta"])
    mesh_bbox = adjusted_bbox(mesh)
    p32 = disks.points.cpu().numpy()
    r32 = disks.radii.cpu().numpy()
    inv = disks.soa_inv_perm
    emit({"phase": "grid_tables", "geometry": "disk18k",
          "disks": disks.num_primitives, **grid_tables(lambda: (
              GridData.build(grid_accel.build_disk_grid(p32, None, r32),
                             *grid_accel.disk_boxes(p32, r32), inv, 3,
                             disks.device)))})
    emit({"phase": "grid_tables", "geometry": "trench_mesh_0.1",
          "triangles": mesh.num_primitives, **grid_tables(lambda: (
              GridData.build(grid_accel.build_triangle_grid(verts, tris),
                             *grid_accel.triangle_boxes(verts, tris),
                             mesh.soa_inv_perm, 3, mesh.device,
                             exact=grid_accel.triangles_covered(verts,
                                                                tris))))})

    results = {}
    for geo, box in ((disks, disks_bbox), (mesh, mesh_bbox)):
        for dtype in (torch.float32, torch.float64):
            g = geo.to(dtype)
            for kind in ("source", "interior"):
                res = check_grid_hit(g, box, 1 << 20, kind, reps=5)
                results.setdefault((geo.kind, dtype, kind), res)
        # rays at rims and edges (a quarter grazing), and straight down
        # onto packed flat faces and shared edges: float32
        check_grid_hit(geo, box, 65536, "rims", reps=2)
        check_grid_hit(geo, box, 65536, "ties", reps=2)
    flagship = bounce_settings()
    bounce = {}
    for n_rays, n_sub in GRID_BOUNCE_SHAPES:
        bounce[("disk18k", n_rays, n_sub)] = check_grid_bounce(
            disks, disks_bbox, n_rays, "interior", n_sub, flagship, reps=3)
    bounce[("triangles", 1 << 20, 1)] = check_grid_bounce(
        mesh, mesh_bbox, 1 << 20, "source", 1, flagship, reps=3)
    check_grid_bounce(mesh, mesh_bbox, 512, "interior", 16, flagship, reps=3)

    launches = {}
    launches["disk18k"] = grid_apply_pair(
        "disk18k", disks, GRID_RAYS_PER_POINT, True,
        (BOUNCE, GRID, HIST, *SORTS))
    launches["disk18k_unfused"] = grid_apply_pair(
        "disk18k_unfused", disks, GRID_RAYS_PER_POINT // 8, False,
        ("disk_grid_nearest_hit.launches", HIST, *SORTS))
    launches["triangles_unfused"] = grid_apply_pair(
        "trench_mesh_0.1_unfused", mesh, 20, False,
        ("triangle_grid_nearest_hit.launches", HIST, *SORTS))
    del disks, mesh
    t0 = time.perf_counter()
    pts, nrm = fixtures.create_trench_grid_3d(**DISK1M)
    fixture_seconds = time.perf_counter() - t0
    big = DiskGeometry.build(pts, nrm, DISK1M["grid_delta"],
                             pack_neighbors=False)
    big_bbox = adjusted_bbox(big)
    p32 = big.points.cpu().numpy()
    r32 = big.radii.cpu().numpy()
    emit({"phase": "grid_tables", "geometry": "disk1m",
          "disks": big.num_primitives, "fixture_seconds": fixture_seconds,
          **grid_tables(lambda: GridData.build(
              grid_accel.build_disk_grid(p32, None, r32),
              *grid_accel.disk_boxes(p32, r32), big.soa_inv_perm, 3,
              big.device))})
    big = big.with_neighbor_pack()
    # the grid kernel at 704,250 disks, its walk read from the compact
    # table (the padded one, 299 MB, lies far past the L2)
    results[("disk", torch.float32, "disk1m_source")] = check_grid_hit(
        big, big_bbox, 1 << 20, "source", reps=3)
    bounce[("disk1m", 1 << 20, 1)] = check_grid_bounce(
        big, big_bbox, 1 << 20, "interior", 1, flagship, reps=2)
    launches["disk1m"] = grid_apply_pair(
        "disk1m", big, DISK1M_RAYS_PER_POINT, True,
        (BOUNCE, GRID, HIST, *SORTS))
    del big
    torch.cuda.empty_cache()
    emit({"phase": "grid_path_seconds",
          "seconds": time.perf_counter() - t_phase})
    return results, bounce, launches


def grid_kernel_entries(results, launches_by_path, keys):
    """The kernels line's entries of the grid closest-hit kernels (their
    float64 forms inside), timed on source rays at 2^20."""
    entries = []
    for kind in ("disk", "triangle"):
        name = f"{kind}_grid_nearest_hit"
        counted = name + ".launches"
        res = results[(kind, torch.float32, "source")]
        res64 = results[(kind, torch.float64, "source")]
        walk = ("cells_a_ray", "pairs_a_ray", "wasted_pairs_a_ray",
                "chunk_kernel_ms")
        big = results.get((kind, torch.float32, "disk1m_source"))
        entries.append({
            "name": name, "route": "cuda",
            "source": "viennaray_tpu_torch/csrc/grid_traverse.cu",
            "replaces": "viennaray_tpu/ops/grid_traverse.py:64",
            "launches": sum(n[counted] for n in launches_by_path.values()),
            "launches_by_path": {path: n[counted] for path, n in
                                 launches_by_path.items() if n[counted]},
            **{k: res[k] for k in keys + walk},
            "f64": {k: res64[k] for k in keys + walk},
            **({"disk1m": {k: big[k] for k in keys + walk}} if big else {}),
        })
    return entries


# ---- the per-bounce coherence resort ------------------------------------------
RESORT_LANES = 1 << 20
RESORT_AUX = 2  # an aux of two columns (an energy and a channel, say)
RESORT_REPS = 20


def resort_state(geometry, bbox, n, dtype, seed):
    """A state of ``n`` lanes as the resort meets it: interior rays of the
    geometry's box (``make_rays``), a tenth of them on the box's faces and
    on the poles and the equator of the sphere, a third dead, weights,
    flags and counts from the seed; and (n, 2) aux."""
    from viennaray_tpu_torch.ops.bounce import RayState

    org, dirn = make_rays(geometry, bbox, n, "interior", seed)
    gen = torch.Generator(device=geometry.device)
    gen.manual_seed(seed + 1)
    u = torch.rand((4, n), generator=gen, device=geometry.device)
    tenth = n // 10
    org[:tenth // 2] = bbox[0]
    org[tenth // 2:tenth] = bbox[1]
    dirn[:tenth // 3] = torch.tensor([0.0, 0.0, 1.0], device=dirn.device)
    dirn[tenth // 3:tenth] = torch.tensor([0.6, -0.6, 0.0],
                                          device=dirn.device)
    org, dirn = org.to(dtype).contiguous(), dirn.to(dtype).contiguous()
    state = RayState(
        org, dirn, u[0].to(dtype), u[1].to(dtype), u[2] > 1.0 / 3.0,
        u[3] < 0.1, (u[3] * 7).to(torch.int32), (u[2] * 5).to(torch.int32))
    aux = torch.rand((n, RESORT_AUX), generator=gen, device=geometry.device,
                     dtype=dtype)
    return state, aux


def check_coherence_key(geometry, bbox, dtype, dirbins, lanes=RESORT_LANES,
                        offset=0):
    """The resort's key kernel against its plain version on ``lanes`` lanes
    (2^20 by default), bit for bit, timed on the device alone (``ms``) and
    as the host issues it (``issued_ms``); the bound is its bytes (org and
    dir read, alive read, the key written). ``offset``: the state made
    ``offset`` lanes longer and viewed from that lane on, so that its arrays
    are not aligned for the kernel's quads of lanes."""
    from viennaray_tpu_torch.ops import permute as PM

    state, _ = resort_state(geometry, bbox, lanes + offset, dtype, seed=31)
    lo = bbox[0].to(dtype).contiguous()
    ext = torch.clamp(bbox[1] - bbox[0], min=1e-6).to(dtype).contiguous()
    args = (state.org[offset:], state.dirn[offset:], state.alive[offset:],
            lo, ext, dirbins)
    got = PM.coherence_key(*args)
    want = PM.coherence_key_ref(*args)
    torch.cuda.synchronize()
    equal = bool(torch.equal(got, want))
    word = 8 if dtype == F64 else 4
    n_bytes = lanes * (6 * word + 1 + 4)
    res = {
        "phase": "kernel_check",
        "kernel": "coherence_key" + ("_f64" if dtype == F64 else ""),
        "shape": f"R={lanes}, offset={offset}, dirbins={dirbins}, "
                 f"{geometry.kind}s' box",
        "tolerance": "keys equal bit for bit",
        "bitwise_equal": equal,
        "max_abs_err": float((got - want).abs().max()),
        "distinct_keys": int(torch.unique(got).numel()),
        "ms": device_ms(lambda: PM.coherence_key(*args), RESORT_REPS),
        "issued_ms": time_cuda(lambda: PM.coherence_key(*args), RESORT_REPS),
        "plain_ms": time_cuda(lambda: PM.coherence_key_ref(*args),
                              RESORT_REPS),
        "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None,
    }
    emit(res)
    if not equal:
        raise RuntimeError(f"coherence_key disagrees: {res}")
    return res


def check_permute_state(geometry, bbox, dtype, n_take, with_aux):
    """The permutation kernel against its plain version (one indexing op an
    array) at 2^20 lanes, ``n_take`` of them taken (a permutation, or a
    compaction's first half), with and without aux, bit for bit, timed
    beside the ``index_select`` calls the one launch replaces; the bound is
    its bytes (take, and each row read once and written once)."""
    from viennaray_tpu_torch.ops import permute as PM

    state, aux = resort_state(geometry, bbox, RESORT_LANES, dtype, seed=37)
    aux = aux if with_aux else None
    gen = torch.Generator(device=geometry.device)
    gen.manual_seed(41)
    take = torch.randperm(RESORT_LANES, generator=gen,
                          device=geometry.device)[:n_take]
    got, got_aux = PM.permute_state(take, state, aux)
    want, want_aux = PM.permute_state_ref(take, state, aux)
    torch.cuda.synchronize()
    pairs = list(zip(got, want)) + ([(got_aux, want_aux)] if with_aux else [])
    equal = all(bool(torch.equal(a, b)) for a, b in pairs)
    arrays = list(state) + ([aux] if with_aux else [])

    def index_select():
        return [x.index_select(0, take) for x in arrays]

    row = sum(x[0].numel() * x.element_size() for x in arrays)
    n_bytes = n_take * (8 + 2 * row)
    res = {
        "phase": "kernel_check",
        "kernel": "permute_state" + ("_f64" if dtype == F64 else ""),
        "shape": f"R={RESORT_LANES}, take {n_take}, "
                 f"aux {RESORT_AUX if with_aux else 0}, {row} bytes a row",
        "tolerance": "every array equal bit for bit",
        "bitwise_equal": equal,
        "max_abs_err": max(float((a.double() - b.double()).abs().max())
                           for a, b in pairs),
        "ms": time_cuda(lambda: PM.permute_state(take, state, aux),
                        RESORT_REPS),
        "plain_ms": time_cuda(lambda: PM.permute_state_ref(take, state, aux),
                              RESORT_REPS),
        "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": time_cuda(index_select, RESORT_REPS),
    }
    emit(res)
    if not equal:
        raise RuntimeError(f"permute_state disagrees: {res}")
    return res


def resort_apply(geometry, bounce_sort, seed):
    """One apply of ``TraceDisk`` on ``geometry`` (disk18k's physics, 200
    rays per point) with the resort asked for or not, after a warm-up apply
    (so the timed one is run number 2), the registry's counts read just
    before and just after: (normalized flux, fields, launches)."""
    import dataclasses

    import viennaray_tpu_torch as vrt
    from viennaray_tpu_torch.trace.kernel import grid_for

    tracer = vrt.TraceDisk(dim=3, bounce_sort=bounce_sort)
    tracer.geometry = geometry
    configure(tracer, GRID_RAYS_PER_POINT)
    tracer.set_rng_seed(seed)
    tracer.apply()
    before = dict(telemetry.COUNTS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flux = tracer.apply()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    info = dataclasses.asdict(tracer.get_ray_trace_info())
    launches = launches_since(before)
    return np.asarray(tracer.normalize_flux(flux), np.float64), {
        "bounce_sort": bounce_sort, "seed": seed, "seconds": seconds,
        "search": "chunks" if grid_for(geometry, tracer._make_config())
        is None else "grid",
        "counters": {k: info[k] for k in INFO_COUNTERS},
        "geometry_hits_per_ray": info["geometry_hits"] / info["num_rays"],
        "search_steps_a_search": info["chunks_swept"]
        / max(info["tile_bounces"], 1),
        "launches": {k: v for k, v in launches.items() if v},
    }, launches


# the float64 resort run: the triangle flagship at this many rays per
# triangle (184,320 rays, batches of 2^18)
RESORT_F64_RAYS = 32


def phase_resort_path(pts, nrm, verts, tris, disk_launches, tri_launches):
    """The per-bounce coherence resort (``ops/permute.py``,
    ``trace/kernel.py:resort``), which the tracers run only when asked
    (``bounce_sort=True``; ``trace/kernel.py:BOUNCE_SORT``): its key and the
    state's permutation against their plain versions at 2^20 lanes, bit for
    bit, in float32 and float64 (the key at 8, 32 and 64 bins; the
    permutation with and without aux, taking 2^20 and 2^19 lanes), each
    timed beside its plain version and its bytes bound (the permutation also
    beside ``index_select`` per array). Then the flagships with the resort
    asked for: the triangle flagship (12 chunks: it resorts, a key before
    every launch, where its default run, ``tri_launches``, keys only its
    compactions) against its oracle golden and hits per ray, two same-seed
    runs and the run at one thread per ray bit for bit (``run_path``); the
    disk flagship (6 chunks: the gate is off) launching exactly what its
    default run did (``disk_launches``), against its goldens; the triangle
    flagship in float64 through ``trace_unfused`` with the resort (the
    float64 forms launched, a key before every bounce; finite flux, hits per
    ray within 2 % of the oracle's). Then disk18k (18,180 disks, 200 rays per point) with the
    resort on its grid and on the chunk search, bit for bit, and without the
    resort on the same seed and on another: the resort changes which lane
    meets which uniform, so its flux is another sample, held to 1.45 times
    the two seeds' rel-L2 (``PERF.md`` §2's rule), its hits per ray to 2 %.
    Returns (kernel results, launches by path)."""
    from viennaray_tpu_torch.geometry.disk_geometry import DiskGeometry
    from viennaray_tpu_torch.geometry.triangle_geometry import TriangleGeometry
    from viennaray_tpu_torch.io import fixtures

    t_phase = time.perf_counter()
    mesh = TriangleGeometry.build(verts, tris, FLAGSHIP["grid_delta"])
    box = adjusted_bbox(mesh)
    results = {}
    for dtype in (torch.float32, F64):
        for dirbins in (8, 32, 64):
            results[("key", dtype, dirbins)] = check_coherence_key(
                mesh, box, dtype, dirbins)
            # lanes past the last quad of four; a view at an offset
            results[("key_tail", dtype, dirbins)] = check_coherence_key(
                mesh, box, dtype, dirbins, lanes=RESORT_LANES - 3)
            results[("key_offset", dtype, dirbins)] = check_coherence_key(
                mesh, box, dtype, dirbins, offset=1)
        for n_take, with_aux in ((RESORT_LANES, False), (RESORT_LANES, True),
                                 (RESORT_LANES // 2, True)):
            results[("permute", dtype, n_take, with_aux)] = (
                check_permute_state(mesh, box, dtype, n_take, with_aux))
    del mesh

    launches = {}
    golden, record, tol = oracle_golden("tri3d_trench_oracle")
    _, launches["triangles_resort"], _ = run_path(
        {"geometry": "triangles", "body": "fused", "bounce_sort": True},
        functools.partial(make_tri_tracer, verts, tris, bounce_sort=True),
        {"rel_l2_oracle": golden}, tol, (BOUNCE, *SORTS), record,
        same_seed=True)
    _, launches["disks_resort"], _ = run_path(
        {"geometry": "disks", "body": "fused", "bounce_sort": True},
        functools.partial(make_tracer, pts, nrm, bounce_sort=True),
        disk_goldens(), GOLDEN_TOL, (BOUNCE, HIST, *SORTS))

    tracer64 = make_tri_tracer(verts, tris, rays_per_point=RESORT_F64_RAYS,
                               fused=False, bounce_sort=True)
    tracer64.apply()  # the areas
    before = dict(telemetry.COUNTS)
    flux64, counters64, seconds64 = trace_unfused(tracer64, F64,
                                                  bounce_sort=True)
    launches["triangles_f64_resort"] = launches_since(before)
    hits64 = counters64["geometry_hits"] / tracer64._make_config().total_rays(
        tracer64.geometry.num_primitives)
    f64_run = {"num_rays": tracer64._make_config().total_rays(len(tris)),
               "seconds": seconds64, "geometry_hits_per_ray": hits64,
               "oracle_geometry_hits_per_ray": record["geometry_hits_per_ray"],
               "launches": {k: v for k, v in
                            launches["triangles_f64_resort"].items() if v}}

    disks = DiskGeometry.build(*fixtures.create_trench_grid_3d(**GRID_FINE),
                               GRID_FINE["grid_delta"])
    sorted_norm, on, launches["disk18k_resort"] = resort_apply(
        disks, True, SEED)
    chunk_norm, on_chunks, launches["disk18k_chunks_resort"] = resort_apply(
        disks.replace(grid=None), True, SEED)
    plain_norm, off, launches["disk18k_no_resort"] = resort_apply(
        disks, False, SEED)
    other_norm, other, _ = resort_apply(disks, False, SEED + 7)
    apart = rel_l2(sorted_norm, plain_norm)
    noise = rel_l2(other_norm, plain_norm)
    hits_apart = abs(on["geometry_hits_per_ray"]
                     / off["geometry_hits_per_ray"] - 1)
    grid_chunks_equal = bool(np.array_equal(sorted_norm, chunk_norm)
                             and on["counters"] == on_chunks["counters"])
    def resorted(run, launch=BOUNCE):
        """A key before every launch (the resort's) besides the
        compactions'."""
        return run["coherence_key.launches"] >= run[launch] > 0

    res = {
        "phase": "resort_path", "nvidia_smi": card_name(),
        "triangle_launches": {k: {BOUNCE: n[BOUNCE], SORTS[1]: n[SORTS[1]]}
                              for k, n in (("default", tri_launches), (
                                  "resort", launches["triangles_resort"]))},
        "disks_resort_launches_equal_default":
            launches["disks_resort"] == disk_launches,
        "triangles_f64": f64_run,
        "disk18k": {"disks": disks.num_primitives, "resort": on,
                    "resort_chunk_search": on_chunks, "no_resort": off,
                    "no_resort_other_seed": other},
        "grid_and_chunks_bitwise_equal_with_resort": grid_chunks_equal,
        "rel_l2_resort_vs_no_resort": apart,
        "rel_l2_two_seeds": noise, "rel_l2_bound": 1.45 * noise,
        "hits_per_ray_apart": hits_apart,
        "seconds": time.perf_counter() - t_phase,
    }
    emit(res)
    f64_launched = launches["triangles_f64_resort"]
    ok = (resorted(launches["triangles_resort"]) and not resorted(tri_launches)
          and launches["disks_resort"] == disk_launches
          and f64_launched["coherence_key.launches_f64"]
          >= f64_launched["triangle_nearest_hit.launches_f64"] > 0
          and only_launched(f64_launched, "triangle_nearest_hit.launches_f64",
                            "histogram_launches_f64",
                            "permute_state.launches_f64",
                            "coherence_key.launches_f64")
          and np.isfinite(flux64).all() and flux64.max() > 0
          and abs(hits64 / record["geometry_hits_per_ray"] - 1) <= 0.02
          and resorted(launches["disk18k_resort"])
          and not resorted(launches["disk18k_no_resort"])
          and grid_chunks_equal
          and np.isfinite(sorted_norm).all() and sorted_norm.max() > 0
          and apart < 1.45 * noise and hits_apart <= 0.02)
    if not ok:
        raise RuntimeError(f"resort path failed its checks: {res}")
    return results, launches


def resort_kernel_entries(results, paths, keys):
    """The ``kernels`` line's entries of the resort's key and the state's
    permutation: launches by path over every main path (``paths``; the
    float64 forms' from the float64 paths), times at 2^20 lanes (the key at
    32 bins; the permutation of the whole state without aux, as the tracers
    run it)."""
    entries = []
    for name, replaces, res, res64, more in (
        ("coherence_key", "viennaray_tpu/trace/kernel.py:397",
         results[("key", torch.float32, 32)], results[("key", F64, 32)],
         {**{f"dirbins_{d}": results[("key", torch.float32, d)]
             for d in (8, 64)},
          "tail": results[("key_tail", torch.float32, 32)],
          "offset": results[("key_offset", torch.float32, 32)]}),
        ("permute_state", "viennaray_tpu/trace/kernel.py:431",
         results[("permute", torch.float32, RESORT_LANES, False)],
         results[("permute", F64, RESORT_LANES, False)],
         {"aux_2": results[("permute", torch.float32, RESORT_LANES, True)],
          "take_half_aux_2": results[("permute", torch.float32,
                                      RESORT_LANES // 2, True)]}),
    ):
        by_path = {p: n[f"{name}.launches"] for p, n in paths.items()
                   if n.get(f"{name}.launches")}
        by_path64 = {p: n[f"{name}.launches_f64"] for p, n in paths.items()
                     if n.get(f"{name}.launches_f64")}
        entries.append({
            "name": name, "route": "cuda",
            "source": "viennaray_tpu_torch/csrc/permute.cu",
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            **{k: res[k] for k in keys},
            **{label: {k: r[k] for k in keys} for label, r in more.items()},
            "f64": {**{k: res64[k] for k in keys},
                    "launches": sum(by_path64.values()),
                    "launches_by_path": by_path64},
        })
    return entries


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device and found none",
              file=sys.stderr)
        return 1
    from viennaray_tpu_torch.geometry.disk_geometry import DiskGeometry
    from viennaray_tpu_torch.geometry.line_geometry import LineGeometry
    from viennaray_tpu_torch.geometry.triangle_geometry import TriangleGeometry
    from viennaray_tpu_torch.io import fixtures
    from viennaray_tpu_torch.ops import bounce as B
    from viennaray_tpu_torch.ops.histogram import SMALL_ENTRIES

    phase_card()
    phase_build()
    phase_host_build()
    nbr = phase_neighborhood()

    pts, nrm = fixtures.create_trench_grid_3d(**FLAGSHIP)
    # no device named: the CUDA device, as a user's call would get it
    before = dict(telemetry.COUNTS)
    geometry = DiskGeometry.build(pts, nrm, FLAGSHIP["grid_delta"])
    nbr_flagship = launches_since(before)
    if (nbr_flagship["build_neighborhood_cuda.launches"],
            nbr_flagship["build_neighborhood_cuda.launches_f64"]) != (4, 0):
        raise RuntimeError(f"the flagship's build launched {nbr_flagship}")
    bbox = adjusted_bbox(geometry)

    hit_wide = check_nearest_hit(geometry, bbox, 1 << 20, "source", reps=10)
    check_nearest_hit(geometry, bbox, 1 << 20, "interior", reps=10)
    check_nearest_hit(geometry, bbox, 512, "interior", reps=200)
    check_nearest_hit(geometry, bbox, 1000, "interior", reps=200)  # ragged R
    hist_wide = check_histogram(geometry, 1 << 20, len(pts), reps=20)
    # kernel 2's two paths: 6,144 entries (a 512-ray bounce of the unfused
    # body), 65,536 and 2^20, beside index_add_; and one entry either side
    # of the threshold, where both paths must give the same bits
    hist_small = check_histogram(geometry, 512, len(pts), reps=200)
    hist_mid = check_histogram(geometry, 1 << 20, len(pts), reps=200,
                               n_entries=65536)
    check_histogram(geometry, 1 << 20, len(pts), reps=100, n_entries=1 << 20)
    hist_edge = {n_entries: check_histogram(geometry, 1 << 20, len(pts),
                                            reps=50, n_entries=n_entries)
                 for n_entries in (SMALL_ENTRIES - 1, SMALL_ENTRIES + 1)}
    hist_18k = check_histogram(geometry, 1 << 20, 18180, reps=20)
    # the small path on disk18k's bins (the unfused body's narrow bounces
    # there), at 6,144 entries and one below the threshold
    hist_small_18k = check_histogram(geometry, 512, 18180, reps=200)
    hist_edge_18k = check_histogram(geometry, 1 << 20, 18180, reps=50,
                                    n_entries=SMALL_ENTRIES - 1)
    # the large path's cluster branch at C = 16 (300,000 bins, 18,750 a
    # block), and disk1m's shape on the global branch: 2^20 rays x (K + 1)
    # = 43 entries on 704,250 bins
    hist_c16 = check_histogram(geometry, 1 << 20, 300_000, reps=20)
    hist_1m = check_histogram(geometry, 1 << 20, 704_250, reps=10, slots=43)
    # the histogram's backward at the gradient path's shape: 2^19 rays x
    # (K + 1) = 12 entries
    hist_grad = check_histogram_grad(geometry, 1 << 19, reps=50)
    flagship = bounce_settings()
    mirror = bounce_settings(specular=True, walls="REFLECTIVE")
    bounce_wide = check_bounce(
        geometry, bbox, 1 << 20, "source", 1, False, flagship, reps=10)
    check_bounce(geometry, bbox, 1 << 20, "interior", 1, False, flagship,
                 reps=10)
    check_bounce(geometry, bbox, 16384, "interior", 4, True, flagship,
                 reps=50)
    disk_tail = check_bounce(geometry, bbox, 512, "interior", 16, True,
                             flagship, reps=100)
    check_bounce(geometry, bbox, 1000, "interior", 16, True, flagship,
                 reps=100)  # ragged R
    check_bounce(geometry, bbox, 65536, "interior", 1, True, mirror, reps=50)
    # the 18,180-disk trench: chunks of 1,024 lanes, two staged tiles each
    fine = dict(FLAGSHIP, grid_delta=0.1)
    fine_geometry = DiskGeometry.build(
        *fixtures.create_trench_grid_3d(**fine), fine["grid_delta"]
    )
    fine_bbox = adjusted_bbox(fine_geometry)
    check_nearest_hit(fine_geometry, fine_bbox, 65536, "interior", reps=5)
    fine_mid = check_bounce(fine_geometry, fine_bbox, 16384, "interior", 4,
                            True, flagship, reps=5)
    flat, flat_bbox = trench_2d()
    flat_ignore = bounce_settings(walls="IGNORE", dim=2)
    flat_mirror = bounce_settings(specular=True, walls="REFLECTIVE", dim=2)
    check_bounce(flat, flat_bbox, 4096, "flat", 4, True, flat_ignore, reps=50)
    check_bounce(flat, flat_bbox, 4096, "flat", 4, True, flat_mirror, reps=50)
    # the ion's coned-cosine reflection and gas scattering on the flagship's
    # disks, and sticking per lane (two materials)
    ion = bounce_settings(particle=ion_particle())
    gas = bounce_settings(particle=gas_particle())
    ion_bounce_wide = check_bounce(
        geometry, bbox, 1 << 20, "source", 1, True, ion, reps=10)
    check_bounce(geometry, bbox, 512, "interior", 16, True, ion, reps=100)
    check_bounce(geometry, bbox, 65536, "interior", 1, True, gas, reps=20)
    check_bounce(geometry, bbox, 4096, "interior", 4, True, gas, reps=50)
    two_materials = geometry.replace(material_ids=(
        torch.arange(len(pts), device=geometry.device) % 2).to(torch.int32))
    check_bounce(two_materials, bbox, 65536, "interior", 1, False, flagship,
                 reps=20, particle=line_particle())
    # the window form: the window flux model's deposits in the kernel (the
    # trace's only placement) at every width, handed out at 2^20 x 1 (the
    # placement chip_diagnose.py --window weighs), the 2D trench, the
    # 18,180-disk trench, and the kFull instantiation (coned-cosine)
    window = bounce_settings(flux_model="window")
    windowed = geometry.with_window_list()
    window_bounce_wide = check_bounce(
        windowed, bbox, 1 << 20, "source", 1, True, window, reps=10)
    check_bounce(windowed, bbox, 1 << 20, "interior", 1, False, window,
                 reps=10)
    check_bounce(windowed, bbox, 16384, "interior", 4, True, window, reps=50)
    window_tail = check_bounce(windowed, bbox, 512, "interior", 16, True,
                               window, reps=100)
    check_bounce(windowed, bbox, 1000, "interior", 16, True, window,
                 reps=100)  # ragged R
    check_bounce(flat, flat_bbox, 4096, "flat", 4, True,
                 flat_ignore._replace(window=True), reps=50)
    check_bounce(fine_geometry, fine_bbox, 16384, "interior", 4, True, window,
                 reps=5)
    ion_window = ion._replace(window=True)
    check_bounce(windowed, bbox, 1 << 20, "source", 1, True, ion_window,
                 reps=10)
    check_bounce(windowed, bbox, 512, "interior", 16, True, ion_window,
                 reps=100)

    # ---- triangles: 5,760 in 12 chunks of 512 lanes ------------------------
    verts, tris = fixtures.create_trench_mesh_3d(**FLAGSHIP)
    mesh = TriangleGeometry.build(verts, tris, FLAGSHIP["grid_delta"])
    mesh_bbox = adjusted_bbox(mesh)
    tri_hit_wide = check_nearest_hit(mesh, mesh_bbox, 1 << 20, "source",
                                     reps=5)
    check_nearest_hit(mesh, mesh_bbox, 1 << 20, "interior", reps=5)
    check_nearest_hit(mesh, mesh_bbox, 512, "interior", reps=100)
    check_nearest_hit(mesh, mesh_bbox, 1000, "interior", reps=100)  # ragged R
    check_histogram(mesh, 1 << 20, len(tris), reps=20)
    tri_bounce_wide = check_bounce(
        mesh, mesh_bbox, 1 << 20, "source", 1, False, flagship, reps=5)
    check_bounce(mesh, mesh_bbox, 1 << 20, "interior", 1, False, flagship,
                 reps=5)
    check_bounce(mesh, mesh_bbox, 1 << 20, "source", 1, True, flagship,
                 reps=5)
    check_bounce(mesh, mesh_bbox, 16384, "interior", 4, True, flagship,
                 reps=20)
    tri_tail = check_bounce(mesh, mesh_bbox, 512, "interior", 16, True,
                            flagship, reps=50)
    check_bounce(mesh, mesh_bbox, 1000, "interior", 16, True, flagship,
                 reps=50)  # ragged R
    check_bounce(mesh, mesh_bbox, 65536, "interior", 1, True, mirror, reps=20)
    # the 9,000-triangle trench: chunks of 1,024 lanes, two staged tiles each
    mid = dict(FLAGSHIP, grid_delta=0.2)
    mid_mesh = TriangleGeometry.build(
        *fixtures.create_trench_mesh_3d(**mid), mid["grid_delta"]
    )
    check_nearest_hit(mid_mesh, adjusted_bbox(mid_mesh), 65536, "interior",
                      reps=5)
    # a 2D line mesh extruded to triangles, as TraceTriangle(dim=2) builds it
    ribbon, ribbon_bbox = trench_2d_lines()
    check_bounce(ribbon, ribbon_bbox, 4096, "flat", 4, True, flat_ignore,
                 reps=50)
    check_bounce(ribbon, ribbon_bbox, 4096, "flat", 4, True, flat_mirror,
                 reps=50)
    check_bounce(mesh, mesh_bbox, 1 << 20, "source", 1, True, ion, reps=5)
    check_bounce(mesh, mesh_bbox, 512, "interior", 16, True, ion, reps=50)
    check_bounce(mesh, mesh_bbox, 65536, "interior", 1, True, gas, reps=10)
    check_bounce(mesh, mesh_bbox, 4096, "interior", 4, True, gas, reps=20)

    # ---- lines: 782 segments in 2 chunks of 512 lanes, two materials. Every
    # ray of these checks starts exactly on z = 0 with dz = 0, against chunk
    # boxes whose z interval is [-1, 1]: the search's z slab stays finite
    line_mesh, line_materials = line_trench()
    lines = LineGeometry.from_mesh(line_mesh, material_ids=line_materials)
    lines_bbox = adjusted_bbox(lines, dim=2)
    line_hit_wide = check_nearest_hit(lines, lines_bbox, 1 << 20,
                                      "flat_source", reps=10)
    check_nearest_hit(lines, lines_bbox, 1 << 20, "flat", reps=10)
    check_nearest_hit(lines, lines_bbox, 1000, "flat", reps=100)  # ragged R
    check_histogram(lines, 1 << 20, lines.num_primitives, reps=20)
    table = line_particle()
    line_diffuse = bounce_settings(dim=2, particle=table)
    line_mirror = bounce_settings(specular=True, walls="REFLECTIVE", dim=2)
    line_gas = bounce_settings(dim=2, particle=gas_particle())
    line_bounce_wide = check_bounce(
        lines, lines_bbox, 1 << 20, "flat_source", 1, True, line_diffuse,
        reps=10, particle=table)
    check_bounce(lines, lines_bbox, 1 << 20, "flat", 1, False, line_diffuse,
                 reps=10, particle=table)
    check_bounce(lines, lines_bbox, 16384, "flat", 4, True, line_diffuse,
                 reps=50, particle=table)
    line_tail = check_bounce(lines, lines_bbox, 512, "flat", 16, True,
                             line_diffuse, reps=100, particle=table)
    check_bounce(lines, lines_bbox, 1000, "flat", 16, True, line_diffuse,
                 reps=100, particle=table)  # ragged R
    check_bounce(lines, lines_bbox, 1 << 20, "flat", 1, True, line_mirror,
                 reps=10, particle=table)
    check_bounce(lines, lines_bbox, 512, "flat", 16, True, line_mirror,
                 reps=100, particle=table)
    check_bounce(lines, lines_bbox, 65536, "flat", 1, True, line_gas, reps=20)
    check_bounce(lines, lines_bbox, 4096, "flat", 4, True, line_gas, reps=50)
    check_bounce(lines, lines_bbox, 4096, "flat", 4, True,
                 bounce_settings(dim=2, particle=ion_particle()), reps=50)

    # ---- the closest-hit kernels' warp per ray and reject: every width of
    # the unfused ladder on every ray kind; then one batch past 2^27 rays
    for geom, box, kinds in (
        (geometry, bbox, ("source", "interior", "ties", "rims")),
        (mesh, mesh_bbox, ("source", "interior", "ties", "rims")),
        (lines, lines_bbox, ("flat_source", "flat")),
    ):
        for kind in kinds:
            check_search_widths(geom, box, kind)
    for geom in (fine_geometry, mid_mesh):
        check_search_widths(geom, adjusted_bbox(geom), "interior",
                            (512, 65536))
    check_search_wide_index(geometry, bbox)

    # ---- kernel 4's group mapping: the narrow and mid widths of the ladder
    # (and one wide one) on every kind, both kFull values, the window form
    # and tie-heavy rays; then every instantiated G at one shape per kind
    group_shapes = ((512, 16), (1000, 16), (2048, 16), (16384, 4), (65536, 1))
    for geom, box, rays, settings, particle in (
        (geometry, bbox, "interior", flagship, None),
        (geometry, bbox, "interior", ion, None),
        (geometry, bbox, "ties", flagship, None),
        (windowed, bbox, "interior", window, None),
        (windowed, bbox, "interior", ion_window, None),
        (windowed, bbox, "ties", window, None),
        (mesh, mesh_bbox, "interior", flagship, None),
        (mesh, mesh_bbox, "interior", gas, None),
        (mesh, mesh_bbox, "ties", flagship, None),
        (lines, lines_bbox, "flat", line_diffuse, table),
        (lines, lines_bbox, "flat", line_gas, None),
        (flat, flat_bbox, "flat", flat_ignore, None),
    ):
        for n_rays, n_sub in group_shapes:
            check_bounce(geom, box, n_rays, rays, n_sub, True, settings,
                         reps=1, particle=particle, time_plain=False)
    for geom, box, rays, settings, particle in (
        (geometry, bbox, "interior", flagship, None),
        (windowed, bbox, "interior", window, None),
        (mesh, mesh_bbox, "interior", flagship, None),
        (lines, lines_bbox, "flat", line_diffuse, table),
    ):
        for g in B.GROUPS:
            check_bounce(geom, box, 2048, rays, 16, True, settings, reps=3,
                         particle=particle, group=g, time_plain=False)

    grid_hits, grid_bounce, grid_launches_by_path = phase_grid_path()

    torch.cuda.reset_peak_memory_stats()
    launches, unfused_launches, neighbor_norm = phase_disk_paths(pts, nrm)
    tri_launches, tri_unfused_launches = phase_triangle_paths(verts, tris)
    resort_results, resort_launches = phase_resort_path(
        pts, nrm, verts, tris, launches, tri_launches)
    line_launches, line_unfused_launches = phase_line_paths()
    ion_launches, ion_unfused_launches = phase_ion_paths(pts, nrm)
    gas_launches = phase_gas_path(pts, nrm)
    window_launches, window_unfused_launches = phase_window_paths(
        pts, nrm, neighbor_norm)
    wdist_launches = phase_wdist_path(pts, nrm)
    grid_launches, surface_launches = phase_source_paths(pts, nrm)
    disk2d_launches, disk2d_unfused_launches = phase_disk2d_paths()
    hooks = phase_hook_paths(pts, nrm, verts, tris)
    sharded_launches, sharded_grad_launches = phase_sharded_path(pts, nrm)
    emit({"phase": "peak_memory",
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
    grad = phase_grad_paths(pts, nrm, verts, tris)
    f64_kernels, f64_narrow, f64 = phase_f64_paths(pts, nrm, verts, tris)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape")
    # every main path's launches, for the kernels that run on nearly all
    main_paths = {
        "disks": launches, "disks_unfused": unfused_launches,
        "triangles": tri_launches, "triangles_unfused": tri_unfused_launches,
        "lines": line_launches, "lines_unfused": line_unfused_launches,
        "ion": ion_launches, "ion_unfused": ion_unfused_launches,
        "gas": gas_launches, "window": window_launches,
        "window_unfused": window_unfused_launches, "wdist": wdist_launches,
        "grid_source": grid_launches, "surface": surface_launches,
        "disk2d": disk2d_launches, "disk2d_unfused": disk2d_unfused_launches,
        **hooks, "sharded": sharded_launches,
        **{f"grid_{name}": n for name, n in grid_launches_by_path.items()},
        **resort_launches,
    }
    emit({"kernels": [
        {
            "name": "disk_nearest_hit", "route": "cuda",
            "source": "viennaray_tpu_torch/csrc/nearest_hit.cu",
            "replaces": "viennaray_tpu/ops/pallas_intersect.py:166",
            # the default path is fused and never reaches it: its count is
            # the unfused paths' runs and the wdist run's
            "launches": unfused_launches[DISK]
            + ion_unfused_launches[DISK]
            + window_unfused_launches[DISK]
            + wdist_launches[DISK]
            + disk2d_unfused_launches[DISK]
            + sum(n[DISK] for n in hooks.values())
            + sum(n[DISK] for n in grad.values())
            + sharded_grad_launches[DISK],
            "launches_by_path": {
                "disks_unfused": unfused_launches[DISK],
                "ion_unfused": ion_unfused_launches[DISK],
                "window_unfused": window_unfused_launches[DISK],
                "wdist": wdist_launches[DISK],
                "disk2d_unfused":
                    disk2d_unfused_launches[DISK],
                **{name: n[DISK] for name, n in hooks.items()
                   if n[DISK]},
                **{name: n[DISK] for name, n in grad.items()
                   if n[DISK]},
                "sharded_grad": sharded_grad_launches[DISK],
            },
            **{k: hit_wide[k] for k in keys},
        },
        {
            "name": "flux_histogram", "route": "cuda",
            "source": "viennaray_tpu_torch/csrc/flux_histogram.cu",
            "replaces": "viennaray_tpu/ops/pallas_histogram.py:39",
            "launches": launches[HIST],
            "launches_by_path": {
                "disks": launches[HIST],
                "disks_unfused": unfused_launches[HIST],
                "triangles": tri_launches[HIST],
                "triangles_unfused": tri_unfused_launches[HIST],
                "lines": line_launches[HIST],
                "lines_unfused": line_unfused_launches[HIST],
                "ion": ion_launches[HIST],
                "ion_unfused": ion_unfused_launches[HIST],
                "window": window_launches[HIST],
                "window_unfused": window_unfused_launches[HIST],
                "wdist": wdist_launches[HIST],
                "grid": grid_launches[HIST],
                "surface": surface_launches[HIST],
                "disk2d_unfused": disk2d_unfused_launches[HIST],
                **{name: n[HIST] for name, n in hooks.items()},
                **{name: n[HIST] for name, n in grad.items()},
                "sharded": sharded_launches[HIST],
                "sharded_grad": sharded_grad_launches[HIST],
            },
            # two paths of one kernel (ops/histogram.py:path_for): one
            # cluster below the threshold of entries, the whole card above
            "paths": {"small": f"E < {SMALL_ENTRIES}", "large": "else"},
            **{k: hist_wide[k] for k in keys},
            # the large path's branches (ops/histogram.py:cluster_for): the
            # bins in a cluster's shared memory where they fit, else global
            "branches": {"cluster": "cluster_for(n) > 0", "global": "else"},
            "ms_by_branch": hist_wide["ms_by_branch"],
            **{name: {k: res[k] for k in keys + ("path", "branch",
                                                "small_cluster",
                                                "ms_by_branch")}
               for name, res in (("E_6144", hist_small),
                                 (f"E_{SMALL_ENTRIES - 1}",
                                  hist_edge[SMALL_ENTRIES - 1]),
                                 (f"E_{SMALL_ENTRIES + 1}",
                                  hist_edge[SMALL_ENTRIES + 1]),
                                 ("E_6144_n_18180", hist_small_18k),
                                 (f"E_{SMALL_ENTRIES - 1}_n_18180",
                                  hist_edge_18k),
                                 ("E_65536", hist_mid),
                                 ("n_18180", hist_18k),
                                 ("n_300000", hist_c16),
                                 ("disk1m_shape", hist_1m))},
        },
        {
            # kernel 2's backward: the gradient of the weights, a gather. The
            # JAX package has no TPU kernel for it: XLA transposes its
            # one-hot contraction
            "name": "flux_histogram_grad", "route": "cuda",
            "source": "viennaray_tpu_torch/csrc/flux_histogram.cu",
            "replaces": "viennaray_tpu/trace/kernel.py:161",
            "launches": grad["grad"][HIST_GRAD],
            "launches_by_path": {
                **{name: n[HIST_GRAD]
                   for name, n in grad.items()},
                "sharded_grad": sharded_grad_launches[HIST_GRAD]},
            **{k: hist_grad[k] for k in keys},
        },
        *f64_kernel_entries(f64_kernels, f64_narrow, f64, keys),
        {
            "name": "triangle_nearest_hit", "route": "cuda",
            "source": "viennaray_tpu_torch/csrc/nearest_hit.cu",
            "replaces": "viennaray_tpu/ops/pallas_intersect.py:359",
            # as for disks: the unfused triangle path's run, and the hooked
            # triangle run's
            "launches": tri_unfused_launches[TRI]
            + hooks["two_channels_builtin_reimplemented_triangles"][
                TRI]
            + grad["grad_triangles"][TRI],
            "launches_by_path": {
                "triangles_unfused": tri_unfused_launches[TRI],
                "two_channels_builtin_reimplemented_triangles": hooks[
                    "two_channels_builtin_reimplemented_triangles"][
                    TRI],
                "grad_triangles": grad["grad_triangles"][
                    TRI],
            },
            **{k: tri_hit_wide[k] for k in keys},
        },
        {
            # the line instantiation of the same template; the JAX package
            # runs this search in XLA, not in a TPU kernel
            "name": "line_nearest_hit", "route": "cuda",
            "source": "viennaray_tpu_torch/csrc/nearest_hit.cu",
            "replaces": "viennaray_tpu/ops/intersect.py:172",
            "launches": line_unfused_launches[LINE]
            + hooks["two_channels_builtin_reimplemented_lines"][
                LINE],
            "launches_by_path": {
                "lines_unfused": line_unfused_launches[LINE],
                "two_channels_builtin_reimplemented_lines": hooks[
                    "two_channels_builtin_reimplemented_lines"][
                    LINE],
            },
            **{k: line_hit_wide[k] for k in keys},
        },
        *grid_kernel_entries(grid_hits, grid_launches_by_path, keys),
        *resort_kernel_entries(resort_results, {**main_paths, **f64}, keys),
        {
            # the disk neighbor table: the JAX package builds it on the host
            # (its compiled helper); a CUDA DiskGeometry.build builds it here
            "name": "neighborhood", "route": "cuda",
            "source": "viennaray_tpu_torch/csrc/neighborhood.cu",
            "replaces": "viennaray_tpu/geometry/neighborhood.py:16",
            "launches": nbr["launches"]["build_neighborhood_cuda.launches"]
            + nbr_flagship["build_neighborhood_cuda.launches"],
            "launches_by_path": {
                "disk1m_build":
                    nbr["launches"]["build_neighborhood_cuda.launches"],
                "flagship_build":
                    nbr_flagship["build_neighborhood_cuda.launches"]},
            **{k: nbr[k] for k in keys},
            "plain": "the host helper (native/host_accel.cpp), host clock",
            "ops_bound_ms": nbr["ops_bound_ms"],
            "bytes_bound_ms": nbr["bytes_bound_ms"],
        },
        {
            "name": "fused_bounce", "route": "cuda",
            "source": "viennaray_tpu_torch/csrc/bounce.cu",
            "replaces": "viennaray_tpu/ops/pallas_bounce.py:1056",
            # every instantiation: the applies of the disk, triangle, line
            # and ion configurations, the gas run, the window flagship and
            # the grid and surface sources' runs
            "launches": launches[BOUNCE] + tri_launches[BOUNCE]
            + line_launches[BOUNCE] + ion_launches[BOUNCE]
            + gas_launches[BOUNCE] + window_launches[BOUNCE]
            + grid_launches[BOUNCE] + surface_launches[BOUNCE]
            + disk2d_launches[BOUNCE]
            + sum(n[BOUNCE] for n in hooks.values())
            + sharded_launches[BOUNCE],
            # the threads per ray G (ops/bounce.py:group_for), and the G
            # values instantiated
            "groups": {
                "32": f"R < {B.GROUP_BELOW_WIDTH} or chunks >= "
                      f"{B.GROUP_ALL_WIDTHS_CHUNKS}",
                "1": "else"},
            "groups_instantiated": list(B.GROUPS),
            "launches_by_path": {
                "disks": launches[BOUNCE],
                "triangles": tri_launches[BOUNCE],
                "lines": line_launches[BOUNCE],
                "ion": ion_launches[BOUNCE],
                "gas": gas_launches[BOUNCE],
                "window": window_launches[BOUNCE],
                "grid": grid_launches[BOUNCE],
                "surface": surface_launches[BOUNCE],
                "disk2d": disk2d_launches[BOUNCE],
                **{name: n[BOUNCE] for name, n in hooks.items()
                   if n[BOUNCE]},
                "sharded": sharded_launches[BOUNCE],
            },
            **{k: bounce_wide[k] for k in keys},
            "triangles": {k: tri_bounce_wide[k] for k in keys},
            "lines": {k: line_bounce_wide[k] for k in keys},
            "ion": {k: ion_bounce_wide[k] for k in keys},
            "window": {k: window_bounce_wide[k] for k in keys},
            # the grid search (kernel 4 walking the uniform grid): its
            # launches on the grid paths, and its times beside the chunk
            # search's on the same state
            "grid": {
                "launches": sum(n[GRID]
                                for n in grid_launches_by_path.values()),
                "launches_by_path": {
                    name: n[GRID]
                    for name, n in grid_launches_by_path.items()
                    if n[GRID]},
                "ms": {f"{geo}_{r}x{k}": {
                    "grid_ms": res[True]["grid_ms"],
                    "chunk_ms": res[True]["chunk_ms"],
                    "cells_a_search": res[True]["cells_a_search"],
                    "grid_bound_ms": res[True]["grid_bound_ms"],
                    "grid_bound_by": res[True]["grid_bound_by"],
                    "chunk_bound_ms": res[True]["chunk_bound_ms"]}
                    for (geo, r, k), res in grid_bounce.items()},
            },
            # the tail's launches, which the group mapping serves
            "narrow": {name: {k: res[k] for k in keys + ("group",)}
                       for name, res in (
                           ("disks_512x16", disk_tail),
                           ("window_512x16", window_tail),
                           ("triangles_512x16", tri_tail),
                           ("lines_512x16", line_tail),
                           ("disks_18180_16384x4", fine_mid))},
        },
    ]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
