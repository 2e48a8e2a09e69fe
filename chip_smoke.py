#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It imports only ``viennaray_tpu_torch`` and, in order:

1. prints the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and asserts that TF32 matrix products are off;
2. builds the CUDA kernels from ``viennaray_tpu_torch/csrc`` with ``nvcc``;
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
   histogram kernel's two paths bit for bit against each other (one entry
   either side of the threshold too); and times kernel, plain version and,
   for the histogram, one ``index_add_`` call (at 6,144, 65,536, 2^20 and
   12,582,912 entries);
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
12. prints the peak device memory;
13. drives the differentiable trace (``phase_grad_paths``,
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
import subprocess
import sys
import time

import numpy as np
import torch

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


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    emit({
        "phase": "card", "nvidia_smi": smi, "torch": torch.__version__,
        "cuda": torch.version.cuda, "allow_tf32": allow_tf32,
    })
    if allow_tf32:
        raise RuntimeError("TF32 matrix products must be off")


def phase_build():
    from viennaray_tpu_torch import _build

    _build.library()
    emit({
        "phase": "build", "nvcc_seconds": round(_build.build_seconds, 3),
        "sources": sorted(p.name for p in _build.CSRC.iterdir()),
        # registers, shared memory and spills of each kernel
        "ptxas": [line for line in _build.build_log.splitlines()
                  if "registers" in line or "spill" in line
                  or "Compiling entry" in line],
    })


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


def make_deposits(geometry, n_rays, n_bins, seed):
    """Seeded (ids, w) shaped like one bounce's deposits. Disks: per ray the
    hit disk and its K neighbour slots; about half the rays deposit, and a
    few of a depositing ray's neighbour slots carry its weight. Triangles:
    per ray the hit triangle alone."""
    dev = geometry.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    k = geometry.neighbors.shape[1] if geometry.kind == "disk" else 0
    if k == 0:
        ids = torch.randint(n_bins, (n_rays, 1), generator=gen, device=dev,
                            dtype=torch.int32)
    elif n_bins == geometry.num_primitives:
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
                    dtype=torch.float32):
    """Kernel 2 on one bounce's worth of deposits (the first ``n_entries``
    of them where given) against its plain version, on the path the wrapper
    picks; the other path on the same input must give the same bits. Times
    both paths, the plain version and one ``index_add_`` call. ``dtype``
    float64: the float64 form on the weights widened, held bit for bit to
    its plain version (the same integer sums)."""
    from viennaray_tpu_torch.ops import histogram as H

    f64 = dtype == torch.float64
    ids, w = make_deposits(geometry, n_rays, n_bins, seed=11)
    w = w.to(dtype)
    if n_entries is not None:
        ids, w = ids[:n_entries].contiguous(), w[:n_entries].contiguous()
    path = H.path_for(ids.numel(), n_bins, dtype)
    paths = [path]
    if n_bins <= H.small_max_bins(dtype):
        paths.append("large" if path == "small" else "small")
    outs = {p: H.flux_histogram(ids, w, n_bins, path=p) for p in paths}
    out_1 = H.flux_histogram(ids, w, n_bins)
    out_2 = H.flux_histogram(ids, w, n_bins)
    torch.cuda.synchronize()
    ref = H.flux_histogram_ref(ids, w, n_bins)
    bitwise = bool(torch.equal(out_1, out_2))
    paths_equal = all(torch.equal(o, out_1) for o in outs.values())
    max_abs_err = float((out_1 - ref).abs().max())
    tol = 0.0 if f64 else float(ref.abs().max()) * 2.0 ** -22
    ms_by_path = {
        p: time_cuda(lambda p=p: H.flux_histogram(ids, w, n_bins, path=p), reps)
        for p in paths
    }
    plain_ms = time_cuda(lambda: H.flux_histogram_ref(ids, w, n_bins), reps)
    ids64 = ids.long()
    library_ms = time_cuda(
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
        "path": path, "threshold": H.SMALL_ENTRIES,
        "tolerance": "bit for bit against the plain version (the same "
                     "integer sums of two fixed-point words an entry) and "
                     "between the paths" if f64 else
                     "|kernel - plain| <= 2^-22 * max|plain| (the plain "
                     "version sums in float64; both round once to float32); "
                     "both paths bit for bit",
        "tolerance_abs": tol, "max_abs_err": max_abs_err,
        "bitwise_repeatable": bitwise, "paths_bitwise_equal": paths_equal,
        "ms": ms_by_path[path], "ms_by_path": ms_by_path,
        "plain_ms": plain_ms,
        "bound_ms": max(op_ms, byte_ms),
        "bound_by": "operations" if op_ms > byte_ms else "bytes",
        "library_ms": library_ms,
    }
    emit(res)
    if not (bitwise and paths_equal and max_abs_err <= tol):
        raise RuntimeError(f"flux_histogram fails its check: {res}")
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
                source=None):
    """The disk flagship through ``TraceDisk``, or with another particle,
    the window flux model, 1/distance weighting, or ``source(tracer)`` (the
    grid or the surface source of the flagship) in place of the random one."""
    import viennaray_tpu_torch as vrt

    # device=None: the CUDA device, or raises
    tracer = vrt.TraceDisk(dim=3, fused=fused)
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


def make_tri_tracer(verts, tris, rays_per_point=RAYS_PER_POINT, fused=True):
    import viennaray_tpu_torch as vrt

    tracer = vrt.TraceTriangle(dim=3, fused=fused)
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


def _kernel_wrappers():
    from viennaray_tpu_torch.ops import bounce as B
    from viennaray_tpu_torch.ops import histogram as H
    from viennaray_tpu_torch.ops import nearest_hit as NH

    return {
        "fused_bounce": B.fused_bounce,
        "disk_nearest_hit": NH.disk_nearest_hit,
        "triangle_nearest_hit": NH.triangle_nearest_hit,
        "line_nearest_hit": NH.line_nearest_hit,
        "flux_histogram": H.flux_histogram,
        "flux_histogram_grad": H.flux_histogram_grad,
    }


# the wrappers that also launch a float64 form, counted in ``launches_f64``
F64_KERNELS = ("disk_nearest_hit", "triangle_nearest_hit", "line_nearest_hit",
               "flux_histogram", "flux_histogram_grad")


def reset_launches():
    wrappers = _kernel_wrappers()
    for name, wrapper in wrappers.items():
        wrapper.launches = 0
        if name in F64_KERNELS:
            wrapper.launches_f64 = 0
    wrappers["fused_bounce"].sub_bounces = 0
    for table in (wrappers["fused_bounce"].launches_by_group,
                  wrappers["flux_histogram"].launches_by_path,
                  wrappers["flux_histogram"].launches_by_path_f64):
        for key in table:
            table[key] = 0


def read_launches():
    """Every kernel's launches: the float32 forms by the wrapper's name, the
    float64 forms as ``<name>_f64``."""
    wrappers = _kernel_wrappers()
    out = {name: w.launches for name, w in wrappers.items()}
    out.update({f"{name}_f64": wrappers[name].launches_f64
                for name in F64_KERNELS})
    return out


def timed_apply(tracer, goldens, tol=GOLDEN_TOL):
    """One apply with the launch counts set to 0 just before and read just
    after, its normalized flux held to ``goldens`` (result key -> array) with
    rel-L2 < ``tol``; returns (result fields, ok, launches)."""
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flux = tracer.apply()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    wrappers = _kernel_wrappers()
    sub_bounces = wrappers["fused_bounce"].sub_bounces
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
        "bounce_launches_by_group": {
            str(g): n for g, n in
            wrappers["fused_bounce"].launches_by_group.items() if n},
        "histogram_launches_by_path": dict(
            wrappers["flux_histogram"].launches_by_path),
        "bounces": sub_bounces or launches["disk_nearest_hit"]
        or launches["triangle_nearest_hit"] or launches["line_nearest_hit"],
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
    if launches["fused_bounce"]:
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
        ("fused_bounce", "flux_histogram"), same_seed=True)
    _, unfused_launches, _ = run_path(
        {"body": "unfused"},
        functools.partial(make, rays_per_point=RAYS_PER_POINT // 4, fused=False),
        disk_goldens(), 2.0 * GOLDEN_TOL, ("disk_nearest_hit", "flux_histogram"))
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
        {**label, "body": "fused"}, make, goldens, tol, ("fused_bounce",),
        record, same_seed=True)
    _, unfused_launches, _ = run_path(
        {**label, "body": "unfused"},
        functools.partial(make, rays_per_point=RAYS_PER_POINT // 8, fused=False),
        goldens, 3.0 * tol, ("triangle_nearest_hit", "flux_histogram"), record)
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
        ("fused_bounce",), record, same_seed=True)
    _, unfused_launches, _ = run_path(
        {**label, "body": "unfused"},
        functools.partial(make_line_tracer,
                          rays_per_point=RAYS_PER_POINT // 4, fused=False),
        goldens, 2.0 * tol, ("line_nearest_hit", "flux_histogram"), record)

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
        {"rel_l2_oracle": np.repeat(golden, 2)}, 1.0, ("fused_bounce",),
        extra=against_line_run)
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
        {**label, "body": "fused"}, make, goldens, tol, ("fused_bounce",),
        record, same_seed=True)
    _, unfused_launches, _ = run_path(
        {**label, "body": "unfused"},
        functools.partial(make, rays_per_point=RAYS_PER_POINT // 4, fused=False),
        goldens, 2.0 * tol, ("disk_nearest_hit", "flux_histogram"), record)
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
        ("fused_bounce", "flux_histogram"), record, extra=scatter_events)
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
        {**label, "body": "fused"}, make, goldens, tol, ("fused_bounce",),
        record, same_seed=True, extra=against_neighbor)
    _, unfused_launches, _ = run_path(
        {**label, "body": "unfused"},
        functools.partial(make, rays_per_point=RAYS_PER_POINT // 4, fused=False),
        goldens, 2.0 * tol, ("disk_nearest_hit", "flux_histogram"), record)
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
        ("disk_nearest_hit", "flux_histogram"), record, same_seed=True)
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
        ("fused_bounce",), record, same_seed=True)
    _, unfused_launches, _ = run_path(
        {**label, "body": "unfused"},
        functools.partial(make_disk2d_tracer, fused=False,
                          rays=DISK2D["rays"] // 4),
        goldens, 2.0 * tol, ("disk_nearest_hit", "flux_histogram"), record)
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
        ("fused_bounce", "flux_histogram"), bench_record, same_seed=True)
    golden, record, tol = oracle_golden("surface3d_trench_jax")
    _, surface_launches, _ = run_path(
        {"geometry": "disks", "source": "surface", "body": "fused"},
        functools.partial(make_tracer, pts, nrm, source=surface_source),
        {"rel_l2_jax_surface": golden}, tol,
        ("fused_bounce", "flux_histogram"), record, same_seed=True)
    return grid_launches, surface_launches


# ---- custom particles and multi-species runs -----------------------------------
HOOK_RAYS = 500  # rays per point of the hooked applies
HOOK_LABELS = ("ionFlux", "energyFlux")


@contextlib.contextmanager
def kernel_spans(kind):
    """CUDA events around every launch of a kernel wrapper while the block
    runs: the trace's own (the bounce kernel, the closest-hit search of the
    geometry ``kind``, the histogram), the histogram the hooks call, and the
    histogram's backward. Yields the list of (start, end) event pairs. The
    two histogram wrappers count their launches on their module's names,
    which are the timed wrappers inside the block: those take the counts
    and hand them back after."""
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
            H.flux_histogram, H.flux_histogram_grad)

    def install(bounce, search, trace_hist, hist, hist_grad):
        TK.fused_bounce, TK._SEARCH[kind] = bounce, search
        TK.flux_histogram, H.flux_histogram = trace_hist, hist
        H.flux_histogram_grad = hist_grad

    hist = timed(real[3])
    hist.launches = hist.launches_f64 = 0
    hist.launches_by_path = real[3].launches_by_path
    hist.launches_by_path_f64 = real[3].launches_by_path_f64
    hist_grad = timed(real[4])
    hist_grad.launches = hist_grad.launches_f64 = 0
    install(timed(real[0]), timed(real[1]), hist, hist, hist_grad)
    try:
        yield spans
    finally:
        install(*real)
        for wrapper, counted in ((real[3], hist), (real[4], hist_grad)):
            wrapper.launches += counted.launches
            wrapper.launches_f64 += counted.launches_f64


def span_apply(tracer):
    """One apply with the launch counts set to 0 just before and read just
    after, inside ``kernel_spans``. Returns (flux, fields, launches);
    ``share_outside_kernels`` is 1 minus the events' spans over the apply's
    wall time."""
    reset_launches()
    with kernel_spans(tracer.geometry.kind) as spans:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flux = tracer.apply()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = read_launches()
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
    }, launches, ("disk_nearest_hit", "flux_histogram"), rerun=(plain, tracer))

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
    }, launches, ("disk_nearest_hit", "flux_histogram"), rerun=(plain, tracer))

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
    }, launches, ("disk_nearest_hit", "flux_histogram"), rerun=(plain, tracer))

    # 4. triangles and lines: the two-channel collision_fn with the
    # reimplemented reflection; channel 0 is the built-in apply's bits
    for name, make, rays, search, dim in (
        ("triangles", functools.partial(make_tri_tracer, verts, tris),
         RAYS_PER_POINT // 8, "triangle_nearest_hit", 3),
        ("lines", make_line_tracer, HOOK_RAYS, "line_nearest_hit", 2),
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
               }, launches, (search, "flux_histogram"), rerun=(plain, tracer))

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
    }, launches, ("fused_bounce", "flux_histogram"), rerun=(plain, tracer))

    # 6. two species through apply_particles (the JAX package's
    # examples/multi_species.py), each against its own apply on a fresh
    # tracer at the same run number
    tracer = multi_species.make_tracer(HOOK_RAYS)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flux, infos = vrt.apply_particles(tracer, multi_species.species())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
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
    }, launches, ("fused_bounce", "flux_histogram"))
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
    """``run()`` with the launch counts set to 0 just before and read just
    after, inside ``kernel_spans``, on a fresh peak of device memory.
    Returns (result, fields, launches)."""
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with kernel_spans(geometry.kind) as spans:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = read_launches()
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
        launches["disk_nearest_hit"] == want
        and launches["flux_histogram"] == want
        and launches["flux_histogram_grad"] == want_backward
        and only_launched(launches, "disk_nearest_hit", "flux_histogram",
                          "flux_histogram_grad"))
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
                and only_launched(launches, "disk_nearest_hit",
                                  "flux_histogram", "flux_histogram_grad")):
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
            and only_launched(launches, "triangle_nearest_hit",
                              "flux_histogram", "flux_histogram_grad")):
        raise RuntimeError(f"grad path failed its checks: {res}")
    return out


# ---- the compiled host geometry build -------------------------------------
HOST_BUILD_DELTAS = (0.25, 0.1)  # the flagship's 2,993 disks and 18,180


@contextlib.contextmanager
def numpy_neighborhood():
    """``geometry.neighborhood.build_neighborhood`` replaced by its numpy path
    while the block runs (every caller reads it through the module)."""
    from viennaray_tpu_torch.geometry import neighborhood

    saved = neighborhood.build_neighborhood
    neighborhood.build_neighborhood = neighborhood.build_neighborhood_numpy
    try:
        yield
    finally:
        neighborhood.build_neighborhood = saved


def phase_host_build():
    """The compiled host helper (``native/host_accel.cpp``): it must load on
    this machine. At 2,993 and 18,180 disks, ``DiskGeometry.build`` and
    ``with_window_list`` by the helper and by the numpy path, in turns
    (numpy, helper, helper, numpy), their seconds printed, and every table
    (neighbors, neighbor records, window ids and records) equal; beside them
    the neighborhood alone (``build_neighborhood`` at the disk diameter)."""
    from viennaray_tpu_torch.geometry.disk_geometry import DiskGeometry
    from viennaray_tpu_torch.io import fixtures
    from viennaray_tpu_torch.utils import native

    t0 = time.perf_counter()
    lib = native.load()
    load_seconds = time.perf_counter() - t0
    if lib is None:
        raise RuntimeError("the compiled host helper did not load")
    for delta in HOST_BUILD_DELTAS:
        pts, nrm = fixtures.create_trench_grid_3d(**dict(FLAGSHIP,
                                                          grid_delta=delta))

        def build():
            t0 = time.perf_counter()
            geometry = DiskGeometry.build(pts, nrm, delta)
            t1 = time.perf_counter()
            windowed = geometry.with_window_list()
            torch.cuda.synchronize()
            return windowed, t1 - t0, time.perf_counter() - t1

        # the neighborhood alone (the disk table's: pairs within the disk
        # diameter), each path twice
        from viennaray_tpu_torch.config import disk_factor
        from viennaray_tpu_torch.geometry import neighborhood

        radius = 2.0 * delta * disk_factor(3)
        nbr_seconds = {"numpy": [], "native": []}
        nbr_tables = {}
        for mode, fn in (("numpy", neighborhood.build_neighborhood_numpy),
                         ("native", neighborhood.build_neighborhood),
                         ("native", neighborhood.build_neighborhood),
                         ("numpy", neighborhood.build_neighborhood_numpy)):
            t0 = time.perf_counter()
            nbr_tables[mode] = fn(pts, radius, dim=3)
            nbr_seconds[mode].append(time.perf_counter() - t0)
        nbr_equal = all(np.array_equal(a, b) for a, b in zip(
            nbr_tables["numpy"], nbr_tables["native"]))
        runs = {"numpy": [], "native": []}
        tables = {}
        for mode in ("numpy", "native", "native", "numpy"):
            with (numpy_neighborhood() if mode == "numpy"
                  else contextlib.nullcontext()):
                geometry, build_s, window_s = build()
            runs[mode].append((build_s, window_s))
            tables[mode] = geometry
        a, b = tables["native"], tables["numpy"]
        equal = all(torch.equal(getattr(a, f), getattr(b, f)) for f in (
            "neighbors", "neighbor_pack", "window_ids", "window_pack"))
        best = {m: (min(r[0] for r in v), min(r[1] for r in v))
                for m, v in runs.items()}
        res = {
            "phase": "host_build", "disks": a.num_primitives,
            "neighborhood_seconds": nbr_seconds,
            "neighborhood_speedup": min(nbr_seconds["numpy"])
            / min(nbr_seconds["native"]),
            "neighbors_k": a.neighbors.shape[1],
            "window_w": a.window_ids.shape[1],
            "build_seconds": {m: [r[0] for r in v] for m, v in runs.items()},
            "window_list_seconds": {m: [r[1] for r in v]
                                    for m, v in runs.items()},
            "build_speedup": best["numpy"][0] / best["native"][0],
            "window_list_speedup": best["numpy"][1] / best["native"][1],
            "tables_equal": equal and nbr_equal,
            "helper_load_seconds": load_seconds,
            "helper_gxx_seconds": native.build_seconds,
        }
        emit(res)
        if not (equal and nbr_equal):
            raise RuntimeError(f"the helper's tables differ: {res}")


# ---- float64 tracing -------------------------------------------------------
F64 = torch.float64


def trace_unfused(tracer, dtype):
    """The tracer's rays (its configuration, source, seed and batches)
    through ``trace_batch``'s unfused body in ``dtype``, on its geometry
    widened by ``to(dtype)``, its source cast alike, and a ``GeneratorRNG``
    of that type: the tracers are float32 only, so this is how a user traces
    a configuration in float64. Run after one apply of the tracer (which
    builds the areas its normalization reads). Returns (raw flux (N,)
    float64 numpy, counters dict, seconds)."""
    from viennaray_tpu_torch.config import adjust_bounding_box
    from viennaray_tpu_torch.rng import GeneratorRNG
    from viennaray_tpu_torch.trace.kernel import BatchCounters, trace_batch

    geometry = tracer.geometry.to(dtype)
    dev = geometry.device
    config = tracer._make_config()
    n = geometry.num_primitives
    total = config.total_rays(n)
    margin = (geometry.disk_radius if geometry.kind == "disk"
              else geometry.grid_delta)
    adjusted = adjust_bounding_box(tracer.geometry.bbox.cpu().numpy(),
                                   tracer._source_direction, margin,
                                   tracer._dim)
    source = tracer._default_source(adjusted, n).to(dtype)
    bbox = torch.tensor(adjusted, dtype=dtype, device=dev)
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
            idx < total, config, fused=False)
        flux += batch_flux.double()
        totals += np.asarray(counters, np.int64)
    out = flux.cpu().numpy()
    seconds = time.perf_counter() - t0
    return out, dict(zip(BatchCounters._fields, totals.tolist())), seconds


def f64_flagship(label, tracer, goldens, tol, kernels, record):
    """One flagship in float64 through ``trace_unfused`` beside the float32
    run of the same rays through the same loop, in turns (float32,
    float64, float64, float32), the launch counts read around the second
    float64 run; the float32 loop must give the tracer's own unfused
    apply bit for bit. Holds the float64 flux to ``goldens`` (rel-L2 <
    ``tol``), its hits per ray to the oracle ``record``'s (2 %), the launches
    to the float64 ``kernels`` alone, and two float64 runs to the same bits."""
    applied = tracer.apply()  # the areas; the float32 unfused apply
    flux32, cnt32, s32a = trace_unfused(tracer, torch.float32)
    flux64, cnt64, s64a = trace_unfused(tracer, F64)
    reset_launches()
    again, cnt_again, s64b = trace_unfused(tracer, F64)
    launches = read_launches()
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
    entries); the disk flagship (500 rays per point), the triangle flagship
    (250 per triangle) and the lines (500 per segment) through
    ``trace_batch``'s unfused body in float64 beside float32; ``grad_1e7``
    in float64 against ``grad3d_trench_jax``; the normals' finite
    differences at full width. Returns (kernel results, launches by path)."""
    from viennaray_tpu_torch.geometry.disk_geometry import DiskGeometry
    from viennaray_tpu_torch.geometry.line_geometry import LineGeometry
    from viennaray_tpu_torch.geometry.triangle_geometry import TriangleGeometry

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
    narrow["histogram"] = check_histogram(geometry, 512, len(pts), reps=200,
                                          dtype=F64)
    kernels["histogram_grad"] = check_histogram_grad(geometry, 1 << 19,
                                                     reps=50, dtype=F64)
    narrow["histogram_grad"] = check_histogram_grad(geometry, 512, reps=200,
                                                    dtype=F64)

    launches = {}
    disk_kernels = ("disk_nearest_hit_f64", "flux_histogram_f64")
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
        ("triangle_nearest_hit_f64", "flux_histogram_f64"), record)
    golden, record, tol = oracle_golden("line2d_trench_oracle")
    launches["lines_f64"] = f64_flagship(
        {"geometry": "lines"},
        make_line_tracer(rays_per_point=RAYS_PER_POINT // 4, fused=False),
        {"rel_l2_oracle": golden}, 2.0 * tol,
        ("line_nearest_hit_f64", "flux_histogram_f64"), record)

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
        grad_launches["disk_nearest_hit_f64"] == want
        and grad_launches["flux_histogram_f64"] == want
        and grad_launches["flux_histogram_grad_f64"]
        == (GRAD["bounces"] - 1) * n_batches
        and only_launched(grad_launches, "disk_nearest_hit_f64",
                          "flux_histogram_f64", "flux_histogram_grad_f64"))
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
    entries) and, under ``narrow``, at 512 rays (6,144 entries)."""
    def count(name, *paths):
        by_path = {p: launches[p][name] for p in paths}
        return {"launches": sum(by_path.values()),
                "launches_by_path": by_path}

    entries = []
    for name, key, source, replaces, paths in (
        ("disk_nearest_hit_f64", "disk", "nearest_hit.cu",
         "viennaray_tpu/ops/pallas_intersect.py:166",
         ("disks_f64", "grad_f64")),
        ("triangle_nearest_hit_f64", "triangle", "nearest_hit.cu",
         "viennaray_tpu/ops/pallas_intersect.py:359", ("triangles_f64",)),
        ("line_nearest_hit_f64", "line", "nearest_hit.cu",
         "viennaray_tpu/ops/intersect.py:172", ("lines_f64",)),
        ("flux_histogram_f64", "histogram", "flux_histogram.cu",
         "viennaray_tpu/ops/pallas_histogram.py:39",
         ("disks_f64", "triangles_f64", "lines_f64", "grad_f64")),
        ("flux_histogram_grad_f64", "histogram_grad", "flux_histogram.cu",
         "viennaray_tpu/trace/kernel.py:161", ("grad_f64",)),
    ):
        entries.append({
            "name": name, "route": "cuda",
            "source": f"viennaray_tpu_torch/csrc/{source}",
            "replaces": replaces, **count(name, *paths),
            **{k: results[key][k] for k in keys},
            "narrow": {k: narrow[key][k] for k in keys},
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

    pts, nrm = fixtures.create_trench_grid_3d(**FLAGSHIP)
    # no device named: the CUDA device, as a user's call would get it
    geometry = DiskGeometry.build(pts, nrm, FLAGSHIP["grid_delta"])
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
    for n_entries in (SMALL_ENTRIES - 1, SMALL_ENTRIES + 1):
        check_histogram(geometry, 1 << 20, len(pts), reps=50,
                        n_entries=n_entries)
    check_histogram(geometry, 1 << 20, 18180, reps=20)
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

    torch.cuda.reset_peak_memory_stats()
    launches, unfused_launches, neighbor_norm = phase_disk_paths(pts, nrm)
    tri_launches, tri_unfused_launches = phase_triangle_paths(verts, tris)
    line_launches, line_unfused_launches = phase_line_paths()
    ion_launches, ion_unfused_launches = phase_ion_paths(pts, nrm)
    gas_launches = phase_gas_path(pts, nrm)
    window_launches, window_unfused_launches = phase_window_paths(
        pts, nrm, neighbor_norm)
    wdist_launches = phase_wdist_path(pts, nrm)
    grid_launches, surface_launches = phase_source_paths(pts, nrm)
    disk2d_launches, disk2d_unfused_launches = phase_disk2d_paths()
    hooks = phase_hook_paths(pts, nrm, verts, tris)
    emit({"phase": "peak_memory",
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
    grad = phase_grad_paths(pts, nrm, verts, tris)
    f64_kernels, f64_narrow, f64 = phase_f64_paths(pts, nrm, verts, tris)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape")
    emit({"kernels": [
        {
            "name": "disk_nearest_hit", "route": "cuda",
            "source": "viennaray_tpu_torch/csrc/nearest_hit.cu",
            "replaces": "viennaray_tpu/ops/pallas_intersect.py:166",
            # the default path is fused and never reaches it: its count is
            # the unfused paths' runs and the wdist run's
            "launches": unfused_launches["disk_nearest_hit"]
            + ion_unfused_launches["disk_nearest_hit"]
            + window_unfused_launches["disk_nearest_hit"]
            + wdist_launches["disk_nearest_hit"]
            + disk2d_unfused_launches["disk_nearest_hit"]
            + sum(n["disk_nearest_hit"] for n in hooks.values())
            + sum(n["disk_nearest_hit"] for n in grad.values()),
            "launches_by_path": {
                "disks_unfused": unfused_launches["disk_nearest_hit"],
                "ion_unfused": ion_unfused_launches["disk_nearest_hit"],
                "window_unfused": window_unfused_launches["disk_nearest_hit"],
                "wdist": wdist_launches["disk_nearest_hit"],
                "disk2d_unfused":
                    disk2d_unfused_launches["disk_nearest_hit"],
                **{name: n["disk_nearest_hit"] for name, n in hooks.items()
                   if n["disk_nearest_hit"]},
                **{name: n["disk_nearest_hit"] for name, n in grad.items()
                   if n["disk_nearest_hit"]},
            },
            **{k: hit_wide[k] for k in keys},
        },
        {
            "name": "flux_histogram", "route": "cuda",
            "source": "viennaray_tpu_torch/csrc/flux_histogram.cu",
            "replaces": "viennaray_tpu/ops/pallas_histogram.py:39",
            "launches": launches["flux_histogram"],
            "launches_by_path": {
                "disks": launches["flux_histogram"],
                "disks_unfused": unfused_launches["flux_histogram"],
                "triangles": tri_launches["flux_histogram"],
                "triangles_unfused": tri_unfused_launches["flux_histogram"],
                "lines": line_launches["flux_histogram"],
                "lines_unfused": line_unfused_launches["flux_histogram"],
                "ion": ion_launches["flux_histogram"],
                "ion_unfused": ion_unfused_launches["flux_histogram"],
                "window": window_launches["flux_histogram"],
                "window_unfused": window_unfused_launches["flux_histogram"],
                "wdist": wdist_launches["flux_histogram"],
                "grid": grid_launches["flux_histogram"],
                "surface": surface_launches["flux_histogram"],
                "disk2d_unfused": disk2d_unfused_launches["flux_histogram"],
                **{name: n["flux_histogram"] for name, n in hooks.items()},
                **{name: n["flux_histogram"] for name, n in grad.items()},
            },
            # two paths of one kernel (ops/histogram.py:path_for): one block
            # below the threshold of entries, the whole card above it
            "paths": {"small": f"E < {SMALL_ENTRIES}", "large": "else"},
            **{k: hist_wide[k] for k in keys},
            "E_6144": {k: hist_small[k] for k in keys + ("path", "ms_by_path")},
            "E_65536": {k: hist_mid[k] for k in keys + ("path", "ms_by_path")},
        },
        {
            # kernel 2's backward: the gradient of the weights, a gather. The
            # JAX package has no TPU kernel for it: XLA transposes its
            # one-hot contraction
            "name": "flux_histogram_grad", "route": "cuda",
            "source": "viennaray_tpu_torch/csrc/flux_histogram.cu",
            "replaces": "viennaray_tpu/trace/kernel.py:161",
            "launches": grad["grad"]["flux_histogram_grad"],
            "launches_by_path": {
                name: n["flux_histogram_grad"] for name, n in grad.items()},
            **{k: hist_grad[k] for k in keys},
        },
        *f64_kernel_entries(f64_kernels, f64_narrow, f64, keys),
        {
            "name": "triangle_nearest_hit", "route": "cuda",
            "source": "viennaray_tpu_torch/csrc/nearest_hit.cu",
            "replaces": "viennaray_tpu/ops/pallas_intersect.py:359",
            # as for disks: the unfused triangle path's run, and the hooked
            # triangle run's
            "launches": tri_unfused_launches["triangle_nearest_hit"]
            + hooks["two_channels_builtin_reimplemented_triangles"][
                "triangle_nearest_hit"]
            + grad["grad_triangles"]["triangle_nearest_hit"],
            "launches_by_path": {
                "triangles_unfused": tri_unfused_launches["triangle_nearest_hit"],
                "two_channels_builtin_reimplemented_triangles": hooks[
                    "two_channels_builtin_reimplemented_triangles"][
                    "triangle_nearest_hit"],
                "grad_triangles": grad["grad_triangles"][
                    "triangle_nearest_hit"],
            },
            **{k: tri_hit_wide[k] for k in keys},
        },
        {
            # the line instantiation of the same template; the JAX package
            # runs this search in XLA, not in a TPU kernel
            "name": "line_nearest_hit", "route": "cuda",
            "source": "viennaray_tpu_torch/csrc/nearest_hit.cu",
            "replaces": "viennaray_tpu/ops/intersect.py:172",
            "launches": line_unfused_launches["line_nearest_hit"]
            + hooks["two_channels_builtin_reimplemented_lines"][
                "line_nearest_hit"],
            "launches_by_path": {
                "lines_unfused": line_unfused_launches["line_nearest_hit"],
                "two_channels_builtin_reimplemented_lines": hooks[
                    "two_channels_builtin_reimplemented_lines"][
                    "line_nearest_hit"],
            },
            **{k: line_hit_wide[k] for k in keys},
        },
        {
            "name": "fused_bounce", "route": "cuda",
            "source": "viennaray_tpu_torch/csrc/bounce.cu",
            "replaces": "viennaray_tpu/ops/pallas_bounce.py:1056",
            # every instantiation: the applies of the disk, triangle, line
            # and ion configurations, the gas run, the window flagship and
            # the grid and surface sources' runs
            "launches": launches["fused_bounce"] + tri_launches["fused_bounce"]
            + line_launches["fused_bounce"] + ion_launches["fused_bounce"]
            + gas_launches["fused_bounce"] + window_launches["fused_bounce"]
            + grid_launches["fused_bounce"] + surface_launches["fused_bounce"]
            + disk2d_launches["fused_bounce"]
            + sum(n["fused_bounce"] for n in hooks.values()),
            # the threads per ray G (ops/bounce.py:group_for), and the G
            # values instantiated
            "groups": {
                "32": f"R < {B.GROUP_BELOW_WIDTH} or chunks >= "
                      f"{B.GROUP_ALL_WIDTHS_CHUNKS}",
                "1": "else"},
            "groups_instantiated": list(B.GROUPS),
            "launches_by_path": {
                "disks": launches["fused_bounce"],
                "triangles": tri_launches["fused_bounce"],
                "lines": line_launches["fused_bounce"],
                "ion": ion_launches["fused_bounce"],
                "gas": gas_launches["fused_bounce"],
                "window": window_launches["fused_bounce"],
                "grid": grid_launches["fused_bounce"],
                "surface": surface_launches["fused_bounce"],
                "disk2d": disk2d_launches["fused_bounce"],
                **{name: n["fused_bounce"] for name, n in hooks.items()
                   if n["fused_bounce"]},
            },
            **{k: bounce_wide[k] for k in keys},
            "triangles": {k: tri_bounce_wide[k] for k in keys},
            "lines": {k: line_bounce_wide[k] for k in keys},
            "ion": {k: ion_bounce_wide[k] for k in keys},
            "window": {k: window_bounce_wide[k] for k in keys},
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
