#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It imports only ``viennaray_tpu_torch`` and, in order:

1. prints the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and asserts that TF32 matrix products are off;
2. builds the CUDA kernels from ``viennaray_tpu_torch/csrc`` with ``nvcc``;
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes the 3D-trench flagship gives it (and the histogram at 18,180 bins
   too), and times kernel, plain version and, for the histogram, one
   ``index_add_`` call;
4. drives the flagship through ``TraceDisk``: 2,993 disks, 2,000 rays per
   point, periodic walls, diffuse particle with sticking 0.1, seed 42,
   mega-batches of 2^20 rays; checks the normalized flux against the two
   golden files (rel-L2 < 0.05), that both kernels were launched, and that
   two same-seed runs are bitwise equal;
5. prints the peak device memory.

Every phase prints one JSON object on a line of its own. The line before the
last lists the kernels; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failing phase raises and the script exits non-zero. Without a CUDA device
it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12  # H100 SXM data sheet, float32 outside the tensor cores
# float32 arithmetic operations of one ray/disk test in csrc/disk_hit.cuh:
# two dot products (5 each), the plane time (2), the hit offset (9) and its
# squared length (5). The three comparisons are not counted, and the bound
# takes every ray against every real disk (what the function computes), not
# the pairs that are left after the kernel's chunk skip.
OPS_PER_PAIR = 26
FLAGSHIP = dict(grid_delta=0.25, extent=5.0, trench_width=4.0, trench_depth=4.0)
RAYS_PER_POINT = 2000
SEED = 42
GOLDEN_TOL = 0.05
ROOT = os.path.dirname(os.path.abspath(__file__))


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
    })


def make_rays(geometry, bbox, n, kind, seed):
    """Seeded rays at the flagship's geometry: ``source`` = what the trace's
    first bounce sees (source plane, cosine lobe), ``interior`` = origins
    anywhere in the box with directions all over the sphere, as after
    diffuse bounces."""
    from viennaray_tpu_torch.ops import sampling

    dev = geometry.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    u = torch.rand((4, n), generator=gen, device=dev)
    lo, hi = bbox[0], bbox[1]
    org = lo + (hi - lo) * torch.stack([u[0], u[1], u[2]], dim=1)
    if kind == "source":
        org[:, 2] = hi[2]
        lobe = sampling.power_cosine_direction(u[2], u[3], 1.0)
        dirn = torch.stack([lobe[:, 0], lobe[:, 1], -lobe[:, 2]], dim=1)
    else:
        dirn = sampling.unit_sphere(u[3], torch.rand(n, generator=gen, device=dev))
    return org.contiguous(), dirn.contiguous()


def check_nearest_hit(geometry, bbox, n_rays, kind, reps):
    from viennaray_tpu_torch.ops import nearest_hit as NH

    org, dirn = make_rays(geometry, bbox, n_rays, kind, seed=7)
    args = (org, dirn, geometry.prims_soa, geometry.soa_perm,
            geometry.soa_chunk_bbs)
    t_k, p_k, h_k = NH.disk_nearest_hit(*args, t_near=1e-4)
    torch.cuda.synchronize()
    t_p, p_p, h_p = NH.disk_nearest_hit_ref(*args, t_near=1e-4)
    hit_equal = bool(torch.equal(h_k, h_p))
    prim_equal = bool(torch.equal(p_k, p_p))
    max_abs_err = float((t_k - t_p)[h_p].abs().max()) if bool(h_p.any()) else 0.0
    ms = time_cuda(lambda: NH.disk_nearest_hit(*args, t_near=1e-4), reps)
    plain_ms = time_cuda(lambda: NH.disk_nearest_hit_ref(*args, t_near=1e-4), 1)
    n_real = geometry.num_primitives
    npad = geometry.prims_soa.shape[1]
    op_ms = n_rays * n_real * OPS_PER_PAIR / F32_FLOPS * 1e3
    n_bytes = (n_rays * (24 + 9) + npad * 36
               + geometry.soa_chunk_bbs.numel() * 4)
    byte_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    res = {
        "phase": "kernel_check", "kernel": "disk_nearest_hit",
        "shape": f"R={n_rays} ({kind} rays), Npad={npad}, "
                 f"C={geometry.soa_chunk_bbs.shape[0]}",
        "tolerance": "hit and prim equal on every lane, t equal bit for bit "
                     "(no fused multiply-add, IEEE division, same order)",
        "hit_equal": hit_equal, "prim_equal": prim_equal,
        "hit_fraction": float(h_p.float().mean()),
        "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(op_ms, byte_ms),
        "bound_by": "operations" if op_ms >= byte_ms else "bytes",
        "library_ms": None,
    }
    emit(res)
    if not (hit_equal and prim_equal and max_abs_err == 0.0):
        raise RuntimeError(f"disk_nearest_hit disagrees with its plain version: {res}")
    return res


def make_deposits(geometry, n_rays, n_bins, seed):
    """Seeded (ids, w) shaped like one bounce's deposits: per ray the hit
    disk and its K neighbour slots; about half the rays deposit, and a few
    of a depositing ray's neighbour slots carry its weight."""
    dev = geometry.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    k = geometry.neighbors.shape[1]
    if n_bins == geometry.num_primitives:
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


def check_histogram(geometry, n_rays, n_bins, reps):
    from viennaray_tpu_torch.ops import histogram as H

    ids, w = make_deposits(geometry, n_rays, n_bins, seed=11)
    out_1 = H.flux_histogram(ids, w, n_bins)
    out_2 = H.flux_histogram(ids, w, n_bins)
    torch.cuda.synchronize()
    ref = H.flux_histogram_ref(ids, w, n_bins)
    bitwise = bool(torch.equal(out_1, out_2))
    max_abs_err = float((out_1 - ref).abs().max())
    tol = float(ref.abs().max()) * 2.0 ** -22
    ms = time_cuda(lambda: H.flux_histogram(ids, w, n_bins), reps)
    plain_ms = time_cuda(lambda: H.flux_histogram_ref(ids, w, n_bins), reps)
    ids64 = ids.long()
    library_ms = time_cuda(
        lambda: torch.zeros(n_bins, device=w.device).index_add_(0, ids64, w),
        reps,
    )
    byte_ms = (ids.numel() * 8 + n_bins * 4) / HBM_BYTES_PER_S * 1e3
    # one float32 addition per entry that carries weight
    op_ms = float((w != 0).sum()) / F32_FLOPS * 1e3
    res = {
        "phase": "kernel_check", "kernel": "flux_histogram",
        "shape": f"E={ids.numel()}, n={n_bins}, "
                 f"nonzero={float((w != 0).float().mean()):.3f}",
        "tolerance": "|kernel - plain| <= 2^-22 * max|plain| (the plain "
                     "version sums in float64; both round once to float32)",
        "tolerance_abs": tol, "max_abs_err": max_abs_err,
        "bitwise_repeatable": bitwise, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(op_ms, byte_ms),
        "bound_by": "operations" if op_ms > byte_ms else "bytes",
        "library_ms": library_ms,
    }
    emit(res)
    if not (bitwise and max_abs_err <= tol):
        raise RuntimeError(f"flux_histogram fails its check: {res}")
    return res


def make_tracer(pts, nrm):
    import viennaray_tpu_torch as vrt

    tracer = vrt.TraceDisk(dim=3)  # device=None: the CUDA device, or raises
    tracer.set_geometry(pts, nrm, FLAGSHIP["grid_delta"])
    tracer.set_boundary_conditions([vrt.BoundaryCondition.PERIODIC] * 3)
    tracer.set_particle_type(vrt.DiffuseParticle(0.1, "flux"))
    tracer.set_number_of_rays_per_point(RAYS_PER_POINT)
    tracer.set_rng_seed(SEED)
    return tracer


def rel_l2(a, golden_name):
    g = np.asarray(
        np.load(os.path.join(ROOT, "benchmarks", "golden", golden_name)),
        np.float64,
    )
    return float(np.linalg.norm(a - g) / max(np.linalg.norm(g), 1e-12))


def phase_main_path(pts, nrm):
    from viennaray_tpu_torch.ops import histogram as H
    from viennaray_tpu_torch.ops import nearest_hit as NH

    tracer = make_tracer(pts, nrm)
    first = tracer.apply()  # warm-up; also the first of the same-seed pair
    torch.cuda.synchronize()

    NH.disk_nearest_hit.launches = 0
    H.flux_histogram.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flux = tracer.apply()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {
        "disk_nearest_hit": NH.disk_nearest_hit.launches,
        "flux_histogram": H.flux_histogram.launches,
    }
    info = tracer.get_ray_trace_info()
    norm = np.asarray(tracer.normalize_flux(flux), np.float64)
    parity = rel_l2(norm, "bench_disk3d.npy")
    parity_oracle = rel_l2(norm, "bench_disk3d_oracle.npy")

    again = make_tracer(pts, nrm).apply()  # fresh tracer, same seed, first run
    bitwise = bool(np.array_equal(first, again))

    res = {
        "phase": "main_path", "disks": int(len(pts)),
        "num_rays": info.num_rays, "batch": tracer._ray_batch_size,
        "seconds": seconds, "rays_per_s": info.num_rays / seconds,
        "total_rays_traced": info.total_rays_traced,
        "geometry_hits": info.geometry_hits,
        "non_geometry_hits": info.non_geometry_hits,
        "boundary_hits": info.boundary_hits,
        "geometry_hits_per_ray": info.geometry_hits / info.num_rays,
        "rel_l2_golden": parity, "rel_l2_oracle": parity_oracle,
        "launches": launches, "same_seed_bitwise_equal": bitwise,
    }
    emit(res)
    ok = (
        np.isfinite(norm).all() and norm.shape == (len(pts),)
        and norm.max() > 0 and parity < GOLDEN_TOL
        and parity_oracle < GOLDEN_TOL and min(launches.values()) > 0
        and bitwise
    )
    if not ok:
        raise RuntimeError(f"main path failed its checks: {res}")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device and found none",
              file=sys.stderr)
        return 1
    from viennaray_tpu_torch.config import adjust_bounding_box, TraceDirection
    from viennaray_tpu_torch.geometry.disk_geometry import DiskGeometry
    from viennaray_tpu_torch.io import fixtures

    phase_card()
    phase_build()

    pts, nrm = fixtures.create_trench_grid_3d(**FLAGSHIP)
    # no device named: the CUDA device, as a user's call would get it
    geometry = DiskGeometry.build(pts, nrm, FLAGSHIP["grid_delta"])
    dev = geometry.device
    bbox = torch.tensor(
        adjust_bounding_box(geometry.bbox.cpu().numpy(), TraceDirection.POS_Z,
                            geometry.disk_radius, 3),
        dtype=torch.float32, device=dev,
    )

    hit_wide = check_nearest_hit(geometry, bbox, 1 << 20, "source", reps=10)
    check_nearest_hit(geometry, bbox, 1 << 20, "interior", reps=10)
    check_nearest_hit(geometry, bbox, 512, "interior", reps=200)
    check_nearest_hit(geometry, bbox, 1000, "interior", reps=200)  # ragged R
    hist_wide = check_histogram(geometry, 1 << 20, len(pts), reps=20)
    check_histogram(geometry, 512, len(pts), reps=200)
    check_histogram(geometry, 1 << 20, 18180, reps=20)

    torch.cuda.reset_peak_memory_stats()
    launches = phase_main_path(pts, nrm)
    emit({"phase": "peak_memory",
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape")
    emit({"kernels": [
        {
            "name": "disk_nearest_hit", "route": "cuda",
            "source": "viennaray_tpu_torch/csrc/nearest_hit.cu",
            "replaces": "viennaray_tpu/ops/pallas_intersect.py:166",
            "launches": launches["disk_nearest_hit"],
            **{k: hit_wide[k] for k in keys},
        },
        {
            "name": "flux_histogram", "route": "cuda",
            "source": "viennaray_tpu_torch/csrc/flux_histogram.cu",
            "replaces": "viennaray_tpu/ops/pallas_histogram.py:39",
            "launches": launches["flux_histogram"],
            **{k: hist_wide[k] for k in keys},
        },
    ]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
