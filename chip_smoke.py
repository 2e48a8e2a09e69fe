#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It imports only ``viennaray_tpu_torch`` and, in order:

1. prints the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and asserts that TF32 matrix products are off;
2. builds the CUDA kernels from ``viennaray_tpu_torch/csrc`` with ``nvcc``;
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes the 3D-trench flagships give it: 2,993 disks and 5,760 triangles
   (and at the 18,180-disk and 9,000-triangle trenches, and the bounce kernel
   on a 2D trench of disks and on an extruded 2D line mesh too), and times
   kernel, plain version and, for the histogram, one ``index_add_`` call;
4. drives the flagship through the default ``TraceDisk`` (the fused bounce
   kernel): 2,993 disks, 2,000 rays per point, periodic walls, diffuse
   particle with sticking 0.1, seed 42, mega-batches of 2^20 rays; checks the
   normalized flux against the two golden files (rel-L2 < 0.05), that the
   bounce and histogram kernels were launched, and that two same-seed runs
   are bitwise equal;
5. drives the same flagship through ``TraceDisk(fused=False)`` (the unfused
   body around the closest-hit and histogram kernels) at 1,000 rays per
   point, against the same goldens;
6. drives the triangle flagship through the default ``TraceTriangle``:
   5,760 triangles, 2,000 rays per triangle, the same physics; checks the
   normalized flux against the oracle golden
   ``viennaray_tpu_torch/io/golden/tri3d_trench_oracle.npy`` and the
   geometry hits per ray against the oracle's (within 2 %), that the bounce
   kernel was launched, and that two same-seed runs are bitwise equal; then
   through ``TraceTriangle(fused=False)`` (the triangle closest-hit kernel
   and the histogram kernel on every bounce) at 500 rays per triangle;
7. prints the peak device memory.

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
# float32 arithmetic operations of one (ray, primitive) test. A disk
# (csrc/disk_hit.cuh): two dot products (5 each), the plane time (2), the hit
# offset (9) and its squared length (5). A triangle (csrc/tri_hit.cuh): two
# cross products (9 each), three dot products (5 each), the offset from v0
# (3), three quotients and u + v. Comparisons are not counted, and the bound
# takes every ray against every real primitive (what the function computes),
# not the pairs that are left after the kernel's chunk skip.
OPS_PER_PAIR = {"disk": 26, "triangle": 45}
FLAGSHIP = dict(grid_delta=0.25, extent=5.0, trench_width=4.0, trench_depth=4.0)
RAYS_PER_POINT = 2000
SEED = 42
GOLDEN_TOL = 0.05
ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(ROOT, "benchmarks", "golden")
TRI_GOLDEN = os.path.join(
    ROOT, "viennaray_tpu_torch", "io", "golden", "tri3d_trench_oracle"
)


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
    diffuse bounces, ``flat`` = the same in the plane z = 0 of a 2D run."""
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
    if kind == "flat":
        org[:, 2] = 0.0
        dirn[:, 2] = 0.0
        dirn = dirn / torch.linalg.norm(dirn, dim=1, keepdim=True)
    return org.contiguous(), dirn.contiguous()


def check_nearest_hit(geometry, bbox, n_rays, kind, reps):
    """The closest-hit kernel of the geometry's kind (disks or triangles)
    against its plain version."""
    from viennaray_tpu_torch.ops import nearest_hit as NH

    name = f"{geometry.kind}_nearest_hit"
    kernel, plain = getattr(NH, name), getattr(NH, name + "_ref")
    org, dirn = make_rays(geometry, bbox, n_rays, kind, seed=7)
    args = (org, dirn, geometry.prims_soa, geometry.soa_perm,
            geometry.soa_chunk_bbs)
    t_k, p_k, h_k = kernel(*args, t_near=1e-4)
    torch.cuda.synchronize()
    t_p, p_p, h_p = plain(*args, t_near=1e-4)
    hit_equal = bool(torch.equal(h_k, h_p))
    prim_equal = bool(torch.equal(p_k, p_p))
    max_abs_err = float((t_k - t_p)[h_p].abs().max()) if bool(h_p.any()) else 0.0
    ms = time_cuda(lambda: kernel(*args, t_near=1e-4), reps)
    plain_ms = time_cuda(lambda: plain(*args, t_near=1e-4), 1)
    n_real = geometry.num_primitives
    rows, npad = geometry.prims_soa.shape
    op_ms = n_rays * n_real * OPS_PER_PAIR[geometry.kind] / F32_FLOPS * 1e3
    n_bytes = (n_rays * (24 + 9) + npad * (rows + 1) * 4
               + geometry.soa_chunk_bbs.numel() * 4)
    byte_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    res = {
        "phase": "kernel_check", "kernel": name,
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
        raise RuntimeError(f"{name} disagrees with its plain version: {res}")
    return res


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


def bounce_settings(specular=False, walls="PERIODIC", dim=3):
    """The flagship's settings of a bounce (diffuse, periodic walls, sticking
    0.1), or a specular particle, or other walls; in 2D the source lies on
    the +y face."""
    import viennaray_tpu_torch as vrt
    from viennaray_tpu_torch.ops.bounce import BounceSettings

    bc = vrt.BoundaryCondition[walls]
    particle = (vrt.SpecularParticle(0.1, 1.0) if specular
                else vrt.DiffuseParticle(0.1))
    direction = vrt.TraceDirection.POS_Z if dim == 3 else vrt.TraceDirection.POS_Y
    return BounceSettings.from_config(
        vrt.TraceConfig(dim=dim, boundary_conditions=(bc,) * 3,
                        source_direction=direction),
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

    step = 0.05
    corners = [(-3.0, 0.0), (-1.0, 0.0), (-1.0, -2.0), (1.0, -2.0),
               (1.0, 0.0), (3.0, 0.0)]
    nodes = [corners[0]]
    for (x0, y0), (x1, y1) in zip(corners[:-1], corners[1:]):
        n = int(round(max(abs(x1 - x0), abs(y1 - y0)) / step))
        nodes += [(x0 + (x1 - x0) * i / n, y0 + (y1 - y0) * i / n)
                  for i in range(1, n + 1)]
    nodes = np.c_[np.array(nodes, np.float32), np.zeros(len(nodes), np.float32)]
    lines = np.stack([np.arange(len(nodes) - 1), np.arange(1, len(nodes))], 1)
    geometry = TriangleGeometry.from_line_mesh(
        LineMesh(nodes, lines, grid_delta=step)
    )
    return geometry, adjusted_bbox(geometry, dim=2)


def trench_2d():
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
    geometry = DiskGeometry.build(pts, nrm, step, dim=2)
    return geometry, adjusted_bbox(geometry, dim=2)


def make_state(geometry, bbox, n_rays, kind, n_sub, settings, seed):
    """Seeded state and uniforms on the card: rays from ``make_rays``, a
    twentieth of the lanes dead, a tenth that have passed a disk from behind,
    weights from w0 down to the roulette threshold, boundary-hit counts up to
    the cap."""
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
    uniforms = torch.rand((n_rays, 3 * n_sub), generator=gen, device=dev)
    return state, uniforms


def check_bounce(geometry, bbox, n_rays, kind, n_sub, in_kernel, settings,
                 reps):
    from viennaray_tpu_torch.ops import bounce as B

    walls = B.make_walls(bbox, geometry, settings)
    state, uniforms = make_state(
        geometry, bbox, n_rays, kind, n_sub, settings, seed=13
    )
    args = (state, uniforms, geometry, walls, settings)
    kw = dict(n_sub=n_sub, deposit_in_kernel=in_kernel)
    res = B.fused_bounce(*args, **kw)
    again = B.fused_bounce(*args, **kw)
    torch.cuda.synchronize()
    ref = B.fused_bounce_ref(*args, **kw)

    st, rs = res.state, ref.state
    flags_same = (
        (st.alive == rs.alive) & (st.hfb == rs.hfb)
        & (st.n_refl == rs.n_refl) & (st.n_bdry == rs.n_bdry)
    )
    if not in_kernel:
        flags_same &= (res.hit_prim == ref.hit_prim) & (res.wdep == ref.wdep)
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
    counts, ref_counts = res.counts.tolist(), ref.counts.tolist()
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
    # one by one, and its sinf / cosf are the functions PyTorch's own kernels
    # call, so nothing is left to differ, whatever n_sub.
    tolerance = (
        "flags, counters, hit prim and deposit weight equal on every lane; "
        "origin, direction and weight bit for bit on the lanes left alive; "
        "counts equal; flux within 2^-22 of the largest bin (the plain "
        "version sums in float64; both round once to float32)"
    )
    ok = (
        lanes_equal == 1.0 and max(err.values()) == 0.0
        and counts == ref_counts and flux_err <= flux_max * 2.0 ** -22
    )

    ms = time_cuda(lambda: B.fused_bounce(*args, **kw), reps)
    plain_ms = time_cuda(lambda: B.fused_bounce_ref(*args, **kw), 1)
    n_real = geometry.num_primitives
    rows, npad = geometry.prims_soa.shape
    k_nbrs = geometry.neighbors.shape[1] if geometry.kind == "disk" else 0
    # operations: every search of this run (a lane alive at a sub-bounce)
    # against every real primitive; bytes: state and uniforms in, state and
    # the flux or the (hit, weight) pair out, the geometry tables once
    traces = ref_counts[3]
    op_ms = traces * n_real * OPS_PER_PAIR[geometry.kind] / F32_FLOPS * 1e3
    n_bytes = (
        n_rays * (66 + 12 * n_sub + 62) + npad * (rows + 1) * 4
        + geometry.soa_chunk_bbs.numel() * 4 + n_real * k_nbrs * 36
        + (n_real * 4 if in_kernel else n_rays * 8)
    )
    byte_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    res_out = {
        "phase": "kernel_check", "kernel": "fused_bounce",
        "shape": f"{geometry.kind}s, R={n_rays} ({kind} rays), n_sub={n_sub}, "
                 f"deposits "
                 f"{'in the kernel' if in_kernel else 'handed out'}, "
                 f"{'specular' if settings.refl_kind else 'diffuse'}, "
                 f"{('reflective', 'periodic', 'ignore')[settings.bc1]}, "
                 f"dim={settings.dim}, "
                 f"Npad={npad}, C={geometry.soa_chunk_bbs.shape[0]}, K={k_nbrs}",
        "tolerance": tolerance, "lanes_equal": lanes_equal,
        "max_abs_err_state": err, "counts": counts, "plain_counts": ref_counts,
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


def make_tracer(pts, nrm, rays_per_point=RAYS_PER_POINT, fused=True):
    import viennaray_tpu_torch as vrt

    # device=None: the CUDA device, or raises
    tracer = vrt.TraceDisk(dim=3, fused=fused)
    tracer.set_geometry(pts, nrm, FLAGSHIP["grid_delta"])
    return configure(tracer, rays_per_point)


def make_tri_tracer(verts, tris, rays_per_point=RAYS_PER_POINT, fused=True):
    import viennaray_tpu_torch as vrt

    tracer = vrt.TraceTriangle(dim=3, fused=fused)
    tracer.set_geometry(verts, tris, FLAGSHIP["grid_delta"])
    return configure(tracer, rays_per_point)


def configure(tracer, rays_per_point):
    """The flagships' physics: periodic walls, diffuse particle with sticking
    0.1, a fixed seed."""
    import viennaray_tpu_torch as vrt

    tracer.set_boundary_conditions([vrt.BoundaryCondition.PERIODIC] * 3)
    tracer.set_particle_type(vrt.DiffuseParticle(0.1, "flux"))
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


def tri_golden():
    """The triangle oracle golden, its record, and the bound the flux is held
    to: rel-L2 < 0.05, or 1.45 times the golden's own noise (the rel-L2
    between its two seeds) where that noise is above 0.035."""
    golden = np.load(TRI_GOLDEN + ".npy")
    with open(TRI_GOLDEN + ".json") as f:
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
        "flux_histogram": H.flux_histogram,
    }


def reset_launches():
    for wrapper in _kernel_wrappers().values():
        wrapper.launches = 0
    _kernel_wrappers()["fused_bounce"].sub_bounces = 0


def read_launches():
    return {name: w.launches for name, w in _kernel_wrappers().items()}


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
    sub_bounces = _kernel_wrappers()["fused_bounce"].sub_bounces
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
        "non_geometry_hits": info.non_geometry_hits,
        "boundary_hits": info.boundary_hits,
        "geometry_hits_per_ray": info.geometry_hits / info.num_rays,
        **errors, "rel_l2_bound": tol,
        "launches": launches,
        "bounces": sub_bounces or launches["disk_nearest_hit"]
        or launches["triangle_nearest_hit"],
    }
    ok = (
        np.isfinite(norm).all() and norm.shape == (n_prims,)
        and norm.max() > 0 and all(e < tol for e in errors.values())
    )
    return fields, ok, launches


def phase_main_path(pts, nrm):
    """The default path: the flagship at full width through the default
    tracer, whose body is the fused bounce kernel."""
    tracer = make_tracer(pts, nrm)
    first = tracer.apply()  # warm-up; also the first of the same-seed pair
    fields, ok, launches = timed_apply(tracer, disk_goldens())
    again = make_tracer(pts, nrm).apply()  # fresh tracer, same seed, first run
    bitwise = bool(np.array_equal(first, again))
    res = {"phase": "main_path", "body": "fused", **fields,
           "same_seed_bitwise_equal": bitwise}
    emit(res)
    if not (ok and bitwise and launches["fused_bounce"] > 0
            and launches["flux_histogram"] > 0):
        raise RuntimeError(f"main path failed its checks: {res}")
    return launches


def phase_unfused_path(pts, nrm):
    """The unfused path at half the depth: the unfused body around
    the closest-hit and histogram kernels, 1,000 rays per point. In one
    process with the fused apply, so the two times can be compared."""
    tracer = make_tracer(pts, nrm, rays_per_point=1000, fused=False)
    tracer.apply()  # warm-up, so that the timed apply is the second as above
    fields, ok, launches = timed_apply(tracer, disk_goldens())
    res = {"phase": "main_path", "body": "unfused", **fields}
    emit(res)
    if not (ok and launches["disk_nearest_hit"] > 0
            and launches["flux_histogram"] > 0
            and launches["fused_bounce"] == 0):
        raise RuntimeError(f"unfused path failed its checks: {res}")
    return launches


def hits_per_ray_ok(fields, record):
    """``geometry_hits / num_rays`` within 2 % of the oracle's."""
    want = record["geometry_hits_per_ray"]
    fields["oracle_geometry_hits_per_ray"] = want
    return abs(fields["geometry_hits_per_ray"] - want) <= 0.02 * want


def phase_triangle_main_path(verts, tris):
    """The triangle flagship at full width through the default
    ``TraceTriangle``, whose body is the fused bounce kernel's triangle
    instantiation."""
    golden, record, tol = tri_golden()
    tracer = make_tri_tracer(verts, tris)
    first = tracer.apply()
    fields, ok, launches = timed_apply(tracer, {"rel_l2_oracle": golden}, tol)
    ok = ok and hits_per_ray_ok(fields, record)
    again = make_tri_tracer(verts, tris).apply()
    bitwise = bool(np.array_equal(first, again))
    res = {"phase": "main_path", "geometry": "triangles", "body": "fused",
           **fields, "same_seed_bitwise_equal": bitwise}
    emit(res)
    if not (ok and bitwise and launches["fused_bounce"] > 0):
        raise RuntimeError(f"triangle main path failed its checks: {res}")
    return launches


def phase_triangle_unfused_path(verts, tris):
    """The unfused triangle path at a quarter of the depth (500 rays per
    triangle): the triangle closest-hit kernel and the histogram kernel on
    every bounce. A quarter of the rays doubles the Monte Carlo noise, so
    the flux bound doubles too."""
    golden, record, tol = tri_golden()
    tracer = make_tri_tracer(verts, tris, rays_per_point=500, fused=False)
    tracer.apply()
    fields, ok, launches = timed_apply(
        tracer, {"rel_l2_oracle": golden}, 2.0 * tol
    )
    ok = ok and hits_per_ray_ok(fields, record)
    res = {"phase": "main_path", "geometry": "triangles", "body": "unfused",
           **fields}
    emit(res)
    if not (ok and launches["triangle_nearest_hit"] > 0
            and launches["flux_histogram"] > 0
            and launches["fused_bounce"] == 0):
        raise RuntimeError(f"unfused triangle path failed its checks: {res}")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device and found none",
              file=sys.stderr)
        return 1
    from viennaray_tpu_torch.geometry.disk_geometry import DiskGeometry
    from viennaray_tpu_torch.geometry.triangle_geometry import TriangleGeometry
    from viennaray_tpu_torch.io import fixtures

    phase_card()
    phase_build()

    pts, nrm = fixtures.create_trench_grid_3d(**FLAGSHIP)
    # no device named: the CUDA device, as a user's call would get it
    geometry = DiskGeometry.build(pts, nrm, FLAGSHIP["grid_delta"])
    bbox = adjusted_bbox(geometry)

    hit_wide = check_nearest_hit(geometry, bbox, 1 << 20, "source", reps=10)
    check_nearest_hit(geometry, bbox, 1 << 20, "interior", reps=10)
    check_nearest_hit(geometry, bbox, 512, "interior", reps=200)
    check_nearest_hit(geometry, bbox, 1000, "interior", reps=200)  # ragged R
    hist_wide = check_histogram(geometry, 1 << 20, len(pts), reps=20)
    check_histogram(geometry, 512, len(pts), reps=200)
    check_histogram(geometry, 1 << 20, 18180, reps=20)
    flagship = bounce_settings()
    mirror = bounce_settings(specular=True, walls="REFLECTIVE")
    bounce_wide = check_bounce(
        geometry, bbox, 1 << 20, "source", 1, False, flagship, reps=10)
    check_bounce(geometry, bbox, 1 << 20, "interior", 1, False, flagship,
                 reps=10)
    check_bounce(geometry, bbox, 16384, "interior", 4, True, flagship,
                 reps=50)
    check_bounce(geometry, bbox, 512, "interior", 16, True, flagship,
                 reps=100)
    check_bounce(geometry, bbox, 1000, "interior", 16, True, flagship,
                 reps=100)  # ragged R
    check_bounce(geometry, bbox, 65536, "interior", 1, True, mirror, reps=50)
    # the 18,180-disk trench: chunks of 1,024 lanes, two staged tiles each
    fine = dict(FLAGSHIP, grid_delta=0.1)
    fine_geometry = DiskGeometry.build(
        *fixtures.create_trench_grid_3d(**fine), fine["grid_delta"]
    )
    fine_bbox = adjusted_bbox(fine_geometry)
    check_nearest_hit(fine_geometry, fine_bbox, 65536, "interior", reps=20)
    check_bounce(fine_geometry, fine_bbox, 16384, "interior", 4, True,
                 flagship, reps=20)
    flat, flat_bbox = trench_2d()
    flat_ignore = bounce_settings(walls="IGNORE", dim=2)
    flat_mirror = bounce_settings(specular=True, walls="REFLECTIVE", dim=2)
    check_bounce(flat, flat_bbox, 4096, "flat", 4, True, flat_ignore, reps=50)
    check_bounce(flat, flat_bbox, 4096, "flat", 4, True, flat_mirror, reps=50)

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
    check_bounce(mesh, mesh_bbox, 512, "interior", 16, True, flagship,
                 reps=50)
    check_bounce(mesh, mesh_bbox, 1000, "interior", 16, True, flagship,
                 reps=50)  # ragged R
    check_bounce(mesh, mesh_bbox, 65536, "interior", 1, True, mirror, reps=20)
    # the 9,000-triangle trench: chunks of 1,024 lanes, two staged tiles each
    mid = dict(FLAGSHIP, grid_delta=0.2)
    mid_mesh = TriangleGeometry.build(
        *fixtures.create_trench_mesh_3d(**mid), mid["grid_delta"]
    )
    check_nearest_hit(mid_mesh, adjusted_bbox(mid_mesh), 65536, "interior",
                      reps=10)
    # a 2D line mesh extruded to triangles, as TraceTriangle(dim=2) builds it
    ribbon, ribbon_bbox = trench_2d_lines()
    check_bounce(ribbon, ribbon_bbox, 4096, "flat", 4, True, flat_ignore,
                 reps=50)
    check_bounce(ribbon, ribbon_bbox, 4096, "flat", 4, True, flat_mirror,
                 reps=50)

    torch.cuda.reset_peak_memory_stats()
    launches = phase_main_path(pts, nrm)
    unfused_launches = phase_unfused_path(pts, nrm)
    tri_launches = phase_triangle_main_path(verts, tris)
    tri_unfused_launches = phase_triangle_unfused_path(verts, tris)
    emit({"phase": "peak_memory",
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape")
    emit({"kernels": [
        {
            "name": "disk_nearest_hit", "route": "cuda",
            "source": "viennaray_tpu_torch/csrc/nearest_hit.cu",
            "replaces": "viennaray_tpu/ops/pallas_intersect.py:166",
            # the default path is fused and never reaches it: its count is
            # the unfused path's run
            "launches": unfused_launches["disk_nearest_hit"],
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
            },
            **{k: hist_wide[k] for k in keys},
        },
        {
            "name": "triangle_nearest_hit", "route": "cuda",
            "source": "viennaray_tpu_torch/csrc/nearest_hit.cu",
            "replaces": "viennaray_tpu/ops/pallas_intersect.py:359",
            # as for disks: the unfused triangle path's run
            "launches": tri_unfused_launches["triangle_nearest_hit"],
            **{k: tri_hit_wide[k] for k in keys},
        },
        {
            "name": "fused_bounce", "route": "cuda",
            "source": "viennaray_tpu_torch/csrc/bounce.cu",
            "replaces": "viennaray_tpu/ops/pallas_bounce.py:1056",
            # both instantiations: the disk flagship's apply and the
            # triangle flagship's
            "launches": launches["fused_bounce"] + tri_launches["fused_bounce"],
            "launches_by_path": {
                "disks": launches["fused_bounce"],
                "triangles": tri_launches["fused_bounce"],
            },
            **{k: bounce_wide[k] for k in keys},
            "triangles": {k: tri_bounce_wide[k] for k in keys},
        },
    ]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
