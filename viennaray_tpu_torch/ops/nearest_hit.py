"""Closest disk, triangle or 2D line-segment hit per ray: host packers, plain
versions, CUDA wrappers.

Counterpart of ``viennaray_tpu/ops/pallas_intersect.py`` (disks, triangles,
the line packer) and of ``viennaray_tpu/ops/intersect.py:line_nearest_hit``
(the JAX package searches lines in XLA, not in a Pallas kernel; here the
line search is a third instantiation of the one kernel template).

- ``pack_disk_prims``, ``pack_triangle_prims``, ``pack_line_prims`` and their
  helpers are the host-side (numpy) packing of a geometry into Morton-compact
  chunks of a struct-of-arrays, kept as copies.
- ``disk_nearest_hit_ref`` / ``triangle_nearest_hit_ref`` /
  ``line_nearest_hit_ref`` are the plain PyTorch versions.
- ``disk_nearest_hit`` / ``triangle_nearest_hit`` / ``line_nearest_hit`` are
  the wrappers around the CUDA kernels of ``csrc/nearest_hit.cu``: on a CUDA
  tensor they launch the kernel or raise, on a CPU tensor they run the plain
  version. ``GROUP`` is the kernels' threads per ray.
- ``disk_reject_ref`` / ``triangle_reject_ref`` are plain versions of the
  kernels' division-free reject (``csrc/disk_hit.cuh:DiskReject``,
  ``csrc/tri_hit.cuh:TriReject``), for the tests that hold it to its
  invariant; nothing on the trace's path calls them.

Selection rule, both versions of every kind: the lowest t wins, then the
lowest sorted lane. A disk hit needs ``denom != 0``, ``t > t_near`` and
``|o + t d - c|^2 < r^2``; a triangle hit is the double-sided
Moller-Trumbore test ``|det| >= 1e-9``, ``u >= 0``, ``v >= 0``,
``u + v <= 1``, ``t > t_near``; a line hit is the 2D cross-product test
``denom != 0``, ``t > t_near``, ``1e-5 < s < 1 - 1e-5`` (the endpoint clip of
GeneralPipelineLine.cu:19-49: a ray through the 2e-5 of a segment's length
around a shared node misses both neighbours). The two versions do the same
float32 operations in the same order without fused multiply-adds (see
``csrc/disk_hit.cuh``, ``csrc/tri_hit.cuh``, ``csrc/line_hit.cuh``), so they
agree exactly.

Float64 (the float64 trace: rays, SoA and chunk boxes all float64, the
tables of a geometry widened by ``to(torch.float64)``): the plain versions
run the same operations in float64, and the wrappers launch the kernels'
float64 forms (``vr_*_nearest_hit_f64``, counted in ``launches_f64``), which
repeat them with the float64 round-to-nearest intrinsics, bit for bit. The
constants are the JAX package's float64 search's
(``viennaray_tpu/ops/intersect.py:29, 122, 188``): float32 values widened,
``BIG``, the determinant's ``float32(1e-9)`` and the clip's
``float32(1e-5)`` and ``float32(1) - float32(1e-5)``; ``t_near`` and the
guard ``1e-30`` are float64 values, as there. The float64 forms run no
reject: its margins are float32 rounding bounds.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build

BIG = np.float32(3.4e38)
# the triangle test's least |det|: a float32 value in both types, as the JAX
# package's float64 search widens its float32 eps (ops/intersect.py:122)
TRI_EPS = np.float32(1e-9)

# prims row layout (SoA): cx cy cz nx ny nz r2 ndc  -> (8, Npad)
PRIM_ROWS = 8

# The kernel's threads per ray (``csrc/nearest_hit.cu:kGroup``): a warp, at
# every width. On an H100 (PERF.md §6: ``chip_diagnose.py --launch-times``
# beside a build at one thread per ray with the same reject) a warp per ray
# was faster at every width of the unfused ladder (512 to 2^20 rays) on the
# 2,993 disks, the 5,760 triangles, the 782 segments and the 18,180 disks:
# 1.1x at 2^20 disks, 5.7x at 512 disks, 3.7x at 2^20 triangles, 40x at 512
# triangles. So the closest-hit search, unlike the bounce kernel
# (``ops/bounce.py:group_for``), has no rule by width.
GROUP = 32
# The most rays one launch takes: the kernel's ray count is a C int.
MAX_RAYS = 2**31 - 1


def auto_pt(n_prims: int) -> int:
    """Chunk width (lanes per SoA chunk) for a geometry of ``n_prims``: the
    reference's widths, so that both packages pack the same tables."""
    if n_prims <= 8192:
        return 512
    if n_prims * 32 <= 8 * 1024 * 1024:
        return 1024
    return 2048


def _morton3(c):
    """Interleave 3 x 21-bit cell coordinates into a 63-bit Morton code —
    chunks of consecutive codes are spatially COMPACT blocks, so a ray's
    slab test prunes all but O(N^(1/3)) chunk AABBs for ANY direction."""
    c = c - c.min(axis=0, keepdims=True)
    c = np.clip(c, 0, (1 << 21) - 1).astype(np.uint64)

    def spread(v):
        v &= np.uint64(0x1FFFFF)
        v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
        v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
        return v

    return (
        spread(c[:, 0])
        | (spread(c[:, 1]) << np.uint64(1))
        | (spread(c[:, 2]) << np.uint64(2))
    )


def _block_order(centers, cell, pad_to, sort_axis):
    """Morton-compact blocks of ``pad_to`` prims, blocks iterated
    source-side-first (descending block-max along ``sort_axis`` so early
    chunks establish t_min for the skip test).

    Returns the permutation original -> packed order.
    """
    n = len(centers)
    if n == 0:
        return np.zeros((0,), np.int32)
    c = np.floor(centers / cell).astype(np.int64)
    order = np.argsort(_morton3(c), kind="stable")
    n_chunks = -(-n // pad_to)
    # order blocks by descending max coordinate along the trace axis
    block_key = np.full((n_chunks,), -np.inf)
    for b in range(n_chunks):
        seg = order[b * pad_to : (b + 1) * pad_to]
        block_key[b] = centers[seg, sort_axis].max()
    blocks = np.argsort(-block_key, kind="stable")
    out = np.concatenate(
        [order[b * pad_to : (b + 1) * pad_to] for b in blocks]
    )
    return out.astype(np.int32)


def pack_disk_prims(points, normals, radii, pad_to=None, sort_axis=2):
    """Host-side SoA packing: Morton-compact chunks, source-side-first.

    Returns (prims (8, Npad) f32, perm (Npad,) int32 sorted->original,
             chunk_bboxes (n_chunks, 8) f32 [xmin ymin zmin xmax ymax zmax 0 0]).
    """
    points = np.asarray(points, np.float32)
    normals = np.asarray(normals, np.float32)
    radii = np.asarray(radii, np.float32)
    n = len(points)
    if pad_to is None:
        pad_to = auto_pt(n)

    if n > 0:
        cell = max(float(radii.max()) * 8.0, 1e-6)
        order = _block_order(points, cell, pad_to, sort_axis)
    else:
        order = np.zeros((0,), np.int32)

    pts_s = points[order]
    nrm_s = normals[order]
    rad_s = radii[order]

    npad = -(-max(n, 1) // pad_to) * pad_to
    out = np.zeros((PRIM_ROWS, npad), np.float32)
    out[0:3, :n] = pts_s.T
    out[3:6, :n] = nrm_s.T
    out[6, :n] = rad_s * rad_s
    out[7, :n] = np.sum(nrm_s * pts_s, axis=1)
    # padding prims: zero normal -> denom==0 -> never valid
    out[0:3, n:] = 1e18

    perm = np.zeros((npad,), np.int32)
    perm[:n] = order

    n_chunks = npad // pad_to
    bbs = np.full((n_chunks, 8), 1e18, np.float32)
    for ci in range(n_chunks):
        lo = ci * pad_to
        hi = min(lo + pad_to, n)
        if hi <= lo:
            continue
        p = pts_s[lo:hi]
        r = rad_s[lo:hi, None]
        bbs[ci, 0:3] = (p - r).min(axis=0)
        bbs[ci, 3:6] = (p + r).max(axis=0)
        bbs[ci, 6:8] = 0.0
    return out, perm, bbs


# prims row layout of triangles (SoA): v0(3) e1(3) e2(3) n(3) -> (12, Npad)
TRI_ROWS = 12


def pack_triangle_prims(vertices, triangles, normals=None, pad_to=None,
                        sort_axis=2):
    """SoA triangle packing: rows [v0(3) e1(3) e2(3) n(3)] -> (12, Npad),
    spatially sorted source-side-first like the disk packing. Rows 9-11 carry
    the STORED unit normals (user orientation may differ from cross(e1,e2));
    when ``normals`` is None they are computed from the edge cross product
    (the geometry's default, rayGeometryTriangle.hpp:57-75).

    Returns (prims (12, Npad), perm (Npad,) int32, chunk_bboxes (n_chunks, 8)).
    """
    vertices = np.asarray(vertices, np.float32)
    triangles = np.asarray(triangles, np.int64)
    n = len(triangles)
    if pad_to is None:
        pad_to = auto_pt(n)
    v0 = vertices[triangles[:, 0]]
    v1 = vertices[triangles[:, 1]]
    v2 = vertices[triangles[:, 2]]
    if normals is None:
        cr = np.cross(v1 - v0, v2 - v0)
        ln = np.linalg.norm(cr, axis=1, keepdims=True)
        normals = cr / np.where(ln > 0, ln, 1.0)
    else:
        normals = np.asarray(normals, np.float32).reshape(-1, 3)

    if n > 0:
        centroid = (v0 + v1 + v2) / 3.0
        scale = max(float(np.abs(v1 - v0).max()), 1e-6) * 4.0
        order = _block_order(centroid, scale, pad_to, sort_axis)
    else:
        order = np.zeros((0,), np.int32)

    v0s, v1s, v2s = v0[order], v1[order], v2[order]
    npad = -(-max(n, 1) // pad_to) * pad_to
    out = np.zeros((TRI_ROWS, npad), np.float32)
    out[0:3, :n] = v0s.T
    out[3:6, :n] = (v1s - v0s).T
    out[6:9, :n] = (v2s - v0s).T
    out[9:12, :n] = normals[order].T
    out[0:3, n:] = 1e18  # far-away padding; zero edges -> det==0 -> invalid

    perm = np.zeros((npad,), np.int32)
    perm[:n] = order

    n_chunks = npad // pad_to
    bbs = np.full((n_chunks, 8), 1e18, np.float32)
    for ci in range(n_chunks):
        lo = ci * pad_to
        hi = min(lo + pad_to, n)
        if hi <= lo:
            continue
        allv = np.concatenate([v0s[lo:hi], v1s[lo:hi], v2s[lo:hi]])
        bbs[ci, 0:3] = allv.min(axis=0)
        bbs[ci, 3:6] = allv.max(axis=0)
        bbs[ci, 6:8] = 0.0
    return out, perm, bbs


# prims row layout of 2D line segments (SoA): p0x p0y ldx ldy nx ny -> (6, Npad)
LINE_ROWS = 6
# the endpoint clip keeps 1e-5 < s < 1 - 1e-5. The upper end is ONE float32
# value in both versions: float32(1) - float32(1e-5), bits 0x3f7fff58, which
# is also what the double 1 - 1e-5 rounds to.
LINE_S_MIN = np.float32(1e-5)
LINE_S_MAX = np.float32(1.0) - np.float32(1e-5)


def pack_line_prims(p0, p1, normals, pad_to=None, sort_axis=1):
    """SoA 2D line-segment packing: rows [p0x p0y ldx ldy nx ny] -> (6, Npad)
    in Morton-compact source-side-first chunk order (parity with the GPU
    line pipeline's custom prims, gpu/raygLineGeometry.hpp).

    Returns (prims (6, Npad), perm (Npad,), chunk_bboxes (n_chunks, 8)); the
    chunk boxes are z-inflated by +-1 so the 3D slab test never sees a
    degenerate interval (line geometry is strictly 2D, z = 0).
    """
    p0 = np.asarray(p0, np.float32)
    p1 = np.asarray(p1, np.float32)
    normals = np.asarray(normals, np.float32)
    n = len(p0)
    if pad_to is None:
        pad_to = auto_pt(n)

    if n > 0:
        mid = 0.5 * (p0 + p1)
        seg = max(float(np.linalg.norm((p1 - p0)[:, :2], axis=1).max()), 1e-6)
        order = _block_order(mid, seg * 8.0, pad_to, sort_axis)
    else:
        order = np.zeros((0,), np.int32)

    p0s, p1s, nrm_s = p0[order], p1[order], normals[order]
    npad = -(-max(n, 1) // pad_to) * pad_to
    out = np.zeros((LINE_ROWS, npad), np.float32)
    out[0, :n] = p0s[:, 0]
    out[1, :n] = p0s[:, 1]
    out[2, :n] = (p1s - p0s)[:, 0]
    out[3, :n] = (p1s - p0s)[:, 1]
    out[4, :n] = nrm_s[:, 0]
    out[5, :n] = nrm_s[:, 1]
    out[0:2, n:] = 1e18  # far padding; zero line dir -> denom == 0 -> invalid

    perm = np.zeros((npad,), np.int32)
    perm[:n] = order

    n_chunks = npad // pad_to
    bbs = np.full((n_chunks, 8), 1e18, np.float32)
    for ci in range(n_chunks):
        lo = ci * pad_to
        hi = min(lo + pad_to, n)
        if hi <= lo:
            continue
        allv = np.concatenate([p0s[lo:hi], p1s[lo:hi]])
        bbs[ci, 0:3] = allv.min(axis=0)
        bbs[ci, 3:6] = allv.max(axis=0)
        bbs[ci, 2] -= 1.0
        bbs[ci, 5] += 1.0
        bbs[ci, 6:8] = 0.0
    return out, perm, bbs


def _check_inputs(org, dirn, prims, perm, chunk_bbs, rows=PRIM_ROWS):
    """Shape, type, device and contiguity the kernel takes; raises otherwise."""
    if org.ndim != 2 or org.shape[1] != 3 or dirn.shape != org.shape:
        raise ValueError("org and dirn must both be (R, 3)")
    if org.shape[0] > MAX_RAYS:
        raise ValueError(f"at most {MAX_RAYS} rays, got {org.shape[0]}")
    if prims.ndim != 2 or prims.shape[0] != rows:
        raise ValueError(f"prims must be ({rows}, Npad)")
    npad = prims.shape[1]
    if perm.shape != (npad,):
        raise ValueError("perm must be (Npad,)")
    if chunk_bbs.ndim != 2 or chunk_bbs.shape[1] != 8:
        raise ValueError("chunk_bbs must be (n_chunks, 8)")
    if chunk_bbs.shape[0] == 0 or npad % chunk_bbs.shape[0]:
        raise ValueError("Npad must be a whole number of chunks")
    if org.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"org must be float32 or float64, got {org.dtype}")
    fdt = org.dtype  # every float table in the rays' type
    for name, x, dt in (
        ("org", org, fdt), ("dirn", dirn, fdt),
        ("prims", prims, fdt), ("chunk_bbs", chunk_bbs, fdt),
        ("perm", perm, torch.int32),
    ):
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")
        if x.device != org.device:
            raise ValueError(f"{name} is on {x.device}, org on {org.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


# (ray, disk) pairs the plain version holds at a time: its temporaries stay
# in cache on a CPU and bounded on a card
_REF_BLOCK_PAIRS = {"cpu": 1 << 16, "cuda": 1 << 24}


def disk_nearest_hit_ref(org, dirn, prims, perm, chunk_bbs=None, t_near=1e-4):
    """Plain PyTorch version of the kernel, on any device.

    org/dirn (R, 3) f32 or f64; prims (8, Npad) of the same type; perm
    (Npad,) sorted->original. ``chunk_bbs`` is accepted for the kernel's
    signature and never read: the result does not depend on chunk skipping.
    Rays go through in blocks of a fixed number of (ray, disk) pairs,
    through four reused buffers.
    Returns (t (R,) of org's type, prim (R,) int32 original numbering, hit
    (R,) bool).
    """
    R = org.shape[0]
    npad = prims.shape[1]
    dev = org.device
    lanes = torch.arange(npad, device=dev, dtype=torch.int32)[None, :]
    big = torch.tensor(BIG, device=dev)
    t_out = torch.empty(R, dtype=org.dtype, device=dev)
    idx_out = torch.empty(R, dtype=torch.int32, device=dev)
    step = max(1, min(R, _REF_BLOCK_PAIRS[dev.type] // npad))
    bufs = torch.empty((4, step, npad), dtype=org.dtype, device=dev)
    for lo in range(0, R, step):
        tt = disk_pair_times(org[lo:lo + step], dirn[lo:lo + step], prims,
                             t_near, bufs)
        _pick_lowest(tt, lanes, t_out, idx_out, lo)
    return _finish(t_out, idx_out, perm, big)


def disk_pair_times(o, d, prims, t_near, bufs=None):
    """The exact disk test of every (ray, lane) pair of a block of rays: (n,
    Npad) of the rays' type, the hit's t where the pair hits, else ``BIG``.
    ``bufs``: four (>= n, Npad) buffers of that type it may write (None:
    fresh ones)."""
    dev = o.device
    n, npad = o.shape[0], prims.shape[1]
    if bufs is None:
        bufs = torch.empty((4, n, npad), dtype=o.dtype, device=dev)
    cx, cy, cz, nx, ny, nz, r2, ndc = (prims[i][None, :] for i in range(8))
    tiny = torch.tensor(1e-30, dtype=o.dtype, device=dev)
    tn = torch.tensor(t_near, dtype=o.dtype, device=dev)
    den, t, tmp, dist2 = (b[:n] for b in bufs)
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    # One op per operation, in the order of csrc/disk_hit.cuh:
    # denom = (dx*nx + dy*ny) + dz*nz
    torch.mul(dx, nx, out=den)
    den.add_(torch.mul(dy, ny, out=tmp))
    den.add_(torch.mul(dz, nz, out=tmp))
    # t = (ndc - ((ox*nx + oy*ny) + oz*nz)) / dsafe
    torch.mul(ox, nx, out=t)
    t.add_(torch.mul(oy, ny, out=tmp))
    t.add_(torch.mul(oz, nz, out=tmp))
    torch.sub(ndc, t, out=t)
    nonzero = den != 0.0
    t.div_(torch.where(nonzero, den, tiny, out=den))
    # dist2 = (hx*hx + hy*hy) + hz*hz with h = (o + t*d) - c
    torch.mul(t, dx, out=dist2).add_(ox).sub_(cx)
    dist2.mul_(dist2)
    torch.mul(t, dy, out=tmp).add_(oy).sub_(cy)
    dist2.add_(tmp.mul_(tmp))
    torch.mul(t, dz, out=tmp).add_(oz).sub_(cz)
    dist2.add_(tmp.mul_(tmp))
    valid = nonzero & (t > tn) & (dist2 < r2)
    return torch.where(valid, t, torch.tensor(BIG, device=dev))


def _pick_lowest(tt, lanes, t_out, idx_out, lo):
    """Write a block's lowest t per ray and, among the lanes that reach it,
    the lowest sorted lane (written out: argmin's choice among equal values
    is not specified on every device)."""
    n = tt.shape[0]
    tmin = tt.amin(dim=1)
    t_out[lo:lo + n] = tmin
    idx_out[lo:lo + n] = torch.where(
        tt == tmin[:, None], lanes, tt.shape[1]
    ).amin(dim=1)


def _finish(t_out, idx_out, perm, big):
    hit = t_out < big
    idx_out = torch.where(hit, idx_out, torch.zeros_like(idx_out))
    return t_out, perm[idx_out.long()], hit


def triangle_nearest_hit_ref(org, dirn, prims, perm, chunk_bbs=None,
                             t_near=1e-4):
    """Plain PyTorch version of the triangle kernel, on any device.

    org/dirn (R, 3) f32 or f64; prims (12, Npad) of the same type; perm
    (Npad,) sorted->original. ``chunk_bbs`` is accepted for the kernel's
    signature and never read. Rays go through in blocks of a fixed number of
    (ray, triangle) pairs.
    Returns (t (R,) of org's type, prim (R,) int32 original numbering, hit
    (R,) bool).
    """
    R = org.shape[0]
    npad = prims.shape[1]
    dev = org.device
    lanes = torch.arange(npad, device=dev, dtype=torch.int32)[None, :]
    big = torch.tensor(BIG, device=dev)
    t_out = torch.empty(R, dtype=org.dtype, device=dev)
    idx_out = torch.empty(R, dtype=torch.int32, device=dev)
    step = max(1, min(R, _REF_BLOCK_PAIRS[dev.type] // npad))
    for lo in range(0, R, step):
        tt = triangle_pair_times(org[lo:lo + step], dirn[lo:lo + step], prims,
                                 t_near)
        _pick_lowest(tt, lanes, t_out, idx_out, lo)
    return _finish(t_out, idx_out, perm, big)


def triangle_pair_times(o, d, prims, t_near):
    """The exact triangle test of every (ray, lane) pair of a block of rays:
    (n, Npad) of the rays' type, the hit's t where the pair hits, else
    ``BIG``. One tensor op per operation, in the order of csrc/tri_hit.cuh;
    three products are summed as (a + b) + c."""
    dev = o.device
    ax, ay, az, e1x, e1y, e1z, e2x, e2y, e2z = (
        prims[i][None, :] for i in range(9)
    )
    like = dict(dtype=o.dtype, device=dev)
    tiny = torch.tensor(1e-30, **like)
    eps = torch.tensor(float(TRI_EPS), **like)
    tn = torch.tensor(t_near, **like)
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    # h = d x e2
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    det = (hx * e1x + hy * e1y) + hz * e1z
    ok = det.abs() >= eps
    dsafe = torch.where(ok, det, tiny)
    del det
    sx, sy, sz = ox - ax, oy - ay, oz - az
    u = ((sx * hx + sy * hy) + sz * hz) / dsafe
    del hx, hy, hz
    # q = s x e1
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    del sx, sy, sz
    v = ((qx * dx + qy * dy) + qz * dz) / dsafe
    t = ((qx * e2x + qy * e2y) + qz * e2z) / dsafe
    del qx, qy, qz, dsafe
    valid = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > tn)
    return torch.where(valid, t, torch.tensor(BIG, device=dev))


def line_nearest_hit_ref(org, dirn, prims, perm, chunk_bbs=None, t_near=1e-4):
    """Plain PyTorch version of the line kernel, on any device.

    org/dirn (R, 3) f32 or f64, of which only x and y are read; prims (6,
    Npad) of the same type; perm (Npad,) sorted->original. ``chunk_bbs`` is
    accepted for the kernel's signature and never read. One tensor op per
    operation, in the order of csrc/line_hit.cuh, with two IEEE divisions
    (the JAX package multiplies by one reciprocal).
    Returns (t (R,) of org's type, prim (R,) int32 original numbering, hit
    (R,) bool).
    """
    R = org.shape[0]
    npad = prims.shape[1]
    dev = org.device
    p0x, p0y, lx, ly = (prims[i][None, :] for i in range(4))
    lanes = torch.arange(npad, device=dev, dtype=torch.int32)[None, :]
    big = torch.tensor(BIG, device=dev)
    like = dict(dtype=org.dtype, device=dev)
    tiny = torch.tensor(1e-30, **like)
    tn = torch.tensor(t_near, **like)
    # the clip's ends are float32 values in both types (widened in float64)
    s_min = torch.tensor(float(LINE_S_MIN), **like)
    s_max = torch.tensor(float(LINE_S_MAX), **like)
    t_out = torch.empty(R, dtype=org.dtype, device=dev)
    idx_out = torch.empty(R, dtype=torch.int32, device=dev)
    step = max(1, min(R, _REF_BLOCK_PAIRS[dev.type] // npad))
    for lo in range(0, R, step):
        o = org[lo:lo + step]
        d = dirn[lo:lo + step]
        ox, oy = o[:, 0:1], o[:, 1:2]
        dx, dy = d[:, 0:1], d[:, 1:2]
        denom = dx * ly - dy * lx
        nonzero = denom != 0.0
        dsafe = torch.where(nonzero, denom, tiny)
        del denom
        wx, wy = p0x - ox, p0y - oy
        t = (wx * ly - wy * lx) / dsafe
        s = (wx * dy - wy * dx) / dsafe
        del wx, wy, dsafe
        valid = nonzero & (t > tn) & (s > s_min) & (s < s_max)
        del s
        _pick_lowest(torch.where(valid, t, big), lanes, t_out, idx_out, lo)
    return _finish(t_out, idx_out, perm, big)


def _fma(a, b, c, fma):
    """a * b + c in float32: one rounding (a fused multiply-add, emulated by
    the exact float64 product and one float64 sum, rounded once more to
    float32) with ``fma``, else two (one op per operation)."""
    if fma:
        return (a.double() * b.double() + c.double()).float()
    return a * b + c


def _reject_setup(org, chunk_bbs, npad):
    """Per ray |o|_inf (R, 1); per lane the largest |coordinate| B and the
    largest extent L of its chunk's box (1, Npad)."""
    pt = npad // chunk_bbs.shape[0]
    box = chunk_bbs[:, :6]
    b = box.abs().amax(dim=1)
    ext = box[:, 3:6] - box[:, 0:3]
    l = torch.maximum(torch.maximum(ext[:, 0], ext[:, 1]), ext[:, 2])
    so = org.abs().amax(dim=1, keepdim=True)
    return (so, b.repeat_interleave(pt)[None, :],
            l.repeat_interleave(pt)[None, :])


def disk_reject_ref(org, dirn, prims, chunk_bbs, t_near, tmin, fma=False):
    """Plain version of the kernel's division-free disk reject
    (``csrc/disk_hit.cuh:DiskReject``), on any device: the (R, Npad) bool
    mask of the (ray, lane) pairs it drops below the bound ``tmin`` ((R, 1)
    or (R, Npad) float32). The same float32 operations in the same order;
    ``fma`` rounds each of the kernel's FMAs once (as the card does), else
    twice. Used by the tests that hold the reject to its invariant (a dropped
    pair is never one that the exact test selects below ``tmin``)."""
    so, b, _ = _reject_setup(org, chunk_bbs, prims.shape[1])
    ox, oy, oz = (org[:, i:i + 1] for i in range(3))
    dx, dy, dz = (dirn[:, i:i + 1] for i in range(3))
    cx, cy, cz, r2 = (prims[i][None, :] for i in (0, 1, 2, 6))
    dd = _fma(dx, dx, _fma(dy, dy, dz * dz, fma), fma)
    tnd = torch.tensor(t_near, dtype=torch.float32, device=org.device) * dd
    eps = (so + b) * 2.0**-16
    kr = dd * (1.0 + 2.0**-9)
    ke = dd * (eps * eps * 4096.0)
    wx, wy, wz = cx - ox, cy - oy, cz - oz
    kx = _fma(wy, dz, -(wz * dy), fma)
    ky = _fma(wz, dx, -(wx * dz), fma)
    kz = _fma(wx, dy, -(wy * dx), fma)
    cross2 = _fma(kx, kx, _fma(ky, ky, kz * kz, fma), fma)
    bb = _fma(wx, dx, _fma(wy, dy, wz * dz, fma), fma)
    thr = _fma(r2, kr, ke, fma)
    e = tnd - bb
    f = _fma(-tmin, dd, bb, fma)
    return ((cross2 > thr) | ((e > 0.0) & (e * e > thr))
            | ((f > 0.0) & (f * f > thr)))


def triangle_reject_ref(org, dirn, prims, chunk_bbs, t_near, tmin, fma=False):
    """Plain version of the kernel's division-free triangle reject
    (``csrc/tri_hit.cuh:TriReject``), with the contract of
    ``disk_reject_ref``."""
    so, b, l = _reject_setup(org, chunk_bbs, prims.shape[1])
    ox, oy, oz = (org[:, i:i + 1] for i in range(3))
    dx, dy, dz = (dirn[:, i:i + 1] for i in range(3))
    ax, ay, az, e1x, e1y, e1z, e2x, e2y, e2z = (
        prims[i][None, :] for i in range(9)
    )
    tn = torch.tensor(t_near, dtype=torch.float32, device=org.device)
    dm = dirn.abs().amax(dim=1, keepdim=True)
    sl = (so + b) * 2.0**-16 * l
    m_det = l * 2.0**-16 * l * dm
    m_u = sl * dm
    m_t = sl * l
    lim = 1e-9 - m_det
    hx = _fma(dy, e2z, -(dz * e2y), fma)
    hy = _fma(dz, e2x, -(dx * e2z), fma)
    hz = _fma(dx, e2y, -(dy * e2x), fma)
    det = _fma(hx, e1x, _fma(hy, e1y, hz * e1z, fma), fma)
    sx, sy, sz = ox - ax, oy - ay, oz - az
    uu = _fma(sx, hx, _fma(sy, hy, sz * hz, fma), fma)
    qx = _fma(sy, e1z, -(sz * e1y), fma)
    qy = _fma(sz, e1x, -(sx * e1z), fma)
    qz = _fma(sx, e1y, -(sy * e1x), fma)
    vv = _fma(qx, dx, _fma(qy, dy, qz * dz, fma), fma)
    tt = _fma(qx, e2x, _fma(qy, e2y, qz * e2z, fma), fma)
    ad = det.abs()
    g = torch.where(det < 0.0, -1.0, 1.0)
    gu, gv, gt = g * uu, g * vv, g * tt
    mb = ad * 2.0**-100 + m_u
    signed = (
        (gu < -mb) | (gv < -mb)
        | ((gu + gv) - ad > ad * 2.0**-18 + (m_u * 2.0 + m_det))
        | (gt + m_t <= tn * (ad - m_det) * (1.0 - 2.0**-18))
        | (gt - m_t >= tmin * (ad + m_det) * (1.0 + 2.0**-18))
    )
    zero_edge = (ad == 0.0) & (e2x == 0.0) & (e2y == 0.0) & (e2z == 0.0)
    return (ad < lim) | torch.where(ad > m_det, signed, zero_edge)


def _launch(wrapper, entry, org, dirn, prims, perm, chunk_bbs, t_near):
    """Launch the closest-hit kernel ``entry`` of ``csrc/nearest_hit.cu``, or
    its float64 form ``entry + "_f64"`` for float64 rays, on checked CUDA
    tensors and count it on ``wrapper``; returns (t, prim, hit)."""
    f64 = org.dtype == torch.float64
    if f64:
        entry += "_f64"
    R = org.shape[0]
    npad = prims.shape[1]
    t = torch.empty(R, dtype=org.dtype, device=org.device)
    prim = torch.empty(R, dtype=torch.int32, device=org.device)
    hit = torch.empty(R, dtype=torch.bool, device=org.device)
    lib = _build.library()
    with torch.cuda.device(org.device):
        err = getattr(lib, entry)(
            org.data_ptr(), dirn.data_ptr(), prims.data_ptr(),
            chunk_bbs.data_ptr(), perm.data_ptr(), R, npad,
            npad // chunk_bbs.shape[0], float(t_near), t.data_ptr(),
            prim.data_ptr(), hit.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}")
    if f64:
        wrapper.launches_f64 += 1
    else:
        wrapper.launches += 1
    return t, prim, hit


def disk_nearest_hit(org, dirn, prims, perm, chunk_bbs, t_near=1e-4):
    """Closest disk hit; R up to ``MAX_RAYS``. On CUDA tensors launches the
    kernel of ``csrc/nearest_hit.cu`` (or raises); on CPU tensors runs the
    plain version.

    org/dirn (R, 3) f32; prims (8, Npad) f32; perm (Npad,) int32; chunk_bbs
    (Npad / pt, 8) f32; or every float tensor f64, which launches the float64
    form (``launches_f64``). Returns (t (R,) of org's type, prim (R,) int32 in
    ORIGINAL numbering, hit (R,) bool).
    """
    _check_inputs(org, dirn, prims, perm, chunk_bbs)
    if org.device.type == "cpu":
        return disk_nearest_hit_ref(org, dirn, prims, perm, chunk_bbs, t_near)
    if org.device.type != "cuda":
        raise RuntimeError(f"disk_nearest_hit: unsupported device {org.device}")
    return _launch(disk_nearest_hit, "vr_disk_nearest_hit", org, dirn,
                   prims, perm, chunk_bbs, t_near)


disk_nearest_hit.launches = 0
disk_nearest_hit.launches_f64 = 0


def triangle_nearest_hit(org, dirn, prims, perm, chunk_bbs, t_near=1e-4):
    """Closest triangle hit; R up to ``MAX_RAYS``; the contract of
    ``disk_nearest_hit`` with prims (12, Npad) from ``pack_triangle_prims``.
    On CUDA tensors launches the triangle kernel of ``csrc/nearest_hit.cu``
    (or raises); on CPU tensors runs the plain version."""
    _check_inputs(org, dirn, prims, perm, chunk_bbs, rows=TRI_ROWS)
    if org.device.type == "cpu":
        return triangle_nearest_hit_ref(
            org, dirn, prims, perm, chunk_bbs, t_near
        )
    if org.device.type != "cuda":
        raise RuntimeError(
            f"triangle_nearest_hit: unsupported device {org.device}"
        )
    return _launch(triangle_nearest_hit, "vr_triangle_nearest_hit", org, dirn,
                   prims, perm, chunk_bbs, t_near)


triangle_nearest_hit.launches = 0
triangle_nearest_hit.launches_f64 = 0


def line_nearest_hit(org, dirn, prims, perm, chunk_bbs, t_near=1e-4):
    """Closest 2D line-segment hit; R up to ``MAX_RAYS``; the contract of
    ``disk_nearest_hit`` with prims (6, Npad) from ``pack_line_prims``. On
    CUDA tensors launches the line kernel of ``csrc/nearest_hit.cu`` (or
    raises); on CPU tensors runs the plain version."""
    _check_inputs(org, dirn, prims, perm, chunk_bbs, rows=LINE_ROWS)
    if org.device.type == "cpu":
        return line_nearest_hit_ref(org, dirn, prims, perm, chunk_bbs, t_near)
    if org.device.type != "cuda":
        raise RuntimeError(f"line_nearest_hit: unsupported device {org.device}")
    return _launch(line_nearest_hit, "vr_line_nearest_hit", org, dirn,
                   prims, perm, chunk_bbs, t_near)


line_nearest_hit.launches = 0
line_nearest_hit.launches_f64 = 0
