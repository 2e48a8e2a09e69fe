"""Closest disk hit per ray: host packers, plain version, CUDA wrapper.

Counterpart of ``viennaray_tpu/ops/pallas_intersect.py`` (the disk part).

- ``pack_disk_prims`` and its helpers are the host-side (numpy) packing of a
  disk cloud into Morton-compact chunks of a struct-of-arrays, kept as copies.
- ``disk_nearest_hit_ref`` is the plain PyTorch version.
- ``disk_nearest_hit`` is the wrapper around the CUDA kernel
  ``csrc/nearest_hit.cu``: on a CUDA tensor it launches the kernel or raises,
  on a CPU tensor it runs the plain version.

Selection rule, both versions: a hit needs ``denom != 0``, ``t > t_near`` and
``|o + t d - c|^2 < r^2``; the lowest t wins, then the lowest sorted lane.
The two versions do the same float32 operations in the same order without
fused multiply-adds (see ``csrc/disk_hit.cuh``), so they agree exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build

BIG = np.float32(3.4e38)

# prims row layout (SoA): cx cy cz nx ny nz r2 ndc  -> (8, Npad)
PRIM_ROWS = 8


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


def _check_inputs(org, dirn, prims, perm, chunk_bbs):
    """Shape, type, device and contiguity the kernel takes; raises otherwise."""
    if org.ndim != 2 or org.shape[1] != 3 or dirn.shape != org.shape:
        raise ValueError("org and dirn must both be (R, 3)")
    if prims.ndim != 2 or prims.shape[0] != PRIM_ROWS:
        raise ValueError(f"prims must be ({PRIM_ROWS}, Npad)")
    npad = prims.shape[1]
    if perm.shape != (npad,):
        raise ValueError("perm must be (Npad,)")
    if chunk_bbs.ndim != 2 or chunk_bbs.shape[1] != 8:
        raise ValueError("chunk_bbs must be (n_chunks, 8)")
    if chunk_bbs.shape[0] == 0 or npad % chunk_bbs.shape[0]:
        raise ValueError("Npad must be a whole number of chunks")
    for name, x, dt in (
        ("org", org, torch.float32), ("dirn", dirn, torch.float32),
        ("prims", prims, torch.float32), ("chunk_bbs", chunk_bbs, torch.float32),
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

    org/dirn (R, 3) f32; prims (8, Npad); perm (Npad,) sorted->original.
    ``chunk_bbs`` is accepted for the kernel's signature and never read: the
    result does not depend on chunk skipping. Rays go through in blocks of
    a fixed number of (ray, disk) pairs, through four reused buffers.
    Returns (t (R,) f32, prim (R,) int32 original numbering, hit (R,) bool).
    """
    R = org.shape[0]
    npad = prims.shape[1]
    dev = org.device
    cx, cy, cz, nx, ny, nz, r2, ndc = (prims[i][None, :] for i in range(8))
    lanes = torch.arange(npad, device=dev, dtype=torch.int32)[None, :]
    big = torch.tensor(BIG, device=dev)
    tiny = torch.tensor(1e-30, dtype=torch.float32, device=dev)
    tn = torch.tensor(t_near, dtype=torch.float32, device=dev)
    t_out = torch.empty(R, dtype=torch.float32, device=dev)
    idx_out = torch.empty(R, dtype=torch.int32, device=dev)
    step = max(1, min(R, _REF_BLOCK_PAIRS[dev.type] // npad))
    bufs = torch.empty((4, step, npad), dtype=torch.float32, device=dev)
    for lo in range(0, R, step):
        o = org[lo:lo + step]
        d = dirn[lo:lo + step]
        den, t, tmp, dist2 = (b[: o.shape[0]] for b in bufs)
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
        tt = torch.where(valid, t, big)
        tmin = tt.amin(dim=1)
        # lowest sorted lane among the minima (written out: argmin's choice
        # among equal values is not specified on every device)
        first = torch.where(tt == tmin[:, None], lanes, npad).amin(dim=1)
        t_out[lo:lo + step] = tmin
        idx_out[lo:lo + step] = first
    hit = t_out < big
    idx_out = torch.where(hit, idx_out, torch.zeros_like(idx_out))
    return t_out, perm[idx_out.long()], hit


def disk_nearest_hit(org, dirn, prims, perm, chunk_bbs, t_near=1e-4):
    """Closest disk hit; any R. On CUDA tensors launches the kernel of
    ``csrc/nearest_hit.cu`` (or raises); on CPU tensors runs the plain version.

    org/dirn (R, 3) f32; prims (8, Npad) f32; perm (Npad,) int32; chunk_bbs
    (Npad / pt, 8) f32. Returns (t (R,), prim (R,) int32 in ORIGINAL
    numbering, hit (R,) bool).
    """
    _check_inputs(org, dirn, prims, perm, chunk_bbs)
    if org.device.type == "cpu":
        return disk_nearest_hit_ref(org, dirn, prims, perm, chunk_bbs, t_near)
    if org.device.type != "cuda":
        raise RuntimeError(f"disk_nearest_hit: unsupported device {org.device}")
    R = org.shape[0]
    npad = prims.shape[1]
    t = torch.empty(R, dtype=torch.float32, device=org.device)
    prim = torch.empty(R, dtype=torch.int32, device=org.device)
    hit = torch.empty(R, dtype=torch.bool, device=org.device)
    lib = _build.library()
    with torch.cuda.device(org.device):
        err = lib.vr_disk_nearest_hit(
            org.data_ptr(), dirn.data_ptr(), prims.data_ptr(),
            chunk_bbs.data_ptr(), perm.data_ptr(), R, npad,
            npad // chunk_bbs.shape[0], float(t_near), t.data_ptr(),
            prim.data_ptr(), hit.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"vr_disk_nearest_hit: CUDA error {err}")
    disk_nearest_hit.launches += 1
    return t, prim, hit


disk_nearest_hit.launches = 0
