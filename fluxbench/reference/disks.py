"""A plain Monte Carlo flux tracer for oriented-disk clouds on a few planes.

The benchmark's reference: the semantics of ViennaRay's disk tracer
(rayTraceKernel.hpp, rayBoundary.hpp, rayReflection.hpp, raySourceRandom.hpp,
rayGeometryDisk.hpp, rayTraceDisk.hpp) written out in plain PyTorch and NumPy.
It imports nothing of the program under test and takes nothing it made: it
works out the disks' radius, neighbor lists, areas and its own search
structure from the points and normals the benchmark generated.

The search groups the disks by the plane they lie on (a trench is four
planes), intersects each ray with every plane and tests, with the disk's own
arithmetic, the disks whose centres lie near the crossing point. So it finds
the closest disk hit, from either side, as a search over all disks would,
and refuses a cloud of more than ``MAX_PLANES`` planes, for which it would be
no faster than that search.

Every ray runs to its end: a geometry hit (a front hit deposits the ray's
weight on the hit disk and on each neighbor the ray crosses, then reflects
diffusely and loses the sticking share; a hit from behind passes the first
time and kills the second), a wall (periodic: the ray moves to the opposite
wall; reflective: it mirrors; ignore: it ends), or an escape; Russian
roulette ends weak rays. ``dtype`` is the type of the tracing arithmetic:
float32 for the reference, bfloat16 for the benchmark's control. Fluxes are
summed in float64.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

# radius = grid delta * sqrt(3) / 2 * (1 + 1e-5) in 3D (rayUtil.hpp DiskFactor)
DISK_FACTOR_3D = 0.5 * 1.7320508 * (1 + 1e-5)
T_NEAR = 1e-4  # rayUtil.hpp: rays ignore hits closer than this
NEIGHBOR_EPS = 1e-6  # rayTraceKernel.hpp:462-507, the re-test's least |n . d|
WEIGHT_THRESHOLD = 0.1  # roulette below this share of the start weight
RENEW_WEIGHT = 0.3  # and a survivor's new weight
MAX_PLANES = 64
BIG = 1e30
WALL_KINDS = ("reflective", "periodic", "ignore")


@dataclasses.dataclass
class Cloud:
    """A disk cloud as the reference sees it (float64 and numpy unless
    said): the disks, the box, the walls and the search tables."""

    points: np.ndarray  # (N, 3)
    normals: np.ndarray  # (N, 3), unit
    radius: float
    bbox: np.ndarray  # (2, 3), the box of the centres
    source_z: float  # the source plane, 2 radii above the box
    neighbors: np.ndarray  # (N, K) int64, -1 padded: centres within 2 radii
    plane_normal: np.ndarray  # (P, 3)
    plane_offset: np.ndarray  # (P,)  n . c
    plane_axes: np.ndarray  # (P, 2, 3) in-plane unit axes
    plane_lo: np.ndarray  # (P, 2) in-plane corner of the cell table
    plane_dims: np.ndarray  # (P, 2) int64 cells
    plane_base: np.ndarray  # (P,) int64 first cell of each plane
    cell: float  # the in-plane cell side
    cell_start: np.ndarray  # (C + 1,) int64
    cell_items: np.ndarray  # (N,) int64, disks by cell

    @property
    def num_disks(self):
        return len(self.points)


def disk_radius(grid_delta):
    return float(grid_delta) * DISK_FACTOR_3D


def neighbor_table(points, distance):
    """Every pair of centres within ``distance`` (||p_i - p_j|| <= distance,
    rayPointNeighborhood.hpp:287-298), as an (N, K) table padded with -1,
    each row in increasing index."""
    from scipy.spatial import cKDTree

    pairs = cKDTree(points).query_pairs(distance, output_type="ndarray")
    n = len(points)
    if len(pairs) == 0:
        return np.full((n, 1), -1, np.int64)
    a = np.concatenate([pairs[:, 0], pairs[:, 1]])
    b = np.concatenate([pairs[:, 1], pairs[:, 0]])
    order = np.lexsort((b, a))
    a, b = a[order], b[order]
    counts = np.bincount(a, minlength=n)
    k = int(counts.max())
    table = np.full((n, k), -1, np.int64)
    slot = np.arange(len(a)) - np.repeat(np.cumsum(counts) - counts, counts)
    table[a, slot] = b
    return table


def _planes(points, normals, scale):
    """Group the disks by plane: equal normals and plane offsets equal to a
    millionth of the cloud's extent. Returns (plane of each disk, normals,
    offsets)."""
    offset = np.einsum("ij,ij->i", points, normals)
    key = np.concatenate(
        [normals, np.round(offset / (1e-6 * scale))[:, None]], axis=1)
    uniq, plane_of = np.unique(key, axis=0, return_inverse=True)
    plane_of = plane_of.reshape(-1)
    if len(uniq) > MAX_PLANES:
        raise ValueError(f"the cloud lies on {len(uniq)} planes; this "
                         f"reference serves at most {MAX_PLANES}")
    p_normal = uniq[:, :3]
    p_offset = np.zeros(len(uniq))
    np.add.at(p_offset, plane_of, offset)
    p_offset /= np.bincount(plane_of, minlength=len(uniq))
    return plane_of, p_normal, p_offset


def _in_plane_axes(n):
    """Two unit axes spanning the plane of normal ``n``."""
    a = np.zeros(3)
    a[int(np.argmin(np.abs(n)))] = 1.0
    e1 = np.cross(n, a)
    e1 /= np.linalg.norm(e1)
    return np.stack([e1, np.cross(n, e1)])


def build_cloud(points, normals, grid_delta):
    """The reference's cloud of ``points`` and ``normals`` (as generated,
    float32) at ``grid_delta``."""
    points = np.asarray(points, np.float32).astype(np.float64)
    normals = np.asarray(normals, np.float32).astype(np.float64)
    normals = normals / np.linalg.norm(normals, axis=1, keepdims=True)
    r = disk_radius(grid_delta)
    bbox = np.stack([points.min(axis=0), points.max(axis=0)])
    scale = float(np.max(bbox[1] - bbox[0])) or 1.0
    plane_of, p_normal, p_offset = _planes(points, normals, scale)
    axes = np.stack([_in_plane_axes(n) for n in p_normal])
    uv = np.einsum("nj,nkj->nk", points, axes[plane_of])
    cell = 2.0 * r
    lo = np.zeros((len(p_normal), 2))
    dims = np.zeros((len(p_normal), 2), np.int64)
    for p in range(len(p_normal)):
        mine = uv[plane_of == p]
        lo[p] = mine.min(axis=0) - cell
        dims[p] = np.floor((mine.max(axis=0) - lo[p]) / cell).astype(
            np.int64) + 2
    base = np.concatenate([[0], np.cumsum(dims[:, 0] * dims[:, 1])])
    ij = np.floor((uv - lo[plane_of]) / cell).astype(np.int64)
    cell_id = base[plane_of] + ij[:, 0] * dims[plane_of, 1] + ij[:, 1]
    order = np.argsort(cell_id, kind="stable")
    start = np.searchsorted(cell_id[order], np.arange(base[-1] + 1))
    return Cloud(
        points=points, normals=normals, radius=r, bbox=bbox,
        source_z=float(bbox[1, 2] + 2.0 * r),
        neighbors=neighbor_table(points, 2.0 * r),
        plane_normal=p_normal, plane_offset=p_offset, plane_axes=axes,
        plane_lo=lo, plane_dims=dims, plane_base=base[:-1], cell=cell,
        cell_start=start.astype(np.int64), cell_items=order.astype(np.int64))


def clipped_areas(cloud, device, samples=256):
    """Each disk's area inside the box of the centres on x and y
    (rayGeometryDisk.hpp:computeDiskAreas), by the midpoint rule on a
    ``samples`` x ``samples`` grid over the disk for the disks that reach
    past that box; pi r^2 for the others. A (N,) float64 tensor on
    ``device``."""
    r = cloud.radius
    f64 = dict(dtype=torch.float64, device=device)
    pts = torch.tensor(cloud.points[:, :2], **f64)
    nrm = cloud.normals
    lo = torch.tensor(cloud.bbox[0, :2], **f64)
    hi = torch.tensor(cloud.bbox[1, :2], **f64)
    areas = torch.full((len(pts),), math.pi * r * r, **f64)
    reach = torch.tensor(r * np.sqrt(np.clip(1.0 - nrm[:, :2] ** 2, 0.0, None)),
                         **f64)
    cut = torch.nonzero(((pts - reach) < lo).any(dim=1)
                        | ((pts + reach) > hi).any(dim=1)).squeeze(1)
    s = (torch.arange(samples, **f64) + 0.5) / samples * 2.0 - 1.0
    su, sv = torch.meshgrid(s, s, indexing="ij")
    inside = su ** 2 + sv ** 2 < 1.0
    su, sv = su[inside], sv[inside]
    cell_area = (2.0 * r / samples) ** 2
    axes = torch.tensor(np.stack([_in_plane_axes(nrm[i])
                                  for i in cut.tolist()]).reshape(-1, 2, 3),
                        **f64)
    for b in range(0, len(cut), 64):
        i = cut[b:b + 64]
        e = axes[b:b + 64, :, :2]  # (B, 2, 2): the axes' x and y
        q = (pts[i, None, :] + r * (su[None, :, None] * e[:, None, 0]
                                    + sv[None, :, None] * e[:, None, 1]))
        ok = ((q >= lo) & (q <= hi)).all(dim=2)
        areas[i] = ok.sum(dim=1).double() * cell_area
    return areas


class _Tables:
    """The cloud's tables on the device, in the tracing type."""

    def __init__(self, cloud, walls, device, dtype):
        f = dict(device=device, dtype=dtype)
        f32 = dict(device=device, dtype=torch.float32)
        i64 = dict(device=device, dtype=torch.int64)
        self.dtype = dtype
        self.n = cloud.num_disks
        self.points = torch.tensor(cloud.points, **f)
        self.normals = torch.tensor(cloud.normals, **f)
        self.nc = (self.points * self.normals).sum(dim=1)
        self.r2 = torch.tensor(cloud.radius ** 2, **f)
        self.r = torch.tensor(cloud.radius, **f)
        self.neighbors = torch.tensor(cloud.neighbors, **i64)
        self.p_normal = torch.tensor(cloud.plane_normal, **f32)
        self.p_offset = torch.tensor(cloud.plane_offset, **f32)
        self.p_axes = torch.tensor(cloud.plane_axes, **f32)
        self.p_lo = torch.tensor(cloud.plane_lo, **f32)
        self.p_dims = torch.tensor(cloud.plane_dims, **i64)
        self.p_base = torch.tensor(cloud.plane_base, **i64)
        self.cell = float(cloud.cell)
        self.cell_start = torch.tensor(cloud.cell_start, **i64)
        self.cell_items = torch.tensor(cloud.cell_items, **i64)
        box = cloud.bbox
        # [lo_x hi_x lo_y hi_y lo_z hi_z]: the walls span the box of the
        # centres laterally and reach from its floor to the source plane
        self.box = [float(box[0, 0]), float(box[1, 0]), float(box[0, 1]),
                    float(box[1, 1]), float(box[0, 2]), cloud.source_z]
        self.walls = walls
        self.t_near = torch.tensor(T_NEAR, **f)


def _dot(a, b):
    return (a * b).sum(dim=-1)


def _candidates(tab, o, d):
    """(ray, disk) pairs to test: for every plane the ray crosses ahead of
    it, the disks whose cells touch the crossing point's 3 x 3 cells."""
    # elementwise products, no matrix product: a TF32 one would move the
    # crossing points
    o32, d32 = o.float()[:, None, :], d.float()[:, None, :]
    den = _dot(d32, tab.p_normal[None])  # (R, P)
    t = (tab.p_offset[None, :] - _dot(o32, tab.p_normal[None])) / torch.where(
        den == 0, torch.full_like(den, 1e-30), den)
    ahead = (den != 0) & (t > 0)
    q = o32 + t[..., None] * d32  # (R, P, 3)
    uv = _dot(q[:, :, None, :], tab.p_axes[None])  # (R, P, 2)
    ij = torch.floor(torch.clamp((uv - tab.p_lo[None]) / tab.cell, -2.0,
                                 2.0 ** 40)).to(torch.int64)
    offs = torch.tensor([-1, 0, 1], device=o.device)
    iu = ij[..., 0, None, None] + offs[:, None]  # (R, P, 3, 1)
    iv = ij[..., 1, None, None] + offs[None, :]  # (R, P, 1, 3)
    nu = tab.p_dims[:, 0][None, :, None, None]
    nv = tab.p_dims[:, 1][None, :, None, None]
    ok = ahead[..., None, None] & (iu >= 0) & (iu < nu) & (iv >= 0) & (iv < nv)
    cid = tab.p_base[None, :, None, None] + iu * nv + iv
    cid = torch.where(ok, cid, torch.zeros_like(cid)).reshape(len(o), -1)
    ok = ok.expand(-1, -1, 3, 3).reshape(len(o), -1)
    start = tab.cell_start[cid]
    count = torch.where(ok, tab.cell_start[cid + 1] - start,
                        torch.zeros_like(start))
    flat = count.reshape(-1)
    total = int(flat.sum())
    slot = torch.repeat_interleave(torch.arange(flat.numel(), device=o.device),
                                   flat, output_size=total)
    first = torch.cumsum(flat, 0) - flat
    k = torch.arange(total, device=o.device) - first[slot]
    ray = slot // count.shape[1]
    disk = tab.cell_items[start.reshape(-1)[slot] + k]
    return ray, disk


def _closest_hit(tab, o, d):
    """(t, disk) of each ray's closest disk hit, t BIG where none: the
    disk's own test (denominator not 0, t > t_near, the crossing point
    closer to the centre than the radius), the lowest t and, among equal
    t, the lowest disk."""
    R = len(o)
    ray, disk = _candidates(tab, o, d)
    n = tab.normals[disk]
    oo, dd = o[ray], d[ray]
    den = _dot(dd, n)
    t = (tab.nc[disk] - _dot(oo, n)) / torch.where(
        den == 0, torch.full_like(den, 1e-30), den)
    h = oo + t[:, None] * dd - tab.points[disk]
    ok = (den != 0) & (t > tab.t_near) & (_dot(h, h) < tab.r2)
    t32 = torch.where(ok, t.float(), torch.full_like(t, BIG, dtype=torch.float32))
    best = torch.full((R,), BIG, device=o.device)
    best.scatter_reduce_(0, ray, t32, "amin")
    win = ok & (t32 == best[ray])
    big_id = torch.full_like(disk, tab.n)
    best_disk = torch.full((R,), tab.n, dtype=torch.int64, device=o.device)
    best_disk.scatter_reduce_(0, ray, torch.where(win, disk, big_id), "amin")
    t_hit = torch.full((R,), BIG, device=o.device, dtype=o.dtype)
    has = best_disk < tab.n
    t_hit[has] = best[has].to(o.dtype)
    return t_hit, best_disk


def _wall_times(tab, o, d):
    """(t_x, t_y): each ray's crossing of the next x and y wall, BIG where
    it runs parallel, the crossing lies behind t_near, or the crossing
    point lies outside the wall (below the floor, above the source plane, or
    beyond the other axis' walls) (rayBoundary.hpp:164-245)."""
    lo_x, hi_x, lo_y, hi_y, lo_z, hi_z = tab.box
    big = torch.full((len(o),), BIG, device=o.device, dtype=o.dtype)

    def one(axis, lo, hi, other, olo, ohi):
        da, oa = d[:, axis], o[:, axis]
        dsafe = torch.where(da == 0, torch.full_like(da, 1e-30), da)
        t = torch.where(da > 0, (hi - oa) / dsafe,
                        torch.where(da < 0, (lo - oa) / dsafe, big))
        t = torch.where(t > tab.t_near, t, big)
        hz = o[:, 2] + d[:, 2] * t
        ho = o[:, other] + d[:, other] * t
        ok = (hz >= lo_z) & (hz <= hi_z) & (ho >= olo) & (ho <= ohi)
        return torch.where(ok, t, big)

    return one(0, lo_x, hi_x, 1, lo_y, hi_y), one(1, lo_y, hi_y, 0, lo_x, hi_x)


def _neighbor_deposits(tab, o, d, disk):
    """(ids, ok) of the hit disks' neighbors that the ray, as it was before
    the bounce, crosses from the front within their radius
    (rayTraceKernel.hpp:462-507)."""
    ids = tab.neighbors[disk]  # (R, K)
    idc = torch.clamp(ids, min=0)
    c, n = tab.points[idc], tab.normals[idc]
    prod = _dot(n, d[:, None, :])
    t = (tab.nc[idc] - _dot(n, o[:, None, :])) / torch.where(
        prod == 0, torch.full_like(prod, 1e-30), prod)
    h = o[:, None, :] + t[..., None] * d[:, None, :] - c
    dist = torch.sqrt(_dot(h, h))
    ok = ((ids >= 0) & (prod <= 0) & (prod.abs() >= NEIGHBOR_EPS) & (t > 0)
          & (dist < tab.r))
    return idc, ok


def _source(tab, n, gen, cosine_power):
    """n rays from the source plane: origins uniform over it, directions
    from the power-cosine lobe around -z (raySourceRandom.hpp:70-86)."""
    lo_x, hi_x, lo_y, hi_y, _, z = tab.box
    u = torch.rand((4, n), generator=gen, device=tab.points.device).to(tab.dtype)
    o = torch.stack([lo_x + (hi_x - lo_x) * u[0], lo_y + (hi_y - lo_y) * u[1],
                     torch.full_like(u[0], z)], dim=1)
    cos_t = u[3] ** (1.0 / (cosine_power + 1.0))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = (2.0 * math.pi) * u[2]
    d = torch.stack([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t, -cos_t],
                    dim=1)
    return o, d


def trace(cloud, n_rays, *, sticking, walls, seed, device, chunks=1,
          cosine_power=1.0, max_boundary_hits=1000, dtype=torch.float32):
    """Trace ``n_rays`` rays on ``cloud`` as ``chunks`` independent runs of
    equal size (the first ``n_rays % chunks`` one ray larger).

    ``walls``: the x and y walls' kinds ("periodic", "reflective" or
    "ignore"). Returns (flux (chunks, N) float64 on ``device``: each run's
    deposits; hits (chunks,) int64: front hits; hits_sq (chunks,) float64:
    the sum over rays of each ray's front hits squared; rays (chunks,)
    int64)."""
    for w in walls:
        if w not in WALL_KINDS:
            raise ValueError(f"unknown wall {w!r}")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    tab = _Tables(cloud, walls, device, dtype)
    flux = torch.zeros((chunks, tab.n), dtype=torch.float64, device=device)
    hits = torch.zeros(chunks, dtype=torch.int64, device=device)
    hits_sq = torch.zeros(chunks, dtype=torch.float64, device=device)
    sizes = [n_rays // chunks + (m < n_rays % chunks) for m in range(chunks)]
    for m, size in enumerate(sizes):
        f, h, h2 = _trace_run(tab, size, gen, sticking, cosine_power,
                              max_boundary_hits)
        flux[m] = f
        hits[m] = h
        hits_sq[m] = h2
    rays = torch.tensor(sizes, dtype=torch.int64, device=device)
    return flux, hits, hits_sq, rays


def _trace_run(tab, n, gen, sticking, cosine_power, max_boundary_hits):
    dev = tab.points.device
    dtype = tab.dtype
    o, d = _source(tab, n, gen, cosine_power)
    w = torch.ones(n, dtype=dtype, device=dev)
    hfb = torch.zeros(n, dtype=torch.bool, device=dev)
    n_bdry = torch.zeros(n, dtype=torch.int64, device=dev)
    n_hits = torch.zeros(n, dtype=torch.int64, device=dev)
    ray_id = torch.arange(n, device=dev)
    per_ray_hits = torch.zeros(n, dtype=torch.int64, device=dev)
    flux = torch.zeros(tab.n, dtype=torch.float64, device=dev)
    lo_x, hi_x, lo_y, hi_y = tab.box[:4]
    while len(o):
        t_geo, disk = _closest_hit(tab, o, d)
        t_x, t_y = _wall_times(tab, o, d)
        t_wall = torch.minimum(t_x, t_y)
        geo = t_geo <= t_wall  # the geometry wins ties
        geo &= t_geo < BIG
        wall_x = ~geo & (t_x <= t_y) & (t_x < BIG)
        wall_y = ~geo & ~wall_x & (t_y < BIG)
        t_ev = torch.where(geo, t_geo, t_wall)
        hp = o + d * torch.where(geo | wall_x | wall_y, t_ev,
                                 torch.zeros_like(t_ev))[:, None]
        alive = geo | wall_x | wall_y  # an escape ends the ray

        # walls (rayBoundary.hpp:29-127)
        is_wall = wall_x | wall_y
        n_bdry = n_bdry + is_wall.to(torch.int64)
        alive &= ~(is_wall & (n_bdry > max_boundary_hits))
        new_o, new_d = o.clone(), d.clone()
        for axis, mask, lo, hi, kind in ((0, wall_x, lo_x, hi_x, tab.walls[0]),
                                         (1, wall_y, lo_y, hi_y, tab.walls[1])):
            if kind == "ignore":
                alive &= ~mask
                continue
            moved = hp.clone()
            if kind == "periodic":
                moved[:, axis] = torch.where(
                    d[:, axis] > 0, torch.full_like(hp[:, axis], lo),
                    torch.full_like(hp[:, axis], hi))
            new_o = torch.where(mask[:, None], moved, new_o)
            if kind == "reflective":
                flipped = d.clone()
                flipped[:, axis] = -flipped[:, axis]
                new_d = torch.where(mask[:, None], flipped, new_d)

        # geometry: from behind, pass once and die the second time
        # (rayTraceKernel.hpp:225-241)
        dc = torch.clamp(disk, max=tab.n - 1)
        n_hit = tab.normals[dc]
        back = geo & (_dot(d, n_hit) > 0)
        alive &= ~(back & hfb)
        passing = back & ~hfb
        hfb = hfb | passing
        new_o = torch.where(passing[:, None], hp, new_o)
        front = geo & ~back

        # deposits: the weight before sticking on the hit disk and on each
        # neighbor the ray crosses (rayTraceKernel.hpp:255-300)
        fi = front.nonzero().squeeze(1)
        if len(fi):
            wf = w[fi].double()
            flux.index_add_(0, disk[fi], wf)
            nb, ok = _neighbor_deposits(tab, o[fi], d[fi], disk[fi])
            flux.index_add_(0, nb[ok], wf[:, None].expand_as(ok)[ok])
        n_hits = n_hits + front.to(torch.int64)

        # diffuse reflection, sticking and roulette (rayReflection.hpp:32-50,
        # rayTraceKernel.hpp:309-335, 435-460)
        u = torch.rand((3, len(o)), generator=gen, device=dev).to(dtype)
        z = 1.0 - 2.0 * u[0]
        phi = (2.0 * math.pi) * u[1]
        s = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        refl = torch.stack([s * torch.cos(phi), s * torch.sin(phi), z],
                           dim=1) + n_hit
        refl = refl / torch.clamp(torch.sqrt(_dot(refl, refl)), min=1e-12)[:, None]
        w_new = w - w * sticking
        alive &= ~(front & (w_new <= 0))
        weak = front & (w_new < WEIGHT_THRESHOLD)
        killed = weak & (u[2] < 1.0 - w_new / RENEW_WEIGHT)
        alive &= ~killed
        w_new = torch.where(weak & ~killed,
                            torch.full_like(w_new, RENEW_WEIGHT), w_new)
        new_o = torch.where(front[:, None], hp, new_o)
        new_d = torch.where(front[:, None], refl, new_d)
        w = torch.where(front, w_new, w)

        done = ~alive
        if bool(done.any()):
            per_ray_hits[ray_id[done]] = n_hits[done]
        keep = alive.nonzero().squeeze(1)
        o, d, w = new_o[keep], new_d[keep], w[keep]
        hfb, n_bdry, n_hits = hfb[keep], n_bdry[keep], n_hits[keep]
        ray_id = ray_id[keep]
    h = per_ray_hits.double()
    return flux, int(per_ray_hits.sum()), float((h * h).sum())


def normalize(cloud, flux, n_rays, areas):
    """Flux per unit area and per source ray: flux * source area / (rays *
    disk area) (rayTraceDisk.hpp:120-137); the source plane spans the box
    of the centres on x and y. ``flux`` (..., N) float64."""
    box = cloud.bbox
    source_area = (box[1, 0] - box[0, 0]) * (box[1, 1] - box[0, 1])
    return flux * (source_area / n_rays) / areas


def smooth(cloud, flux):
    """Each disk's flux averaged with its neighbors', weighted by the dot
    product of the normals where that is positive
    (rayTraceDisk.hpp:173-192). ``flux`` (..., N) float64 tensor."""
    dev = flux.device
    nb = torch.tensor(cloud.neighbors, device=dev)
    nrm = torch.tensor(cloud.normals, device=dev)
    idc = torch.clamp(nb, min=0)
    w = (nrm[:, None, :] * nrm[idc]).sum(dim=-1)
    w = torch.where((nb >= 0) & (w > 0), w, torch.zeros_like(w))
    return (flux + (flux[..., idc] * w).sum(dim=-1)) / (1.0 + w.sum(dim=1))
