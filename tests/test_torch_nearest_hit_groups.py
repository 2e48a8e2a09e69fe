"""The closest-hit kernels' redesign, on the CPU: the division-free reject
that runs before the exact test, the two-stage search it makes, and the
wrappers.

``disk_reject_ref`` / ``triangle_reject_ref`` are the plain twins of the
kernels' rejects (``csrc/disk_hit.cuh:DiskReject``,
``csrc/tri_hit.cuh:TriReject``). Each is evaluated twice: in float32 with one
rounding per operation, and with the kernel's fused multiply-adds emulated
(the exact float64 product and one float64 sum, rounded to float32), which is
how the card rounds them. Both must keep their invariant: a dropped pair is
never one that the exact test (``disk_pair_times`` / ``triangle_pair_times``,
the plain versions' arithmetic) selects below the bound. The bound tried
for every pair is the float just above its own t, the sharpest it can meet,
and on the flagship also the running best of the lane-ordered walk (no
thread of the kernel's warp holds a lower bound at that lane). Nothing here is compared within a tolerance: the search
with the reject equals the plain version bit for bit.

The JAX package has no reject: its Pallas kernels run the exact test on every
pair (``tests/test_torch_nearest_hit.py`` and ``tests/test_torch_triangle.py``
hold the port's plain versions to them).
"""

import functools

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from viennaray_tpu_torch.geometry.disk_geometry import DiskGeometry
from viennaray_tpu_torch.geometry.triangle_geometry import TriangleGeometry
from viennaray_tpu_torch.io import fixtures
from viennaray_tpu_torch.ops import nearest_hit as NH

torch.set_num_threads(1)

FLAGSHIP = dict(grid_delta=0.25, extent=5.0, trench_width=4.0,
                trench_depth=4.0)
T_NEAR = 1e-4
BIG = float(NH.BIG)
KINDS = {
    "disk": (NH.disk_pair_times, NH.disk_reject_ref),
    "triangle": (NH.triangle_pair_times, NH.triangle_reject_ref),
}


@functools.lru_cache(maxsize=None)
def flagship(kind):
    """The 2,993-disk or the 5,760-triangle flagship, packed on the CPU."""
    gd = FLAGSHIP["grid_delta"]
    if kind == "disk":
        return DiskGeometry.build(*fixtures.create_trench_grid_3d(**FLAGSHIP),
                                  gd, device="cpu")
    return TriangleGeometry.build(*fixtures.create_trench_mesh_3d(**FLAGSHIP),
                                  gd, device="cpu")


def interior_rays(n, seed):
    """numpy-seeded rays with origins anywhere in the trench's box and
    directions all over the sphere, as after diffuse bounces."""
    rng = np.random.default_rng(seed)
    org = rng.uniform([-5.0, -5.0, -4.0], [5.0, 5.0, 0.2], (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.from_numpy(org.astype(np.float32)),
            torch.from_numpy(d.astype(np.float32)))


def source_rays(n, seed):
    """numpy-seeded rays from the source plane above the trench, downward in
    a cosine lobe, as the trace's first bounce sees them."""
    rng = np.random.default_rng(seed)
    org = np.stack([rng.uniform(-5.0, 5.0, n), rng.uniform(-5.0, 5.0, n),
                    np.full(n, 0.2165)], 1)
    u, phi = rng.uniform(size=n), rng.uniform(0, 2 * np.pi, n)
    st_ = np.sqrt(u)
    d = np.stack([st_ * np.cos(phi), st_ * np.sin(phi), -np.sqrt(1 - u)], 1)
    return (torch.from_numpy(org.astype(np.float32)),
            torch.from_numpy(d.astype(np.float32)))


def running_best(tt):
    """The bound each pair meets in the lane-ordered walk: the lowest t of
    the lanes before it (BIG before the first)."""
    run = torch.cummin(tt, dim=1).values
    return torch.cat([torch.full_like(run[:, :1], BIG), run[:, :-1]], dim=1)


def assert_invariant(kind, org, dirn, prims, chunk_bbs):
    """No pair that the exact test hits is dropped under the float just above
    its own t, in either rounding. The reject drops more the
    lower the bound (its only use of the bound is monotone), so that pair is
    kept under any bound above its t too: no bound, the walk's running best,
    a thread's of the warp. Returns the exact test's (n, Npad) times."""
    pairs, reject = KINDS[kind]
    tt = pairs(org, dirn, prims, T_NEAR)
    hits = tt < BIG
    assert hits.any()
    above = torch.where(hits, torch.nextafter(tt, torch.tensor(np.inf)),
                        torch.tensor(BIG))
    for fma in (False, True):
        dropped = reject(org, dirn, prims, chunk_bbs, T_NEAR, above, fma=fma)
        bad = dropped & hits
        assert not bad.any(), (
            f"{kind} reject (fma={fma}) dropped {int(bad.sum())} pairs that "
            f"the exact test selects below a bound just above their t")
    return tt


@pytest.mark.parametrize("kind", ["disk", "triangle"])
@pytest.mark.parametrize("rays", ["interior", "source"])
def test_reject_never_drops_a_selected_pair_on_the_flagship(kind, rays):
    """Seeded rays on the flagship's 2,993 disks or 5,760 triangles, in
    blocks of 512: the first 1,024 of 4,096 interior rays and 1,024 source
    rays in both roundings. On all 4,096 interior rays the reject drops at
    least 90 % of all pairs (padding lanes included) under the running best
    of the lane-ordered walk (no thread of the warp holds a lower bound
    there), and it drops no pair whose t lies below that bound; the share it
    drops is a count, so the reject provably does something."""
    geo = flagship(kind)
    _, reject = KINDS[kind]
    n = 4096 if rays == "interior" else 1024
    org, dirn = (interior_rays if rays == "interior" else source_rays)(n, 3)
    dropped = total = 0
    for lo in range(0, n, 512):
        o, d = org[lo:lo + 512], dirn[lo:lo + 512]
        if lo < 1024:
            tt = assert_invariant(kind, o, d, geo.prims_soa,
                                  geo.soa_chunk_bbs)
        else:
            tt = KINDS[kind][0](o, d, geo.prims_soa, T_NEAR)
        if rays == "interior":
            best = running_best(tt)
            drop = reject(o, d, geo.prims_soa, geo.soa_chunk_bbs, T_NEAR,
                          best)
            assert not (drop & (tt < best)).any()
            dropped += int(drop.sum())
            total += drop.numel()
    if rays == "interior":
        assert dropped >= 0.9 * total


def two_stage_search(kind, org, dirn, prims, perm, chunk_bbs, fma):
    """The kernels' search order in plain PyTorch: chunk by chunk, each
    chunk's pairs first through the reject under the best t of the chunks
    before (the bound the kernel's warp starts a chunk with), then the exact
    test on the survivors only; the lowest t wins, then the lowest lane.
    Returns (t, prim, hit) as the plain versions do."""
    pairs, reject = KINDS[kind]
    n_chunks = chunk_bbs.shape[0]
    npad = prims.shape[1]
    pt = npad // n_chunks
    R = org.shape[0]
    best = torch.full((R, 1), BIG)
    lane = torch.full((R, 1), npad, dtype=torch.int64)
    for c in range(n_chunks):
        cols = slice(c * pt, (c + 1) * pt)
        sub = prims[:, cols].contiguous()
        dropped = reject(org, dirn, sub, chunk_bbs[c:c + 1], T_NEAR, best,
                         fma=fma)
        tt = torch.where(dropped, torch.tensor(BIG),
                         pairs(org, dirn, sub, T_NEAR))
        tmin = tt.amin(dim=1, keepdim=True)
        first = torch.where(tt == tmin, torch.arange(pt)[None, :],
                            pt).amin(dim=1, keepdim=True) + c * pt
        better = tmin < best
        best = torch.where(better, tmin, best)
        lane = torch.where(better, first, lane)
    hit = best[:, 0] < BIG
    idx = torch.where(hit, lane[:, 0], 0)
    return best[:, 0], perm[idx], hit


@pytest.mark.parametrize("kind", ["disk", "triangle"])
def test_two_stage_search_equals_plain_version_bit_for_bit(kind):
    geo = flagship(kind)
    org, dirn = interior_rays(512, seed=5)
    s_org, s_dirn = source_rays(512, seed=6)
    org, dirn = torch.cat([org, s_org]), torch.cat([dirn, s_dirn])
    plain = getattr(NH, f"{kind}_nearest_hit_ref")
    want = plain(org, dirn, geo.prims_soa, geo.soa_perm, geo.soa_chunk_bbs,
                 t_near=T_NEAR)
    assert 0.3 < float(want[2].float().mean()) < 1.0
    for fma in (False, True):
        got = two_stage_search(kind, org, dirn, geo.prims_soa, geo.soa_perm,
                               geo.soa_chunk_bbs, fma)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _frame(normal):
    """Two unit vectors orthogonal to each unit ``normal`` (n, 3)."""
    helper = np.where(np.abs(normal[:, :1]) < 0.9, [[1.0, 0, 0]],
                      [[0, 1.0, 0]])
    a = _unit(np.cross(normal, helper))
    return a, np.cross(normal, a)


def _aim(rng, target, n_pairs, mode, scale, normal):
    """Origins and unit directions of rays through ``target`` points:
    ``normal`` along +-``normal`` (the line passes the target's distance from
    a disk's centre, so rounding alone decides a rim), ``grazing`` nearly in
    the plane of ``normal``, ``t_near`` starting a hair before or after
    t_near from the target, else from a random side at distances from 1e-3
    to 10 times ``scale``."""
    if mode == "normal":
        d = normal * rng.choice([-1.0, 1.0], (n_pairs, 1))
    elif mode == "grazing":
        a, b = _frame(normal)
        ang = rng.uniform(0, 2 * np.pi, (n_pairs, 1))
        tilt = rng.choice([1e-7, 1e-5, 1e-3], (n_pairs, 1))
        d = _unit(np.cos(ang) * a + np.sin(ang) * b + tilt * normal)
    else:
        d = _unit(rng.normal(size=(n_pairs, 3)))
    if mode == "t_near":
        dist = T_NEAR * (1.0 + rng.choice([-1e-6, 0.0, 1e-6, 1e-3],
                                          (n_pairs, 1)))
    else:
        dist = scale * 10.0 ** rng.uniform(-3, 1, (n_pairs, 1))
    return target - dist * d, d


MODES = ["normal", "grazing", "t_near", "far"]


def _disk_case(seed, mode, scale, offset):
    """Disks of radius ``scale`` around centres at ``offset`` and rays aimed
    at points a hair inside and outside their rims (r (1 +- 1e-6), r (1 +-
    1e-7)), at the centre and at random points of the disk."""
    rng = np.random.default_rng(seed)
    n = 48
    centres = offset + scale * rng.uniform(-4, 4, (n, 3))
    normals = _unit(rng.normal(size=(n, 3)))
    radii = scale * rng.uniform(0.5, 1.5, n)
    a, b = _frame(normals)
    ang = rng.uniform(0, 2 * np.pi, (n, 1))
    frac = rng.choice([1 - 1e-6, 1 + 1e-6, 1 - 1e-7, 1 + 1e-7, 0.0, 0.5],
                      (n, 1))
    target = centres + frac * radii[:, None] * (np.cos(ang) * a
                                                + np.sin(ang) * b)
    org, d = _aim(rng, target, n, mode, scale, normals)
    prims, perm, bbs = NH.pack_disk_prims(centres, normals, radii, pad_to=16)
    return org, d, prims, bbs


def _triangle_case(seed, mode, scale, offset):
    """A strip of triangles that share edges and vertices, and rays aimed at
    points on and a hair off their edges (u = 0, v = 0, u + v = 1, scaled by
    1 +- 1e-6), at their vertices and at interior points; tiny determinants
    come from the grazing rays."""
    rng = np.random.default_rng(seed)
    n_tri = 32
    base = offset + scale * rng.uniform(-1, 1, (3,))
    step = scale * _unit(rng.normal(size=3))
    side = scale * _unit(rng.normal(size=3))
    lower = base + np.arange(n_tri // 2 + 1)[:, None] * step
    upper = lower + side + 0.1 * scale * rng.normal(size=lower.shape)
    verts = np.concatenate([lower, upper])
    m = n_tri // 2 + 1
    tris = []
    for i in range(n_tri // 2):
        tris.append([i, i + 1, m + i])
        tris.append([i + 1, m + i + 1, m + i])
    tris = np.asarray(tris)
    v0, v1, v2 = (verts[tris[:, k]] for k in range(3))
    n = len(tris)
    u = rng.choice([0.0, 1e-6, -1e-6, 0.3, 1.0], n)
    v = rng.choice([0.0, 1e-6, -1e-6, 0.3], n)
    on_sum = rng.uniform(size=n) < 0.3
    v = np.where(on_sum, (1.0 - u) * (1 + rng.choice([0, 1e-6, -1e-6], n)), v)
    target = v0 + u[:, None] * (v1 - v0) + v[:, None] * (v2 - v0)
    normal = _unit(np.cross(v1 - v0, v2 - v0))
    org, d = _aim(rng, target, n, mode, scale, normal)
    prims, perm, bbs = NH.pack_triangle_prims(verts, tris, pad_to=16)
    return org, d, prims, bbs


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(kind=st.sampled_from(["disk", "triangle"]),
       seed=st.integers(0, 2**31 - 1), mode=st.sampled_from(MODES),
       scale=st.sampled_from([1e-3, 0.25, 1.0, 50.0]),
       offset=st.sampled_from([0.0, 10.0, -1000.0]))
def test_reject_never_drops_a_selected_pair_on_adversarial_pairs(
        kind, seed, mode, scale, offset):
    """Rims, edges, shared edges and vertices, grazing rays, tiny
    determinants and t at t_near, at scales from 1e-3 to 50 and far from
    the origin: every ray against every primitive of its case."""
    make = _disk_case if kind == "disk" else _triangle_case
    org, d, prims, bbs = make(seed, mode, scale, offset)
    assert_invariant(kind, torch.from_numpy(org.astype(np.float32)),
                     torch.from_numpy(d.astype(np.float32)),
                     torch.from_numpy(prims), torch.from_numpy(bbs))


@pytest.mark.parametrize("kind", ["disk", "triangle", "line"])
def test_wrappers_give_the_plain_result_and_refuse_too_many_rays(kind):
    """The kernels search with a warp per ray at every width (the H100's
    table, PERF.md); on CPU tensors the wrappers give the plain version's
    result, and on any device they refuse more rays than the kernel's C int
    counts, before anything runs (the rays here are one row broadcast, so
    the refusal costs no memory)."""
    assert NH.GROUP == 32 and NH.MAX_RAYS == 2**31 - 1
    if kind == "line":
        verts, lines = fixtures.create_trench_line_mesh(grid_delta=0.5)[:2]
        p0, p1 = verts[lines[:, 0]], verts[lines[:, 1]]
        nrm = np.stack([-(p1 - p0)[:, 1], (p1 - p0)[:, 0]], 1)
        prims, perm, bbs = NH.pack_line_prims(p0, p1, _unit(nrm))
        prims, perm, bbs = map(torch.from_numpy, (prims, perm, bbs))
        org, dirn = interior_rays(256, seed=9)
        org[:, 2] = 0.0
        dirn[:, 2] = 0.0
        dirn = dirn / torch.linalg.norm(dirn, dim=1, keepdim=True)
    else:
        geo = flagship(kind)
        prims, perm, bbs = geo.prims_soa, geo.soa_perm, geo.soa_chunk_bbs
        org, dirn = interior_rays(256, seed=9)
    wrapper = getattr(NH, f"{kind}_nearest_hit")
    plain = getattr(NH, f"{kind}_nearest_hit_ref")
    want = plain(org, dirn, prims, perm, bbs, t_near=T_NEAR)
    assert want[2].any()
    got = wrapper(org, dirn, prims, perm, bbs, t_near=T_NEAR)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    many = org[:1].expand(NH.MAX_RAYS + 1, 3)
    with pytest.raises(ValueError, match="at most"):
        wrapper(many, many, prims, perm, bbs, t_near=T_NEAR)
    fits = org[:1].expand(NH.MAX_RAYS, 3)
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(fits, fits, prims, perm, bbs, t_near=T_NEAR)
