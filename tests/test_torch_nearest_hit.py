"""The port's plain nearest-hit against the JAX package's two searches: the
Pallas kernel (interpret mode, as tests/test_pallas_kernels.py runs it) and
the brute-force ``intersect.disk_nearest_hit``.

Tolerances, and why there are any:
- ``hit`` is equal on every lane.
- ``t`` is within 3e-5 relative where ``prim`` agrees. The Pallas kernel
  multiplies by an approximate reciprocal refined by one Newton step where
  the port divides (measured here: up to 1.4e-5 on 15 of 576 lanes, so the
  1e-5 one would wish for does not hold); the brute force gets t from a
  matrix product.
- ``prim`` is equal on at least 99.9 % of the hit lanes against the Pallas
  kernel, which shares the port's rule for equal t (lowest sorted lane).
  The brute force breaks ties by the lowest ORIGINAL index instead, and ties
  are common here: neighbouring disks of a flat face overlap and lie in one
  plane, so a ray crosses both at exactly the same t. Against it, a lane
  whose two answers are such an exact tie counts as agreeing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viennaray_tpu as vrt
from viennaray_tpu.io import fixtures as ref_fixtures
from viennaray_tpu.ops import intersect as ref_intersect
from viennaray_tpu.ops import pallas_intersect as ref_pallas

from viennaray_tpu_torch.ops import nearest_hit

from torch_port_helpers import port_geometry, reference_geometry

torch.set_num_threads(1)


def _rays(n, seed=0):
    """numpy-seeded rays over the 3D trench: origins above and inside it,
    directions mostly downward."""
    rng = np.random.default_rng(seed)
    org = rng.uniform(-5.0, 5.0, (n, 3)).astype(np.float32)
    org[:, 2] = rng.uniform(-3.5, 1.5, n).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[: n // 2, 2] = -np.abs(d[: n // 2, 2]) - 0.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d


@pytest.fixture(scope="module")
def trench():
    _, _, _, ref_geo = reference_geometry("trench_0.5")
    geo = port_geometry(ref_geo)
    assert geo.soa_chunk_bbs.shape[0] >= 2
    org, d = _rays(1024)
    t, prim, hit = nearest_hit.disk_nearest_hit_ref(
        torch.from_numpy(org), torch.from_numpy(d), geo.prims_soa,
        geo.soa_perm, geo.soa_chunk_bbs, t_near=1e-4,
    )
    return ref_geo, geo, org, d, (t.numpy(), prim.numpy(), hit.numpy())


def _plane_time(geo, org, d, prim):
    """t of each ray on its given disk's plane, in the port's arithmetic."""
    soa = geo.prims_soa.numpy()
    lane = geo.soa_inv_perm.numpy()[prim]
    nx, ny, nz, ndc = soa[3, lane], soa[4, lane], soa[5, lane], soa[7, lane]
    denom = d[:, 0] * nx + d[:, 1] * ny + d[:, 2] * nz
    ndo = org[:, 0] * nx + org[:, 1] * ny + org[:, 2] * nz
    return (ndc - ndo) / np.where(denom == 0, np.float32(1e-30), denom)


def _compare(geo, org, d, got, want, ties_count_as_equal):
    t, prim, hit = got
    t_w, prim_w, hit_w = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(hit, hit_w)
    assert 0.3 < hit.mean() < 1.0
    same = (prim == prim_w) & hit
    np.testing.assert_allclose(t[same], t_w[same], rtol=3e-5)
    if ties_count_as_equal:
        tie = hit & ~same & (_plane_time(geo, org, d, prim_w) == t)
        assert tie.sum() > 0  # the rule under test is exercised
        same = same | tie
    assert same.sum() >= 0.999 * hit.sum()


def test_plain_version_matches_pallas_kernel(trench):
    ref_geo, geo, org, d, got = trench
    want = ref_pallas.disk_nearest_hit_pallas(
        jnp.asarray(org), jnp.asarray(d), ref_geo.prims_soa, ref_geo.soa_perm,
        ref_geo.soa_chunk_bbs, rt=256, interpret=True,
    )
    _compare(geo, org, d, got, want, ties_count_as_equal=False)


def test_plain_version_matches_brute_force(trench):
    ref_geo, geo, org, d, got = trench
    want = ref_intersect.disk_nearest_hit(
        jnp.asarray(org), jnp.asarray(d), ref_geo.points, ref_geo.normals,
        ref_geo.radii, 1e-4,
    )
    _compare(geo, org, d, got, want, ties_count_as_equal=True)


def test_ragged_ray_count_and_wrapper(trench):
    """Any R runs (the Pallas kernel needs a multiple of its tile), each ray's
    answer does not depend on the batch it is in, and on CPU tensors the
    wrapper is the plain version."""
    _, geo, org, d, (t, prim, hit) = trench
    n = 777
    got = nearest_hit.disk_nearest_hit(
        torch.from_numpy(org[:n]), torch.from_numpy(d[:n]), geo.prims_soa,
        geo.soa_perm, geo.soa_chunk_bbs, t_near=1e-4,
    )
    np.testing.assert_array_equal(got[0].numpy(), t[:n])
    np.testing.assert_array_equal(got[1].numpy(), prim[:n])
    np.testing.assert_array_equal(got[2].numpy(), hit[:n])
    assert got[1].dtype == torch.int32 and got[2].dtype == torch.bool
    # a shifted slice falls into other blocks of the plain version: same answer
    shifted = nearest_hit.disk_nearest_hit_ref(
        torch.from_numpy(org[5:n]), torch.from_numpy(d[5:n]), geo.prims_soa,
        geo.soa_perm, None, t_near=1e-4,
    )
    np.testing.assert_array_equal(shifted[0].numpy(), t[5:n])
    np.testing.assert_array_equal(shifted[1].numpy(), prim[5:n])


def test_equal_t_goes_to_lowest_sorted_lane():
    """Two coincident disks are hit at exactly the same t: the lower sorted
    lane wins, in the port as in the Pallas kernel."""
    pts, nrm = ref_fixtures.create_plane_grid(0.5, 1.5, (0, 1, 2))
    dup = 10
    pts = np.concatenate([pts, pts[dup:dup + 1]])
    nrm = np.concatenate([nrm, nrm[dup:dup + 1]])
    ref_geo = vrt.DiskGeometry.build(pts, nrm, 0.5, dim=3)
    geo = port_geometry(ref_geo)
    n = 256
    org = np.tile(pts[dup] + np.float32([0.01, -0.02, 1.0]), (n, 1)).astype(np.float32)
    d = np.tile(np.float32([0.0, 0.0, -1.0]), (n, 1))
    t, prim, hit = nearest_hit.disk_nearest_hit_ref(
        torch.from_numpy(org), torch.from_numpy(d), geo.prims_soa,
        geo.soa_perm, geo.soa_chunk_bbs,
    )
    inv = geo.soa_inv_perm.numpy()
    twins = (dup, len(pts) - 1)
    winner = min(twins, key=lambda p: inv[p])
    assert hit.all() and (prim.numpy() == winner).all()
    _, prim_ref, _ = ref_pallas.disk_nearest_hit_pallas(
        jnp.asarray(org), jnp.asarray(d), ref_geo.prims_soa, ref_geo.soa_perm,
        ref_geo.soa_chunk_bbs, rt=256, interpret=True,
    )
    np.testing.assert_array_equal(prim.numpy(), np.asarray(prim_ref))


def test_wrapper_refuses_what_the_kernel_does_not_take(trench):
    _, geo, org, d, _ = trench
    o, dd = torch.from_numpy(org), torch.from_numpy(d)
    args = (geo.prims_soa, geo.soa_perm, geo.soa_chunk_bbs)
    with pytest.raises(TypeError):
        nearest_hit.disk_nearest_hit(o.double(), dd.double(), *args)
    with pytest.raises(ValueError):
        nearest_hit.disk_nearest_hit(o[:, :2], dd[:, :2], *args)
    with pytest.raises(ValueError):
        nearest_hit.disk_nearest_hit(o.T.contiguous().T, dd, *args)
    with pytest.raises(ValueError):
        nearest_hit.disk_nearest_hit(o, dd, geo.prims_soa[:7], *args[1:])
