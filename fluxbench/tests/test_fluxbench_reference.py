"""The plain reference on hand-checked cases."""

import math

import numpy as np
import pytest
import torch

from fluxbench.reference import disks


def cloud_of(points, normals, grid_delta=1.0):
    return disks.build_cloud(np.asarray(points, np.float32),
                             np.asarray(normals, np.float32), grid_delta)


def test_closest_hit_by_hand():
    # r = 0.866...: disk A at z = 0, disk B above it at z = 1, disk C on
    # the plane x = 3 facing +x
    c = cloud_of([[0, 0, 0], [0, 0, 1], [3, 0, 0]],
                 [[0, 0, 1], [0, 0, 1], [1, 0, 0]])
    tab = disks._Tables(c, ("periodic", "periodic"), "cpu", torch.float32)
    o = torch.tensor([[0, 0, 2], [0, 0, 0.5], [0.5, 0.5, 2], [0.7, 0.7, 2],
                      [-1, 0, 0.3]], dtype=torch.float32)
    d = torch.tensor([[0, 0, -1], [0, 0, 1], [0, 0, -1], [0, 0, -1],
                      [1, 0, 0]], dtype=torch.float32)
    t, disk = disks._closest_hit(tab, o, d)
    assert t[:3].tolist() == [1.0, 0.5, 1.0]
    assert disk[:3].tolist() == [1, 1, 1]
    assert t[3] >= disks.BIG and disk[3] == c.num_disks  # outside both rims
    assert t[4].item() == pytest.approx(4.0) and disk[4] == 2


def test_neighbor_table_against_all_pairs():
    rng = np.random.default_rng(3)
    pts = rng.uniform(0, 4, (300, 3))
    table = disks.neighbor_table(pts, 0.7)
    dist = np.linalg.norm(pts[:, None] - pts[None], axis=2)
    for i in range(len(pts)):
        want = sorted(j for j in range(len(pts)) if j != i and dist[i, j] <= 0.7)
        assert [j for j in table[i] if j >= 0] == want


def test_clipped_areas_at_the_box_corners():
    # four disks at the corners of the box [0, 1]^2, radius 0.866 < 1:
    # each keeps a quarter; one in the middle of a side keeps a half
    c = cloud_of([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0], [0.5, 0, 0]],
                 [[0, 0, 1]] * 5)
    a = disks.clipped_areas(c, "cpu").numpy()
    full = math.pi * c.radius ** 2
    assert a[:4] == pytest.approx(full / 4, rel=1e-3)
    # the side disk reaches past both corners' walls too: x in [0, 1]
    # clips its far edges (0.5 + 0.866 > 1)
    assert a[4] < full / 2


def test_normalize_and_smooth_by_hand():
    c = cloud_of([[0, 0, 0], [1, 0, 0], [5, 0, 0]],
                 [[0, 0, 1], [0, 0, 1], [1, 0, 0]])
    # disks 0 and 1 are neighbors (1 <= 2 r); disk 2 has none
    flux = torch.tensor([[2.0, 4.0, 6.0]], dtype=torch.float64)
    out = disks.smooth(c, flux)
    assert out[0].tolist() == pytest.approx([3.0, 3.0, 6.0])
    areas = torch.tensor([1.0, 2.0, 4.0], dtype=torch.float64)
    box = c.bbox
    src = (box[1, 0] - box[0, 0]) * (box[1, 1] - box[0, 1])
    got = disks.normalize(c, flux, 10.0, areas)
    assert got[0].tolist() == pytest.approx(
        [2 * src / 10, 4 * src / 20, 6 * src / 40])


def test_a_floor_that_absorbs_every_ray_takes_one_hit_a_ray():
    xs = np.arange(-3, 3.01, 0.5)
    x, y = np.meshgrid(xs, xs, indexing="ij")
    pts = np.stack([x.ravel(), y.ravel(), np.zeros(x.size)], 1)
    c = cloud_of(pts, np.tile([0, 0, 1], (len(pts), 1)), 0.5)
    flux, hits, hits_sq, rays = disks.trace(
        c, 4000, sticking=1.0, walls=("periodic", "periodic"), seed=5,
        device="cpu", chunks=2)
    assert rays.tolist() == [2000, 2000]
    assert hits.tolist() == [2000, 2000]  # every ray hits once, then dies
    assert hits_sq.tolist() == [2000.0, 2000.0]
    # each hit deposits weight 1 on every disk covering the hit point:
    # at least one, at most the disk and its 8 neighbors
    assert 4000 <= flux.sum().item() <= 9 * 4000


def test_a_cloud_of_many_planes_is_refused():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (100, 3))
    nrm = rng.normal(size=(100, 3))
    with pytest.raises(ValueError, match="planes"):
        cloud_of(pts, nrm)
