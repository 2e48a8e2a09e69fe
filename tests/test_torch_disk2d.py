"""The 2D disk path end to end: ``TraceDisk(dim=2)`` against the scalar
oracle's ``disk2d_trench_oracle`` golden, on the CPU.

The configuration is the JAX package's ``disk2d_trench``
(``benchmarks/make_goldens.py:config_disk2d_trench``) on its fixture
``create_trench_grid_2d`` at grid delta 0.1: 180 disks, periodic walls,
diffuse particle with sticking 0.1, source on the +y face, batches of
16,384. The golden is the mean of two oracle seeds of 4,000,000 rays each
(``viennaray_tpu_torch/io/make_oracle_goldens.py --name
disk2d_trench_oracle``); the test needs neither ``g++`` nor the oracle.
"""

import json
import os

import numpy as np
import pytest
import torch

import viennaray_tpu_torch as vrtt
from viennaray_tpu_torch.io import fixtures

torch.set_num_threads(1)

GOLDEN = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "viennaray_tpu_torch", "io", "golden", "disk2d_trench_oracle",
)
# the configuration's depth is 200,000 rays; a quarter of them carries
# twice its Monte Carlo noise, so the bound is twice the golden bound of 0.05
# (PERF.md section 2)
RAYS = 50_000
BOUND = 2 * 0.05


def _golden():
    with open(GOLDEN + ".json") as f:
        return np.load(GOLDEN + ".npy"), json.load(f)


def _tracer(fused):
    t = vrtt.TraceDisk(dim=2, device="cpu", fused=fused)
    pts, nrm = fixtures.create_trench_grid_2d(grid_delta=0.1)
    t.set_geometry(pts, nrm, 0.1)
    t.set_boundary_conditions([vrtt.BoundaryCondition.PERIODIC] * 2)
    t.set_particle_type(vrtt.DiffuseParticle(0.1, "flux"))
    t.set_source_direction(vrtt.TraceDirection.POS_Y)
    t.set_number_of_rays_fixed(RAYS)
    t.set_rng_seed(12345)
    t.set_ray_batch_size(16384)
    return t


def test_golden_record_is_the_disk2d_trench_configuration():
    golden, record = _golden()
    assert record["mesh"]["fixture"] == "create_trench_grid_2d"
    assert record["mesh"]["disks"] == len(golden) == 180
    assert record["mesh"]["grid_delta"] == 0.1
    assert record["physics"]["sticking"] == 0.1
    assert record["physics"]["boundary"] == "periodic"
    assert record["seeds"] == [101, 202]
    # the two seeds agree far below the golden bound
    assert record["rel_l2_between_seeds"] < 0.035
    assert np.isfinite(golden).all() and golden.min() > 0


@pytest.mark.parametrize("fused", [True, False])
def test_trace_disk_2d_matches_disk2d_trench_oracle(fused):
    """Both bodies (on the CPU, the fused one runs the bounce kernel's plain
    version over the ladder of 4 and 16 bounces per launch): SOURCE-normalized
    flux within the bound, hits per ray within 2 % of the oracle's."""
    golden, record = _golden()
    t = _tracer(fused)
    flux = t.apply()
    norm = t.normalize_flux(flux)
    assert norm.shape == golden.shape and np.isfinite(norm).all()
    rel_l2 = np.linalg.norm(norm - golden) / np.linalg.norm(golden)
    assert rel_l2 < BOUND, rel_l2
    info = t.get_ray_trace_info()
    assert info.num_rays == RAYS
    want = record["geometry_hits_per_ray"]
    assert abs(info.geometry_hits / info.num_rays - want) <= 0.02 * want
