"""The comparison's numbers on hand-checked cases."""

import math

import numpy as np
import pytest
import torch

from fluxbench import compare


def reference(n):
    """Two runs of one ray each, 1 +- 0.5 on every element: the mean 1, a
    ray's variance s^2 = 0.5 on every element, ``n`` = 2 rays."""
    per_run = torch.stack([torch.full((n,), 1.5, dtype=torch.float64),
                           torch.full((n,), 0.5, dtype=torch.float64)])
    return compare.Reference(per_run, torch.tensor([1, 1]),
                             torch.tensor(3), torch.tensor(5.0))


@pytest.mark.parametrize("n,lo,hi", [(1024, 512, 768), (1000, 768, 1000)])
def test_a_fault_in_one_block_reads_in_that_block(n, lo, hi):
    # 2 rays against 2: the noise of the difference is s^2 (1/2 + 1/2)
    ref = reference(n)
    out = np.ones(n)
    out[lo:hi] += 0.5
    assert compare.flux_chi2(ref, out, 2) == pytest.approx(
        0.25 * (hi - lo) / (0.5 * n))
    # blocks of 256 (n // 64 is less): the shifted block's own chi-square
    assert compare.flux_chi2_block(ref, out, 2) == pytest.approx(0.5)
    assert compare.flux_chi2_block(ref, np.ones(n), 2) == 0.0


def test_a_small_cloud_is_one_block_and_a_large_one_64():
    ref = reference(200)
    out = np.ones(200)
    out[:10] += 0.5
    assert compare.flux_chi2_block(ref, out, 2) == pytest.approx(
        compare.flux_chi2(ref, out, 2))
    n = 64 * 300
    ref = reference(n)
    out = np.ones(n)
    out[:300] += 0.5  # the first of 64 blocks of 300
    assert compare.flux_chi2_block(ref, out, 2) == pytest.approx(0.5)


def test_a_wrong_or_broken_output_reads_infinite():
    ref = reference(300)
    assert compare.flux_chi2_block(ref, np.ones(299), 2) == math.inf
    bad = np.ones(300)
    bad[3] = np.nan
    assert compare.flux_chi2_block(ref, bad, 2) == math.inf


def test_judge_takes_the_numbers_its_limits_name():
    ref = reference(1024)
    out = np.ones(1024)
    out[:256] += 0.5
    ok, numbers = compare.judge(ref, [(out, 1.5, 2), (out, 1.5, 2)],
                                {"flux_chi2_mean": 0.15,
                                 "flux_chi2_block": 0.9})
    # the mean of two outputs of 2 rays: as noisy as one of 4
    assert numbers["flux_chi2_mean"][0] == pytest.approx(
        0.25 * 256 / (512 * (1 / 4 + 1 / 2)))
    assert numbers["flux_chi2_block"][0] == pytest.approx(
        0.25 * 256 / (128 * (1 / 4 + 1 / 2)))
    assert not ok  # the block's 0.67 is within 0.9, the mean's 0.167 not
    assert set(numbers) == {"flux_chi2_mean", "flux_chi2_block"}
    ok, _ = compare.judge(ref, [(out, 1.5, 2)], {"flux_chi2_block": 0.9})
    assert ok
