"""The port's plain weighted histogram against the JAX package's Pallas
histogram kernel (interpret mode) and against ``np.add.at`` in float64.

Tolerance 1e-5 relative to the largest bin: the Pallas kernel carries each
weight as a bf16 high part plus a bf16 residual (about 16 bits), the port
sums in float64 and rounds once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viennaray_tpu.ops.pallas_histogram import flux_histogram as ref_histogram

from viennaray_tpu_torch.ops import histogram

torch.set_num_threads(1)


def _deposits(n_bins, n_entries, seed, zero_fraction=0.7):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n_bins, n_entries).astype(np.int32)
    w = rng.random(n_entries).astype(np.float32)
    w[rng.random(n_entries) < zero_fraction] = 0.0
    return ids, w


@pytest.mark.parametrize("n_bins", [100, 2993, 9000, 18180])
def test_plain_version_matches_pallas_kernel_and_numpy(n_bins):
    ids, w = _deposits(n_bins, 4096, seed=n_bins)
    got = histogram.flux_histogram_ref(
        torch.from_numpy(ids), torch.from_numpy(w), n_bins
    ).numpy()
    exact = np.zeros(n_bins, np.float64)
    np.add.at(exact, ids, w.astype(np.float64))
    np.testing.assert_array_equal(got, exact.astype(np.float32))
    pallas = np.asarray(
        ref_histogram(jnp.asarray(ids), jnp.asarray(w), n_bins, interpret=True)
    )
    assert np.abs(got - pallas).max() <= 1e-5 * exact.max()
    # on CPU tensors the wrapper is the plain version
    wrapped = histogram.flux_histogram(
        torch.from_numpy(ids), torch.from_numpy(w), n_bins
    )
    np.testing.assert_array_equal(wrapped.numpy(), got)


def test_all_zero_weights_and_empty_input():
    ids, w = _deposits(500, 2048, seed=3)
    out = histogram.flux_histogram(
        torch.from_numpy(ids), torch.zeros(2048), 500
    )
    assert out.shape == (500,) and out.dtype == torch.float32
    assert not out.any()
    empty = histogram.flux_histogram(
        torch.zeros(0, dtype=torch.int32), torch.zeros(0), 500
    )
    assert empty.shape == (500,) and not empty.any()


def test_repeatable_and_input_checks():
    ids, w = _deposits(2993, 4096, seed=5)
    a = histogram.flux_histogram(torch.from_numpy(ids), torch.from_numpy(w), 2993)
    b = histogram.flux_histogram(torch.from_numpy(ids), torch.from_numpy(w), 2993)
    assert torch.equal(a, b)
    with pytest.raises(TypeError):
        histogram.flux_histogram(
            torch.from_numpy(ids).long(), torch.from_numpy(w), 2993
        )
    with pytest.raises(ValueError):
        histogram.flux_histogram(
            torch.from_numpy(ids)[:10], torch.from_numpy(w), 2993
        )
