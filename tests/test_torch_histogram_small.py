"""Kernel 2's small path (``csrc/flux_histogram.cu``:
``small_cluster_histogram_kernel``) on the CPU: its schedule as a plain
tensor-op model, the rule for its cluster size and for the path, and
``csrc/histogram_cluster.cuh:small_cluster_shift`` built by ``g++``.

The model does what the one launch of one cluster of C blocks does, step by
step: the entries dealt to the cluster's warps (launch B's schedule,
``warp_rounds``); each block's share of the entries for the largest |w|
(where every warp takes a few steps at most, the entries its warps hold in
registers from the maximum to the deposit; else quad q to thread q mod T of
the cluster's T threads, the entries past the last quad likewise), each
block's maximum and the cluster's (what every block reads from the others'
shared memory); each warp's entries with weight deposited 32 at a time with
the entries of one deposit that share a bin summed, the sums added to the
slice of the bin's owner (bin b in block b mod C at word b // C); and each
block's conversion of its own slice. Its output must be the plain version's
(``flux_histogram_ref``) bit for bit in float64, within 2^-22 of the
largest bin in float32 (the plain version sums in float64) with the integer
sums bit for bit, and the large path's model
(``test_torch_histogram_cluster.schedule_model``) bit for bit in both.
"""

import math
import os
import pathlib
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viennaray_tpu.ops.pallas_histogram import flux_histogram as ref_histogram

from viennaray_tpu_torch.ops import histogram as H

from test_torch_histogram_cluster import (
    CSRC,
    _deposits,
    _held_to_the_plain_version,
    fixed_words,
    schedule_model,
    warp_rounds,
)

torch.set_num_threads(1)
F32, F64 = torch.float32, torch.float64
CLUSTERS = [1, 2, 4, 8, 16]
# csrc/flux_histogram.cu: the threads of a block of the small path
THREADS = int(re.search(r"kSmallThreads = (\d+);", pathlib.Path(
    CSRC, "flux_histogram.cu").read_text()).group(1))
WARPS = THREADS // 32


def _bits(w):
    """The bits of |w| as the kernel orders them (mag_bits)."""
    a = w.abs()
    if w.dtype == F32:
        return a.view(torch.int32).long()
    return a.view(torch.int64)


def held(n_entries, cluster, vec=True):
    """Whether every warp of the cluster takes one step of quads (64 a
    warp) at most and one of the entries past the last quad (32 a warp), so
    that its threads keep their entries in registers."""
    n4 = n_entries // 4 if vec else 0
    n_warps = cluster * WARPS
    return n4 <= 64 * n_warps and n_entries - 4 * n4 <= 32 * n_warps


def entry_warps(entries, n4, n_warps):
    """The warp that deposits each entry (``warp_rounds``' deal): quad q,
    counted from the last, in step q // 64 of warp (q // 64) mod n_warps;
    entry e past the last quad in warp ((e - 4 n4) // 32) mod n_warps."""
    q = n4 - 1 - entries // 4
    tail = entries - 4 * n4
    return torch.where(entries < 4 * n4, (q // 64) % n_warps,
                       (tail // 32) % n_warps)


def max_shares(n_entries, cluster, vec=True):
    """The block of the cluster that reads each entry for the largest |w|:
    where ``held``, the block whose warp deposits it; else share_max with t
    = rank T + thread, T = THREADS C: quad q by thread q mod T, each entry
    past the last quad e by thread (e - 4 n4) mod T; where not vec no quads
    at all."""
    e = torch.arange(n_entries)
    n4 = n_entries // 4 if vec else 0
    if held(n_entries, cluster, vec):
        return entry_warps(e, n4, cluster * WARPS) // WARPS
    T = THREADS * cluster
    thread = torch.where(e < 4 * n4, (e // 4) % T, (e - 4 * n4) % T)
    return thread // THREADS


def small_schedule_model(ids, w, n_bins, cluster, vec=True):
    """The small path in tensor ops on one cluster of ``cluster`` blocks.
    Returns (out, the integer sums by bin, a record of the steps)."""
    n_entries = ids.numel()
    shift = cluster.bit_length() - 1
    words = 1 if w.dtype == F32 else 2
    size = -(-n_bins >> shift)  # slice_bins
    assert size * words * 8 <= H.SLICE_BYTES
    # each block's largest bits of |w|, then the cluster's
    block = max_shares(n_entries, cluster, vec)
    block_max = torch.zeros(cluster, dtype=torch.int64)
    if n_entries:
        block_max.scatter_reduce_(0, block, _bits(w), "amax")
    bits = int(block_max.max())
    record = {"block_max": block_max, "atomics": 0}
    out = torch.full((n_bins,), -1.0, dtype=w.dtype)
    slices = [torch.zeros(cluster, size, dtype=torch.int64)
              for _ in range(words)]
    if bits != 0:
        fixed = fixed_words(w, n_entries)
        assert fixed is not None
        words_of, convert = fixed
        valid = (w != 0) & (ids >= 0) & (ids < n_bins)
        entries = valid.nonzero().squeeze(1)
        # launch B's schedule on the cluster's warps (no quads where not
        # vec)
        call, _ = warp_rounds(entries, n_entries if vec else 0,
                              cluster * WARPS)
        bins = ids[entries].long()
        atoms, which = torch.unique(call * n_bins + bins, return_inverse=True)
        a_bin = atoms % n_bins
        record["atomics"] = len(atoms)
        owner, local = a_bin & (cluster - 1), a_bin >> shift
        for sl, v in zip(slices, words_of):
            sums = torch.zeros(len(atoms), dtype=torch.int64).index_add_(
                0, which, v[entries])
            sl.view(-1).index_add_(0, owner * size + local, sums)
    # each block converts its own slice: bin_of(i, rank) = i C + rank
    converted = torch.zeros(n_bins, dtype=torch.int64)
    by_bin = [torch.zeros(n_bins, dtype=torch.int64) for _ in range(words)]
    for rank in range(cluster):
        i = torch.arange(size)
        b = (i << shift) | rank
        keep = b < n_bins
        converted.index_add_(0, b[keep], torch.ones(int(keep.sum()),
                                                     dtype=torch.int64))
        for g, sl in zip(by_bin, slices):
            g[b[keep]] = sl[rank, keep]
    assert bool((converted == 1).all())
    if bits == 0:
        out.zero_()
    else:
        out = convert(by_bin)
    return out, by_bin, record


ENTRIES = [0, 1, 6144, H.SMALL_ENTRIES - 1]


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("n_entries", ENTRIES)
@pytest.mark.parametrize("cluster", CLUSTERS)
def test_the_small_schedule_gives_the_plain_sums(cluster, n_entries, dtype):
    """Every C on 2,993 bins (a multiple of no C above 1), E from none to
    one below the threshold, the last bin hit; the large path's model gives
    the same bits, and so does the schedule without quads (arrays not
    16-byte aligned)."""
    n_bins = 2993
    ids, w = _deposits(n_entries, n_bins, seed=cluster + n_entries,
                       dtype=dtype)
    if n_entries:
        ids[-1], w[-1] = n_bins - 1, 0.75
    out, sums, record = small_schedule_model(ids, w, n_bins, cluster)
    if n_entries == 0:
        assert not out.any() and record["atomics"] == 0
        assert torch.equal(out, H.flux_histogram_ref(ids, w, n_bins))
        return
    _held_to_the_plain_version(ids, w, n_bins, out, sums)
    assert out[-1] != 0
    # the cluster's maximum is the call's, whichever block read it
    assert int(record["block_max"].max()) == int(_bits(w).max())
    large, _, _ = schedule_model(ids, w, n_bins, 1, clusters=1)
    assert torch.equal(out, large)
    unaligned, _, _ = small_schedule_model(ids, w, n_bins, cluster, vec=False)
    assert torch.equal(unaligned, out)


@pytest.mark.parametrize("dtype", [F32, F64])
def test_all_weights_zero(dtype):
    ids, _ = _deposits(6144, 2993, seed=4, dtype=dtype)
    zeros = torch.zeros(6144, dtype=dtype)
    for cluster in CLUSTERS:
        out, _, record = small_schedule_model(ids, zeros, 2993, cluster)
        assert out.dtype == dtype and not out.any()
        assert record["atomics"] == 0
    assert torch.equal(H.flux_histogram(ids, zeros, 2993, path="small"), out)


@pytest.mark.parametrize("dtype", [F32, F64])
def test_the_largest_cluster_at_the_bins_limit(dtype):
    """The most bins the small path takes (``small_max_bins``): the
    slices of 16 blocks, full; the last bin lands in the last block's last
    word."""
    n_bins = H.small_max_bins(dtype)
    assert H.small_cluster_for(n_bins, dtype) == 16
    assert H.small_cluster_for(n_bins + 1, dtype) == 0
    ids, w = _deposits(5000, n_bins, seed=8, dtype=dtype, runs=False)
    ids[-3:], w[-3:] = n_bins - 1, 0.5
    out, sums, _ = small_schedule_model(ids, w, n_bins, 16)
    _held_to_the_plain_version(ids, w, n_bins, out, sums)
    assert out[-1] != 0


def test_the_small_schedule_against_the_pallas_kernel():
    """The JAX package's histogram (interpret mode) on the same seeded
    input, within 1e-5 of the largest bin (its bf16 pair of words)."""
    n_bins = 2993
    ids, w = _deposits(6144, n_bins, seed=21, zero=0.5)
    out, _, _ = small_schedule_model(ids, w, n_bins,
                                     H.small_cluster_for(n_bins))
    pallas = np.asarray(ref_histogram(jnp.asarray(ids.numpy()),
                                      jnp.asarray(w.numpy()), n_bins,
                                      interpret=True))
    exact = np.zeros(n_bins)
    np.add.at(exact, ids.numpy(), w.numpy().astype(np.float64))
    assert np.abs(out.numpy() - pallas).max() <= 1e-5 * np.abs(exact).max()


def _rule_cases():
    """(n, words): either side of the most bins the largest cluster's
    slices hold, and the shapes the trace gives kernel 2."""
    cases = [(n, words) for words in (1, 2)
             for n in (1, 2, 15, 16, 17, 2993, 18180, 36_000, 300_000,
                       704_250)]
    for words in (1, 2):
        top = 16 * H.SLICE_BYTES // 8 // words
        cases += [(top + d, words) for d in (-16, -1, 0, 1, 16)]
    return cases


def test_the_entries_stay_in_registers():
    """Up to 16 blocks' one step of their warps (8 x 256 x 16 = 32,768
    aligned entries) each entry is read once, its thread keeping it in
    registers from the maximum to the deposit; past that the kernel reads
    the entries twice."""
    top = 8 * THREADS * 16
    for n in (2993, 18180, 36_000):
        for dtype in (F32, F64):
            cluster = H.small_cluster_for(n, dtype)
            for e in (0, 1, 2047, 2048, 2049, 6144, 24575, top - 1, top):
                assert held(e, cluster), (e, n)
            assert not held(top + 4, cluster)


def test_small_cluster_for():
    """The largest cluster wherever its slices hold the bins, in float32
    and float64; none past that."""
    for n, words in _rule_cases():
        dtype = F32 if words == 1 else F64
        fits = math.ceil(n / 16) * words * 8 <= H.SLICE_BYTES
        assert H.small_cluster_for(n, dtype) == (16 if fits else 0), (n, words)
    assert H.small_max_bins(F32) == 16 * H.SLICE_BYTES // 8
    assert H.small_max_bins(F64) == H.small_max_bins(F32) // 2


def test_path_for_at_its_thresholds():
    """The small path below ``SMALL_ENTRIES`` entries where the bins fit in
    a cluster's slices (half as many float64 bins), else the large path."""
    for dtype in (F32, F64):
        top = H.small_max_bins(dtype)
        assert H.path_for(H.SMALL_ENTRIES - 1, 2993, dtype) == "small"
        assert H.path_for(H.SMALL_ENTRIES, 2993, dtype) == "large"
        assert H.path_for(0, top, dtype) == "small"
        assert H.path_for(6144, top + 1, dtype) == "large"
        assert H.path_for(6144, 18180, dtype) == "small"


def test_the_small_path_on_the_cpu():
    """``path="small"`` runs the plain version on the CPU up to the bins
    the cluster holds, and refuses more."""
    ids, w = _deposits(3000, 300_000, seed=5, runs=False)
    assert torch.equal(H.flux_histogram(ids, w, 300_000, path="small"),
                       H.flux_histogram_ref(ids, w, 300_000))
    with pytest.raises(ValueError, match="small path"):
        H.flux_histogram(ids, w, H.small_max_bins(F32) + 1, path="small")
    with pytest.raises(ValueError, match="small path"):
        H.flux_histogram(ids, w.double(), H.small_max_bins(F64) + 1,
                         path="small")


# ---- the header's rule, built by g++ -------------------------------------------
HOST_MAIN = r"""
#include <cstdio>
#include "histogram_cluster.cuh"

int main() {
  long long n;
  int words;
  // each line of stdin: n words; prints small_cluster_shift's answer
  while (scanf("%lld %d", &n, &words) == 2) {
    printf("%d\n", small_cluster_shift(n, words));
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_rule(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the header cannot be built here")
    work = tmp_path_factory.mktemp("histogram_small_host")
    (work / "main.cpp").write_text(HOST_MAIN)
    exe = work / "rule"
    subprocess.run([gxx, "-std=c++17", "-O1", "-I", CSRC,
                    str(work / "main.cpp"), "-o", str(exe)],
                   check=True, capture_output=True, text=True, timeout=300)
    return exe


def test_the_header_on_the_host(host_rule):
    """``small_cluster_shift`` is ``small_cluster_for``'s rule at the edge
    of the slices' room and at the trace's shapes."""
    cases = _rule_cases()
    run = subprocess.run([str(host_rule)], input="".join(
        f"{n} {words}\n" for n, words in cases), capture_output=True,
        text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    got = [int(line) for line in run.stdout.split("\n") if line]
    for (n, words), shift in zip(cases, got, strict=True):
        want = H.small_cluster_for(n, F32 if words == 1 else F64)
        assert (1 << shift if shift >= 0 else 0) == want, (n, words)
