"""Kernel 2's large path (``csrc/flux_histogram.cu``) on the CPU: its
schedule as a plain tensor-op model, and the owner mapping of
``csrc/histogram_cluster.cuh`` built by ``g++``.

The model does what launch B does, step by step: the entries dealt to the
warps of a persistent grid of ``clusters`` x C blocks (two quads a lane a
step, then the tail one entry a lane), each warp's entries with weight
queued and deposited 32 at a time, the entries of one deposit that share a
bin summed (``warp_sum``: one atomic a bin and deposit), the sums added to the
slice of the bin's owner in its cluster (bin b in block b mod C at word
b // C) or, on the global branch, to the global bins, each cluster's nonzero
slice words flushed once into the global bins, and the last cluster's
conversion (each bin converted once, block r taking bins r T + t stepping
C T). Integer sums are associative, so its output must be the plain
version's (``flux_histogram_ref``) bit for bit in float64; in float32 the
plain version sums in float64 and rounds once, so within 2^-22 of the
largest bin, with the integer sums themselves bit for bit.
"""

import math
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viennaray_tpu.ops.pallas_histogram import flux_histogram as ref_histogram

from viennaray_tpu_torch.ops import histogram as H

torch.set_num_threads(1)
CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                    "viennaray_tpu_torch", "csrc")
THREADS = 1024  # csrc/histogram_cluster.cuh:kClusterThreads
WARPS = THREADS // 32
SLICE_BINS = H.SLICE_BYTES // 8  # float32 bins a slice


def fixed_words(w, n_entries):
    """The kernel's fixed-point words of each weight (float32: one, float64:
    two) and the conversion of the bins' sums back, or None where every
    weight is 0."""
    wmax = float(w.abs().max()) if w.numel() else 0.0
    if wmax == 0.0:
        return None
    if w.dtype == torch.float32:
        # fixed_point.cuh:scale_exponent, to_fixed, finalize_kernel
        k = 62 - math.frexp(wmax)[1] - n_entries.bit_length()
        words = [torch.round(w.double() * math.ldexp(1.0, k)).long()]
        return words, lambda s: (s[0].double() * math.ldexp(1.0, -k)).float()
    k, low = H.fixed_point_f64(wmax, n_entries)
    x = w * math.ldexp(1.0, k)
    hi = torch.round(x)
    lo = torch.round((x - hi) * math.ldexp(1.0, low))
    return [hi.long(), lo.long()], lambda s: (
        s[0].double() * math.ldexp(1.0, -k)
        + s[1].double() * math.ldexp(1.0, -(k + low)))


def warp_rounds(entries, n_entries, n_warps):
    """For entries with weight (indices), the warp_sum call that adds each
    (a number unique to one call of one warp) and that warp's block. Quads,
    counted from the last (q read as n4 - 1 - q), [64 s, 64 s + 64) make
    step s of warp s mod n_warps, the tail's entries
    4 n4 + [32 t, 32 t + 32) its step t of warp t mod n_warps, after every
    quad step. A warp queues its entries with weight in the order it reads
    them (by step; in a step of quads by call, 4 ((q mod 64) // 32) +
    (e mod 4), then lane) and deposits them 32 at a time: round r takes its
    queued entries 32 r to 32 r + 31, the last round fewer."""
    n4 = n_entries // 4
    q = n4 - 1 - entries // 4  # the quads read from the last
    in_quads = entries < 4 * n4
    tail = torch.clamp(entries - 4 * n4, min=0)
    quad_steps = -(-n4 // 64)
    warp = torch.where(in_quads, (q // 64) % n_warps, (tail // 32) % n_warps)
    order = torch.where(
        in_quads, ((q // 64) * 8 + ((q % 64) // 32) * 4 + entries % 4) * 32
        + q % 32, (quad_steps * 8 + tail // 32) * 32 + tail % 32)
    by_warp = torch.argsort(warp * (int(order.max()) + 1) + order)
    _, counts = torch.unique_consecutive(warp[by_warp], return_counts=True)
    starts = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    rank = torch.empty_like(by_warp)
    rank[by_warp] = torch.arange(len(by_warp)) - starts
    rounds = len(entries) // 32 + 2
    return warp * rounds + rank // 32, warp // WARPS


def conversion_cover(n_bins, cluster):
    """The bins the last cluster's blocks convert, each block r taking
    r T + t, stepping C T: every bin once."""
    done = torch.zeros(n_bins, dtype=torch.int64)
    for r in range(cluster):
        for t0 in range(r * THREADS, n_bins, cluster * THREADS):
            done[t0:t0 + THREADS] += 1
    return bool((done == 1).all())


def schedule_model(ids, w, n_bins, cluster, clusters, shared=True):
    """Kernel 2's large path in tensor ops on ``clusters`` clusters of
    ``cluster`` blocks; ``shared`` False: the global branch. Returns (out,
    the sums of the global bins, a record of the atomics)."""
    n_entries = ids.numel()
    out = torch.zeros(n_bins, dtype=w.dtype)
    fixed = fixed_words(w, n_entries)
    if fixed is None:
        return out, None, {"atomics": 0, "flush": 0}
    words, convert = fixed
    valid = (w != 0) & (ids >= 0) & (ids < n_bins)
    entries = valid.nonzero().squeeze(1)
    bins = ids[entries].long()
    vals = [x[entries] for x in words]
    call, block = warp_rounds(entries, n_entries,
                              clusters * cluster * WARPS)
    # warp_sum: one atomic a (call, bin)
    atoms, which = torch.unique(call * n_bins + bins, return_inverse=True)
    sums = [torch.zeros(len(atoms), dtype=torch.int64).index_add_(0, which, v)
            for v in vals]
    a_bin = atoms % n_bins
    a_cluster = torch.zeros(len(atoms), dtype=torch.int64).scatter_(
        0, which, block // cluster)
    record = {"atomics": len(atoms), "entries": len(entries)}
    glob = [torch.zeros(n_bins, dtype=torch.int64) for _ in words]
    if shared:
        shift = cluster.bit_length() - 1
        size = -(-n_bins >> shift)  # slice_bins
        assert size * len(words) * 8 <= H.SLICE_BYTES
        owner, local = a_bin & (cluster - 1), a_bin >> shift
        slot = (a_cluster * cluster + owner) * size + local
        flushed = 0
        word_index = torch.arange(clusters * cluster * size)
        f_bin = (word_index % size) << shift | ((word_index // size)
                                                % cluster)
        for g, s in zip(glob, sums):
            slices = torch.zeros(clusters * cluster * size,
                                 dtype=torch.int64).index_add_(0, slot, s)
            live = slices != 0
            assert bool((f_bin[live] < n_bins).all())
            g.index_add_(0, f_bin[live], slices[live])
            flushed += int(live.sum())
        record["flush"] = flushed
    else:
        for g, s in zip(glob, sums):
            g.index_add_(0, a_bin, s)
        record["flush"] = 0
    assert conversion_cover(n_bins, cluster)
    return convert(glob), glob, record


def _deposits(n_entries, n_bins, seed, dtype=torch.float32, zero=0.8,
              runs=True):
    """Seeded (ids, w): weights with most entries 0, the last bin among the
    ids, and with ``runs`` the same bin in four consecutive quads at one
    place (entries e, e + 4, e + 8, e + 12: neighbouring rays share disks),
    which one warp_sum call takes together."""
    rng = np.random.default_rng(seed)
    if runs:
        base = rng.integers(0, n_bins, (n_entries // 16 + 1, 1, 4))
        ids = np.broadcast_to(base, (len(base), 4, 4)).reshape(-1)
        ids = ids[:n_entries].copy()
    else:
        ids = rng.integers(0, n_bins, n_entries)
    ids[rng.random(n_entries) < 0.01] = n_bins - 1
    w = rng.random(n_entries) * 4.0 - 1.0
    w[rng.random(n_entries) < zero] = 0.0
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    return (torch.from_numpy(ids.astype(np.int32)),
            torch.from_numpy(w.astype(np_dtype)))


def _held_to_the_plain_version(ids, w, n_bins, out, glob):
    ref = H.flux_histogram_ref(ids, w, n_bins)
    if w.dtype == torch.float64:
        assert torch.equal(out, ref)
        return
    # the integer sums bit for bit, the float32 output within 2^-22
    words, _ = fixed_words(w, ids.numel())
    want = torch.zeros(n_bins, dtype=torch.int64).index_add_(
        0, ids.long(), torch.where(w != 0, words[0], 0))
    assert torch.equal(glob[0], want)
    assert float((out - ref).abs().max()) <= float(ref.abs().max()) * 2.0**-22


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("cluster", [1, 2, 8, 16])
def test_the_schedule_gives_the_plain_sums(cluster, dtype):
    """C = 1, 2, 8, 16 on 2,993 bins (not a multiple of C), ragged entries
    (a tail after the quads), two clusters; the global branch alike."""
    n_bins, n_entries = 2993, 70_001
    ids, w = _deposits(n_entries, n_bins, seed=cluster, dtype=dtype)
    out, glob, record = schedule_model(ids, w, n_bins, cluster, clusters=2)
    _held_to_the_plain_version(ids, w, n_bins, out, glob)
    # the runs: the warps' sums take fewer atomics than entries; each
    # cluster flushes each bin at most once
    assert record["atomics"] < record["entries"]
    assert record["flush"] <= 2 * n_bins * len(glob)
    out_g, glob_g, _ = schedule_model(ids, w, n_bins, cluster, clusters=2,
                                      shared=False)
    assert torch.equal(out_g, out)
    assert all(torch.equal(a, b) for a, b in zip(glob_g, glob))


F32, F64 = torch.float32, torch.float64
# (n, dtype, C): either side of the first flush boundary (a slice of
# FLUSH_WORDS words) and at the last slice that fits (C = 16)
BOUNDARIES = [(H.FLUSH_WORDS, F32, 1), (H.FLUSH_WORDS + 1, F32, 2),
              (16 * SLICE_BINS - 1, F32, 16), (16 * SLICE_BINS, F32, 16),
              (H.FLUSH_WORDS // 2, F64, 1), (H.FLUSH_WORDS // 2 + 1, F64, 2),
              (8 * SLICE_BINS, F64, 16)]


@pytest.mark.parametrize("n_bins, dtype, cluster", BOUNDARIES)
def test_slice_boundaries(n_bins, dtype, cluster):
    """n at a slice boundary and either side of it: ``cluster_for`` takes
    the C given, the slices hold ceil(n / C) bins, and the last bin lands in
    its owner's slice."""
    assert H.cluster_for(n_bins, dtype) == cluster
    ids, w = _deposits(20_000, n_bins, seed=n_bins % 97, dtype=dtype,
                       runs=False)
    ids[-5:] = n_bins - 1
    w[-5:] = 0.5
    out, glob, _ = schedule_model(ids, w, n_bins, cluster, clusters=3)
    _held_to_the_plain_version(ids, w, n_bins, out, glob)
    assert out[-1] != 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_all_weights_zero_and_no_entries(dtype):
    ids, _ = _deposits(5000, 700, seed=3, dtype=dtype)
    zeros = torch.zeros(5000, dtype=dtype)
    for i, x in ((ids, zeros), (ids[:0], zeros[:0])):
        out, _, record = schedule_model(i, x, 700, 4, clusters=2)
        assert out.dtype == dtype and not out.any()
        assert record["atomics"] == 0
        assert torch.equal(H.flux_histogram(i, x, 700, path="large",
                                            branch="global"), out)


def test_more_than_2_24_entries():
    """E = 2^24 + 5: the scale's entry count takes 25 bits; the last entry
    sits in the tail after the quads, others in the last quads' steps."""
    n_entries, n_bins = (1 << 24) + 5, 18180
    ids = torch.zeros(n_entries, dtype=torch.int32)
    w = torch.zeros(n_entries, dtype=torch.float32)
    rng = np.random.default_rng(5)
    at = np.concatenate([rng.integers(0, n_entries, 3000),
                         np.arange(n_entries - 300, n_entries)])
    ids[at] = torch.from_numpy(rng.integers(0, n_bins, len(at))
                               .astype(np.int32))
    w[at] = torch.from_numpy(rng.random(len(at)).astype(np.float32))
    ids[-1] = n_bins - 1
    out, glob, _ = schedule_model(ids, w, n_bins, H.cluster_for(n_bins),
                                  clusters=8)
    _held_to_the_plain_version(ids, w, n_bins, out, glob)


def test_cluster_for_and_path_for():
    """The C of the shapes the trace gives kernel 2 (the flagship, disk18k,
    disk1m) and of the slice boundaries; ``path_for`` as before."""
    assert [H.cluster_for(n) for n in (1, 2993, 18180, 300_000,
                                       16 * SLICE_BINS + 1, 704_250)] == [
        1, 1, 8, 16, 0, 0]
    assert [H.cluster_for(n, F64) for n in (2993, 18180,
                                            8 * SLICE_BINS + 1)] == [2, 16, 0]
    assert H.path_for(H.SMALL_ENTRIES - 1, 2993) == "small"
    assert H.path_for(H.SMALL_ENTRIES, 2993) == "large"
    assert H.path_for(10, 704_250) == "large"


def test_branch_for():
    """The cluster branch where the bins fit and the entries are at least
    FLUSH_ENTRIES times the words the blocks flush, else the global one:
    the flagship's wide launches of 32,768 and 65,536 rays (12 entries a
    ray) take the global branch, from 131,072 rays the cluster branch; so
    do 2^20 entries."""
    edge = H.FLUSH_ENTRIES * 132 * 2993
    assert H.branch_for(edge - 1, 2993) == "global"
    assert H.branch_for(edge, 2993) == "cluster"
    assert [H.branch_for(12 * r, 2993) for r in (1 << 15, 1 << 16, 1 << 17,
                                                 1 << 20)] == [
        "global", "global", "cluster", "cluster"]
    assert H.branch_for(1 << 20, 2993) == "cluster"
    # disk18k at C = 8 (2,273 bins a slice); float64 words count twice
    assert H.branch_for(12 << 20, 18180) == "cluster"
    assert H.branch_for(H.FLUSH_ENTRIES * 132 * 2273 - 1, 18180) == "global"
    assert H.branch_for(12 << 19, 2993, F64) == "cluster"
    assert H.branch_for(H.FLUSH_ENTRIES * 132 * 2 * 1497 - 1, 2993,
                        F64) == "global"
    # past the cluster's reach, and fewer SMs
    assert H.branch_for(45_088_768, 704_250) == "global"
    assert H.branch_for(edge // 2, 2993, sms=66) == "cluster"


def test_the_branch_argument():
    """``branch`` forces a branch of the large path, is checked, and on the
    CPU runs the plain version (the same bits)."""
    ids, w = _deposits(H.SMALL_ENTRIES + 5000, 2993, seed=9)
    ref = H.flux_histogram_ref(ids, w, 2993)
    for branch in ("cluster", "global"):
        assert torch.equal(H.flux_histogram(ids, w, 2993, branch=branch), ref)
        assert torch.equal(H.flux_histogram(ids, w, 2993, path="large",
                                            branch=branch), ref)
    with pytest.raises(ValueError, match="no such branch"):
        H.flux_histogram(ids, w, 2993, branch="shared")
    with pytest.raises(ValueError, match="large path"):
        H.flux_histogram(ids, w, 2993, path="small", branch="global")
    with pytest.raises(ValueError, match="large path"):
        H.flux_histogram(ids[:100], w[:100], 2993, branch="global")
    big = 704_250
    ids_big = torch.full((100,), big - 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="global branch"):
        H.flux_histogram(ids_big, w[:100], big, path="large",
                         branch="cluster")
    out = H.flux_histogram(ids_big, w[:100], big, path="large",
                           branch="global")
    assert torch.equal(out, H.flux_histogram_ref(ids_big, w[:100], big))


def test_the_schedule_against_the_pallas_kernel():
    """The JAX package's histogram (interpret mode) on the same seeded
    input, within 1e-5 of the largest bin (its bf16 pair of words)."""
    n_bins = 2993
    ids, w = _deposits(8192, n_bins, seed=21, zero=0.5)
    out, _, _ = schedule_model(ids, w, n_bins, 8, clusters=1)
    pallas = np.asarray(ref_histogram(jnp.asarray(ids.numpy()),
                                      jnp.asarray(w.numpy()), n_bins,
                                      interpret=True))
    exact = np.zeros(n_bins)
    np.add.at(exact, ids.numpy(), w.numpy().astype(np.float64))
    assert np.abs(out.numpy() - pallas).max() <= 1e-5 * np.abs(exact).max()


# ---- the owner mapping and the rule for C, built by g++ ---------------------
HOST_MAIN = r"""
#include <cstdio>
#include "histogram_cluster.cuh"

int main() {
  long long n;
  int words;
  // each line of stdin: n words; prints the shift, then checks that the
  // slices deal every bin once: b = bin_of(bin_local(b), bin_owner(b)), in
  // a slice of slice_bins(n, shift) words
  while (scanf("%lld %d", &n, &words) == 2) {
    const int shift = cluster_shift(n, words);
    int ok = 1;
    for (int s = 0; s <= kMaxClusterShift; ++s) {
      for (long long b = 0; b < n; ++b) {
        const int id = (int)b;
        if (bin_of(bin_local(id, s), bin_owner(id, s), s) != b ||
            bin_local(id, s) >= slice_bins(n, s) ||
            bin_owner(id, s) >= (1 << s)) {
          ok = 0;
        }
      }
    }
    printf("%d %d\n", shift, ok);
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_mapping(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the header cannot be built here")
    work = tmp_path_factory.mktemp("histogram_cluster_host")
    (work / "main.cpp").write_text(HOST_MAIN)
    exe = work / "mapping"
    subprocess.run([gxx, "-std=c++17", "-O1", "-I", CSRC,
                    str(work / "main.cpp"), "-o", str(exe)],
                   check=True, capture_output=True, text=True, timeout=300)
    return exe


def test_the_header_on_the_host(host_mapping):
    """``cluster_shift`` is ``cluster_for``'s rule, and the owner mapping
    deals every bin to one word of one slice, at every C and around every
    slice boundary."""
    cases = [(n, words) for words in (1, 2)
             for c in (1, 2, 4, 8, 16)
             for edge in (c * H.FLUSH_WORDS // words,
                          c * SLICE_BINS // words)
             for n in (edge - 1, edge, edge + 1)]
    cases += [(1, 1), (2993, 1), (2993, 2), (18180, 1), (18180, 2),
              (300_000, 1), (704_250, 1)]
    run = subprocess.run([str(host_mapping)], input="".join(
        f"{n} {words}\n" for n, words in cases), capture_output=True,
        text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    got = [tuple(map(int, line.split())) for line in run.stdout.split("\n")
           if line]
    dtypes = {1: torch.float32, 2: torch.float64}
    for (n, words), (shift, ok) in zip(cases, got, strict=True):
        assert ok == 1, n
        want = H.cluster_for(n, dtypes[words])
        assert (1 << shift if shift >= 0 else 0) == want, (n, words)
