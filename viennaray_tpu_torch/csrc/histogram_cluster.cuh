// Kernel 2's bins over a thread-block cluster (flux_histogram.cu): which
// block of a cluster of C = 2^cshift blocks holds a bin, where in its
// shared memory, and which C a call takes on either path. Plain host and
// device code, so that tests/test_torch_histogram_cluster.py and
// tests/test_torch_histogram_small.py build it with g++ and hold it to
// ops/histogram.py:cluster_for and small_cluster_for.
//
// Bin b lives in block b & (C - 1) of the cluster (its owner), at word
// b >> cshift of that block's slice: the bins are dealt to the C blocks in
// turn, so a slice holds ceil(n / C) words (two for float64 weights: the
// high words, then the low words) and a power-of-two C needs no division.
#pragma once

#ifdef __CUDACC__
#define VR_HOST_DEVICE __host__ __device__
#else
#define VR_HOST_DEVICE
#endif

namespace {

// the threads of a block of the large path: one block an SM
constexpr int kClusterThreads = 1024;
// a block's slice of bins in shared memory (of the 227 KB a block may have;
// its warps' queues of entries take up to 24 KB more)
constexpr long long kSliceBytes = 200 * 1024;
// C up to 16 blocks (above 8 a non-portable size)
constexpr int kMaxClusterShift = 4;
// the words of a slice that C keeps to where it can: each block flushes its
// slice, so the flush takes (blocks x slice words) global atomics
constexpr long long kFlushWords = 4096;

VR_HOST_DEVICE inline long long slice_bins(long long n_bins, int cshift) {
  return (n_bins + (1ll << cshift) - 1) >> cshift;
}

VR_HOST_DEVICE inline int bin_owner(int id, int cshift) {
  return id & ((1 << cshift) - 1);
}

VR_HOST_DEVICE inline int bin_local(int id, int cshift) { return id >> cshift; }

VR_HOST_DEVICE inline long long bin_of(long long local, int rank, int cshift) {
  return (local << cshift) | rank;
}

// The cluster branch's cshift for n_bins bins of `words` 64-bit words each
// (1 for float32 weights, 2 for float64): the smallest whose slices hold at
// most kFlushWords words, else kMaxClusterShift; -1 where that slice does
// not fit in kSliceBytes (the global branch)
VR_HOST_DEVICE inline int cluster_shift(long long n_bins, int words) {
  int c = 0;
  while (c < kMaxClusterShift && slice_bins(n_bins, c) * words > kFlushWords) {
    ++c;
  }
  return slice_bins(n_bins, c) * words * 8 <= kSliceBytes ? c : -1;
}

// The small path's cshift for n_bins bins of `words` words each: the
// largest cluster (a sweep of C = 1 to 16 at 512 to 24,575 entries on 2,993
// and 18,180 bins found it within 2 % of the fastest C at every shape, and
// up to 4.4x faster than C = 1; chip_diagnose.py --small-sweep, PERF.md),
// or -1 where its slices do not fit in kSliceBytes (the large path then)
VR_HOST_DEVICE inline int small_cluster_shift(long long n_bins, int words) {
  const int c = kMaxClusterShift;
  return slice_bins(n_bins, c) * words * 8 <= kSliceBytes ? c : -1;
}

}  // namespace
