// Weighted histogram: out[b] = sum of w[e] over the entries with ids[e] == b.
//
// Replaces the TPU kernel viennaray_tpu/ops/pallas_histogram.py:_hist_kernel
// (launched by flux_histogram). That kernel turns the scatter into one-hot
// matrix products because the TPU has no fast scatter; an H100 has atomics,
// so none of the one-hot machinery is carried over.
//
// Design: integer atomics on fixed-point weights (csrc/fixed_point.cuh, shared
// with the bounce kernel): bitwise repeatable whatever order the atomics land
// in, and float32-accurate. The scale comes from the largest |w| of the call
// (a first pass) and the entry count E. The other deterministic design, a
// stable sort by bin followed by a segmented sum, would spend most of its
// time in a library sort of all E entries; this one reads each entry twice
// (w) or once (ids).
//
// What bounds it on an H100: bytes, 8 per entry (ids and w read once); the
// bins are a few KB to a few MB. Entries with weight 0 (most neighbour slots)
// cost the read and nothing else.
//
// The large path (vr_flux_histogram): two launches a call, nothing cleared
// by the host.
// - Launch A (prepare_kernel) takes the largest |w| of each block's share of
//   the entries with 16-byte loads into a partial maximum of its own (an
//   atomic maximum would need a word cleared before the launch), and clears
//   the global bins and the ticket.
// - Launch B (cluster_histogram_kernel), A's programmatic dependent (its
//   blocks start on the SMs A's blocks leave), reduces the partial maxima,
//   so every block holds the call's scale, and accumulates. It reads the
//   quads from the last, which A read last, so some are still in L2. Its
//   blocks, 1,024 threads and one an SM, form clusters of C = 2^cshift
//   blocks (a launch attribute). On the cluster branch the n bins are dealt
//   to the C blocks of a cluster (csrc/histogram_cluster.cuh), each holding
//   its slice in shared memory, and an entry's value goes to its owner's
//   slice through the cluster's distributed shared memory (mapa and
//   red.shared::cluster; at C = 1 as two native 32-bit atomics, since a
//   64-bit shared atomic compiles to a compare-and-swap loop). After a cluster
//   barrier each block adds its slice's nonzero words to the global bins:
//   (clusters x n) global atomics where a private copy of all n bins a block
//   would flush (blocks x n). C keeps a slice near 4,096 words where it can;
//   up to 16 x 25,600 float32 bins stay on the chip. Past that, and where
//   the entries are few beside the flush (ops/histogram.py:branch_for), the
//   global branch sends the entries' values to the global bins directly;
//   they stay in the 50 MB L2. Each warp queues its entries that carry
//   weight and deposits them 32 at a time, summing first those that share a
//   bin (warp_sum): one tree for 32 entries with weight, not for 32 entries
//   of which most carry none. Each cluster then takes a ticket after a
//   __threadfence(), and the last one converts the bins into out
//   (finalize_kernel's conversion) and leaves the ticket at 0.
//
// Small calls (vr_flux_histogram_small): the large path's two launches cost
// some 0.011 ms whatever E is, about all the time of the unfused body's
// narrow bounces (a few thousand entries). Below a threshold of entries
// that the wrapper holds (ops/histogram.py:SMALL_ENTRIES), and where the
// bins fit in a cluster's shared memory, one launch of one thread-block
// cluster does it all, with no scratch, no memset, no global atomic and no
// ticket (small_cluster_histogram_kernel). Its C = 2^s blocks
// (histogram_cluster.cuh:small_cluster_shift) each clear their slice of the
// bins (dealt as on the large path's cluster branch), take the largest |w|
// bits of their share of the entries into their own shared memory, and
// after a cluster barrier read the C values through the cluster's
// distributed shared memory, so every block holds the call's bits and
// scale. Then launch B's entry path (warp queues, warp_sum, the additions
// to the owner's slice) and, after a second barrier, each block converts
// its own slice straight into out. The same largest |w|, scale, integer
// sums and conversion as the large path: both paths give the same bits for
// the same input. The cluster spreads the clearing and conversion of the
// bins and the entries over C SMs; at these sizes a call's time is mostly
// the launch and the two barriers, whatever E is (PERF.md).
//
// Float64 weights (the float64 trace; vr_flux_histogram_f64,
// vr_flux_histogram_small_f64): the same two paths with two fixed-point words
// an entry (fixed_point.cuh, "float64 weights"), summed in two 64-bit bins
// each (16 bytes a bin in shared memory). Bound by bytes: 12 an entry (ids
// and w read once) and two words a bin. The plain version does the same
// integer sums with index_add_ on int64 tensors, so kernel, plain version
// and both paths give the same bits. The library call beside it, index_add_
// on float64, adds floats with atomics in an order that changes from run to
// run on a card.
//
// The backward (vr_flux_histogram_grad): d out[b] / d w[e] is 1 where
// ids[e] == b, so the gradient of the weights is a gather, grad_w[e] =
// grad_out[ids[e]]. The JAX package has no TPU kernel for it: XLA transposes
// its one-hot contraction (viennaray_tpu/trace/kernel.py:161-163). Bound by
// bytes, 8 per entry (ids read, grad_w written) plus the bins, which stay
// in L2; one thread per entry, a grid-stride loop, exact (no arithmetic).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fixed_point.cuh"
#include "histogram_cluster.cuh"

namespace cg = cooperative_groups;

namespace {

// The entries of a warp that share a bin summed: every thread of the warp
// calls it together with its entry's key (the bin, or -1 for nothing to
// add) and its N words; a tree over the warp's shuffles in the order of
// their lanes (after NVIDIA's reduce_peers) leaves each key's sums on its
// lowest lane, which gets true and adds them with one atomic a word: a bin
// that many entries hit (the tail's rays sit on a few disks) costs one
// atomic a warp instead of one an entry. Integer sums: the same bits in any
// grouping.
template <int N>
__device__ __forceinline__ bool warp_sum(int key, unsigned long long (&v)[N]) {
  const int lane = threadIdx.x & 31;
  unsigned int peers = __match_any_sync(0xffffffffu, key);
  const int first = __ffs(peers) - 1;
  int rank = __popc(peers & ((1u << lane) - 1u));
  peers &= 0xfffffffeu << lane;  // the peers on higher lanes
  while (__any_sync(0xffffffffu, peers != 0u)) {
    const int next = __ffs(peers);  // 1 + the next peer's lane, or 0
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const unsigned long long t = __shfl_sync(0xffffffffu, v[i], next - 1);
      if (next) v[i] += t;
    }
    peers &= __ballot_sync(0xffffffffu, (rank & 1) == 0);
    rank >>= 1;
  }
  return lane == first;
}

// ---- the large path ---------------------------------------------------------

constexpr int kPrepThreads = 512;
// launch A's blocks an SM at most, so its partial maxima
// (ops/histogram.py:PREP_BLOCKS_PER_SM sizes the scratch for them)
constexpr int kPrepBlocksPerSm = 4;
// the global branch's cluster: its blocks share only the last conversion
constexpr int kGlobalShift = 3;

// the bits of |w|: non-negative floats order like their bit patterns
__device__ __forceinline__ unsigned long long mag_bits(float x) {
  return __float_as_uint(fabsf(x));
}
__device__ __forceinline__ unsigned long long mag_bits(double x) {
  return (unsigned long long)__double_as_longlong(fabs(x));
}

// A 16-byte load; kLast: the last read of these bytes, streamed (first out
// of L2, so that what launch A left there stays longer)
template <bool kLast, typename T>
__device__ __forceinline__ T load16(const T* p) {
  if constexpr (kLast) {
    return __ldcs(p);
  } else {
    return __ldg(p);
  }
}

// the four weights of quad q by 16-byte loads (one float4, two double2)
template <bool kLast>
__device__ __forceinline__ void load_quad(const float* __restrict__ w,
                                          long long q, float (&v)[4]) {
  const float4 a = load16<kLast>(reinterpret_cast<const float4*>(w) + q);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}
template <bool kLast>
__device__ __forceinline__ void load_quad(const double* __restrict__ w,
                                          long long q, double (&v)[4]) {
  const double2* p = reinterpret_cast<const double2*>(w) + 2 * q;
  const double2 a = load16<kLast>(p), b = load16<kLast>(p + 1);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long m) {
  for (int o = 16; o > 0; o >>= 1) {
    m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  }
  return m;
}

// The largest of every thread's m, in every thread of the block (s_max: a
// word a warp)
template <int kThreads>
__device__ __forceinline__ unsigned long long block_max(
    unsigned long long m, unsigned long long* s_max) {
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) s_max[threadIdx.x >> 5] = m;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  return warp_max(lane < kThreads / 32 ? s_max[lane] : 0ull);
}

// quads a thread loads at a time while it takes the largest |w|
constexpr int kMaxQuads = 2;

// The largest bits of |w| of thread t's share of the entries, T threads in
// all: quads t, t + T, ... (kMaxQuads at a time) where vec (the weights and
// ids 16-byte aligned), then the entries past the last quad from 4 n4 + t,
// stepping T
template <typename W>
__device__ __forceinline__ unsigned long long share_max(
    const W* __restrict__ w, long long n_entries, int vec, long long t,
    long long T) {
  const long long n4 = vec ? n_entries / 4 : 0;  // entries [0, 4 n4) as quads
  unsigned long long m = 0;
  for (long long q = t; q < n4; q += kMaxQuads * T) {
    W v[kMaxQuads][4];
#pragma unroll
    for (int i = 0; i < kMaxQuads; ++i) {
      for (int j = 0; j < 4; ++j) v[i][j] = W(0);
      if (q + i * T < n4) load_quad<false>(w, q + i * T, v[i]);
    }
#pragma unroll
    for (int i = 0; i < kMaxQuads; ++i) {
      for (int j = 0; j < 4; ++j) m = max(m, mag_bits(v[i][j]));
    }
  }
  for (long long e = 4 * n4 + t; e < n_entries; e += T) {
    m = max(m, mag_bits(w[e]));
  }
  return m;
}

// Launch A: the largest bits of |w| of this block's share of the entries
// (grid-stride) into partial[blockIdx.x], the bins (n_words) and the ticket
// cleared on the way.
template <typename W>
__global__ void __launch_bounds__(kPrepThreads)
prepare_kernel(const W* __restrict__ w, long long n_entries, int vec,
               unsigned long long* __restrict__ bins, long long n_words,
               unsigned long long* __restrict__ partial,
               unsigned int* __restrict__ ticket) {
  __shared__ unsigned long long s_max[kPrepThreads / 32];
  // launch B may start on the SMs this grid leaves; it waits for this
  // grid's writes before it reads them
  asm volatile("griddepcontrol.launch_dependents;");
  const long long t = (long long)blockIdx.x * kPrepThreads + threadIdx.x;
  const long long T = (long long)gridDim.x * kPrepThreads;
  for (long long i = t; i < n_words; i += T) bins[i] = 0ull;
  if (t == 0) *ticket = 0u;
  const unsigned long long m =
      block_max<kPrepThreads>(share_max(w, n_entries, vec, t, T), s_max);
  if (threadIdx.x == 0) partial[blockIdx.x] = m;
}

// red.global: v added to the 64-bit word *p (fire and forget; atomicAdd may
// compile to an atomic that returns the old value)
__device__ __forceinline__ void red_add_global(unsigned long long* p,
                                               unsigned long long v) {
  asm volatile("red.relaxed.gpu.global.add.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// red.shared::cluster: v added to the 64-bit word at `addr` (a shared::cta
// address of this block) in block `rank` of the cluster
__device__ __forceinline__ void red_add_cluster(unsigned int addr, int rank,
                                                unsigned long long v) {
  unsigned int remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("red.relaxed.cluster.shared::cluster.add.u64 [%0], %1;"
               :: "r"(remote), "l"(v) : "memory");
}

// Where launch B's aggregated values go: the cluster's slices (kShared) or
// the global bins (word 0: the bins, word 1: the float64 form's low words)
struct Sink {
  unsigned long long* bins;
  unsigned long long* slice;  // this block's slice: S words, then S more
  unsigned int slice_addr;    // its shared::cta address
  long long slice_words;      // S
  int n_bins, cshift;
};

// v added to the 64-bit word *p of this block's shared memory by native
// 32-bit atomics (a 64-bit one compiles to a loop of compare-and-swap): the
// low halves' carries go to the high half, so the word holds the 64-bit sum
// (mod 2^64) once every addition is in
__device__ __forceinline__ void shared_add(unsigned long long* p,
                                           unsigned long long v) {
  unsigned int* half = reinterpret_cast<unsigned int*>(p);
  const unsigned int lo = (unsigned int)v;
  unsigned int carry = 0u;
  if (lo != 0u) {
    const unsigned int old = atomicAdd(half, lo);
    carry = old + lo < old ? 1u : 0u;
  }
  const unsigned int hi = (unsigned int)(v >> 32) + carry;
  if (hi != 0u) atomicAdd(half + 1, hi);
}

// Every addition to one word is of one size: 32-bit halves where the block
// is its own cluster (C = 1), else 64-bit words through the cluster's
// shared memory, the owner's own additions too (atomics of two sizes on one
// word are not ordered against each other)
template <bool kShared>
__device__ __forceinline__ void sink_add(const Sink& k, int id, int word,
                                         unsigned long long v) {
  if constexpr (kShared) {
    const long long at = word * k.slice_words + bin_local(id, k.cshift);
    if (k.cshift == 0) {
      shared_add(k.slice + at, v);
    } else {
      red_add_cluster(k.slice_addr + 8u * (unsigned int)at,
                      bin_owner(id, k.cshift), v);
    }
  } else {
    red_add_global(k.bins + (long long)word * k.n_bins + id, v);
  }
}

// One entry a thread, the whole warp together (id -1 or weight 0: nothing)
template <bool kShared>
__device__ __forceinline__ void deposit(const Sink& k, int id, float we,
                                        double scale, double) {
  const bool valid = we != 0.0f && (unsigned int)id < (unsigned int)k.n_bins;
  unsigned long long v[1] = {valid ? to_fixed(we, scale) : 0ull};
  if (warp_sum(valid ? id : -1, v) && valid) sink_add<kShared>(k, id, 0, v[0]);
}
template <bool kShared>
__device__ __forceinline__ void deposit(const Sink& k, int id, double we,
                                        double scale, double scale_lo) {
  const bool valid = we != 0.0 && (unsigned int)id < (unsigned int)k.n_bins;
  unsigned long long v[2] = {0ull, 0ull};
  if (valid) to_fixed_f64(we, scale, scale_lo, v[0], v[1]);
  if (warp_sum(valid ? id : -1, v) && valid) {
    sink_add<kShared>(k, id, 0, v[0]);
    if (v[1] != 0ull) sink_add<kShared>(k, id, 1, v[1]);
  }
}

// A warp's queue of the entries that carry weight, kQueue slots in shared
// memory used as a ring: each step of the loops appends the warp's entries
// with weight (a ballot places them), and whenever 32 are queued they are
// deposited together. warp_sum then runs once for 32 entries with weight,
// not once for 32 entries of which most (the neighbour slots that carry
// nothing) have none.
constexpr int kQueue = 64;

template <typename W>
struct Queue {
  int* id;
  W* w;
  int head, queued;  // the same in every thread of the warp
};

template <bool kShared, typename W>
__device__ __forceinline__ void push(const Sink& k, Queue<W>& q, int id,
                                     W we, double scale, double scale_lo) {
  const int lane = threadIdx.x & 31;
  const bool valid = we != W(0) && (unsigned int)id < (unsigned int)k.n_bins;
  const unsigned int mask = __ballot_sync(0xffffffffu, valid);
  if (valid) {
    const int at = (q.head + q.queued + __popc(mask & ((1u << lane) - 1u))) &
                   (kQueue - 1);
    q.id[at] = id;
    q.w[at] = we;
  }
  q.queued += __popc(mask);
  if (q.queued >= 32) {
    __syncwarp();
    const int at = (q.head + lane) & (kQueue - 1);
    const int qi = q.id[at];
    const W qw = q.w[at];
    __syncwarp();  // read before the next pushes may fill these slots again
    q.head = (q.head + 32) & (kQueue - 1);
    q.queued -= 32;
    deposit<kShared>(k, qi, qw, scale, scale_lo);
  }
}

// the queue's last entries, fewer than 32
template <bool kShared, typename W>
__device__ __forceinline__ void drain(const Sink& k, Queue<W>& q,
                                      double scale, double scale_lo) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  const int at = (q.head + lane) & (kQueue - 1);
  const bool in = lane < q.queued;
  deposit<kShared>(k, in ? q.id[at] : -1, in ? q.w[at] : W(0), scale,
                   scale_lo);
}

// One step of a warp over the entries: 64 quads, two a lane (quads base +
// lane and base + 32 + lane, counted from the last quad: launch A read the
// weights from first to last, so the last of them are still in L2 when
// launch B starts; these loads are the bytes' last use, streamed), then,
// in a step of the entries past the last quad, one entry a lane
template <typename W>
struct Step {
  int id[9];
  W w[9];
};

template <typename W>
__device__ __forceinline__ Step<W> load_quads(const int* __restrict__ ids,
                                              const W* __restrict__ w,
                                              long long n4, long long base) {
  const int lane = threadIdx.x & 31;
  Step<W> st;
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    st.id[j] = -1;
    st.w[j] = W(0);
  }
  const int4* ids4 = reinterpret_cast<const int4*>(ids);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long q = base + lane + 32 * h;
    if (q < n4) {
      W v[4];
      load_quad<true>(w, n4 - 1 - q, v);
      const int4 i4 = load16<true>(ids4 + n4 - 1 - q);
      const int iv[4] = {i4.x, i4.y, i4.z, i4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        st.id[4 * h + j] = iv[j];
        st.w[4 * h + j] = v[j];
      }
    }
  }
  return st;
}

template <typename W>
__device__ __forceinline__ void load_tail(const int* __restrict__ ids,
                                          const W* __restrict__ w,
                                          long long n_entries, long long base,
                                          Step<W>& st) {
  const long long e = base + (threadIdx.x & 31);
  if (e < n_entries) {
    st.id[8] = __ldg(ids + e);
    st.w[8] = __ldg(w + e);
  }
}

// entries [kFrom, kTo) of a step pushed, the whole warp together
template <bool kShared, int kFrom, int kTo, typename W>
__device__ __forceinline__ void push_step(const Sink& k, Queue<W>& queue,
                                          const Step<W>& st, double scale,
                                          double scale_lo) {
#pragma unroll
  for (int j = kFrom; j < kTo; ++j) {
    push<kShared>(k, queue, st.id[j], st.w[j], scale, scale_lo);
  }
}

// The entries into k by the warps of a grid, warp `warp` of n_warps, step
// by step: warp-uniform trip counts, since push takes the whole warp.
template <bool kShared, typename W>
__device__ __forceinline__ void accumulate(
    const Sink& k, Queue<W>& queue, const int* __restrict__ ids,
    const W* __restrict__ w, long long n_entries, int vec, long long warp,
    long long n_warps, double scale, double scale_lo) {
  const long long n4 = vec ? n_entries / 4 : 0;
  for (long long base = warp * 64; base < n4; base += n_warps * 64) {
    push_step<kShared, 0, 8>(k, queue, load_quads(ids, w, n4, base), scale,
                             scale_lo);
  }
  for (long long base = 4 * n4 + warp * 32; base < n_entries;
       base += n_warps * 32) {
    Step<W> st;
    st.id[8] = -1;
    st.w[8] = W(0);
    load_tail(ids, w, n_entries, base, st);
    push_step<kShared, 8, 9>(k, queue, st, scale, scale_lo);
  }
  drain<kShared>(k, queue, scale, scale_lo);
}

// The scales of a call whose largest |w| has these bits (not 0): the float32
// form's and its inverse, or the float64 form's two
template <typename W>
__device__ __forceinline__ void call_scales(unsigned long long bits,
                                            long long n_entries,
                                            double& scale, double& scale_lo,
                                            double& inv) {
  if constexpr (sizeof(W) == 8) {
    scale = scalbn(1.0, scale_exponent_f64(bits, n_entries));
    scale_lo = scalbn(1.0, low_exponent_f64(n_entries));
  } else {
    scale = fixed_scale((unsigned int)bits, n_entries);
    inv = scalbn(1.0, -scale_exponent((unsigned int)bits, n_entries));
  }
}

// Launch B. Every thread of a cluster reaches its barriers: the loops over
// the entries keep whole warps in step and nothing returns early except on a
// condition the whole grid shares (every weight 0).
template <typename W, bool kShared>
__global__ void __launch_bounds__(kClusterThreads, 1)
cluster_histogram_kernel(const int* __restrict__ ids, const W* __restrict__ w,
                         long long n_entries, int n_bins, int vec,
                         const unsigned long long* __restrict__ partial,
                         int n_partials, unsigned long long* __restrict__ bins,
                         unsigned int* __restrict__ ticket,
                         W* __restrict__ out, int cshift) {
  extern __shared__ unsigned long long s_slice[];
  __shared__ unsigned long long s_max[kClusterThreads / 32];
  __shared__ int s_queue_id[kClusterThreads / 32][kQueue];
  __shared__ W s_queue_w[kClusterThreads / 32][kQueue];
  __shared__ int s_last;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  constexpr bool kF64 = sizeof(W) == 8;

  // Launched as launch A's programmatic dependent: what does not read A's
  // output (this block's slice cleared) runs while A's last blocks finish
  const long long slice = slice_bins(n_bins, cshift);
  if constexpr (kShared) {
    for (long long i = threadIdx.x; i < (kF64 ? 2 : 1) * slice;
         i += kClusterThreads) {
      s_slice[i] = 0ull;
    }
    cluster.sync();  // every slice cleared before any block adds to another's
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");  // A's writes are in

  // the call's largest |w|, the same in every block
  unsigned long long m = 0;
  for (int i = threadIdx.x; i < n_partials; i += kClusterThreads) {
    m = max(m, __ldcg(partial + i));
  }
  const unsigned long long bits = block_max<kClusterThreads>(m, s_max);
  if (bits == 0) {  // every weight 0, or no entry: out = 0 (every block
                    // returns here, none waits at a barrier)
    for (long long i = (long long)blockIdx.x * kClusterThreads + threadIdx.x;
         i < n_bins; i += (long long)gridDim.x * kClusterThreads) {
      out[i] = W(0);
    }
    return;
  }
  double scale, scale_lo = 0.0, inv = 0.0;
  call_scales<W>(bits, n_entries, scale, scale_lo, inv);

  const Sink k{bins, s_slice,
               (unsigned int)__cvta_generic_to_shared(s_slice), slice,
               n_bins, cshift};
  Queue<W> queue{s_queue_id[threadIdx.x >> 5], s_queue_w[threadIdx.x >> 5],
                 0, 0};
  accumulate<kShared>(
      k, queue, ids, w, n_entries, vec,
      ((long long)blockIdx.x * kClusterThreads + threadIdx.x) >> 5,
      (long long)gridDim.x * (kClusterThreads / 32), scale, scale_lo);

  if constexpr (kShared) {
    cluster.sync();  // every block's additions to this slice are in
    // the flush: this slice's nonzero bins into the global bins
    for (long long i = threadIdx.x; i < slice; i += kClusterThreads) {
      const long long b = bin_of(i, rank, cshift);
      if (b >= n_bins) break;
      const unsigned long long v = s_slice[i];
      if (v != 0ull) red_add_global(bins + b, v);
      if constexpr (kF64) {
        const unsigned long long lo = s_slice[slice + i];
        if (lo != 0ull) red_add_global(bins + n_bins + b, lo);
      }
    }
  }
  // the cluster's ticket, taken after its blocks' global additions; the
  // cluster that takes the last one converts the bins
  __threadfence();
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    const unsigned int n_clusters = gridDim.x >> cshift;
    const int last = atomicAdd(ticket, 1u) == n_clusters - 1u;
    if (last) *ticket = 0u;
    for (int r = 0; r < (1 << cshift); ++r) {
      *cluster.map_shared_rank(&s_last, r) = last;
    }
  }
  cluster.sync();  // no block reads another's shared memory after this
  if (!s_last) return;
  __threadfence();
  for (long long i = (long long)rank * kClusterThreads + threadIdx.x;
       i < n_bins; i += (long long)kClusterThreads << cshift) {
    if constexpr (kF64) {
      out[i] = from_fixed_f64(__ldcg(bins + i), __ldcg(bins + n_bins + i),
                              bits, n_entries);
    } else {  // finalize_kernel's conversion
      out[i] = (float)((double)(long long)__ldcg(bins + i) * inv);
    }
  }
}

// branch: 1 the cluster branch (at cluster_shift's C), 2 the global branch
// (the caller's rule, ops/histogram.py:branch_for)
template <typename W>
int histogram_large(const int* ids, const W* w, long long n_entries,
                    int n_bins, W* out, unsigned long long* scratch,
                    long long scratch_words, int sms, int branch,
                    cudaStream_t s) {
  constexpr int kWords = sizeof(W) == 8 ? 2 : 1;
  if (n_bins <= 0) return static_cast<int>(cudaGetLastError());
  const long long bin_words = (long long)kWords * n_bins;
  const int max_partials = kPrepBlocksPerSm * sms;
  const bool shared = branch == 1;
  const int cshift = shared ? cluster_shift(n_bins, kWords) : kGlobalShift;
  if (scratch_words < bin_words + 1 + max_partials || branch < 1 ||
      branch > 2 || cshift < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  unsigned long long* bins = scratch;
  unsigned int* ticket = reinterpret_cast<unsigned int*>(scratch + bin_words);
  unsigned long long* partial = scratch + bin_words + 1;
  const int vec = ((reinterpret_cast<size_t>(ids) |
                    reinterpret_cast<size_t>(w)) & 15) == 0;

  // launch A: enough blocks for the entries' quads and the bins' words, one
  // wave (at most kPrepBlocksPerSm an SM)
  const long long work = (n_entries / 4 > bin_words ? n_entries / 4
                                                    : bin_words);
  const long long per_block_a = (long long)kMaxQuads * kPrepThreads;
  const long long want_a = (work + per_block_a - 1) / per_block_a;
  const int grid_a = (int)(want_a < 1 ? 1 : (want_a < max_partials
                                                 ? want_a : max_partials));
  prepare_kernel<W><<<grid_a, kPrepThreads, 0, s>>>(
      w, n_entries, vec, bins, bin_words, partial, ticket);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // launch B
  const size_t smem =
      shared ? (size_t)(slice_bins(n_bins, cshift) * kWords * 8) : 0;
  const void* fn = reinterpret_cast<const void*>(
      shared ? cluster_histogram_kernel<W, true>
             : cluster_histogram_kernel<W, false>);
  // the slice and the static queues may pass 48 KB together
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cshift > 3) {
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << cshift;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1u << cshift);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, fn, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (active < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // as many clusters as the card holds at once (a persistent grid), fewer
  // where the entries are few: a step (two quads) a thread at least
  const long long per_block = (long long)kClusterThreads * 8;
  const long long want_b = ((n_entries + per_block - 1) / per_block +
                            (1 << cshift) - 1) >> cshift;
  const int clusters =
      (int)(want_b < 1 ? 1 : (want_b < active ? want_b : active));
  cfg.gridDim = dim3((unsigned int)clusters << cshift);
  if (shared) {
    err = cudaLaunchKernelEx(&cfg, cluster_histogram_kernel<W, true>, ids, w,
                             n_entries, n_bins, vec, partial, grid_a, bins,
                             ticket, out, cshift);
  } else {
    err = cudaLaunchKernelEx(&cfg, cluster_histogram_kernel<W, false>, ids,
                             w, n_entries, n_bins, vec, partial, grid_a, bins,
                             ticket, out, cshift);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ---- the small path: one thread-block cluster, one launch -----------------

// the threads of a block of the small path: fewer took less time at every
// small shape down to 256 (1,024, 512, 256: 0.00807, 0.00679, 0.00628 ms at
// 6,144 entries on 2,993 bins in one call; 128 no faster; H100, PERF.md)
constexpr int kSmallThreads = 256;

// The whole histogram in one launch of one cluster of C = 2^cshift blocks.
// Every block clears its slice of the bins, takes the largest |w| bits of
// its share of the entries (those its warps deposit; past one step of them,
// the quads and entries r T + t, stepping C T) into s_block_max; after a
// cluster barrier every block reads
// the C values from the cluster's shared memory, so each holds the call's
// bits and scale. Then the warps of the cluster deposit the entries into
// the owners' slices (launch B's accumulate, on the cluster branch), and
// after a second barrier each block converts its own slice into out.
// Every thread reaches both barriers: nothing returns early.
template <typename W>
__global__ void __launch_bounds__(kSmallThreads, 1)
small_cluster_histogram_kernel(const int* __restrict__ ids,
                               const W* __restrict__ w, int n_entries,
                               int n_bins, int vec, W* __restrict__ out,
                               int cshift) {
  extern __shared__ unsigned long long s_slice[];
  __shared__ unsigned long long s_max[kSmallThreads / 32];
  __shared__ unsigned long long s_block_max, s_bits;
  __shared__ int s_queue_id[kSmallThreads / 32][kQueue];
  __shared__ W s_queue_w[kSmallThreads / 32][kQueue];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  constexpr bool kF64 = sizeof(W) == 8;

  const long long slice = slice_bins(n_bins, cshift);
  for (long long i = threadIdx.x; i < (kF64 ? 2 : 1) * slice;
       i += kSmallThreads) {
    s_slice[i] = 0ull;
  }
  const long long t = (long long)rank * kSmallThreads + threadIdx.x;
  const long long T = (long long)kSmallThreads << cshift;
  const long long warp = t >> 5, n_warps = T >> 5;
  // where every warp takes one step of quads at most and one of the
  // entries past them (up to 8 x 256 x 16 = 32,768 aligned entries), each
  // thread keeps its entries in registers from the maximum to the deposit;
  // else they are read twice
  const long long n4 = vec ? n_entries / 4 : 0;
  const bool held = n4 <= 64 * n_warps && n_entries - 4 * n4 <= 32 * n_warps;
  Step<W> st;
  unsigned long long m = 0;
  if (held) {
    st = load_quads(ids, w, n4, warp * 64);
    load_tail(ids, w, n_entries, 4 * n4 + warp * 32, st);
#pragma unroll
    for (int j = 0; j < 9; ++j) m = max(m, mag_bits(st.w[j]));
  } else {
    m = share_max(w, n_entries, vec, t, T);
  }
  m = block_max<kSmallThreads>(m, s_max);
  if (threadIdx.x == 0) s_block_max = m;
  cluster.sync();  // every slice cleared, every block's maximum written
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const unsigned long long c =
        lane < (1 << cshift) ? *cluster.map_shared_rank(&s_block_max, lane)
                             : 0ull;
    const unsigned long long bits = warp_max(c);
    if (lane == 0) s_bits = bits;
  }
  __syncthreads();
  const unsigned long long bits = s_bits;  // the same in every block

  double scale = 0.0, scale_lo = 0.0, inv = 0.0;
  if (bits != 0) {  // else every weight 0, or no entry: out = 0
    call_scales<W>(bits, n_entries, scale, scale_lo, inv);
    const Sink k{nullptr, s_slice,
                 (unsigned int)__cvta_generic_to_shared(s_slice), slice,
                 n_bins, cshift};
    Queue<W> queue{s_queue_id[threadIdx.x >> 5],
                   s_queue_w[threadIdx.x >> 5], 0, 0};
    if (held) {  // accumulate's order: the quads, then the rest
      push_step<true, 0, 8>(k, queue, st, scale, scale_lo);
      if (4 * n4 + warp * 32 < n_entries) {
        push_step<true, 8, 9>(k, queue, st, scale, scale_lo);
      }
      drain<true>(k, queue, scale, scale_lo);
    } else {
      accumulate<true>(k, queue, ids, w, n_entries, vec, warp, n_warps,
                       scale, scale_lo);
    }
  }
  cluster.sync();  // every addition to this slice is in, and no block reads
                   // another's shared memory after this
  for (long long i = threadIdx.x; i < slice; i += kSmallThreads) {
    const long long b = bin_of(i, rank, cshift);
    if (b >= n_bins) break;
    if (bits == 0) {
      out[b] = W(0);
    } else if constexpr (kF64) {
      out[b] = from_fixed_f64(s_slice[i], s_slice[slice + i], bits,
                              n_entries);
    } else {  // finalize_kernel's conversion
      out[b] = (float)((double)(long long)s_slice[i] * inv);
    }
  }
}

template <typename W>
int histogram_small(const int* ids, const W* w, int n_entries, int n_bins,
                    W* out, cudaStream_t s) {
  constexpr int kWords = sizeof(W) == 8 ? 2 : 1;
  if (n_bins <= 0) return static_cast<int>(cudaGetLastError());
  const int cshift = small_cluster_shift(n_bins, kWords);
  if (n_entries < 0 || cshift < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = (size_t)(slice_bins(n_bins, cshift) * kWords * 8);
  const int vec = ((reinterpret_cast<size_t>(ids) |
                    reinterpret_cast<size_t>(w)) & 15) == 0;
  const void* fn =
      reinterpret_cast<const void*>(small_cluster_histogram_kernel<W>);
  // the slice and the static queues (4 to 7 KB) may pass 48 KB together
  cudaError_t err = cudaSuccess;
  if (smem > 40 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (cshift > 3) {
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << cshift;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1u << cshift);
  cfg.blockDim = dim3(kSmallThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, small_cluster_histogram_kernel<W>, ids, w,
                           n_entries, n_bins, vec, out, cshift);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kGradThreads = 256;

__global__ void __launch_bounds__(kGradThreads)
gather_grad_kernel(const float* __restrict__ grad_out,
                   const int* __restrict__ ids, long long n_entries,
                   int n_bins, float* __restrict__ grad_w) {
  const long long stride = (long long)gridDim.x * kGradThreads;
  for (long long e = (long long)blockIdx.x * kGradThreads + threadIdx.x;
       e < n_entries; e += stride) {
    const int id = ids[e];
    // an id outside the bins added nothing in the forward
    grad_w[e] = (unsigned int)id < (unsigned int)n_bins ? __ldg(grad_out + id)
                                                        : 0.0f;
  }
}

// ---- float64 weights ------------------------------------------------------

__global__ void __launch_bounds__(kGradThreads)
gather_grad_f64_kernel(const double* __restrict__ grad_out,
                       const int* __restrict__ ids, long long n_entries,
                       int n_bins, double* __restrict__ grad_w) {
  const long long stride = (long long)gridDim.x * kGradThreads;
  for (long long e = (long long)blockIdx.x * kGradThreads + threadIdx.x;
       e < n_entries; e += stride) {
    const int id = ids[e];
    grad_w[e] = (unsigned int)id < (unsigned int)n_bins ? __ldg(grad_out + id)
                                                        : 0.0;
  }
}

}  // namespace

// ids: (n_entries,) int32 in [0, n_bins); w: (n_entries,) float32;
// out: (n_bins,) float32; scratch: scratch_words 64-bit words, at least
// n_bins + 1 + 4 sms (the bins, the ticket, launch A's partial maxima),
// which the call clears itself; sms: the device's SM count (the caller
// keeps it); branch: histogram_large's. Launches on `stream`,
// allocates nothing, does not synchronise; returns the first CUDA error,
// else cudaGetLastError().
extern "C" int vr_flux_histogram(const int* ids, const float* w,
                                 long long n_entries, int n_bins, float* out,
                                 unsigned long long* scratch,
                                 long long scratch_words, int sms, int branch,
                                 void* stream) {
  return histogram_large(ids, w, n_entries, n_bins, out, scratch,
                         scratch_words, sms, branch,
                         static_cast<cudaStream_t>(stream));
}

// The same histogram in one launch of one thread-block cluster, for
// n_entries < 2^31 and n_bins whose slices fit at small_cluster_shift's C
// (the caller's choice of path; else cudaErrorInvalidValue); no scratch.
// Launches on `stream`, allocates nothing, does not synchronise; returns
// the first CUDA error, else cudaGetLastError().
extern "C" int vr_flux_histogram_small(const int* ids, const float* w,
                                       int n_entries, int n_bins, float* out,
                                       void* stream) {
  return histogram_small(ids, w, n_entries, n_bins, out,
                         static_cast<cudaStream_t>(stream));
}

// The histogram's backward: grad_w[e] = grad_out[ids[e]] (0 for an id outside
// [0, n_bins)). grad_out: (n_bins,) float32; ids: (n_entries,) int32; grad_w:
// (n_entries,) float32; sms: the device's SM count. Launches on `stream`,
// allocates nothing, does not synchronise; returns cudaGetLastError().
extern "C" int vr_flux_histogram_grad(const float* grad_out, const int* ids,
                                      long long n_entries, int n_bins,
                                      float* grad_w, int sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_entries <= 0) return static_cast<int>(cudaGetLastError());
  const long long want = (n_entries + kGradThreads - 1) / kGradThreads;
  const long long cap = (long long)sms * 16;
  gather_grad_kernel<<<(int)(want < cap ? want : cap), kGradThreads, 0, s>>>(
      grad_out, ids, n_entries, n_bins, grad_w);
  return static_cast<int>(cudaGetLastError());
}

// The float64 forms: w, out, grad_out and grad_w doubles; the large path's
// scratch holds at least 2 n_bins + 1 + 4 sms 64-bit words (the bins' high
// words, their low words, the ticket, the partial maxima), which the call
// clears itself; the small path two words a bin in its slices. Launch,
// allocation and errors as above.
extern "C" int vr_flux_histogram_f64(const int* ids, const double* w,
                                     long long n_entries, int n_bins,
                                     double* out, unsigned long long* scratch,
                                     long long scratch_words, int sms,
                                     int branch, void* stream) {
  return histogram_large(ids, w, n_entries, n_bins, out, scratch,
                         scratch_words, sms, branch,
                         static_cast<cudaStream_t>(stream));
}

extern "C" int vr_flux_histogram_small_f64(const int* ids, const double* w,
                                           int n_entries, int n_bins,
                                           double* out, void* stream) {
  return histogram_small(ids, w, n_entries, n_bins, out,
                         static_cast<cudaStream_t>(stream));
}

extern "C" int vr_flux_histogram_grad_f64(const double* grad_out,
                                          const int* ids, long long n_entries,
                                          int n_bins, double* grad_w, int sms,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_entries <= 0) return static_cast<int>(cudaGetLastError());
  const long long want = (n_entries + kGradThreads - 1) / kGradThreads;
  const long long cap = (long long)sms * 16;
  gather_grad_f64_kernel<<<(int)(want < cap ? want : cap), kGradThreads, 0,
                           s>>>(grad_out, ids, n_entries, n_bins, grad_w);
  return static_cast<int>(cudaGetLastError());
}
