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
// time in a library sort of all E entries; this one reads each entry once.
//
// What bounds it on an H100: bytes, 8 per entry (ids and w read once); the
// bins are a few KB. Entries with weight 0 (most neighbour slots) cost the
// read and nothing else. To keep the atomics off the L2, each block sums
// into its own bins in shared memory (64-bit integers, n * 8 bytes, up to
// 200 KB) and flushes the bins it touched with one global atomic each; past
// that size the entries go to the global bins directly.
//
// Small calls: the four device operations above (clear, largest |w|, sum,
// finalize) cost some 0.027 ms whatever E is, which is all the time of the
// unfused body's narrow bounces (a few thousand entries). Below a threshold
// of entries that the wrapper holds (ops/histogram.py:SMALL_ENTRIES), and
// where the bins fit in shared memory, vr_flux_histogram_small does it all in
// one launch of one block: the largest |w| with the same bits, its own
// shared bins, the same scale, the same integer sums and the same final
// conversion, so both paths give the same bits for the same input.
//
// Float64 weights (the float64 trace; vr_flux_histogram_f64,
// vr_flux_histogram_small_f64): the same two paths with two fixed-point words
// an entry (fixed_point.cuh, "float64 weights"), summed in two 64-bit bins
// each (16 bytes a bin in shared memory: the one-block path takes up to
// 12,800 bins). Bound by bytes: 12 an entry (ids and w read once) and two
// words a bin. The plain version does the same integer sums with index_add_
// on int64 tensors, so kernel, plain version and both paths give the same
// bits. The library call beside it, index_add_ on float64, adds floats with
// atomics in an order that changes from run to run on a card.
//
// The backward (vr_flux_histogram_grad): d out[b] / d w[e] is 1 where
// ids[e] == b, so the gradient of the weights is a gather, grad_w[e] =
// grad_out[ids[e]]. The JAX package has no TPU kernel for it: XLA transposes
// its one-hot contraction (viennaray_tpu/trace/kernel.py:161-163). Bound by
// bytes, 8 per entry (ids read, grad_w written) plus the bins, which stay
// in L2; one thread per entry, a grid-stride loop, exact (no arithmetic).
#include <cuda_runtime.h>

#include "fixed_point.cuh"

namespace {

constexpr int kThreads = 512;
constexpr size_t kMaxSharedBins = 200 * 1024;

__global__ void __launch_bounds__(kThreads)
accumulate_kernel(const int* __restrict__ ids, const float* __restrict__ w,
                  long long n_entries, int n_bins,
                  const unsigned int* __restrict__ wmax_bits,
                  unsigned long long* __restrict__ acc, int use_shared) {
  extern __shared__ unsigned long long s_bins[];
  const unsigned int bits = *wmax_bits;
  if (bits == 0) return;  // every weight is 0; uniform across the grid
  const double scale = fixed_scale(bits, n_entries);

  if (use_shared) {
    for (int i = threadIdx.x; i < n_bins; i += kThreads) s_bins[i] = 0ull;
    __syncthreads();
  }
  unsigned long long* bins = use_shared ? s_bins : acc;

  const long long stride = (long long)gridDim.x * kThreads;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
       e < n_entries; e += stride) {
    const float we = w[e];
    if (we == 0.0f) continue;
    const int id = ids[e];
    if ((unsigned int)id >= (unsigned int)n_bins) continue;
    atomicAdd(&bins[id], to_fixed(we, scale));
  }

  if (use_shared) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_bins; i += kThreads) {
      const unsigned long long v = s_bins[i];
      if (v != 0ull) atomicAdd(&acc[i], v);
    }
  }
}

constexpr int kSmallThreads = 1024;

// One entry per thread of a warp, every thread of the warp calling it
// together (id -1 or weight 0: nothing to add). The threads whose entries
// share a bin sum their fixed-point values first (a tree over the warp's
// shuffles in the order of their lanes, after NVIDIA's reduce_peers) and the
// lowest of them adds the sum with one shared atomic: a bin that many
// entries hit (the tail's rays sit on a few disks) costs one atomic a warp
// instead of one an entry. Integer sums: the same bits in any grouping.
__device__ __forceinline__ void add_warp(unsigned long long* s_bins, int id,
                                         float we, int n_bins,
                                         double scale) {
  const int lane = threadIdx.x & 31;
  const bool valid = we != 0.0f && (unsigned int)id < (unsigned int)n_bins;
  const int key = valid ? id : -1;
  unsigned long long v = valid ? to_fixed(we, scale) : 0ull;
  unsigned int peers = __match_any_sync(0xffffffffu, key);
  const int first = __ffs(peers) - 1;
  int rank = __popc(peers & ((1u << lane) - 1u));
  peers &= 0xfffffffeu << lane;  // the peers on higher lanes
  while (__any_sync(0xffffffffu, peers != 0u)) {
    const int next = __ffs(peers);  // 1 + the next peer's lane, or 0
    const unsigned long long t = __shfl_sync(0xffffffffu, v, next - 1);
    if (next) v += t;
    peers &= __ballot_sync(0xffffffffu, (rank & 1) == 0);
    rank >>= 1;
  }
  if (valid && lane == first) atomicAdd(&s_bins[id], v);
}

// the largest bits of |w| of four entries
__device__ __forceinline__ unsigned int abs_bits(float4 v) {
  return max(max(__float_as_uint(fabsf(v.x)), __float_as_uint(fabsf(v.y))),
             max(__float_as_uint(fabsf(v.z)), __float_as_uint(fabsf(v.w))));
}

// The whole histogram in one block: absmax_kernel's largest |w| (bits of
// |w|, integer maximum), the bins cleared in shared memory, accumulate's
// integer sums at fixed_scale(bits, E), finalize_kernel's conversion. One SM
// reads every entry, so it keeps many loads in flight: 16-byte loads of four
// entries (where both arrays are 16-byte aligned), two per thread at a time.
__global__ void __launch_bounds__(kSmallThreads)
small_histogram_kernel(const int* __restrict__ ids,
                       const float* __restrict__ w, int n_entries, int n_bins,
                       float* __restrict__ out) {
  extern __shared__ unsigned long long s_bins[];
  __shared__ unsigned int s_max;
  if (threadIdx.x == 0) s_max = 0u;
  for (int i = threadIdx.x; i < n_bins; i += kSmallThreads) s_bins[i] = 0ull;
  const bool vec = ((reinterpret_cast<size_t>(ids) |
                     reinterpret_cast<size_t>(w)) & 15) == 0;
  const int n4 = vec ? n_entries / 4 : 0;  // entries [0, 4 n4) as quads
  const float4* w4 = reinterpret_cast<const float4*>(w);
  const int4* ids4 = reinterpret_cast<const int4*>(ids);

  unsigned int m = 0;
  for (int q = threadIdx.x; q < n4; q += 2 * kSmallThreads) {
    const float4 a = w4[q];
    const float4 b = q + kSmallThreads < n4 ? w4[q + kSmallThreads]
                                            : make_float4(0.f, 0.f, 0.f, 0.f);
    m = max(m, max(abs_bits(a), abs_bits(b)));
  }
  for (int e = 4 * n4 + threadIdx.x; e < n_entries; e += kSmallThreads) {
    m = max(m, __float_as_uint(fabsf(w[e])));
  }
  for (int o = 16; o > 0; o >>= 1) {
    m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  }
  __syncthreads();  // s_max and the bins are cleared
  if ((threadIdx.x & 31) == 0 && m != 0) atomicMax(&s_max, m);
  __syncthreads();
  const unsigned int bits = s_max;
  if (bits != 0) {
    // warp-uniform trip counts: add_warp takes the whole warp
    const double scale = fixed_scale(bits, n_entries);
    const int lane = threadIdx.x & 31;
    const int warp0 = (threadIdx.x & ~31) * 2;  // two quads a thread
    for (int base = warp0; base < n4; base += 2 * kSmallThreads) {
      const int q0 = base + lane, q1 = base + 32 + lane;
      const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
      const int4 none4 = make_int4(-1, -1, -1, -1);
      const float4 a = q0 < n4 ? w4[q0] : zero4;
      const int4 ia = q0 < n4 ? ids4[q0] : none4;
      const float4 b = q1 < n4 ? w4[q1] : zero4;
      const int4 ib = q1 < n4 ? ids4[q1] : none4;
      add_warp(s_bins, ia.x, a.x, n_bins, scale);
      add_warp(s_bins, ia.y, a.y, n_bins, scale);
      add_warp(s_bins, ia.z, a.z, n_bins, scale);
      add_warp(s_bins, ia.w, a.w, n_bins, scale);
      add_warp(s_bins, ib.x, b.x, n_bins, scale);
      add_warp(s_bins, ib.y, b.y, n_bins, scale);
      add_warp(s_bins, ib.z, b.z, n_bins, scale);
      add_warp(s_bins, ib.w, b.w, n_bins, scale);
    }
    for (int base = 4 * n4 + (threadIdx.x & ~31); base < n_entries;
         base += kSmallThreads) {
      const int e = base + lane;
      const bool in = e < n_entries;
      add_warp(s_bins, in ? ids[e] : -1, in ? w[e] : 0.0f, n_bins, scale);
    }
  }
  __syncthreads();
  if (bits == 0) {
    for (int i = threadIdx.x; i < n_bins; i += kSmallThreads) out[i] = 0.0f;
    return;
  }
  const double inv = scalbn(1.0, -scale_exponent(bits, n_entries));
  for (int i = threadIdx.x; i < n_bins; i += kSmallThreads) {
    out[i] = (float)((double)(long long)s_bins[i] * inv);
  }
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

__global__ void __launch_bounds__(kThreads)
accumulate_f64_kernel(const int* __restrict__ ids,
                      const double* __restrict__ w, long long n_entries,
                      int n_bins,
                      const unsigned long long* __restrict__ wmax_bits,
                      unsigned long long* __restrict__ acc, int use_shared) {
  extern __shared__ unsigned long long s_bins[];
  const unsigned long long bits = *wmax_bits;
  if (bits == 0) return;  // every weight is 0; uniform across the grid
  const double scale = scalbn(1.0, scale_exponent_f64(bits, n_entries));
  const double scale_lo = scalbn(1.0, low_exponent_f64(n_entries));

  // the bins' high words, then their low words
  if (use_shared) {
    for (int i = threadIdx.x; i < 2 * n_bins; i += kThreads) s_bins[i] = 0ull;
    __syncthreads();
  }
  unsigned long long* bins = use_shared ? s_bins : acc;

  const long long stride = (long long)gridDim.x * kThreads;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
       e < n_entries; e += stride) {
    const double we = w[e];
    if (we == 0.0) continue;
    const int id = ids[e];
    if ((unsigned int)id >= (unsigned int)n_bins) continue;
    unsigned long long hi, lo;
    to_fixed_f64(we, scale, scale_lo, hi, lo);
    atomicAdd(&bins[id], hi);
    if (lo != 0ull) atomicAdd(&bins[n_bins + id], lo);
  }

  if (use_shared) {
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * n_bins; i += kThreads) {
      const unsigned long long v = s_bins[i];
      if (v != 0ull) atomicAdd(&acc[i], v);
    }
  }
}

// out[i] from the bins' two words
__global__ void finalize_f64_kernel(
    const unsigned long long* __restrict__ acc,
    const unsigned long long* __restrict__ wmax_bits, long long n_entries,
    int n_bins, double* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_bins) return;
  const unsigned long long bits = *wmax_bits;
  out[i] = bits == 0 ? 0.0
                     : from_fixed_f64(acc[i], acc[n_bins + i], bits,
                                      n_entries);
}

// The whole float64 histogram in one block: the largest |w| (bits, integer
// maximum), the two words of each entry added with shared atomics, the bins
// read back as finalize_f64_kernel does. One entry per thread at a time,
// whole warps in step: the threads whose entries share a bin sum their
// words first (add_warp's tree, once for each word), so a bin that many
// entries hit costs one atomic a warp and word.
__device__ __forceinline__ void add_warp_f64(unsigned long long* s_hi,
                                             unsigned long long* s_lo, int id,
                                             double we, int n_bins,
                                             double scale, double scale_lo) {
  const int lane = threadIdx.x & 31;
  const bool valid = we != 0.0 && (unsigned int)id < (unsigned int)n_bins;
  const int key = valid ? id : -1;
  unsigned long long vh = 0ull, vl = 0ull;
  if (valid) to_fixed_f64(we, scale, scale_lo, vh, vl);
  unsigned int peers = __match_any_sync(0xffffffffu, key);
  const int first = __ffs(peers) - 1;
  int rank = __popc(peers & ((1u << lane) - 1u));
  peers &= 0xfffffffeu << lane;  // the peers on higher lanes
  while (__any_sync(0xffffffffu, peers != 0u)) {
    const int next = __ffs(peers);  // 1 + the next peer's lane, or 0
    const unsigned long long th = __shfl_sync(0xffffffffu, vh, next - 1);
    const unsigned long long tl = __shfl_sync(0xffffffffu, vl, next - 1);
    if (next) {
      vh += th;
      vl += tl;
    }
    peers &= __ballot_sync(0xffffffffu, (rank & 1) == 0);
    rank >>= 1;
  }
  if (valid && lane == first) {
    atomicAdd(&s_hi[id], vh);
    if (vl != 0ull) atomicAdd(&s_lo[id], vl);
  }
}

__global__ void __launch_bounds__(kSmallThreads)
small_histogram_f64_kernel(const int* __restrict__ ids,
                           const double* __restrict__ w, int n_entries,
                           int n_bins, double* __restrict__ out) {
  extern __shared__ unsigned long long s_bins[];
  __shared__ unsigned long long s_max;
  if (threadIdx.x == 0) s_max = 0ull;
  for (int i = threadIdx.x; i < 2 * n_bins; i += kSmallThreads) {
    s_bins[i] = 0ull;
  }
  unsigned long long m = 0;
  for (int e = threadIdx.x; e < n_entries; e += kSmallThreads) {
    m = max(m, (unsigned long long)__double_as_longlong(fabs(w[e])));
  }
  for (int o = 16; o > 0; o >>= 1) {
    m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  }
  __syncthreads();  // s_max and the bins are cleared
  if ((threadIdx.x & 31) == 0 && m != 0) atomicMax(&s_max, m);
  __syncthreads();
  const unsigned long long bits = s_max;
  if (bits != 0) {
    const double scale = scalbn(1.0, scale_exponent_f64(bits, n_entries));
    const double scale_lo = scalbn(1.0, low_exponent_f64(n_entries));
    const int lane = threadIdx.x & 31;
    // warp-uniform trip counts: add_warp_f64 takes the whole warp
    for (int base = threadIdx.x & ~31; base < n_entries;
         base += kSmallThreads) {
      const int e = base + lane;
      const bool in = e < n_entries;
      add_warp_f64(s_bins, s_bins + n_bins, in ? ids[e] : -1,
                   in ? w[e] : 0.0, n_bins, scale, scale_lo);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_bins; i += kSmallThreads) {
    out[i] = bits == 0 ? 0.0
                       : from_fixed_f64(s_bins[i], s_bins[n_bins + i], bits,
                                        n_entries);
  }
}

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
// out: (n_bins,) float32; scratch: n_bins + 1 64-bit words, which this call
// clears itself; sms: the device's SM count (the caller keeps it). Launches
// on `stream`, allocates nothing, does not synchronise; returns the first
// CUDA error, else cudaGetLastError().
extern "C" int vr_flux_histogram(const int* ids, const float* w,
                                 long long n_entries, int n_bins, float* out,
                                 unsigned long long* scratch, int sms,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_bins <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err =
      cudaMemsetAsync(scratch, 0, sizeof(unsigned long long) * (n_bins + 1), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned int* wmax_bits = reinterpret_cast<unsigned int*>(scratch + n_bins);

  if (n_entries > 0) {
    const long long per_block = (long long)kThreads * 8;
    const long long want = (n_entries + per_block - 1) / per_block;
    const int grid_max = (int)(want < (long long)sms * 8 ? want : sms * 8);
    absmax_kernel<<<grid_max, kThreads, 0, s>>>(w, n_entries, wmax_bits);

    const size_t smem = sizeof(unsigned long long) * (size_t)n_bins;
    const int use_shared = smem <= kMaxSharedBins ? 1 : 0;
    int grid = grid_max;
    if (use_shared) {
      // one flush per block: keep to as many blocks as fit on the card at once
      const long long fit = (long long)(kMaxSharedBins / smem);
      const long long per_sm = fit < 1 ? 1 : (fit > 4 ? 4 : fit);
      const long long cap = per_sm * sms;
      grid = (int)(want < cap ? want : cap);
      if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(accumulate_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return static_cast<int>(err);
      }
    }
    accumulate_kernel<<<grid, kThreads, use_shared ? smem : 0, s>>>(
        ids, w, n_entries, n_bins, wmax_bits, scratch, use_shared);
  }
  finalize_kernel<<<(n_bins + 255) / 256, 256, 0, s>>>(
      scratch, wmax_bits, n_entries, n_bins, out);
  return static_cast<int>(cudaGetLastError());
}

// The same histogram in one launch of one block, for n_entries < 2^31 and
// n_bins * 8 <= 200 KB (the caller's choice of path); no scratch. Launches
// on `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError().
extern "C" int vr_flux_histogram_small(const int* ids, const float* w,
                                       int n_entries, int n_bins, float* out,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_bins <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = sizeof(unsigned long long) * (size_t)n_bins;
  if (smem > kMaxSharedBins) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        small_histogram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  small_histogram_kernel<<<1, kSmallThreads, smem, s>>>(ids, w, n_entries,
                                                        n_bins, out);
  return static_cast<int>(cudaGetLastError());
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
// scratch holds 2 n_bins + 1 64-bit words (the bins' high words, their low
// words, the largest |w|), which this call clears itself; the one-block path
// takes n_bins * 16 <= 200 KB. Launch, allocation and errors as above.
extern "C" int vr_flux_histogram_f64(const int* ids, const double* w,
                                     long long n_entries, int n_bins,
                                     double* out, unsigned long long* scratch,
                                     int sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_bins <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, sizeof(unsigned long long) * (2 * (size_t)n_bins + 1), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned long long* wmax_bits = scratch + 2 * (size_t)n_bins;

  if (n_entries > 0) {
    const long long per_block = (long long)kThreads * 8;
    const long long want = (n_entries + per_block - 1) / per_block;
    const int grid_max = (int)(want < (long long)sms * 8 ? want : sms * 8);
    absmax_f64_kernel<<<grid_max, kThreads, 0, s>>>(w, n_entries, wmax_bits);

    const size_t smem = 2 * sizeof(unsigned long long) * (size_t)n_bins;
    const int use_shared = smem <= kMaxSharedBins ? 1 : 0;
    int grid = grid_max;
    if (use_shared) {
      const long long fit = (long long)(kMaxSharedBins / smem);
      const long long per_sm = fit < 1 ? 1 : (fit > 4 ? 4 : fit);
      const long long cap = per_sm * sms;
      grid = (int)(want < cap ? want : cap);
      if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(accumulate_f64_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return static_cast<int>(err);
      }
    }
    accumulate_f64_kernel<<<grid, kThreads, use_shared ? smem : 0, s>>>(
        ids, w, n_entries, n_bins, wmax_bits, scratch, use_shared);
  }
  finalize_f64_kernel<<<(n_bins + 255) / 256, 256, 0, s>>>(
      scratch, wmax_bits, n_entries, n_bins, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vr_flux_histogram_small_f64(const int* ids, const double* w,
                                           int n_entries, int n_bins,
                                           double* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_bins <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = 2 * sizeof(unsigned long long) * (size_t)n_bins;
  if (smem > kMaxSharedBins) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        small_histogram_f64_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  small_histogram_f64_kernel<<<1, kSmallThreads, smem, s>>>(ids, w, n_entries,
                                                            n_bins, out);
  return static_cast<int>(cudaGetLastError());
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
