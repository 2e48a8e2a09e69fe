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

}  // namespace

// ids: (n_entries,) int32 in [0, n_bins); w: (n_entries,) float32;
// out: (n_bins,) float32; scratch: n_bins + 1 64-bit words, which this call
// clears itself. Launches on `stream`, allocates nothing, does not
// synchronise; returns the first CUDA error, else cudaGetLastError().
extern "C" int vr_flux_histogram(const int* ids, const float* w,
                                 long long n_entries, int n_bins, float* out,
                                 unsigned long long* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_bins <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err =
      cudaMemsetAsync(scratch, 0, sizeof(unsigned long long) * (n_bins + 1), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned int* wmax_bits = reinterpret_cast<unsigned int*>(scratch + n_bins);

  if (n_entries > 0) {
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);

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
