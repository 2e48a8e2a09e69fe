// Fixed-point sums of float32 weights in 64-bit integer bins, shared by the
// kernels that accumulate flux (flux_histogram.cu, bounce.cu).
//
// A float atomicAdd would add in an order that changes from run to run, and
// float addition is not associative, so the flux would differ in the last
// bits between two runs of one seed. Integer addition is associative: each
// weight is scaled by a power of two, rounded to a 64-bit integer and added
// with integer atomics, and the sum is the same bit pattern in whatever order
// the atomics land.
//
// Range and accuracy: the scale 2^k is chosen per call from a bound on |w|
// (found by absmax_kernel with an integer atomicMax, also order-free) and a
// bound E on the number of entries, so that E * max|w| * 2^k < 2^62: no bin
// can overflow even if every entry lands in it. One entry is rounded by at
// most 2^-(k+1), which is below 2 * max|w| * E * 2^-62, so a bin of m entries
// of typical size w' is off by a relative 2^-61 * E * max|w| / w' at most:
// 2^-37 times the dynamic range of the weights at E = 2^24, against float32's
// 2^-24. The float32 rounding of the result is the only error a caller can
// see. No TF32, no tensor-core product. Weights must be finite.
#pragma once

namespace {

// Largest |w| of n values into *wmax_bits, which the caller has cleared:
// non-negative floats order like their bit patterns.
__global__ void absmax_kernel(const float* __restrict__ w, long long n,
                              unsigned int* __restrict__ wmax_bits) {
  unsigned int m = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    m = max(m, __float_as_uint(fabsf(w[e])));
  }
  for (int o = 16; o > 0; o >>= 1) {
    m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  }
  if ((threadIdx.x & 31) == 0 && m != 0) atomicMax(wmax_bits, m);
}

// k with n_entries * wmax * 2^k < 2^62
__device__ __forceinline__ int scale_exponent(unsigned int wmax_bits,
                                              long long n_entries) {
  int e;
  frexpf(__uint_as_float(wmax_bits), &e);       // wmax < 2^e
  const int log_e = 64 - __clzll(n_entries);    // n_entries < 2^log_e
  return 62 - e - log_e;
}

// The scale of a call; wmax_bits must not be 0 (every weight 0: nothing to
// add, and the caller returns zeros).
__device__ __forceinline__ double fixed_scale(unsigned int wmax_bits,
                                              long long n_entries) {
  return scalbn(1.0, scale_exponent(wmax_bits, n_entries));
}

// float * 2^k is exact in double; two's complement carries the sign
__device__ __forceinline__ unsigned long long to_fixed(float w, double scale) {
  return (unsigned long long)__double2ll_rn((double)w * scale);
}

// out[i] = bins[i] / scale, rounded once to float32
__global__ void finalize_kernel(const unsigned long long* __restrict__ acc,
                                const unsigned int* __restrict__ wmax_bits,
                                long long n_entries, int n_bins,
                                float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_bins) return;
  const unsigned int bits = *wmax_bits;
  if (bits == 0) {
    out[i] = 0.0f;
    return;
  }
  const double inv = scalbn(1.0, -scale_exponent(bits, n_entries));
  out[i] = (float)((double)(long long)acc[i] * inv);
}

}  // namespace
