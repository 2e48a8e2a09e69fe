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

// ---- float64 weights: two fixed-point words an entry ----------------------
//
// One word resolves 2^-37 of the weights' range, short of float64's 2^-53.
// So a float64 weight w becomes two words, each summed in a 64-bit integer
// bin of its own: with wmax < 2^e the largest |w| and E < 2^b the entries,
// k = min(62 - e - b, kMaxScaleExpF64) and L = 63 - b,
//   x = w 2^k (exact), hi = rint(x), lo = rint((x - hi) 2^L)
// (round half to even; x - hi is exact, |x - hi| <= 1/2). |hi| E and |lo| E
// stay below 2^62: no bin overflows even if every entry lands in it. A bin
// reads back as double(hi_sum) 2^-k + double(lo_sum) 2^-(k + L), two
// conversions rounded to nearest and one rounded sum (the products by
// powers of two are exact). It resolves 2^-(k + L) = wmax 2^-(124 - 2b)
// at most: about 2^-76 of the largest weight at 2^24 entries. Integer sums
// are associative, so the bins are the same bits in any order of the
// atomics, and ops/histogram.py:_histogram_f64_ref gives them with the same
// operations. Weights must be finite, of largest magnitude below 2^900 (k is
// capped at 960 so that 2^-(k + L) stays a normal float64).
constexpr int kMaxScaleExpF64 = 960;

// k of a call: wmax_bits must not be 0
__device__ __forceinline__ int scale_exponent_f64(unsigned long long wmax_bits,
                                                  long long n_entries) {
  int e;
  frexp(__longlong_as_double((long long)wmax_bits), &e);  // wmax < 2^e
  const int log_e = 64 - __clzll(n_entries);  // n_entries < 2^log_e
  const int k = 62 - e - log_e;
  return k < kMaxScaleExpF64 ? k : kMaxScaleExpF64;
}

// L of a call
__device__ __forceinline__ int low_exponent_f64(long long n_entries) {
  return 63 - (64 - __clzll(n_entries));
}

// The two words of w (two's complement carries the sign)
__device__ __forceinline__ void to_fixed_f64(double w, double scale,
                                             double scale_lo,
                                             unsigned long long& hi,
                                             unsigned long long& lo) {
  const double x = __dmul_rn(w, scale);
  const long long h = __double2ll_rn(x);
  hi = (unsigned long long)h;
  lo = (unsigned long long)__double2ll_rn(
      __dmul_rn(__dsub_rn(x, (double)h), scale_lo));
}

// A bin's two sums read back; wmax_bits must not be 0
__device__ __forceinline__ double from_fixed_f64(unsigned long long hi,
                                                 unsigned long long lo,
                                                 unsigned long long wmax_bits,
                                                 long long n_entries) {
  const int k = scale_exponent_f64(wmax_bits, n_entries);
  const int low = low_exponent_f64(n_entries);
  return __dadd_rn(__dmul_rn(__ll2double_rn((long long)hi), scalbn(1.0, -k)),
                   __dmul_rn(__ll2double_rn((long long)lo),
                             scalbn(1.0, -(k + low))));
}

}  // namespace
