// The scalar type of the closest-hit tests: float32, or float64 for the
// kernels' float64 forms (the float64 trace, ops/nearest_hit.py).
//
// The hit tests (disk_hit.cuh, tri_hit.cuh, line_hit.cuh) and the group
// search (prim_search.cuh) are templates on the scalar type T. Their
// arithmetic goes through the overloads below, which are the
// round-to-nearest intrinsics of each type (__fadd_rn ... for float,
// __dadd_rn ... for double): nvcc never contracts them into fused
// multiply-adds, so a test computes bit for bit what the plain PyTorch
// version computes with one eager op per operation, in either type.
//
// Const<T> holds each type's constants. The float64 forms take the JAX
// package's float64 search's (viennaray_tpu/ops/intersect.py:29, 122, 188):
// the float32 values of BIG, the triangle test's 1e-9 and the line clip's
// 1e-5 and 1 - 1e-5, widened; the division guard 1e-30 is a float64 value
// there, as here.
#pragma once

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float vabs(float a) { return fabsf(a); }
__device__ __forceinline__ double vabs(double a) { return fabs(a); }
__device__ __forceinline__ float vmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double vmin(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double vmax(double a, double b) { return fmax(a, b); }

// Four doubles: a staged lane of a float64 SoA (the float32 forms stage
// float4).
struct Double4 {
  double x, y, z, w;
};

template <class T>
struct Const;

template <>
struct Const<float> {
  // no hit
  static __device__ __forceinline__ constexpr float big() { return 3.4e38f; }
  // a zero divisor's stand-in
  static __device__ __forceinline__ constexpr float tiny() { return 1e-30f; }
  // the triangle test's least |det|
  static __device__ __forceinline__ constexpr float tri_eps() { return 1e-9f; }
  // the line clip's ends: 1e-5 and float32(1) - float32(1e-5) = 0x3f7fff58
  static __device__ __forceinline__ constexpr float s_min() { return 1e-5f; }
  static __device__ __forceinline__ constexpr float s_max() {
    return 0xFFFF58p-24f;
  }
  // the chunk box's widening
  static __device__ __forceinline__ constexpr float box_margin() {
    return 1e-4f;
  }
};

template <>
struct Const<double> {
  static __device__ __forceinline__ constexpr double big() {
    return (double)3.4e38f;
  }
  static __device__ __forceinline__ constexpr double tiny() { return 1e-30; }
  static __device__ __forceinline__ constexpr double tri_eps() {
    return (double)1e-9f;
  }
  static __device__ __forceinline__ constexpr double s_min() {
    return (double)1e-5f;
  }
  // the float32 value, widened
  static __device__ __forceinline__ constexpr double s_max() {
    return 0xFFFF58p-24;
  }
  static __device__ __forceinline__ constexpr double box_margin() {
    return 1e-4;
  }
};
