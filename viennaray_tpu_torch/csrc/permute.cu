// The per-bounce coherence resort's key, and the permutation of the per-ray
// state that the resort, the source sort and the compaction share: one
// kernel each, one thread a lane, in float32 and float64.
//
// Replaces no Pallas kernel: the JAX package computes both in XLA
// (viennaray_tpu/trace/kernel.py:397-426 _coherence_key, :431-458
// _permute_state and :460-479 _sorted_state; the source sort's packed
// gather :1284-1297 and the compaction's :1423). There a lane permutation
// is one packed row gather, because nine separate gathers cost more than
// the sort (its note at :431-441). The port's tensor code paid the same
// way: one PyTorch indexing op a state array, eight or nine launches a
// permutation, on paths where the host already holds about half the wall
// time. Here a permutation is one launch, and so is its key.
//
// vr_coherence_key: key[i] = ((cx 16 + cy) 16 + cz) nb_d + dbin for a live
// lane, 1 << 30 for a dead one, with cell c = clamp(trunc((org - lo) / ext
// * 16), 0, 15) on each axis and dbin the direction bin: the sign octant
// below 32 bins; from 32 on the xy octant (x > 0, y > 0, |x| > |y|) plus 8
// times clamp(trunc((z + 1) nb_pol / 2), 0, nb_pol - 1), nb_pol 4 (8 from 64
// bins on). The arithmetic goes through scalar.cuh's round-to-nearest
// intrinsics, one per operation of the plain version
// (ops/permute.py:coherence_key_ref), so nvcc contracts nothing and the
// keys are the plain version's bit for bit; trunc is __float2int_rz /
// __double2int_rz, the cast of the plain version for every finite value
// below 2^31 (a live lane's cell value lies within a few cells of [0, 16)).
//
// vr_permute_state: out[i] = in[take[i]] for every per-ray array (org and
// dir (R, 3), weight and w0, alive and hfb as bytes, n_refl and n_bdry
// int32, and aux (R, A) where A > 0), i < n_out <= R: a compaction keeps
// the first n_out lanes of its order. A copy, so exact.
//
// Bound: bytes. The key reads 6 floats and a byte a lane and writes 4
// bytes; the permutation reads take (8 bytes) and one row of the state
// (42 bytes in float32, 74 in float64, plus A floats) a lane and writes the
// row. Its reads are a gather: each lane's row lies wherever take points,
// so a warp's loads touch 32 sectors an array where a coalesced read
// touches 4 to 12. At 2^20 lanes the state (44 MB in float32) stays in the
// 50 MB L2 between the key, the sort and the gather.
#include <cuda_runtime.h>

#include "scalar.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

__device__ __forceinline__ int trunc_int(float x) { return __float2int_rz(x); }
__device__ __forceinline__ int trunc_int(double x) {
  return __double2int_rz(x);
}
__device__ __forceinline__ int clamp_int(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
coherence_key_kernel(const T* __restrict__ org, const T* __restrict__ dir,
                     const unsigned char* __restrict__ alive,
                     const T* __restrict__ bb_lo, const T* __restrict__ bb_ext,
                     long long n, int dirbins, int* __restrict__ key) {
  const T lo[3] = {bb_lo[0], bb_lo[1], bb_lo[2]};
  const T ext[3] = {bb_ext[0], bb_ext[1], bb_ext[2]};
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    if (!alive[i]) {
      key[i] = 1 << 30;
      continue;
    }
    int cell[3];
    for (int a = 0; a < 3; ++a) {
      const T x = mul_rn(div_rn(sub_rn(org[3 * i + a], lo[a]), ext[a]), T(16));
      cell[a] = clamp_int(trunc_int(x), 0, 15);
    }
    const T dx = dir[3 * i + 0], dy = dir[3 * i + 1], dz = dir[3 * i + 2];
    int dbin, nb_d;
    if (dirbins >= 32) {
      const int nb_pol = dirbins >= 64 ? 8 : 4;
      const T band = mul_rn(add_rn(dz, T(1)), T(nb_pol / 2));
      dbin = (dx > T(0)) + 2 * (dy > T(0)) + 4 * (vabs(dx) > vabs(dy)) +
             8 * clamp_int(trunc_int(band), 0, nb_pol - 1);
      nb_d = 8 * nb_pol;
    } else {
      dbin = (dx > T(0)) + 2 * (dy > T(0)) + 4 * (dz > T(0));
      nb_d = 8;
    }
    key[i] = ((cell[0] * 16 + cell[1]) * 16 + cell[2]) * nb_d + dbin;
  }
}

template <class T>
__global__ void __launch_bounds__(kThreads)
permute_state_kernel(const long long* __restrict__ take, long long n_out,
                     const T* __restrict__ org, const T* __restrict__ dir,
                     const T* __restrict__ weight, const T* __restrict__ w0,
                     const unsigned char* __restrict__ alive,
                     const unsigned char* __restrict__ hfb,
                     const int* __restrict__ n_refl,
                     const int* __restrict__ n_bdry, const T* __restrict__ aux,
                     int n_aux, T* __restrict__ org2, T* __restrict__ dir2,
                     T* __restrict__ weight2, T* __restrict__ w02,
                     unsigned char* __restrict__ alive2,
                     unsigned char* __restrict__ hfb2,
                     int* __restrict__ n_refl2, int* __restrict__ n_bdry2,
                     T* __restrict__ aux2) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < n_out; i += stride) {
    const long long j = take[i];
    for (int a = 0; a < 3; ++a) {
      org2[3 * i + a] = org[3 * j + a];
      dir2[3 * i + a] = dir[3 * j + a];
    }
    weight2[i] = weight[j];
    w02[i] = w0[j];
    alive2[i] = alive[j];
    hfb2[i] = hfb[j];
    n_refl2[i] = n_refl[j];
    n_bdry2[i] = n_bdry[j];
    for (int a = 0; a < n_aux; ++a) {
      aux2[i * n_aux + a] = aux[j * n_aux + a];
    }
  }
}

int blocks_for(long long n) {
  const long long want = (n + kThreads - 1) / kThreads;
  return (int)(want < kMaxBlocks ? want : kMaxBlocks);
}

template <class T>
int launch_key(const T* org, const T* dir, const unsigned char* alive,
               const T* bb_lo, const T* bb_ext, long long n, int dirbins,
               int* key, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  coherence_key_kernel<T>
      <<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          org, dir, alive, bb_lo, bb_ext, n, dirbins, key);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_permute(const long long* take, long long n_out, const T* org,
                   const T* dir, const T* weight, const T* w0,
                   const unsigned char* alive, const unsigned char* hfb,
                   const int* n_refl, const int* n_bdry, const T* aux,
                   int n_aux, T* org2, T* dir2, T* weight2, T* w02,
                   unsigned char* alive2, unsigned char* hfb2, int* n_refl2,
                   int* n_bdry2, T* aux2, void* stream) {
  if (n_out <= 0) return static_cast<int>(cudaGetLastError());
  permute_state_kernel<T>
      <<<blocks_for(n_out), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          take, n_out, org, dir, weight, w0, alive, hfb, n_refl, n_bdry, aux,
          n_aux, org2, dir2, weight2, w02, alive2, hfb2, n_refl2, n_bdry2,
          aux2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The coherence key of n lanes. org, dir: (n, 3); alive: (n,) bytes; bb_lo,
// bb_ext: 3 values each on the device; key: (n,) int32. Launches on
// `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError().
extern "C" int vr_coherence_key(const float* org, const float* dir,
                                const unsigned char* alive, const float* bb_lo,
                                const float* bb_ext, long long n, int dirbins,
                                int* key, void* stream) {
  return launch_key<float>(org, dir, alive, bb_lo, bb_ext, n, dirbins, key,
                           stream);
}

extern "C" int vr_coherence_key_f64(const double* org, const double* dir,
                                    const unsigned char* alive,
                                    const double* bb_lo, const double* bb_ext,
                                    long long n, int dirbins, int* key,
                                    void* stream) {
  return launch_key<double>(org, dir, alive, bb_lo, bb_ext, n, dirbins, key,
                            stream);
}

// out[i] = in[take[i]], i < n_out, for every per-ray array; take: (n_out,)
// int64 in [0, R); aux and aux2 are read only where n_aux > 0. Launches on
// `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError().
extern "C" int vr_permute_state(
    const long long* take, long long n_out, const float* org,
    const float* dir, const float* weight, const float* w0,
    const unsigned char* alive, const unsigned char* hfb, const int* n_refl,
    const int* n_bdry, const float* aux, int n_aux, float* org2, float* dir2,
    float* weight2, float* w02, unsigned char* alive2, unsigned char* hfb2,
    int* n_refl2, int* n_bdry2, float* aux2, void* stream) {
  return launch_permute<float>(take, n_out, org, dir, weight, w0, alive, hfb,
                               n_refl, n_bdry, aux, n_aux, org2, dir2,
                               weight2, w02, alive2, hfb2, n_refl2, n_bdry2,
                               aux2, stream);
}

extern "C" int vr_permute_state_f64(
    const long long* take, long long n_out, const double* org,
    const double* dir, const double* weight, const double* w0,
    const unsigned char* alive, const unsigned char* hfb, const int* n_refl,
    const int* n_bdry, const double* aux, int n_aux, double* org2,
    double* dir2, double* weight2, double* w02, unsigned char* alive2,
    unsigned char* hfb2, int* n_refl2, int* n_bdry2, double* aux2,
    void* stream) {
  return launch_permute<double>(take, n_out, org, dir, weight, w0, alive, hfb,
                                n_refl, n_bdry, aux, n_aux, org2, dir2,
                                weight2, w02, alive2, hfb2, n_refl2, n_bdry2,
                                aux2, stream);
}
