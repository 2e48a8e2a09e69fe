// The per-bounce coherence resort's key, and the permutation of the per-ray
// state that the resort, the source sort and the compaction share: one
// kernel each, in float32 and float64.
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
// Four lanes a thread on wide states (the key's design, below).
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
// so a lane's reads touch a 32-byte sector of every array where the bound
// counts its 42 bytes, and they hit L2 only while the arrays gathered at
// that time fit in it.
//
// The permutation's design. Gathering every array of a lane at once keeps
// all of them in flight (44 MB in float32, 77 MB in float64 at 2^20 lanes,
// the outputs streaming beside them), more than the 50 MB L2, and sends the
// random sector reads to HBM; index_select, one array a launch, gathers
// from an array that stays in L2, and a kernel that did the former lost to
// eight index_select calls (PERF.md). So one launch runs four segments one
// after another in block order, and the blocks resident at a time gather
// from one segment's arrays: org, dir (three words a row), the six per-ray
// scalars (a lane a thread, one read of take for the six), then aux (A
// words a row, A specialised at 1 and 2). In every segment consecutive
// threads write consecutive words, so each warp stores whole lines, and
// each thread keeps kItems independent gathers in flight. Offsets are
// 32-bit where R times the widest row fits.
#include <cuda_runtime.h>

#include "scalar.cuh"

namespace {

__device__ __forceinline__ int trunc_int(float x) { return __float2int_rz(x); }
__device__ __forceinline__ int trunc_int(double x) {
  return __double2int_rz(x);
}
__device__ __forceinline__ int clamp_int(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// ---- the key ---------------------------------------------------------------
//
// Bound by bytes, so the design is about loads in flight. Each thread takes
// a quad of lanes: the quad's org and dir rows are 12 words each, read as
// three 16-byte loads in float32 (six in float64), its four alive bytes one
// 32-bit load, its four keys one 16-byte store; a warp's loads cover whole
// lines once. One wave of blocks over the card, a grid-stride loop beyond.
// Every lane computes its key and a dead lane's is then replaced, so no
// branch splits a warp. The lanes past the last quad, every lane of a state
// whose arrays are not aligned for the quads (a view at an offset), and
// every lane of a state too narrow to give each thread of the wave a quad
// take the same arithmetic one lane a thread: there the card holds few
// warps, and a thread's four lanes of dependent arithmetic took longer
// than four warps' one (2^18 lanes: 0.0052 ms by quads, 0.0039 a lane a
// thread; at 2^20 the quads 0.0074 against 0.0081 at an offset; H100,
// PERF.md). The loads keep the default cache policy: the permutation that
// follows the sort gathers the same org and dir.

constexpr int kKeyThreads = 256;
constexpr int kKeyBlocksPerSm = 4;

// The key of one lane: the cell of its origin and the bin of its direction,
// 1 << 30 for a dead lane
template <class T>
__device__ __forceinline__ int lane_key(const T (&o)[3], const T (&d)[3],
                                        bool alive, const T (&lo)[3],
                                        const T (&ext)[3], int dirbins) {
  int cell[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const T x = mul_rn(div_rn(sub_rn(o[a], lo[a]), ext[a]), T(16));
    cell[a] = clamp_int(trunc_int(x), 0, 15);
  }
  int dbin, nb_d;
  if (dirbins >= 32) {
    const int nb_pol = dirbins >= 64 ? 8 : 4;
    const T band = mul_rn(add_rn(d[2], T(1)), T(nb_pol / 2));
    dbin = (d[0] > T(0)) + 2 * (d[1] > T(0)) +
           4 * (vabs(d[0]) > vabs(d[1])) +
           8 * clamp_int(trunc_int(band), 0, nb_pol - 1);
    nb_d = 8 * nb_pol;
  } else {
    dbin = (d[0] > T(0)) + 2 * (d[1] > T(0)) + 4 * (d[2] > T(0));
    nb_d = 8;
  }
  const int key = ((cell[0] * 16 + cell[1]) * 16 + cell[2]) * nb_d + dbin;
  return alive ? key : 1 << 30;
}

// the 12 words of rows 4q to 4q + 3 of an (n, 3) array, by 16-byte loads
__device__ __forceinline__ void load_rows(const float* __restrict__ p,
                                          long long q, float (&v)[12]) {
  const float4* p4 = reinterpret_cast<const float4*>(p) + 3 * q;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float4 a = __ldg(p4 + i);
    v[4 * i] = a.x;
    v[4 * i + 1] = a.y;
    v[4 * i + 2] = a.z;
    v[4 * i + 3] = a.w;
  }
}
__device__ __forceinline__ void load_rows(const double* __restrict__ p,
                                          long long q, double (&v)[12]) {
  const double2* p2 = reinterpret_cast<const double2*>(p) + 6 * q;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const double2 a = __ldg(p2 + i);
    v[2 * i] = a.x;
    v[2 * i + 1] = a.y;
  }
}

// vec: org, dir and key 16-byte aligned, alive 4-byte aligned, and enough
// lanes, so the lanes [0, 4 (n / 4)) go by quads
template <class T>
__global__ void __launch_bounds__(kKeyThreads)
coherence_key_kernel(const T* __restrict__ org, const T* __restrict__ dir,
                     const unsigned char* __restrict__ alive,
                     const T* __restrict__ bb_lo, const T* __restrict__ bb_ext,
                     long long n, int dirbins, int vec, int* __restrict__ key) {
  const T lo[3] = {bb_lo[0], bb_lo[1], bb_lo[2]};
  const T ext[3] = {bb_ext[0], bb_ext[1], bb_ext[2]};
  const long long t = (long long)blockIdx.x * kKeyThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kKeyThreads;
  const long long n4 = vec ? n / 4 : 0;
  for (long long q = t; q < n4; q += stride) {
    T o[12], d[12];
    load_rows(org, q, o);
    load_rows(dir, q, d);
    const unsigned int al =
        __ldg(reinterpret_cast<const unsigned int*>(alive) + q);
    int k[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const T oj[3] = {o[3 * j], o[3 * j + 1], o[3 * j + 2]};
      const T dj[3] = {d[3 * j], d[3 * j + 1], d[3 * j + 2]};
      k[j] = lane_key(oj, dj, ((al >> (8 * j)) & 0xffu) != 0u, lo, ext,
                      dirbins);
    }
    reinterpret_cast<int4*>(key)[q] = make_int4(k[0], k[1], k[2], k[3]);
  }
  for (long long i = 4 * n4 + t; i < n; i += stride) {
    const T oi[3] = {org[3 * i], org[3 * i + 1], org[3 * i + 2]};
    const T di[3] = {dir[3 * i], dir[3 * i + 1], dir[3 * i + 2]};
    key[i] = lane_key(oi, di, alive[i] != 0, lo, ext, dirbins);
  }
}

// the permutation's work: a block covers kTile words of one segment
constexpr int kPermThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kPermThreads * kItems;
constexpr int kSegments = 4;  // org, dir, the scalars, aux

template <class T>
struct PermuteArgs {
  const long long* take;
  long long n_out;
  const T* org;
  const T* dir;
  const T* weight;
  const T* w0;
  const unsigned char* alive;
  const unsigned char* hfb;
  const int* n_refl;
  const int* n_bdry;
  const T* aux;
  int n_aux;
  T* org2;
  T* dir2;
  T* weight2;
  T* w02;
  unsigned char* alive2;
  unsigned char* hfb2;
  int* n_refl2;
  int* n_bdry2;
  T* aux2;
  int seg_end[kSegments];  // the first block past each segment
};

// dst[w] = src[take[w / W] W + w % W] for the kTile words of one block
// from `base` (W at compile time, or `width` where W = 0), I the offsets'
// type.
template <class E, int W, class I>
__device__ __forceinline__ void gather_words(const long long* __restrict__ take,
                                             const E* __restrict__ src,
                                             E* __restrict__ dst, I n_words,
                                             I base, int width) {
  const I w_n = W > 0 ? (I)W : (I)width;
  I word[kItems];
  I from[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    word[k] = base + (I)(k * kPermThreads + (int)threadIdx.x);
    from[k] = 0;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (word[k] < n_words) {
      const I lane = word[k] / w_n;
      from[k] = (I)__ldg(take + lane) * w_n + (word[k] - lane * w_n);
    }
  }
  E v[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (word[k] < n_words) v[k] = __ldg(src + from[k]);
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (word[k] < n_words) dst[word[k]] = v[k];
  }
}

// The six per-ray scalars of the kTile lanes of one block from `base`: one
// read of take a lane.
template <class T, class I>
__device__ __forceinline__ void gather_scalars(const PermuteArgs<T>& a,
                                               I base) {
  const I n = (I)a.n_out;
  I lane[kItems];
  I from[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    lane[k] = base + (I)(k * kPermThreads + (int)threadIdx.x);
    from[k] = lane[k] < n ? (I)__ldg(a.take + lane[k]) : (I)0;
  }
  T wt[kItems], w0[kItems];
  int nr[kItems], nb[kItems];
  unsigned char al[kItems], hf[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (lane[k] < n) {
      wt[k] = __ldg(a.weight + from[k]);
      w0[k] = __ldg(a.w0 + from[k]);
      nr[k] = __ldg(a.n_refl + from[k]);
      nb[k] = __ldg(a.n_bdry + from[k]);
      al[k] = __ldg(a.alive + from[k]);
      hf[k] = __ldg(a.hfb + from[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (lane[k] < n) {
      a.weight2[lane[k]] = wt[k];
      a.w02[lane[k]] = w0[k];
      a.n_refl2[lane[k]] = nr[k];
      a.n_bdry2[lane[k]] = nb[k];
      a.alive2[lane[k]] = al[k];
      a.hfb2[lane[k]] = hf[k];
    }
  }
}

// kAux: the aux width at compile time (0: none, 1, 2), or -1 for any other
// (read from a.n_aux); I: int where R times the widest row fits, else
// long long.
template <class T, int kAux, class I>
__global__ void __launch_bounds__(kPermThreads)
permute_state_kernel(const PermuteArgs<T> a) {
  const int b = blockIdx.x;
  int seg = 0;
  while (seg < kSegments - 1 && b >= a.seg_end[seg]) ++seg;
  const int first = seg == 0 ? 0 : a.seg_end[seg - 1];
  const I base = (I)(b - first) * (I)kTile;
  const I n = (I)a.n_out;
  if (seg == 0) {
    gather_words<T, 3, I>(a.take, a.org, a.org2, n * 3, base, 3);
  } else if (seg == 1) {
    gather_words<T, 3, I>(a.take, a.dir, a.dir2, n * 3, base, 3);
  } else if (seg == 2) {
    gather_scalars<T, I>(a, base);
  } else if constexpr (kAux != 0) {
    gather_words<T, (kAux > 0 ? kAux : 0), I>(
        a.take, a.aux, a.aux2, n * (I)a.n_aux, base, a.n_aux);
  }
}

template <class T>
int launch_key(const T* org, const T* dir, const unsigned char* alive,
               const T* bb_lo, const T* bb_ext, long long n, int dirbins,
               int* key, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // a thread a quad (a lane where not vec), one wave at most
  const long long wave = (long long)sms * kKeyBlocksPerSm;
  const int vec = ((reinterpret_cast<size_t>(org) |
                    reinterpret_cast<size_t>(dir) |
                    reinterpret_cast<size_t>(key)) & 15) == 0 &&
                  (reinterpret_cast<size_t>(alive) & 3) == 0 &&
                  n >= 4 * wave * kKeyThreads;
  const long long work = vec ? (n + 3) / 4 : n;
  const long long want = (work + kKeyThreads - 1) / kKeyThreads;
  coherence_key_kernel<T>
      <<<(int)(want < wave ? want : wave), kKeyThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(org, dir, alive, bb_lo, bb_ext,
                                              n, dirbins, vec, key);
  return static_cast<int>(cudaGetLastError());
}

int tiles_for(long long words) { return (int)((words + kTile - 1) / kTile); }

template <class T, class I>
void launch_permute_as(const PermuteArgs<T>& a, int blocks, cudaStream_t s) {
  switch (a.n_aux) {
    case 0: permute_state_kernel<T, 0, I><<<blocks, kPermThreads, 0, s>>>(a);
            break;
    case 1: permute_state_kernel<T, 1, I><<<blocks, kPermThreads, 0, s>>>(a);
            break;
    case 2: permute_state_kernel<T, 2, I><<<blocks, kPermThreads, 0, s>>>(a);
            break;
    default:
      permute_state_kernel<T, -1, I><<<blocks, kPermThreads, 0, s>>>(a);
  }
}

template <class T>
int launch_permute(const long long* take, long long n_out, long long n_in,
                   const T* org, const T* dir, const T* weight, const T* w0,
                   const unsigned char* alive, const unsigned char* hfb,
                   const int* n_refl, const int* n_bdry, const T* aux,
                   int n_aux, T* org2, T* dir2, T* weight2, T* w02,
                   unsigned char* alive2, unsigned char* hfb2, int* n_refl2,
                   int* n_bdry2, T* aux2, void* stream) {
  if (n_out <= 0) return static_cast<int>(cudaGetLastError());
  if (n_out > n_in || n_aux < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PermuteArgs<T> a{take, n_out, org, dir, weight, w0, alive, hfb, n_refl,
                   n_bdry, aux, n_aux, org2, dir2, weight2, w02, alive2,
                   hfb2, n_refl2, n_bdry2, aux2, {0, 0, 0, 0}};
  const long long tiles[kSegments] = {
      tiles_for(3 * n_out), tiles_for(3 * n_out), tiles_for(n_out),
      n_aux > 0 ? tiles_for(n_aux * n_out) : 0};
  long long total = 0;
  for (int k = 0; k < kSegments; ++k) {
    total += tiles[k];
    a.seg_end[k] = (int)total;
  }
  if (total >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const long long widest = n_aux > 3 ? n_aux : 3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_in * widest < (1LL << 31) - kTile) {
    launch_permute_as<T, int>(a, (int)total, s);
  } else {
    launch_permute_as<T, long long>(a, (int)total, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The coherence key of n lanes. org, dir: (n, 3); alive: (n,) bytes; bb_lo,
// bb_ext: 3 values each on the device; key: (n,) int32. Launches on
// `stream` (on the current device), allocates nothing, does not
// synchronise; returns the first CUDA error, else cudaGetLastError().
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

// out[i] = in[take[i]], i < n_out <= n_in, for every per-ray array of n_in
// lanes; take: (n_out,) int64 in [0, n_in); aux and aux2 are read only where
// n_aux > 0. Launches on `stream`, allocates nothing, does not synchronise;
// returns cudaGetLastError().
extern "C" int vr_permute_state(
    const long long* take, long long n_out, long long n_in, const float* org,
    const float* dir, const float* weight, const float* w0,
    const unsigned char* alive, const unsigned char* hfb, const int* n_refl,
    const int* n_bdry, const float* aux, int n_aux, float* org2, float* dir2,
    float* weight2, float* w02, unsigned char* alive2, unsigned char* hfb2,
    int* n_refl2, int* n_bdry2, float* aux2, void* stream) {
  return launch_permute<float>(take, n_out, n_in, org, dir, weight, w0,
                               alive, hfb, n_refl, n_bdry, aux, n_aux, org2,
                               dir2, weight2, w02, alive2, hfb2, n_refl2,
                               n_bdry2, aux2, stream);
}

extern "C" int vr_permute_state_f64(
    const long long* take, long long n_out, long long n_in, const double* org,
    const double* dir, const double* weight, const double* w0,
    const unsigned char* alive, const unsigned char* hfb, const int* n_refl,
    const int* n_bdry, const double* aux, int n_aux, double* org2,
    double* dir2, double* weight2, double* w02, unsigned char* alive2,
    unsigned char* hfb2, int* n_refl2, int* n_bdry2, double* aux2,
    void* stream) {
  return launch_permute<double>(take, n_out, n_in, org, dir, weight, w0,
                                alive, hfb, n_refl, n_bdry, aux, n_aux, org2,
                                dir2, weight2, w02, alive2, hfb2, n_refl2,
                                n_bdry2, aux2, stream);
}
