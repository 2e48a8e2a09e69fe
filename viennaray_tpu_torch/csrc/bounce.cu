// Whole bounces of a ray batch: n_sub bounces of every ray per launch.
//
// Replaces the TPU kernel viennaray_tpu/ops/pallas_bounce.py:_bounce_kernel
// with its _one_bounce (launched by fused_bounce / _fused_bounce), for disks.
// Per ray and sub-bounce: search bound, closest disk hit below it, event
// (geometry wins ties over the walls, wall 1 over wall 2), wall handling
// (reflective / periodic / ignore, the boundary-hit cap), backface pass or
// kill, the deposit of the pre-sticking weight, diffuse or specular
// reflection, sticking, the reflection cap, roulette, the state update.
//
// What bounds it on an H100: operations, as the closest-hit kernel: a ray
// tests every disk of every chunk it cannot rule out, about 30 float32
// operations a pair, against some 100 bytes of state, uniforms and outputs
// per ray; the geometry stays in L2. The narrow launches of the tail (512
// rays, 2 blocks) are bound by the latency of n_sub dependent searches.
//
// What the design does about it:
//  - one thread per ray, any R; the ray's whole state lives in registers
//    across the n_sub sub-bounces, counters are int32 and flags bool;
//  - the search is csrc/disk_search.cuh, shared with the closest-hit kernel:
//    the SoA staged through shared memory, a per-warp chunk skip, lowest t
//    then lowest sorted lane. It starts from the bound tmin0 (exit of the
//    walls box inflated by the disks' reach, and the nearest wall crossing,
//    a hair above it so that geometry still wins a tie), so escaping and
//    sideways rays stop waking chunks. Dead lanes wake nothing, and a block
//    whose lanes are all dead leaves the sub-bounce loop at once;
//  - everything the events need is recomputed from registers; the uniforms
//    are read as they are needed, three per sub-bounce;
//  - the event counts are summed per warp and added with one integer atomic
//    per warp and counter, with the lanes alive after the launch, so the
//    caller's one host read per launch needs no reduction.
//
// Deposits. Either handed out (n_sub == 1): the launch writes each ray's
// (hit disk or -1, deposit weight) and the caller lands them. Or in the
// kernel: the thread gathers the hit disk's K neighbor records (8 floats
// each, one row of neighbor_pack), re-tests each against the ray as it was
// before this sub-bounce, and adds the weight to the hit disk's bin and to
// every passing neighbor's, in original numbering. The TPU kernel instead
// sweeps the chunks a second time with a 2r ball around the hit centre,
// because it has no gather; the neighbor list is by construction that ball,
// a thread here can gather, and K records are far fewer than a chunk sweep.
// Blocks run in no order, so the bins are the 64-bit fixed-point integers of
// csrc/fixed_point.cuh: integer atomics are associative, two launches on one
// input give the same bits. The scale follows from the largest w0 (a weight
// never exceeds its ray's w0: sticking lowers it, roulette renews it to a
// fraction of w0) and the entry count R * n_sub * (K + 1).
//
// Numbers: round-to-nearest intrinsics in the plain version's operation
// order (ops/bounce.py:bounce_step), IEEE division and square root, no fused
// multiply-add, so everything but sinf / cosf of the diffuse reflection is
// comparable with the plain version for equality (and those two are the
// functions PyTorch's own kernels call: on an H100 the directions agreed bit
// for bit as well).
//
// Registers (nvcc 12.8 -Xptxas -v, sm_90a): 64 a thread, a 72-byte stack
// frame, 92 bytes of spill stores and 68 of spill loads; 16 KB of shared
// memory. chip_smoke.py prints the figures of every build.
#include <cuda_runtime.h>

#include "disk_search.cuh"
#include "fixed_point.cuh"

namespace {

constexpr float kBig = 3.4e38f;
constexpr float kTwoPi = 6.2831855f;  // float32 of 2 pi
// boundary conditions, as config.BoundaryCondition
constexpr int kReflective = 0;
constexpr int kPeriodic = 1;

struct BounceArgs {
  // state in
  const float* org;
  const float* dir;
  const float* weight;
  const float* w0;
  const unsigned char* alive;
  const unsigned char* hfb;
  const int* n_refl;
  const int* n_bdry;
  const float* uniforms;
  // geometry
  const float* prims;
  const float* chunk_bbs;
  const int* perm;
  const int* neighbors;
  const float* neighbor_pack;
  const float* walls;
  int n_rays, npad, pt, n_prims, k_nbrs, n_sub;
  int dim, first_dir, second_dir, ray_axis, bc1, bc2, specular;
  int max_refl, max_bdry, roulette, deposit;
  float t_near, sticking, wthresh, wrenew;
  // state out
  float* org_out;
  float* dir_out;
  float* weight_out;
  unsigned char* alive_out;
  unsigned char* hfb_out;
  int* n_refl_out;
  int* n_bdry_out;
  // deposits handed out
  int* hit_prim_out;
  float* wdep_out;
  // deposits in the kernel, and the counts
  unsigned long long* bins;
  const unsigned int* wmax_bits;
  long long n_entries;
  unsigned long long* counts;
};

__device__ __forceinline__ float pick(float x, float y, float z, int axis) {
  return axis == 0 ? x : (axis == 1 ? y : z);
}

__device__ __forceinline__ void put(float& x, float& y, float& z, int axis,
                                    float v) {
  if (axis == 0) x = v;
  else if (axis == 1) y = v;
  else z = v;
}

// (ax*bx + ay*by) + az*bz, as ops/vec.py:dot
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

__device__ __forceinline__ float safe_den(float d) {
  return d == 0.0f ? 1e-30f : d;
}

// Crossing time of the next wall plane along one axis, kept only when the
// hit point lies inside the wall's finite rectangle
// (ops/bounce.py:entry_bound, wall_t).
__device__ __forceinline__ float wall_time(
    float o, float d, float lo, float hi, float t_near, float o_r, float d_r,
    float lo_r, float hi_r, bool check_other, float o_o, float d_o,
    float lo_o, float hi_o) {
  const float ds = safe_den(d);
  float t = d > 0.0f ? __fdiv_rn(__fsub_rn(hi, o), ds)
                     : (d < 0.0f ? __fdiv_rn(__fsub_rn(lo, o), ds) : kBig);
  t = t > t_near ? t : kBig;
  const float hp_r = __fadd_rn(o_r, __fmul_rn(d_r, t));
  bool ok = hp_r >= lo_r && hp_r <= hi_r;
  if (check_other) {
    const float hp_o = __fadd_rn(o_o, __fmul_rn(d_o, t));
    ok = ok && hp_o >= lo_o && hp_o <= hi_o;
  }
  return ok ? t : kBig;
}

// exit time of one axis' slab [lo - r_inf, hi + r_inf]
__device__ __forceinline__ float slab_exit(float o, float d, float lo,
                                           float hi, float r_inf) {
  const float ds = safe_den(d);
  return fmaxf(__fdiv_rn(__fsub_rn(__fadd_rn(hi, r_inf), o), ds),
               __fdiv_rn(__fsub_rn(__fsub_rn(lo, r_inf), o), ds));
}

// ops/intersect.py:check_local_intersection for one neighbor record
// [centre(3) normal(3) radius valid]
__device__ __forceinline__ bool neighbor_hit(float ox, float oy, float oz,
                                             float dx, float dy, float dz,
                                             const float4 a, const float4 b) {
  const float cx = a.x, cy = a.y, cz = a.z;
  const float nx = a.w, ny = b.x, nz = b.y;
  const float radius = b.z;
  const float prod = dot3(nx, ny, nz, dx, dy, dz);
  const float ddneg = dot3(cx, cy, cz, nx, ny, nz);
  const float t = __fdiv_rn(__fsub_rn(ddneg, dot3(nx, ny, nz, ox, oy, oz)),
                            safe_den(prod));
  const float hx = __fsub_rn(__fadd_rn(ox, __fmul_rn(t, dx)), cx);
  const float hy = __fsub_rn(__fadd_rn(oy, __fmul_rn(t, dy)), cy);
  const float hz = __fsub_rn(__fadd_rn(oz, __fmul_rn(t, dz)), cz);
  const float dist = __fsqrt_rn(dot3(hx, hy, hz, hx, hy, hz));
  return prod <= 0.0f && fabsf(prod) >= 1e-6f && t > 0.0f && dist < radius &&
         b.w > 0.5f;
}

__device__ __forceinline__ void count_add(unsigned long long* slot, int v) {
  const int sum = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0 && sum != 0) {
    atomicAdd(slot, (unsigned long long)sum);
  }
}

__global__ void __launch_bounds__(kSearchBlock)
bounce_kernel(const BounceArgs a) {
  __shared__ float4 s_prim[2 * kSearchTile];

  const int r = blockIdx.x * kSearchBlock + threadIdx.x;
  const bool in_range = r < a.n_rays;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float weight = 0.f, w0 = 0.f;
  bool alive = false, hfb = false;
  int n_refl = 0, n_bdry = 0;
  if (in_range) {
    ox = a.org[3 * r + 0];
    oy = a.org[3 * r + 1];
    oz = a.org[3 * r + 2];
    dx = a.dir[3 * r + 0];
    dy = a.dir[3 * r + 1];
    dz = a.dir[3 * r + 2];
    weight = a.weight[r];
    w0 = a.w0[r];
    alive = a.alive[r] != 0;
    hfb = a.hfb[r] != 0;
    n_refl = a.n_refl[r];
    n_bdry = a.n_bdry[r];
  }

  const float lo1 = a.walls[0], hi1 = a.walls[1];
  const float lo2 = a.walls[2], hi2 = a.walls[3];
  const float lo_r = a.walls[4], hi_r = a.walls[5];
  const float r_inf = __fadd_rn(a.walls[8], a.t_near);
  const bool three_d = a.dim == 3;

  double scale = 0.0;
  if (a.deposit) {
    const unsigned int bits = *a.wmax_bits;
    if (bits != 0) scale = fixed_scale(bits, a.n_entries);
  }

  int c_collide = 0, c_wall = 0, c_exit = 0, c_traces = 0;
  int hit_prim = -1;
  float wdep = 0.0f;

  for (int k = 0; k < a.n_sub; ++k) {
    if (!__syncthreads_or(alive)) break;  // uniform across the block

    // ---- search bound and wall crossings (ops/bounce.py:entry_bound) ----
    float t_w1 = kBig, t_w2 = kBig, tmin0 = kBig;
    if (alive) {
      const float o1 = pick(ox, oy, oz, a.first_dir);
      const float d1 = pick(dx, dy, dz, a.first_dir);
      const float o2 = pick(ox, oy, oz, a.second_dir);
      const float d2 = pick(dx, dy, dz, a.second_dir);
      const float o_r = pick(ox, oy, oz, a.ray_axis);
      const float d_r = pick(dx, dy, dz, a.ray_axis);
      t_w1 = wall_time(o1, d1, lo1, hi1, a.t_near, o_r, d_r, lo_r, hi_r,
                       three_d, o2, d2, lo2, hi2);
      if (three_d) {
        t_w2 = wall_time(o2, d2, lo2, hi2, a.t_near, o_r, d_r, lo_r, hi_r,
                         true, o1, d1, lo1, hi1);
      }
      const float texit =
          fminf(fminf(slab_exit(o1, d1, lo1, hi1, r_inf),
                      slab_exit(o2, d2, lo2, hi2, r_inf)),
                slab_exit(o_r, d_r, lo_r, hi_r, r_inf));
      tmin0 = __fadd_rn(
          __fmul_rn(fminf(fmaxf(texit, 0.0f), fminf(t_w1, t_w2)),
                    (float)(1.0 + 1e-4)),
          a.t_near);
    }

    // ---- closest disk below the bound ----------------------------------
    float t_geo = tmin0;
    int lane;
    disk_search(s_prim, ox, oy, oz, dx, dy, dz, a.prims, a.chunk_bbs, a.npad,
                a.pt, a.t_near, alive, t_geo, lane);
    if (!alive) continue;

    ++c_traces;
    // ---- event ---------------------------------------------------------
    const float t_geo_m = lane >= 0 ? t_geo : kBig;
    const bool geo_first = t_geo_m <= t_w1 && t_geo_m <= t_w2;
    const bool w1_first = t_w1 <= t_w2;
    const float t_ev = fminf(t_geo_m, fminf(t_w1, t_w2));
    const bool is_exit = t_ev >= kBig;
    const bool is_geo = !is_exit && geo_first;
    const bool is_w1 = !is_exit && !geo_first && w1_first;
    const bool is_w2 = !is_exit && !geo_first && !w1_first;
    const bool is_wall = is_w1 || is_w2;

    const float hpx = __fadd_rn(ox, __fmul_rn(dx, t_ev));
    const float hpy = __fadd_rn(oy, __fmul_rn(dy, t_ev));
    const float hpz = __fadd_rn(oz, __fmul_rn(dz, t_ev));

    // ---- walls ---------------------------------------------------------
    const int n_bdry_new = n_bdry + (is_wall ? 1 : 0);
    const bool overflow = is_wall && n_bdry_new > a.max_bdry;
    float nox = ox, noy = oy, noz = oz, ndx = dx, ndy = dy, ndz = dz;
    bool dead = is_exit || overflow;
    if (is_wall && !overflow) {
      const int axis = is_w1 ? a.first_dir : a.second_dir;
      const int bc = is_w1 ? a.bc1 : a.bc2;
      if (bc == kReflective) {
        nox = hpx; noy = hpy; noz = hpz;
        put(ndx, ndy, ndz, axis, -pick(dx, dy, dz, axis));
      } else if (bc == kPeriodic) {
        nox = hpx; noy = hpy; noz = hpz;
        const float lo = is_w1 ? lo1 : lo2, hi = is_w1 ? hi1 : hi2;
        put(nox, noy, noz, axis, pick(dx, dy, dz, axis) > 0.0f ? lo : hi);
      } else {
        dead = true;  // ignore: the ray ends at the wall
      }
    }

    // ---- surface -------------------------------------------------------
    bool collide = false, bf_pass = false, survived = false;
    float new_weight = weight;
    float rdx = 0.f, rdy = 0.f, rdz = 0.f;
    if (is_geo) {
      const float nx = a.prims[3 * a.npad + lane];
      const float ny = a.prims[4 * a.npad + lane];
      const float nz = a.prims[5 * a.npad + lane];
      const bool backface = dot3(dx, dy, dz, nx, ny, nz) > 0.0f;
      if (backface) {
        // the first hit from behind passes through, the second kills
        if (hfb) dead = true;
        else bf_pass = true;
      } else {
        collide = true;
        ++c_collide;
        // ---- deposit of the pre-sticking weight -----------------------
        const int prim = a.perm[lane];
        if (a.deposit) {
          if (weight != 0.0f) {
            const unsigned long long q = to_fixed(weight, scale);
            atomicAdd(&a.bins[prim], q);
            const float4* rec = reinterpret_cast<const float4*>(
                a.neighbor_pack + (size_t)prim * a.k_nbrs * 8);
            const int* ids = a.neighbors + (size_t)prim * a.k_nbrs;
            for (int j = 0; j < a.k_nbrs; ++j) {
              if (neighbor_hit(ox, oy, oz, dx, dy, dz, rec[2 * j],
                               rec[2 * j + 1])) {
                const int id = min(max(ids[j], 0), a.n_prims - 1);
                atomicAdd(&a.bins[id], q);
              }
            }
          }
        } else {
          hit_prim = prim;
          wdep = weight;
        }

        // ---- reflection ------------------------------------------------
        if (a.specular) {
          // d' = (2 (n . -d)) n + d
          const float two_dp = __fmul_rn(2.0f, -dot3(nx, ny, nz, dx, dy, dz));
          rdx = __fadd_rn(__fmul_rn(two_dp, nx), dx);
          rdy = __fadd_rn(__fmul_rn(two_dp, ny), dy);
          rdz = __fadd_rn(__fmul_rn(two_dp, nz), dz);
          if (!three_d) {
            rdz = 0.0f;
            const float n = __fsqrt_rn(dot3(rdx, rdy, rdz, rdx, rdy, rdz));
            const float den = n > 0.0f ? n : 1.0f;
            rdx = __fdiv_rn(rdx, den);
            rdy = __fdiv_rn(rdy, den);
            rdz = __fdiv_rn(rdz, den);
          }
        } else {
          const float* u = a.uniforms + ((size_t)r * a.n_sub + k) * 3;
          const float z = __fsub_rn(1.0f, __fmul_rn(2.0f, u[0]));
          const float phi = __fmul_rn(kTwoPi, u[1]);
          const float rr =
              __fsqrt_rn(fmaxf(__fsub_rn(1.0f, __fmul_rn(z, z)), 0.0f));
          rdx = __fadd_rn(__fmul_rn(rr, cosf(phi)), nx);
          rdy = __fadd_rn(__fmul_rn(rr, sinf(phi)), ny);
          rdz = three_d ? __fadd_rn(z, nz) : 0.0f;
          const float n =
              fmaxf(__fsqrt_rn(dot3(rdx, rdy, rdz, rdx, rdy, rdz)), 1e-12f);
          rdx = __fdiv_rn(rdx, n);
          rdy = __fdiv_rn(rdy, n);
          rdz = __fdiv_rn(rdz, n);
        }

        // ---- sticking, the reflection cap, roulette --------------------
        new_weight = __fsub_rn(weight, __fmul_rn(weight, a.sticking));
        bool died = new_weight <= 0.0f;
        if (n_refl + 1 > a.max_refl) died = true;
        if (a.roulette) {
          const float low = __fmul_rn(a.wthresh, w0);
          const float renew = __fmul_rn(a.wrenew, w0);
          if (new_weight < low) {
            const float u_roul =
                a.uniforms[((size_t)r * a.n_sub + k) * 3 + 2];
            const float kill_prob = __fsub_rn(
                1.0f, __fdiv_rn(new_weight, fmaxf(renew, 1e-30f)));
            if (u_roul < kill_prob) died = true;
            else new_weight = renew;
          }
        }
        if (died) dead = true;
        else survived = true;
      }
    }
    if (is_wall) ++c_wall;
    if (is_exit) ++c_exit;

    // ---- state update --------------------------------------------------
    if (bf_pass || survived) {
      ox = hpx; oy = hpy; oz = hpz;
    } else {
      ox = nox; oy = noy; oz = noz;
    }
    if (survived) {
      dx = rdx; dy = rdy; dz = rdz;
    } else {
      dx = ndx; dy = ndy; dz = ndz;
    }
    if (!three_d) {
      dz = 0.0f;
      const float n =
          fmaxf(__fsqrt_rn(dot3(dx, dy, dz, dx, dy, dz)), 1e-12f);
      dx = __fdiv_rn(dx, n);
      dy = __fdiv_rn(dy, n);
      dz = __fdiv_rn(dz, n);
    }
    if (collide) {
      weight = new_weight;
      ++n_refl;
    }
    hfb = hfb || bf_pass;
    n_bdry = n_bdry_new;
    alive = !dead;
  }

  if (in_range) {
    a.org_out[3 * r + 0] = ox;
    a.org_out[3 * r + 1] = oy;
    a.org_out[3 * r + 2] = oz;
    a.dir_out[3 * r + 0] = dx;
    a.dir_out[3 * r + 1] = dy;
    a.dir_out[3 * r + 2] = dz;
    a.weight_out[r] = weight;
    a.alive_out[r] = alive ? 1 : 0;
    a.hfb_out[r] = hfb ? 1 : 0;
    a.n_refl_out[r] = n_refl;
    a.n_bdry_out[r] = n_bdry;
    if (!a.deposit) {
      a.hit_prim_out[r] = hit_prim;
      a.wdep_out[r] = wdep;
    }
  }
  count_add(&a.counts[0], c_collide);
  count_add(&a.counts[1], c_wall);
  count_add(&a.counts[2], c_exit);
  count_add(&a.counts[3], c_traces);
  count_add(&a.counts[4], alive ? 1 : 0);
}

}  // namespace

// State in: org, dir (n_rays, 3) float32; weight, w0 (n_rays,) float32;
// alive, hfb (n_rays,) bytes 0/1; n_refl, n_bdry (n_rays,) int32; uniforms
// (n_rays, 3 n_sub) float32. Geometry: prims (8, npad), chunk_bbs
// (npad / pt, 8), perm (npad,) sorted lane -> original id, neighbors
// (n_prims, k_nbrs) int32, neighbor_pack (n_prims, k_nbrs * 8), walls (9,).
// State out: fresh arrays of the same shapes (w0 does not change). With
// deposit != 0 the flux (n_prims,) float32 in original numbering goes to
// flux_out; else n_sub must be 1 and each ray's (hit disk or -1, deposit
// weight) goes to hit_prim_out / wdep_out. scratch: n_prims + 6 64-bit words,
// which this call clears itself: the bins, the largest w0, and the five
// counts (collide, wall, exit, traces, survivors) that the caller reads at
// scratch + n_prims + 1. Launches on `stream`, allocates nothing, does not
// synchronise; returns the first CUDA error, else cudaGetLastError().
extern "C" int vr_fused_bounce(
    const float* org, const float* dir, const float* weight, const float* w0,
    const unsigned char* alive, const unsigned char* hfb, const int* n_refl,
    const int* n_bdry, const float* uniforms, const float* prims,
    const float* chunk_bbs, const int* perm, const int* neighbors,
    const float* neighbor_pack, const float* walls, int n_rays, int npad,
    int pt, int n_prims, int k_nbrs, int n_sub, int dim, int first_dir,
    int second_dir, int ray_axis, int bc1, int bc2, int specular,
    int max_refl, int max_bdry, int roulette, int deposit, float t_near,
    float sticking, float wthresh, float wrenew, float* org_out,
    float* dir_out, float* weight_out, unsigned char* alive_out,
    unsigned char* hfb_out, int* n_refl_out, int* n_bdry_out, float* flux_out,
    int* hit_prim_out, float* wdep_out, unsigned long long* scratch,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!deposit && n_sub != 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, sizeof(unsigned long long) * ((size_t)n_prims + 6), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned int* wmax_bits = reinterpret_cast<unsigned int*>(scratch + n_prims);
  const long long n_entries = (long long)n_rays * n_sub * (k_nbrs + 1);

  if (n_rays > 0) {
    const int grid = (n_rays + kSearchBlock - 1) / kSearchBlock;
    if (deposit) {
      absmax_kernel<<<min(grid, 1024), kSearchBlock, 0, s>>>(w0, n_rays,
                                                             wmax_bits);
    }
    BounceArgs a;
    a.org = org; a.dir = dir; a.weight = weight; a.w0 = w0;
    a.alive = alive; a.hfb = hfb; a.n_refl = n_refl; a.n_bdry = n_bdry;
    a.uniforms = uniforms;
    a.prims = prims; a.chunk_bbs = chunk_bbs; a.perm = perm;
    a.neighbors = neighbors; a.neighbor_pack = neighbor_pack; a.walls = walls;
    a.n_rays = n_rays; a.npad = npad; a.pt = pt; a.n_prims = n_prims;
    a.k_nbrs = k_nbrs; a.n_sub = n_sub;
    a.dim = dim; a.first_dir = first_dir; a.second_dir = second_dir;
    a.ray_axis = ray_axis; a.bc1 = bc1; a.bc2 = bc2; a.specular = specular;
    a.max_refl = max_refl; a.max_bdry = max_bdry; a.roulette = roulette;
    a.deposit = deposit;
    a.t_near = t_near; a.sticking = sticking; a.wthresh = wthresh;
    a.wrenew = wrenew;
    a.org_out = org_out; a.dir_out = dir_out; a.weight_out = weight_out;
    a.alive_out = alive_out; a.hfb_out = hfb_out; a.n_refl_out = n_refl_out;
    a.n_bdry_out = n_bdry_out;
    a.hit_prim_out = hit_prim_out; a.wdep_out = wdep_out;
    a.bins = scratch; a.wmax_bits = wmax_bits; a.n_entries = n_entries;
    a.counts = scratch + n_prims + 1;
    bounce_kernel<<<grid, kSearchBlock, 0, s>>>(a);
  }
  if (deposit && n_prims > 0) {
    finalize_kernel<<<(n_prims + 255) / 256, 256, 0, s>>>(
        scratch, wmax_bits, n_entries, n_prims, flux_out);
  }
  return static_cast<int>(cudaGetLastError());
}
