// The bounce kernel's template (bounce.cu says what it computes and why it
// is built so); included by one translation unit per primitive kind
// (bounce_disks.cu, bounce_window.cu, bounce_tris.cu, bounce_lines.cu), so
// that nvcc compiles the kinds' instantiations in parallel.
#pragma once

#include <cuda_runtime.h>

#include "disk_hit.cuh"
#include "fixed_point.cuh"
#include "grid_search.cuh"
#include "line_hit.cuh"
#include "prim_search.cuh"
#include "tri_hit.cuh"

namespace vr_bounce {

// threads of a block under the group mapping (G > 1): 128 threads, one warp
// per scheduler of an SM, so that a narrow launch spreads over more SMs
constexpr int kGroupBlock = 128;
// the grid search's blocks (a warp per ray), and the blocks an SM must hold
// (its launch bound: registers a thread at most 65,536 / (threads a block x
// blocks)); chip_diagnose.py --grid-blocks A/B-tests them
constexpr int kGridBlock = 128;
constexpr int kGridMinBlocks = 5;

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
  const float* neighbor_pack;  // or the window list's records
  const float* walls;
  const float* stick_lanes;  // per sorted lane, or null: `sticking`
  // the uniform grid's walk (grid_search.cuh); start null: the chunk search
  GridWalk<float> grid;
  int n_rays, npad, pt, n_prims, k_nbrs, n_sub;
  int dim, first_dir, second_dir, ray_axis, bc1, bc2, refl_kind;
  int max_refl, max_bdry, roulette, deposit;
  float t_near, sticking, wthresh, wrenew, mfp;
  // state out
  float* org_out;
  float* dir_out;
  float* weight_out;
  unsigned char* alive_out;
  unsigned char* hfb_out;
  int* n_refl_out;
  int* n_bdry_out;
  // deposits handed out (the window form also hands out the hit time)
  int* hit_prim_out;
  float* wdep_out;
  float* thit_out;
  // deposits in the kernel, and the counts
  unsigned long long* bins;
  const unsigned int* wmax_bits;
  long long n_entries;
  unsigned long long* counts;
};

// Launches bounce_kernel<Kind, full, group> on `s` for a.n_rays rays, or
// bounce_grid_kernel<Kind, full> where a.grid.start != null; group is one of the instantiated G values
// (launch_group), and 32 with a grid; returns 0 or cudaErrorInvalidValue
// (also for a grid on lines, which have none). Defined by each kind's
// translation unit.
int launch_disks(bool full, int group, cudaStream_t s, const BounceArgs& a);
int launch_window(bool full, int group, cudaStream_t s, const BounceArgs& a);
int launch_tris(bool full, int group, cudaStream_t s, const BounceArgs& a);
int launch_lines(bool full, int group, cudaStream_t s, const BounceArgs& a);

}  // namespace vr_bounce

namespace {

using vr_bounce::BounceArgs;
using vr_bounce::kGroupBlock;
using vr_bounce::kGridBlock;
using vr_bounce::kGridMinBlocks;

constexpr float kBig = 3.4e38f;
constexpr float kTwoPi = 6.2831855f;  // float32 of 2 pi
// boundary conditions, as config.BoundaryCondition
constexpr int kReflective = 0;
constexpr int kPeriodic = 1;
// reflection models, as config.ReflectionKind
constexpr int kSpecular = 1;
constexpr int kConedCosine = 2;

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

// One integer atomic per warp and counter: every thread of the block calls
// it together, with what it adds (0 on the threads that must not count).
__device__ __forceinline__ void count_add(unsigned long long* slot, int v) {
  const int sum = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0 && sum != 0) {
    atomicAdd(slot, (unsigned long long)sum);
  }
}

// the unit sphere's point of two uniforms (ops/sampling.py:unit_sphere)
__device__ __forceinline__ void sphere_point(float u1, float u2, float& x,
                                             float& y, float& z) {
  z = __fsub_rn(1.0f, __fmul_rn(2.0f, u1));
  const float phi = __fmul_rn(kTwoPi, u2);
  const float rr = __fsqrt_rn(fmaxf(__fsub_rn(1.0f, __fmul_rn(z, z)), 0.0f));
  x = __fmul_rn(rr, cosf(phi));
  y = __fmul_rn(rr, sinf(phi));
}

// v / max(|v|, 1e-12) (ops/vec.py:normalize with eps)
__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  const float n = fmaxf(__fsqrt_rn(dot3(x, y, z, x, y, z)), 1e-12f);
  x = __fdiv_rn(x, n);
  y = __fdiv_rn(y, n);
  z = __fdiv_rn(z, n);
}

// G = 1: one thread per ray, blocks of kSearchBlock, the block-wide staged
// search. G > 1: G threads per ray (gl = the thread's place in its group),
// blocks of kGroupBlock, the group search, no barrier. Every thread of a
// group holds the ray's whole state and computes the same event, physics and
// update with the same operations, so the group's threads agree bit for bit
// without a broadcast; they split the search and the deposit gather, and
// the group's first thread (the leader) writes the ray's outputs and counts.
// kGrid: the search walks the uniform grid (grid_search_group; built at
// G = 32 only, ops/bounce.py:GRID_GROUP) instead of sweeping the chunks; it
// returns the same (t, lane), so nothing else changes but the search
// counts: the cells the walks visited, and the searches they ran (one per
// live ray and sub-bounce). The body of both kernels below.
template <class Kind, bool kFull, int G, bool kGrid>
__device__ __forceinline__ void bounce_body(const BounceArgs& a) {
  static_assert(!kGrid || G == 32, "the grid search runs a warp per ray");
  constexpr int kBlock =
      kGrid ? kGridBlock : (G == 1 ? kSearchBlock : kGroupBlock);
  __shared__ float4 s_prim[G == 1 ? Kind::kVec * kSearchTile : 1];

  const int r = (blockIdx.x * kBlock + (int)threadIdx.x) / G;
  const int gl = (int)threadIdx.x & (G - 1);
  const bool leader = gl == 0;
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
  const bool scatters = kFull && a.mfp > 0.0f;
  const int n_uni = scatters ? 6 : 3;

  double scale = 0.0;
  if (a.deposit) {
    const unsigned int bits = *a.wmax_bits;
    if (bits != 0) scale = fixed_scale(bits, a.n_entries);
  }

  int c_collide = 0, c_wall = 0, c_exit = 0, c_traces = 0, c_scatter = 0;
  // chunks woken and sub-bounces run by this thread's search group (a warp
  // under G = 1, counted on its first thread; the ray's group under G > 1)
  int c_swept = 0, c_tiles = 0;
  int hit_prim = -1;
  float wdep = 0.0f;
  float thit = 0.0f;

  for (int k = 0; k < a.n_sub; ++k) {
    if constexpr (G == 1) {
      if (!__syncthreads_or(alive)) break;  // uniform across the block
      if (__any_sync(0xffffffffu, alive) && (threadIdx.x & 31) == 0) {
        ++c_tiles;
      }
    } else {
      if (!alive) break;  // uniform across the group
      ++c_tiles;
    }

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

    // ---- closest hit below the bound -----------------------------------
    float t_geo = tmin0;
    int lane, woken;
    if constexpr (kGrid) {
      grid_search_group<Kind, G>(ox, oy, oz, dx, dy, dz, a.prims, a.npad,
                                 a.grid, a.t_near, gl, t_geo, lane, woken);
      c_swept += woken;
    } else if constexpr (G == 1) {
      prim_search<Kind>(s_prim, ox, oy, oz, dx, dy, dz, a.prims, a.chunk_bbs,
                        a.npad, a.pt, a.t_near, alive, t_geo, lane, woken);
      if ((threadIdx.x & 31) == 0) c_swept += woken;
      if (!alive) continue;
    } else {
      prim_search_group<Kind, G>(ox, oy, oz, dx, dy, dz, a.prims,
                                 a.chunk_bbs, a.npad, a.pt, a.t_near, gl,
                                 t_geo, lane, woken);
      c_swept += woken;
    }

    ++c_traces;
    // this sub-bounce's uniforms: [reflection 1 or theta, reflection 2,
    // roulette] and, with scattering, [scatter, scatter z, scatter phi]
    const float* u = a.uniforms + ((size_t)r * a.n_sub + k) * n_uni;
    // ---- event ---------------------------------------------------------
    const float t_geo_m = lane >= 0 ? t_geo : kBig;
    const bool geo_first = t_geo_m <= t_w1 && t_geo_m <= t_w2;
    const bool w1_first = t_w1 <= t_w2;
    const float t_ev = fminf(t_geo_m, fminf(t_w1, t_w2));
    const bool is_exit = t_ev >= kBig;
    // ---- gas scattering: decided before the walls and the geometry -----
    bool scat = false;
    if constexpr (kFull) {
      if (scatters && !is_exit) {
        const float p_scat =
            __fsub_rn(1.0f, expf(__fdiv_rn(-t_ev, a.mfp)));
        scat = u[3] < p_scat;
      }
    }
    const bool hits = !is_exit && !scat;
    const bool is_geo = hits && geo_first;
    const bool is_w1 = hits && !geo_first && w1_first;
    const bool is_w2 = hits && !geo_first && !w1_first;
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
      float nx, ny, nz;
      Kind::normal(a.prims, a.npad, lane, nx, ny, nz);
      const bool backface = dot3(dx, dy, dz, nx, ny, nz) > 0.0f;
      if (backface) {
        // a disk's first hit from behind passes through and its second
        // kills; a triangle's or a line's hit from behind always kills
        if (!Kind::kBackfacePasses || hfb) dead = true;
        else bf_pass = true;
      } else {
        collide = true;
        ++c_collide;
        // ---- deposit of the pre-sticking weight -----------------------
        // the gathered records are split over the group's threads (record
        // j on thread j mod G); each passing one adds its own atomic
        const int prim = a.perm[lane];
        if (a.deposit) {
          if (weight != 0.0f) {
            const unsigned long long q = to_fixed(weight, scale);
            if constexpr (Kind::kWindowDeposit) {
              // every disk of the window list (the hit disk first) that the
              // ray crosses with t_near < t <= t_geo + tau
              const float tlim = __fadd_rn(t_geo, a.walls[6]);
              const float4* rec = reinterpret_cast<const float4*>(
                  a.neighbor_pack + (size_t)prim * a.k_nbrs * 8);
              const int* ids = a.neighbors + (size_t)prim * a.k_nbrs;
              for (int j = gl; j < a.k_nbrs; j += G) {
                const float4 p0 = rec[2 * j], p1 = rec[2 * j + 1];
                const DiskPrim p{p0.x, p0.y, p0.z, p0.w,
                                 p1.x, p1.y, p1.z, p1.w};
                float t;
                if (disk_hit(ox, oy, oz, dx, dy, dz, p, a.t_near, t) &&
                    t <= tlim) {
                  const int id = min(max(ids[j], 0), a.n_prims - 1);
                  atomicAdd(&a.bins[id], q);
                }
              }
            } else if (leader) {
              atomicAdd(&a.bins[prim], q);
            }
            if constexpr (Kind::kNeighborDeposit) {
              const float4* rec = reinterpret_cast<const float4*>(
                  a.neighbor_pack + (size_t)prim * a.k_nbrs * 8);
              const int* ids = a.neighbors + (size_t)prim * a.k_nbrs;
              for (int j = gl; j < a.k_nbrs; j += G) {
                if (neighbor_hit(ox, oy, oz, dx, dy, dz, rec[2 * j],
                                 rec[2 * j + 1])) {
                  const int id = min(max(ids[j], 0), a.n_prims - 1);
                  atomicAdd(&a.bins[id], q);
                }
              }
            }
          }
        } else {
          hit_prim = prim;
          wdep = weight;
          if constexpr (Kind::kWindowDeposit) thit = t_geo;
        }

        // ---- reflection ------------------------------------------------
        const bool coned = kFull && a.refl_kind == kConedCosine;
        if (a.refl_kind == kSpecular) {
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
        } else if (!coned) {
          float sx, sy, sz;
          sphere_point(u[0], u[1], sx, sy, sz);
          rdx = __fadd_rn(sx, nx);
          rdy = __fadd_rn(sy, ny);
          rdz = three_d ? __fadd_rn(sz, nz) : 0.0f;
          normalize3(rdx, rdy, rdz);
        } else if constexpr (kFull) {
          // coned-cosine (physics/reflection.py:coned_cosine): theta = u[0]
          // around the normalised specular direction w, azimuth 2 pi u[1]
          const float two_dp = __fmul_rn(2.0f, -dot3(nx, ny, nz, dx, dy, dz));
          float wx = __fadd_rn(__fmul_rn(two_dp, nx), dx);
          float wy = __fadd_rn(__fmul_rn(two_dp, ny), dy);
          float wz = __fadd_rn(__fmul_rn(two_dp, nz), dz);
          normalize3(wx, wy, wz);
          // Frisvad basis (ops/vec.py:frisvad_basis)
          const bool degen = wz < -0.999999f;
          const float inv =
              __fdiv_rn(1.0f, degen ? 1.0f : __fadd_rn(1.0f, wz));
          const float fb = __fmul_rn(__fmul_rn(-wx, wy), inv);
          const float tx =
              degen ? 0.0f
                    : __fsub_rn(1.0f, __fmul_rn(__fmul_rn(wx, wx), inv));
          const float ty = degen ? -1.0f : fb;
          const float tz = degen ? 0.0f : -wx;
          const float bx = degen ? -1.0f : fb;
          const float by =
              degen ? 0.0f
                    : __fsub_rn(1.0f, __fmul_rn(__fmul_rn(wy, wy), inv));
          const float bz = degen ? 0.0f : -wy;
          const float sin_t = sinf(u[0]), cos_t = cosf(u[0]);
          const float phi = __fmul_rn(kTwoPi, u[1]);
          const float sin_p = sinf(phi), cos_p = cosf(phi);
          rdx = __fadd_rn(
              __fmul_rn(sin_t, __fadd_rn(__fmul_rn(cos_p, tx),
                                         __fmul_rn(sin_p, bx))),
              __fmul_rn(cos_t, wx));
          rdy = __fadd_rn(
              __fmul_rn(sin_t, __fadd_rn(__fmul_rn(cos_p, ty),
                                         __fmul_rn(sin_p, by))),
              __fmul_rn(cos_t, wy));
          rdz = __fadd_rn(
              __fmul_rn(sin_t, __fadd_rn(__fmul_rn(cos_p, tz),
                                         __fmul_rn(sin_p, bz))),
              __fmul_rn(cos_t, wz));
          // a direction into the surface is mirrored back
          const float dpn = dot3(rdx, rdy, rdz, nx, ny, nz);
          if (dpn <= 0.0f) {
            const float two = __fmul_rn(2.0f, dpn);
            rdx = __fsub_rn(rdx, __fmul_rn(two, nx));
            rdy = __fsub_rn(rdy, __fmul_rn(two, ny));
            rdz = __fsub_rn(rdz, __fmul_rn(two, nz));
          }
          if (!three_d) rdz = 0.0f;
          normalize3(rdx, rdy, rdz);
        }

        // ---- sticking, the reflection cap, roulette --------------------
        const float sticking =
            a.stick_lanes != nullptr ? a.stick_lanes[lane] : a.sticking;
        new_weight = __fsub_rn(weight, __fmul_rn(weight, sticking));
        bool died = new_weight <= 0.0f;
        if (n_refl + 1 > a.max_refl) died = true;
        if (a.roulette) {
          const float low = __fmul_rn(a.wthresh, w0);
          const float renew = __fmul_rn(a.wrenew, w0);
          if (new_weight < low) {
            const float u_roul = u[2];
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
    if constexpr (kFull) {
      if (scat) {
        // to org + dir * scatter (the probability draw itself, the
        // reference's arithmetic), on in a direction uniform on the sphere
        ++c_scatter;
        const float u_scat = u[3];
        ox = __fadd_rn(ox, __fmul_rn(dx, u_scat));
        oy = __fadd_rn(oy, __fmul_rn(dy, u_scat));
        oz = __fadd_rn(oz, __fmul_rn(dz, u_scat));
        sphere_point(u[4], u[5], dx, dy, dz);
        if (!three_d) {
          dz = 0.0f;
          normalize3(dx, dy, dz);
        }
      }
    }
    if (!three_d) {
      dz = 0.0f;
      normalize3(dx, dy, dz);
    }
    if (collide) {
      weight = new_weight;
      ++n_refl;
    }
    hfb = hfb || bf_pass;
    n_bdry = n_bdry_new;
    alive = !dead;
  }

  if (in_range && leader) {
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
      if constexpr (Kind::kWindowDeposit) a.thit_out[r] = thit;
    }
  }
  // the group's threads hold the same counts: its leader adds them
  const int own = leader ? 1 : 0;
  count_add(&a.counts[0], own * c_collide);
  count_add(&a.counts[1], own * c_wall);
  count_add(&a.counts[2], own * c_exit);
  count_add(&a.counts[3], own * c_traces);
  count_add(&a.counts[4], own * c_scatter);
  count_add(&a.counts[5], own * (alive ? 1 : 0));
  count_add(&a.counts[6], own * c_swept);
  count_add(&a.counts[7], own * c_tiles);
}

// The bounce kernel with the chunk search, at G threads per ray.
template <class Kind, bool kFull, int G>
__global__ void __launch_bounds__(G == 1 ? kSearchBlock : kGroupBlock)
bounce_kernel(const BounceArgs a) {
  bounce_body<Kind, kFull, G, false>(a);
}

// The bounce kernel with the grid search, a warp per ray. Its bound asks
// for 5 blocks of 128 threads an SM, so at most 102 registers a thread, and
// ptxas fits every instantiation in 94 or 96 without a spill. Under the
// chunk search's bound it held three of them (disks with kFull, the window
// form) at 96 and spilled 24 to 40 bytes; asked for 4 blocks it took 101 to
// 114 registers, 16 warps an SM in place of 20, and the walk, which waits
// on its reads, ran a fifth slower (PERF.md).
template <class Kind, bool kFull>
__global__ void __launch_bounds__(kGridBlock, kGridMinBlocks)
bounce_grid_kernel(const BounceArgs a) {
  bounce_body<Kind, kFull, 32, true>(a);
}

template <class Kind, bool kFull, int G, bool kGrid>
void launch_one(cudaStream_t s, const BounceArgs& a) {
  constexpr int kBlock =
      kGrid ? kGridBlock : (G == 1 ? kSearchBlock : kGroupBlock);
  const long long threads = (long long)a.n_rays * G;
  const int grid = (int)((threads + kBlock - 1) / kBlock);
  if constexpr (kGrid) {
    bounce_grid_kernel<Kind, kFull><<<grid, kBlock, 0, s>>>(a);
  } else {
    bounce_kernel<Kind, kFull, G><<<grid, kBlock, 0, s>>>(a);
  }
}

// The G values instantiated (ops/bounce.py:GROUPS), and the launch of one of
// them; returns cudaErrorInvalidValue for a G that is none of them. An H100
// measured every power of two from 1 to 32 (PERF.md): 32 was the fastest G
// wherever one thread per ray was not, so only the two are built.
template <class Kind, bool kFull>
int launch_group(int group, cudaStream_t s, const BounceArgs& a) {
  switch (group) {
    case 1: launch_one<Kind, kFull, 1, false>(s, a); break;
    case 32: launch_one<Kind, kFull, 32, false>(s, a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// kHasGrid: the kind can walk a grid (disks, triangles); lines cannot. The
// grid search is built at G = 32 only: any other group is refused.
template <class Kind, bool kHasGrid = true>
int launch_kind(bool full, int group, cudaStream_t s, const BounceArgs& a) {
  if (a.grid.start != nullptr) {
    if constexpr (kHasGrid) {
      if (group != 32) return static_cast<int>(cudaErrorInvalidValue);
      if (full) {
        launch_one<Kind, true, 32, true>(s, a);
      } else {
        launch_one<Kind, false, 32, true>(s, a);
      }
      return 0;
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return full ? launch_group<Kind, true>(group, s, a)
              : launch_group<Kind, false>(group, s, a);
}

}  // namespace
