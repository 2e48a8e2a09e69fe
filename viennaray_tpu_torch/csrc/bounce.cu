// Whole bounces of a ray batch: n_sub bounces of every ray per launch.
//
// Replaces the TPU kernel viennaray_tpu/ops/pallas_bounce.py:_bounce_kernel
// with its _one_bounce (launched by fused_bounce / _fused_bounce), for disks
// (its _disk_chunk branch), triangles (_tri_chunk) and 2D line segments
// (_line_chunk), under the neighbor flux model and, for disks, the window
// flux model (its deposit pass, pallas_bounce.py:868-892); the kernel is a
// template on the primitive kind. Per ray and sub-bounce: search bound,
// closest hit below it, event (geometry wins ties over the walls, wall 1
// over wall 2), gas scattering, wall handling (reflective / periodic /
// ignore, the boundary-hit cap), backface pass or kill, the deposit of the
// pre-sticking weight, diffuse, specular or coned-cosine reflection, sticking
// (one value or the hit lane's), the reflection cap, roulette, the state
// update.
//
// What differs by kind, all of it compile-time (DiskKind and DiskWindowKind
// in disk_hit.cuh, TriKind in tri_hit.cuh, LineKind in line_hit.cuh): the hit
// test and the staged tile's width; where the hit normal sits in the SoA (a
// triangle's is its STORED normal, rows 9-11; a line's has two rows and
// z = 0); the backface rule (a disk's first hit from behind passes through
// and the second kills, a triangle's or a line's always kills, so hfb is dead
// state for them); the deposit (a disk's neighbor list, a disk's window list
// under the window model, else the single closest hit: one atomic on the hit
// primitive's bin).
//
// The second template parameter, kFull, compiles the coned-cosine reflection
// and the gas scattering in. A launch without either (the diffuse and
// specular particles, with one sticking value or one per lane) runs the
// kFull = false instantiation, which holds none of their live values: the
// disk and triangle flagships keep the registers and the time they had
// before those branches existed. Coned-cosine: column 0 of a sub-bounce's
// uniforms carries the polar angle theta, sampled outside the kernel (its
// distribution depends on the cone angle alone); the kernel builds the
// Frisvad basis around the normalised specular direction, combines, and
// mirrors a direction that points into the surface. Gas scattering
// (mfp > 0) widens a sub-bounce's uniforms from 3 to 6 columns [.., scatter,
// scatter z, scatter phi]: a ray that does not escape scatters when
// scatter < 1 - exp(-t_event / mfp); it then takes no wall and no geometry
// event, moves to org + dir * scatter and takes a direction uniform on the
// sphere (flattened and renormalised in 2D).
//
// What bounds it on an H100: operations, as the closest-hit kernel: a ray
// tests every primitive of every chunk it cannot rule out, about 30 float32
// operations a (ray, disk) pair and about 50 a (ray, triangle) pair,
// against some 100 bytes of state, uniforms and outputs per ray; the
// geometry stays in L2. That holds at the wide launches (2^17 rays and up).
// The narrow launches of the tail (512 to 16,384 rays, 4 or 16 bounces) are
// bound by latency instead: with one thread per ray a 512-ray launch is 2
// blocks on 2 of the 132 SMs, each thread walks the 3,072 disk or 6,144
// triangle lanes of every chunk it cannot skip one after another, 16 times
// over, and block-wide barriers tie the block's 8 warps together at every
// chunk and sub-bounce.
//
// What the design does about it: a third template parameter G, the threads
// that search for one ray (1 or 32), which the wrapper picks from the launch
// width and the geometry's chunk count (ops/bounce.py:group_for: 32 below
// 65,536 rays, and at every width from 8 chunks on; the measurement is in
// PERF.md):
//  - G = 1 (the wide launches on few chunks): one thread per ray, any R,
//    blocks of 256; the search is csrc/prim_search.cuh:prim_search, shared
//    with the closest-hit kernel: the SoA staged through shared memory, a
//    per-warp chunk skip, lowest t then lowest sorted lane;
//  - G = 32 (the narrow launches, and every launch on many chunks): a warp
//    per ray, blocks of 128, so a 512-ray launch has 16,384 threads on 128
//    SMs. Every thread of the group holds the ray's state and computes the
//    same event, physics and update with the same operations, so they agree
//    bit for bit without a broadcast. The search is prim_search_group: the
//    chunk skip is decided for the one ray, thread l tests lanes l, l + G,
//    ... of a chunk read straight from the SoA (coalesced across the group,
//    no shared memory, no barrier), and the group takes the lexicographic
//    minimum of (t, sorted lane) with __shfl_xor_sync after each chunk: the
//    selection of the serial walk, ties included. The deposit's gather of K
//    neighbor or W window records is split over the group the same way
//    (record j on thread j mod G), each passing record adding its own
//    integer atomic; the hit primitive's bin, the outputs and the counts
//    come from the group's first thread. So (t, lane), the state, the flux
//    and the counts are those of G = 1, bit for bit. The template takes any
//    power of two up to 32; only the G values the wrapper picks are built;
//  - in both, the search starts from the bound tmin0 (exit of the walls box
//    inflated by the disks' reach (triangles reach no further than their
//    vertices: 0), and the nearest wall crossing, a hair above it so that
//    geometry still wins a tie), so escaping and sideways rays stop waking
//    chunks. Dead lanes wake nothing; a block (G = 1) or a group (G > 1)
//    whose rays are all dead leaves the sub-bounce loop at once;
//  - everything the events need is recomputed from registers; the uniforms
//    are read as they are needed, three per sub-bounce;
//  - the event counts are summed per warp and added with one integer atomic
//    per warp and counter, with the lanes alive after the launch, so the
//    caller's one host read per launch needs no reduction. Two more count
//    words say how hard the search worked: the chunks a search group woke
//    and the sub-bounces it ran (a search group: the rays that share one
//    chunk-skip decision, a warp under G = 1, a single ray under G > 1).
//
// Deposits. Either handed out (n_sub == 1): the launch writes each ray's
// (hit disk or -1, deposit weight) and the caller lands them. Or in the
// kernel: the ray's thread (or group) gathers the hit disk's K neighbor
// records (8 floats each, one row of neighbor_pack), re-tests each against
// the ray as it was before this sub-bounce, and adds the weight to the hit
// disk's bin and to every passing neighbor's, in original numbering. The
// TPU kernel instead sweeps the chunks a second time with a 2r ball around
// the hit centre, because it has no gather; the neighbor list is by
// construction that ball, a thread here can gather, and K records are far
// fewer than a chunk sweep.
// The window model (DiskWindowKind) gathers the same way: the hit disk's
// window list (neighbors / neighbor_pack then hold its ids and its records in
// the SoA's layout, k_nbrs = W) holds every disk that can lie within tau past
// the primary hit, the hit disk first; each passes when disk_hit finds it at
// t <= t_hit + tau. The TPU kernel sweeps the chunks a second time instead.
// Blocks run in no order, so the bins are the 64-bit fixed-point integers of
// csrc/fixed_point.cuh: integer atomics are associative, two launches on one
// input give the same bits, and so do G = 1 and G > 1. The scale follows
// from the largest w0 (a weight never exceeds its ray's w0: sticking lowers
// it, roulette renews it to a fraction of w0) and the entry count
// R * n_sub * (K + 1), which still bounds
// the entries: a ray deposits at most once per sub-bounce, and a scattering
// ray deposits nothing; under the window model R * n_sub * W (a list of W
// slots, the hit disk's among them). A triangle or a line has no neighbor
// list (K = 0): the hit primitive's bin takes the one atomic.
//
// Numbers: round-to-nearest intrinsics in the plain version's operation
// order (ops/bounce.py:bounce_step), IEEE division and square root, no fused
// multiply-add, so everything but sinf / cosf (diffuse and coned-cosine
// reflection, scattering direction) and expf (scattering probability) is
// comparable with the plain version for equality (and those are the
// functions PyTorch's own kernels call: on an H100 the diffuse directions
// agreed bit for bit as well).
//
// Registers: chip_smoke.py prints ptxas' figures of every instantiation of
// every build (nvcc -Xptxas -v, sm_90a); PERF.md keeps them. Shared memory
// (G = 1 only): 16 KB for disks, 24 KB for triangles, 8 KB for lines.
//
// Layout: the template is bounce_kernel.cuh; bounce_disks.cu,
// bounce_window.cu, bounce_tris.cu and bounce_lines.cu instantiate it for
// their kind, so that nvcc builds the four in parallel; this file holds the
// entry point.
#include <cuda_runtime.h>

#include "bounce_kernel.cuh"

namespace {

// primitive kinds, as the `kind` argument of vr_fused_bounce
constexpr int kDisks = 0;
constexpr int kTriangles = 1;
constexpr int kLines = 2;
constexpr int kDiskWindow = 3;
// reflection models, as config.ReflectionKind
constexpr int kDiffuse = 0;

}  // namespace

// State in: org, dir (n_rays, 3) float32; weight, w0 (n_rays,) float32;
// alive, hfb (n_rays,) bytes 0/1; n_refl, n_bdry (n_rays,) int32; uniforms
// (n_rays, n_uni n_sub) float32, n_uni = 6 with mfp > 0 and else 3. kind:
// 0 = disks, 1 = triangles, 2 = lines, 3 = disks under the window flux
// model. Geometry: prims (8, npad) for disks, (12, npad) for triangles or
// (6, npad) for lines, chunk_bbs (npad / pt, 8), perm (npad,) sorted lane ->
// original id, walls (9,); disks only: neighbors (n_prims, k_nbrs) int32,
// neighbor_pack (n_prims, k_nbrs * 8), under the window model the window
// list's ids and records [centre(3) normal(3) r2 n.c] (k_nbrs = W, the hit
// disk in every list); triangles and lines pass k_nbrs = 0 and null for
// both. stick_lanes: (npad,) sticking per sorted lane, or null for the one
// value `sticking`. refl_kind: 0 = diffuse, 1 = specular, 2 = coned-cosine
// (uniform column 0 then carries theta). mfp: the mean free path of gas
// scattering, 0 for none.
// State out: fresh arrays of the same shapes (w0 does not change). With
// deposit != 0 the flux (n_prims,) float32 in original numbering goes to
// flux_out; else n_sub must be 1 and each ray's (hit primitive or -1, deposit
// weight) goes to hit_prim_out / wdep_out, and under the window model its
// hit time to thit_out (else null). group: the threads that search for one
// ray, one of the instantiated G values (1, 32). grid_start: null for the
// chunk search, or with grid_lanes the uniform grid's compact walk table for
// the grid search of disks and triangles (grid_search.cuh; (grid_nx grid_ny
// grid_nz + 1) starts and the cells' sorted lanes, the grid's corner and
// cell size), which finds the same hits;
// chunks_swept then counts the cells the walks visited and tile_bounces the
// searches they ran. scratch:
// n_prims + 9 64-bit words, which this call clears itself: the bins, the
// largest w0, and the eight counts that the caller reads at
// scratch + n_prims + 1: collide, wall, exit, traces, scatter, survivors
// (ops/bounce.py:COUNT_NAMES), then chunks_swept (the (search group, chunk)
// pairs whose chunk the group walked) and tile_bounces (the (search group,
// sub-bounce) pairs it ran), summed over the launch. Launches on `stream`,
// allocates nothing, does not synchronise; returns the first CUDA error,
// else cudaGetLastError().
extern "C" int vr_fused_bounce(
    const float* org, const float* dir, const float* weight, const float* w0,
    const unsigned char* alive, const unsigned char* hfb, const int* n_refl,
    const int* n_bdry, const float* uniforms, const float* prims,
    const float* chunk_bbs, const int* perm, const int* neighbors,
    const float* neighbor_pack, const float* walls, const float* stick_lanes,
    int n_rays, int npad, int pt, int n_prims, int k_nbrs, int n_sub,
    int kind, int dim, int first_dir, int second_dir, int ray_axis, int bc1,
    int bc2, int refl_kind, int max_refl, int max_bdry, int roulette,
    int deposit, float t_near, float sticking, float wthresh, float wrenew,
    float mfp, int group, const int* grid_start, const int* grid_lanes,
    int grid_nx, int grid_ny, int grid_nz, float grid_ox, float grid_oy,
    float grid_oz, float grid_cs, float* org_out,
    float* dir_out, float* weight_out, unsigned char* alive_out,
    unsigned char* hfb_out, int* n_refl_out, int* n_bdry_out, float* flux_out,
    int* hit_prim_out, float* wdep_out, float* thit_out,
    unsigned long long* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!deposit && n_sub != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (kind != kDisks && kind != kTriangles && kind != kLines &&
      kind != kDiskWindow) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (kind != kDisks && kind != kDiskWindow && k_nbrs != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (kind == kDiskWindow && (k_nbrs < 1 || (!deposit && !thit_out))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (refl_kind != kDiffuse && refl_kind != kSpecular &&
      refl_kind != kConedCosine) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, sizeof(unsigned long long) * ((size_t)n_prims + 9), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned int* wmax_bits = reinterpret_cast<unsigned int*>(scratch + n_prims);
  // deposits per ray and sub-bounce at most: the hit primitive and its K
  // neighbors, or the W slots of a window list
  const long long n_entries =
      (long long)n_rays * n_sub * (kind == kDiskWindow ? k_nbrs : k_nbrs + 1);

  if (n_rays > 0) {
    if (deposit) {
      const int grid = (n_rays + kSearchBlock - 1) / kSearchBlock;
      absmax_kernel<<<min(grid, 1024), kSearchBlock, 0, s>>>(w0, n_rays,
                                                             wmax_bits);
    }
    vr_bounce::BounceArgs a;
    a.org = org; a.dir = dir; a.weight = weight; a.w0 = w0;
    a.alive = alive; a.hfb = hfb; a.n_refl = n_refl; a.n_bdry = n_bdry;
    a.uniforms = uniforms;
    a.prims = prims; a.chunk_bbs = chunk_bbs; a.perm = perm;
    a.neighbors = neighbors; a.neighbor_pack = neighbor_pack; a.walls = walls;
    a.stick_lanes = stick_lanes;
    a.grid = GridWalk<float>{grid_start, grid_lanes, grid_nx, grid_ny,
                             grid_nz, grid_ox, grid_oy, grid_oz, grid_cs};
    a.n_rays = n_rays; a.npad = npad; a.pt = pt; a.n_prims = n_prims;
    a.k_nbrs = k_nbrs; a.n_sub = n_sub;
    a.dim = dim; a.first_dir = first_dir; a.second_dir = second_dir;
    a.ray_axis = ray_axis; a.bc1 = bc1; a.bc2 = bc2; a.refl_kind = refl_kind;
    a.max_refl = max_refl; a.max_bdry = max_bdry; a.roulette = roulette;
    a.deposit = deposit;
    a.t_near = t_near; a.sticking = sticking; a.wthresh = wthresh;
    a.wrenew = wrenew; a.mfp = mfp;
    a.org_out = org_out; a.dir_out = dir_out; a.weight_out = weight_out;
    a.alive_out = alive_out; a.hfb_out = hfb_out; a.n_refl_out = n_refl_out;
    a.n_bdry_out = n_bdry_out;
    a.hit_prim_out = hit_prim_out; a.wdep_out = wdep_out;
    a.thit_out = thit_out;
    a.bins = scratch; a.wmax_bits = wmax_bits; a.n_entries = n_entries;
    a.counts = scratch + n_prims + 1;
    // the coned-cosine reflection and the scattering live in the kFull
    // instantiation alone
    const bool full = refl_kind == kConedCosine || mfp > 0.0f;
    int bad = 0;
    if (kind == kDisks) {
      bad = vr_bounce::launch_disks(full, group, s, a);
    } else if (kind == kDiskWindow) {
      bad = vr_bounce::launch_window(full, group, s, a);
    } else if (kind == kTriangles) {
      bad = vr_bounce::launch_tris(full, group, s, a);
    } else {
      bad = vr_bounce::launch_lines(full, group, s, a);
    }
    if (bad != 0) return bad;
  }
  if (deposit && n_prims > 0) {
    finalize_kernel<<<(n_prims + 255) / 256, 256, 0, s>>>(
        scratch, wmax_bits, n_entries, n_prims, flux_out);
  }
  return static_cast<int>(cudaGetLastError());
}
