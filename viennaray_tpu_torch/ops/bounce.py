"""Whole bounces of a ray batch: plain version and CUDA wrapper.

Counterpart of ``viennaray_tpu/ops/pallas_bounce.py`` for disks, triangles and
2D line segments (the geometry's ``kind``), under the neighbor flux model and,
for disks, the window flux model.

- ``bounce_step`` is one bounce of every ray on tensors: search bound,
  closest hit, event (geometry / wall / escape), gas scattering, wall
  handling, backface pass or kill, the deposit weight, reflection (diffuse,
  specular or coned-cosine), sticking (one value or one per primitive),
  roulette, state update. The unfused wavefront body of ``trace/kernel.py`` calls it once per
  iteration; ``fused_bounce_ref`` calls it ``n_sub`` times.
- ``fused_bounce_ref`` is the plain PyTorch version of the fused kernel.
- ``fused_bounce`` wraps the CUDA kernel ``csrc/bounce.cu``: on CUDA tensors
  it launches the kernel or raises, on CPU tensors it runs the plain version.

Deposits have two placements. Handed out (``deposit_in_kernel=False``, one
bounce per launch): the launch returns each ray's (hit primitive or -1,
deposit weight) and the caller lands them with ``deposit_entries`` and the
histogram kernel. In the kernel (``deposit_in_kernel=True``, any ``n_sub``):
the launch returns the flux of all its sub-bounces, in original numbering.
For disks both follow the neighbor-list contract (rayTraceKernel.hpp:255-300):
the hit disk takes the pre-sticking weight, and so does every disk of its
neighbor list that passes ``intersect.check_local_intersection`` against the
ray as it was before that bounce. Under the window flux model
(``BounceSettings.window``, the GPU candidate-window contract,
GeneralPipelineDisk.cu:51-59) every disk that ray crosses with
t_near < t <= t_hit + tau takes it, with no facing test: the hit disk's window
list (``DiskGeometry.with_window_list``) holds them all, and the search's own
hit test (``intersect.disk_hit_packed``) re-tests its records. For triangles
and lines the single closest hit takes it (rayTraceKernel.hpp:301-307).

What else differs for triangles and lines (rayTraceKernel.hpp:243-248): a hit
from behind always kills (no pass-through, ``hfb`` is never set), and the hit
normal is the STORED normal, which may oppose a triangle's ``cross(e1, e2)``.

Gas scattering (``mean_free_path > 0``, rayTraceKernel.hpp:179-203) is decided
after the event and before the walls: a ray that does not escape scatters
with probability 1 - exp(-t / mfp) of its event's distance t. A scattering
ray takes no wall and no geometry event: it moves to org + dir * u (u the
probability draw itself, the reference's arithmetic) and flies on in a
direction uniform on the sphere (flattened and renormalised in 2D).

Numbers: the plain version does one float32 operation per tensor op, in a
fixed order (``vec.dot`` sums (x + y) + z), and the kernel repeats those
operations with round-to-nearest intrinsics, IEEE division and square root.
Only ``sinf`` / ``cosf`` of the diffuse and coned-cosine reflections and of
the scattering direction, and ``expf`` of the scattering probability, come
from two libraries.

Float64: ``bounce_step`` and ``hit_time`` run in the state's type, which
follows the geometry's (the float64 trace: a geometry widened by
``to(torch.float64)``, its walls, uniforms and sticking in float64; the
constants ``t_near``, the mean free path and the guards are float64 values,
the float32 values of the JAX package's float64 path, ``BIG`` and the
re-test's ``float32(1e-6)``, are widened as there). ``fused_bounce`` is
float32 only, as the JAX package's megakernel is: the float64 trace takes
the unfused body.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .. import _build
from ..config import BoundaryCondition, ReflectionKind, get_trace_settings
from ..physics import reflection
from . import intersect, vec
from . import sampling
from .nearest_hit import (
    BIG,
    LINE_ROWS,
    PRIM_ROWS,
    TRI_ROWS,
    disk_nearest_hit_ref,
    line_nearest_hit_ref,
    triangle_nearest_hit_ref,
)

# per geometry kind: the kernel's `kind` argument, the SoA's rows, the plain
# closest-hit search
_KINDS = {
    "disk": (0, PRIM_ROWS, disk_nearest_hit_ref),
    "triangle": (1, TRI_ROWS, triangle_nearest_hit_ref),
    "line": (2, LINE_ROWS, line_nearest_hit_ref),
}
# the kernel's `kind` argument of disks under the window flux model
WINDOW_KIND = 3

# order of the counts a launch returns (int64): the five events summed over
# lanes and sub-bounces, then the lanes still alive after the launch, then
# how hard the kernel's search worked: the (search group, chunk) pairs whose
# chunk the group walked and the (search group, sub-bounce) pairs it ran (a
# search group shares one chunk-skip decision: a warp of 32 rays under one
# thread per ray, one ray under a group of threads; ``group_for``). The plain
# version sweeps no chunks: it returns 0 for those two.
COUNT_NAMES = ("collide", "wall", "exit", "traces", "scatter", "survivors",
               "chunks_swept", "tile_bounces")
N_EVENTS = 5

# The kernel's group sizes G (threads that search for one ray) and the
# wrapper's choice (``group_for``). One thread per ray stages each chunk of
# the SoA once per block and tests it from shared memory, but skips a chunk
# only when none of a warp's 32 rays can enter it; a group of G threads
# reads the SoA from L1 and L2, skips for the one ray, and puts G times the
# threads on the card. On an H100 (``chip_diagnose.py --groups``, PERF.md)
# G = 32 was the fastest G of 1, 2, 4, 8, 16, 32 at every width below 65,536
# rays on all four kinds (512 x 16 disks 9.59 -> 0.22 ms), and at every
# width on the geometries of 12 and 18 chunks (triangles at 2^20 x 1:
# 21.57 -> 9.70 ms); one thread per ray stayed fastest from 65,536 rays up on
# the 6-chunk disks and the 2-chunk lines (disks at 2^20 x 1: 5.39 against
# 6.46 ms). Between 6 and 12 chunks nothing was measured: the rule takes 8.
GROUPS = (1, 32)
GROUP_ALL_WIDTHS_CHUNKS = 8  # from this many chunks on, every width: G = 32
GROUP_BELOW_WIDTH = 65536  # below this width, every geometry: G = 32


def group_for(n_rays: int, n_chunks: int) -> int:
    """The threads that search for one ray in a launch of ``n_rays`` on a
    geometry of ``n_chunks`` SoA chunks."""
    if n_rays < GROUP_BELOW_WIDTH or n_chunks >= GROUP_ALL_WIDTHS_CHUNKS:
        return 32
    return 1


class RayState(NamedTuple):
    """Per-ray state, one row per lane."""

    org: torch.Tensor  # (R, 3) float32 (float64 in the float64 trace)
    dirn: torch.Tensor  # (R, 3), the same type
    weight: torch.Tensor  # (R,), the same type
    w0: torch.Tensor  # (R,), the weight the ray started with
    alive: torch.Tensor  # (R,) bool
    hfb: torch.Tensor  # (R,) bool, the ray has passed a disk from behind
    #                    (never set on triangles and lines)
    n_refl: torch.Tensor  # (R,) int32
    n_bdry: torch.Tensor  # (R,) int32


class BounceSettings(NamedTuple):
    """The static settings of a bounce."""

    dim: int
    first_dir: int
    second_dir: int
    ray_axis: int
    bc1: int
    bc2: int
    refl_kind: int
    sticking: float
    t_near: float
    max_reflections: int
    max_boundary_hits: int
    roulette: bool
    weight_threshold_frac: float
    renew_weight_frac: float
    # the coned-cosine lobe's maximal angle, clipped to [1e-6, pi/2 - 1e-6]
    # (ref: kernel.py:1002-1004); read only where theta is sampled. The
    # unfused body's settings take the specular or diffuse model at the
    # limits instead (``from_config``)
    cone_angle: float = 1e-6
    # gas scattering's mean free path; <= 0: no scattering
    mean_free_path: float = -1.0
    # the window flux model (disks only; triangles and lines ignore it)
    window: bool = False

    @property
    def n_uni(self) -> int:
        """Uniforms per ray and sub-bounce: [reflection 1 or theta,
        reflection 2, roulette], and with gas scattering [scatter, scatter z,
        scatter phi] (ref: pallas_bounce.py:62-65)."""
        return 6 if self.mean_free_path > 0.0 else 3

    @classmethod
    def from_config(cls, config, particle, fused=True) -> "BounceSettings":
        """The settings of a trace's bounces. ``fused=False``: the unfused
        body's, where a coned-cosine particle at a cone angle <= 0 or >=
        pi/2 reflects with the specular or the diffuse model
        (``reflection.cone_limit_kind``); the fused kernel clips the angle
        instead, as the reference's kernel does."""
        ray_axis, first_dir, second_dir, _, _ = get_trace_settings(
            config.source_direction
        )
        refl_kind = ReflectionKind(particle.reflection_kind)
        if not fused and refl_kind == ReflectionKind.CONED_COSINE:
            limit = reflection.cone_limit_kind(particle.cone_angle)
            if limit is not None:
                refl_kind = limit
        bc2 = (
            config.boundary_conditions[second_dir]
            if config.dim == 3
            else BoundaryCondition.IGNORE
        )
        return cls(
            dim=config.dim, first_dir=first_dir, second_dir=second_dir,
            ray_axis=ray_axis,
            bc1=int(BoundaryCondition(config.boundary_conditions[first_dir])),
            bc2=int(BoundaryCondition(bc2)),
            refl_kind=int(refl_kind),
            # a tensor's value (the differentiable trace puts the tensor in);
            # a float keeps its float64 value: the float64 trace reads it
            # whole, a float32 trace rounds it to float32
            sticking=float(torch.as_tensor(particle.sticking,
                                           dtype=torch.float64).detach()),
            t_near=float(config.t_near),
            # the counters are int32
            max_reflections=min(int(config.max_reflections), 2**31 - 1),
            max_boundary_hits=min(int(config.max_boundary_hits), 2**31 - 1),
            roulette=bool(config.roulette),
            weight_threshold_frac=float(config.weight_threshold_frac),
            renew_weight_frac=float(config.renew_weight_frac),
            cone_angle=min(max(float(particle.cone_angle), 1e-6),
                           math.pi / 2 - 1e-6),
            mean_free_path=float(particle.mean_free_path),
            window=config.flux_model == "window",
        )

    def deposit_kind(self, geometry) -> str:
        """How a colliding ray deposits: "window" (disks under the window
        flux model), else the geometry's kind."""
        if geometry.kind == "disk" and self.window:
            return "window"
        return geometry.kind


class BounceResult(NamedTuple):
    state: RayState
    counts: torch.Tensor  # (8,) int64, see COUNT_NAMES
    flux: Optional[torch.Tensor]  # (n_prims,) float32, deposits in the kernel
    hit_prim: Optional[torch.Tensor]  # (R,) int32, -1 where no deposit
    wdep: Optional[torch.Tensor]  # (R,) float32
    # (R,) float32, the primary hit's t where a deposit is (0 elsewhere);
    # handed out by the window form only
    t_hit: Optional[torch.Tensor] = None


def make_walls(bbox, geometry, settings: BounceSettings):
    """The nine wall values of a launch, (9,) in the geometry's float type
    (``geometry.dtype``) on its device: [lo1 hi1 lo2 hi2 lo_r hi_r tau nbr2 r_over] of the source-adjusted
    bounding box ``bbox`` (2, 3). tau (1.1 grid_delta, the window model's
    width) and nbr2 ((2 disk_radius)^2) keep the reference's layout; r_over is
    how far a disk can reach beyond the box of the centres. All three are 0
    for triangles and lines, which lie inside the box of their vertices
    (ref: kernel.py:991-994)."""
    s = settings
    like = dict(dtype=geometry.dtype, device=geometry.device)
    if geometry.kind == "disk":
        tau = torch.tensor(1.1 * geometry.grid_delta, **like)
        nbr2 = torch.tensor((2.0 * geometry.disk_radius) ** 2, **like)
        r_over = torch.maximum(
            torch.tensor(geometry.disk_radius, **like), geometry.radii.max()
        )
    else:
        tau = nbr2 = r_over = torch.zeros((), **like)
    box = bbox.to(**like)
    return torch.stack([
        box[0, s.first_dir], box[1, s.first_dir],
        box[0, s.second_dir], box[1, s.second_dir],
        box[0, s.ray_axis], box[1, s.ray_axis],
        tau, nbr2, r_over,
    ])


def _wall_crossing(org, dirn, axis, lo, hi, t_near, big):
    """Crossing time of the next wall plane along one axis; BIG if parallel,
    behind, or closer than t_near (Embree skips hits below tnear)."""
    d = dirn[:, axis]
    o = org[:, axis]
    dsafe = torch.where(d == 0, torch.full_like(d, 1e-30), d)
    t = torch.where(
        d > 0.0, (hi - o) / dsafe, torch.where(d < 0.0, (lo - o) / dsafe, big)
    )
    return torch.where(t > t_near, t, big)


def entry_bound(org, dirn, walls, *, dim, first_dir, second_dir, ray_axis,
                t_near):
    """Search bound and wall crossings of every ray: (tmin0, t_w1, t_w2).

    The walls are FINITE rectangles spanning the box on the two lateral axes
    only (ref: rayBoundary.hpp:164-245, 8 triangles): a crossing whose hit
    point lies outside the rectangle (below the geometry, above the source
    plane) is no wall hit, and its time is BIG.

    ``tmin0`` bounds the search for the closest hit: every primitive lies inside
    the walls box inflated by ``r_over``, so no hit lies beyond the ray's exit
    of that box; and a hit beyond the nearest wall crossing never wins the
    event. Ties go to the geometry, so the bound sits a hair ABOVE the wall
    time: (1 + 1e-4) t + t_near.
    """
    big = torch.tensor(BIG, device=org.device)
    tn = torch.tensor(t_near, dtype=org.dtype, device=org.device)
    lo1, hi1, lo2, hi2, lo_r, hi_r = (walls[i] for i in range(6))

    def wall_t(axis, lo, hi, other_axis, other_lo, other_hi):
        t = _wall_crossing(org, dirn, axis, lo, hi, tn, big)
        hp_r = org[:, ray_axis] + dirn[:, ray_axis] * t
        ok = (hp_r >= lo_r) & (hp_r <= hi_r)
        if dim == 3:
            hp_o = org[:, other_axis] + dirn[:, other_axis] * t
            ok &= (hp_o >= other_lo) & (hp_o <= other_hi)
        return torch.where(ok, t, big)

    t_w1 = wall_t(first_dir, lo1, hi1, second_dir, lo2, hi2)
    if dim == 3:
        t_w2 = wall_t(second_dir, lo2, hi2, first_dir, lo1, hi1)
    else:
        t_w2 = big.expand(org.shape[0])

    r_inf = walls[8] + tn
    lows = {first_dir: lo1, second_dir: lo2, ray_axis: lo_r}
    highs = {first_dir: hi1, second_dir: hi2, ray_axis: hi_r}
    texit = None
    for ax in range(3):
        d = dirn[:, ax]
        dsafe = torch.where(d == 0, torch.full_like(d, 1e-30), d)
        e = torch.maximum(
            (highs[ax] + r_inf - org[:, ax]) / dsafe,
            (lows[ax] - r_inf - org[:, ax]) / dsafe,
        )
        texit = e if texit is None else torch.minimum(texit, e)
    tmin0 = (
        torch.minimum(torch.clamp(texit, min=0.0), torch.minimum(t_w1, t_w2))
        * (1.0 + 1e-4)
        + tn
    )
    return tmin0, t_w1, t_w2


def sticking_lanes(particle, geometry):
    """The per-lane sticking table of a launch: ``None`` for a particle with
    one sticking value, else (Npad,) in the geometry's float type in SORTED
    lane order, each primitive's material looked up in the particle's table
    (padding lanes read primitive 0; they are never hit)
    (ref: kernel.py:1005-1014)."""
    if particle.material_sticking is None:
        return None
    per_prim = particle.sticking_for(geometry.material_ids, geometry.dtype)
    return per_prim[geometry.soa_perm.long()].contiguous()


def hit_time(org, dirn, prim, geometry):
    """The hit time of each ray on the primitive ``prim`` (original
    numbering; -1 reads primitive 0), as a differentiable function of org,
    dirn and the geometry's own tensors. Disks: the plane-hit identity
    t = (n . c - n . o) / (d . n) on the centre and the stored normal, in
    the order of the search's own disk test (csrc/disk_hit.cuh), so that it
    gives the search's t; the JAX package's chip writes the same function as
    ((c - o) . n) / (d . n). Triangles: ((v0 - o) . n) / (d . n) on the first
    vertex (the triangle is planar). d . n == 0 reads 1e-30 (ref:
    viennaray_tpu/trace/kernel.py:585-593, 621-629). Lines: the segment's
    own t from p0 and p1 (ref: viennaray_tpu/ops/intersect.py:172-229), its
    denominator guarded alike."""
    pc = torch.clamp(prim, min=0).long()
    tiny = torch.tensor(1e-30, dtype=org.dtype, device=org.device)
    if geometry.kind == "line":
        p0 = geometry.p0[pc]
        ld = geometry.p1[pc] - p0
        denom = dirn[:, 0] * ld[:, 1] - dirn[:, 1] * ld[:, 0]
        denom = torch.where(denom == 0.0, tiny, denom)
        w = p0 - org
        return (w[:, 0] * ld[:, 1] - w[:, 1] * ld[:, 0]) / denom
    n = geometry.normals[pc]
    den = vec.dot(dirn, n)
    den = torch.where(den == 0.0, tiny, den)
    if geometry.kind == "disk":
        return (vec.dot(geometry.points[pc], n) - vec.dot(org, n)) / den
    v0 = geometry.vertices[geometry.triangles[pc, 0].long()]
    return vec.dot(v0 - org, n) / den


def bounce_step(state: RayState, u, geometry, walls, settings, search,
                stick_lanes=None, reflect=None, differentiable=False):
    """One bounce of every lane.

    u: (R, n_uni) uniforms [reflection 1 (coned-cosine: theta), reflection
    2, roulette], and with gas scattering [scatter, scatter z, scatter phi].
    ``search`` is the closest-hit function of the geometry's kind
    (``disk_nearest_hit``, ``triangle_nearest_hit``, ``line_nearest_hit`` or
    a plain version). ``stick_lanes``: ``sticking_lanes``. ``reflect``: a
    custom particle's reflection, ``reflect(dirn, normal, prim, weight,
    collide) -> (sticking (R,), new direction (R, 3))`` in place of the
    built-in reflection and sticking (the sticking update, the reflection
    cap and the roulette stay); ``prim`` is the hit primitive in original
    numbering, meaningless where ``collide`` is False. Returns (new
    state, hit_prim (R,) int32: the primitive that takes a deposit or -1,
    wdep (R,) float32: the pre-sticking weight it takes, t_hit (R,) float32:
    its hit time (0 where no deposit), counts (5,) int64: collide, wall,
    exit, traces, scatter). Dead lanes pass through unchanged.

    ``differentiable``: the closest-hit search runs on detached rays (the
    hit's selection is piecewise constant, and the kernels see no tensor
    that requires a gradient), then the hit time is recomputed from the
    selected primitive by ``hit_time``, as the JAX package's differentiable
    trace does on its chip (ref: viennaray_tpu/trace/kernel.py:542-629).
    Gradients then reach org, dirn, the geometry's points and normals (the
    hit time, the hit point, the reflection) and the sticking, which may be
    a tensor: ``settings.sticking`` (0-d) or ``stick_lanes``.
    """
    s = settings
    org, dirn, weight, w0, alive, hfb, n_refl, n_bdry = state
    dev = org.device
    Rb = org.shape[0]
    big = torch.tensor(BIG, device=dev)
    lo1, hi1, lo2, hi2 = (walls[i] for i in range(4))

    # ---- 1. search bound and wall crossings ------------------------------
    tmin0, t_w1, t_w2 = entry_bound(
        org, dirn, walls, dim=s.dim, first_dir=s.first_dir,
        second_dir=s.second_dir, ray_axis=s.ray_axis, t_near=s.t_near,
    )

    # ---- 2. closest hit below the bound (ref: rayTraceKernel.hpp:163-167)
    o_search, d_search = (
        (org.detach(), dirn.detach()) if differentiable else (org, dirn))
    t_geo, prim, hit_geo = search(
        o_search.contiguous(), d_search.contiguous(), geometry.prims_soa,
        geometry.soa_perm, geometry.soa_chunk_bbs, t_near=s.t_near,
    )
    if differentiable:
        t_geo = hit_time(org, dirn, prim, geometry)
    hit_geo = hit_geo & (t_geo < tmin0)

    # ---- 3. event: geometry wins ties over the walls, wall 1 over wall 2,
    # written out rather than left to argmin's choice among equal values
    t_geo_m = torch.where(hit_geo, t_geo, big)
    geo_first = (t_geo_m <= t_w1) & (t_geo_m <= t_w2)
    w1_first = t_w1 <= t_w2
    t_ev = torch.minimum(t_geo_m, torch.minimum(t_w1, t_w2))
    escaped = t_ev >= big  # no hit anywhere (Embree miss)

    is_exit = alive & escaped

    # ---- 3b. gas scattering (ref: rayTraceKernel.hpp:179-203): a ray that
    # scatters on its way takes neither the wall nor the geometry event
    if s.mean_free_path > 0.0:
        u_scat = u[:, 3]
        mfp = torch.tensor(s.mean_free_path, dtype=org.dtype, device=dev)
        p_scat = 1.0 - torch.exp(-t_ev / mfp)
        scattering = alive & ~escaped & (u_scat < p_scat)
        scatter_org = org + dirn * u_scat[:, None]
        scatter_dir = sampling.unit_sphere(u[:, 4], u[:, 5])
        if s.dim == 2:
            scatter_dir[:, 2] = 0.0
            scatter_dir = vec.normalize(scatter_dir, eps=1e-12)
        hits = alive & ~escaped & ~scattering
    else:
        scattering = None
        hits = alive & ~escaped

    is_geo_ev = hits & geo_first
    is_wall1 = hits & ~geo_first & w1_first
    is_wall2 = hits & ~geo_first & ~w1_first
    is_wall = is_wall1 | is_wall2

    hitpoint = org + dirn * t_ev[:, None]

    # ---- 4. boundary processing (ref: rayBoundary.hpp:29-127) ------------
    n_bdry_new = n_bdry + is_wall.to(torch.int32)
    bdry_overflow = is_wall & (n_bdry_new > s.max_boundary_hits)

    # the deposits read the pre-bounce org and dirn: new_org and new_dir are
    # fresh tensors, never views of them
    new_org = org
    new_dir = dirn
    dead = torch.zeros(Rb, dtype=torch.bool, device=dev)

    def apply_wall(mask, axis, lo, hi, bc, new_org, new_dir, dead):
        if bc == BoundaryCondition.REFLECTIVE:
            new_org = torch.where(mask[:, None], hitpoint, new_org)
            flipped = new_dir.clone()
            flipped[:, axis] = -flipped[:, axis]
            new_dir = torch.where(mask[:, None], flipped, new_dir)
        elif bc == BoundaryCondition.PERIODIC:
            moved = hitpoint.clone()
            moved[:, axis] = torch.where(dirn[:, axis] > 0, lo, hi)
            new_org = torch.where(mask[:, None], moved, new_org)
        else:  # IGNORE -> terminate (ref: rayBoundary.hpp:66-69)
            dead = dead | mask
        return new_org, new_dir, dead

    new_org, new_dir, dead = apply_wall(
        is_wall1 & ~bdry_overflow, s.first_dir, lo1, hi1, s.bc1,
        new_org, new_dir, dead,
    )
    if s.dim == 3:
        new_org, new_dir, dead = apply_wall(
            is_wall2 & ~bdry_overflow, s.second_dir, lo2, hi2, s.bc2,
            new_org, new_dir, dead,
        )

    # ---- 5. surface interaction: a disk's first hit from behind passes
    # through, the second kills (ref: rayTraceKernel.hpp:225-241); a
    # triangle's or a line's hit from behind always kills (:243-248). The
    # normal is the stored one.
    n_hit = geometry.normals[prim.long()]
    backface = vec.dot(dirn, n_hit) > 0.0
    if geometry.kind == "disk":
        bf_kill = is_geo_ev & backface & hfb
        bf_pass = is_geo_ev & backface & ~hfb
    else:
        bf_kill = is_geo_ev & backface
        bf_pass = torch.zeros(Rb, dtype=torch.bool, device=dev)
    collide = is_geo_ev & ~backface

    # the deposit: the weight before sticking, where the ray collides
    hit_prim = torch.where(collide, prim, torch.full_like(prim, -1))
    wdep = torch.where(collide, weight, torch.zeros_like(weight))
    t_hit = torch.where(collide, t_geo, torch.zeros_like(t_geo))

    # ---- 6. reflection + sticking (ref: rayTraceKernel.hpp:309-335) ------
    if reflect is not None:
        sticking, refl_dir = reflect(dirn, n_hit, prim, weight, collide)
    else:
        if s.refl_kind == ReflectionKind.DIFFUSE:
            refl_dir = reflection.diffuse(u[:, 0], u[:, 1], n_hit, s.dim)
        elif s.refl_kind == ReflectionKind.SPECULAR:
            refl_dir = reflection.specular(dirn, n_hit, s.dim)
        else:  # coned-cosine: theta arrives where the diffuse model's u1 does
            refl_dir = reflection.coned_cosine(u[:, 0], u[:, 1], dirn, n_hit,
                                               s.dim)
        if stick_lanes is None:
            sticking = s.sticking
        else:
            sticking = stick_lanes[geometry.soa_inv_perm[prim.long()].long()]
    new_weight = weight - weight * sticking
    died_absorb = collide & (new_weight <= 0.0)
    n_refl_new = n_refl + collide.to(torch.int32)
    died_max_refl = collide & (n_refl_new > s.max_reflections)

    # Russian roulette (ref: rejectionControl, rayTraceKernel.hpp:435-460)
    if s.roulette:
        low = s.weight_threshold_frac * w0
        renew = s.renew_weight_frac * w0
        needs_roulette = collide & (new_weight < low)
        kill_prob = 1.0 - new_weight / torch.clamp(renew, min=1e-30)
        died_roulette = needs_roulette & (u[:, 2] < kill_prob)
        renewed = needs_roulette & ~died_roulette
        new_weight = torch.where(renewed, renew, new_weight)
    else:
        died_roulette = torch.zeros(Rb, dtype=torch.bool, device=dev)

    survived_collide = (
        collide & ~died_absorb & ~died_max_refl & ~died_roulette
    )

    # ---- 7. state update -------------------------------------------------
    new_org = torch.where(
        (bf_pass | survived_collide)[:, None], hitpoint, new_org
    )
    new_dir = torch.where(survived_collide[:, None], refl_dir, new_dir)
    if scattering is not None:
        new_org = torch.where(scattering[:, None], scatter_org, new_org)
        new_dir = torch.where(scattering[:, None], scatter_dir, new_dir)
    if s.dim == 2:
        zeroed = new_dir.clone()
        zeroed[:, 2] = 0.0
        flat = zeroed / torch.clamp(vec.norm(zeroed)[:, None], min=1e-12)
        new_dir = torch.where(alive[:, None], flat, new_dir)

    weight_out = torch.where(collide, new_weight, weight)
    hfb_out = hfb | bf_pass
    dead = (
        dead | is_exit | bdry_overflow | bf_kill | died_absorb
        | died_max_refl | died_roulette
    )
    alive_out = alive & ~dead

    counts = torch.stack([
        collide.sum(), is_wall.sum(), is_exit.sum(), alive.sum(),
        torch.zeros_like(alive.sum()) if scattering is None
        else scattering.sum(),
    ])
    new_state = RayState(
        new_org, new_dir, weight_out, w0, alive_out, hfb_out, n_refl_new,
        n_bdry_new,
    )
    return new_state, hit_prim, wdep, t_hit, counts


def deposit_entries(org, dirn, hit_prim, wdep, geometry, t_hit=None,
                    settings=None, use_wdist=False, differentiable=False):
    """The histogram entries of one bounce's deposits: (ids, w).

    org, dirn: the rays as they were BEFORE the bounce; t_hit: the primary
    hit's t (``bounce_step``), read by the window model and by ``use_wdist``;
    settings: the bounce's ``BounceSettings``, read by the window model.

    Disks, neighbor model: both (R * (K + 1),), for the hit disk and its K
    neighbor slots. Per ray the hit disk takes ``wdep``, and so does every
    disk of its neighbor list that passes the local re-test; every other
    slot carries weight 0. With ``use_wdist`` (1/distance weighting, ref:
    kernel.py:786-808) the weights become wdep / d / sum(1 / d) * hits, d the
    distance of the hit point from the hit disk's centre, or of the neighbor
    plane's crossing from the neighbor's, plus 1e-6.

    Disks, window model: both (R * W,), one slot per disk of the hit disk's
    window list (itself included): a disk the ray crosses with
    t_near < t <= t_hit + tau takes ``wdep``, every other slot weight 0.

    Triangles and lines: both (R,), the single closest hit (ref:
    kernel.py:1216-1217); a ray without a deposit carries weight 0 into bin 0.

    ``differentiable``: the window model re-tests its list on the geometry's
    points, normals and radii, which the JAX package's window deposit reads
    (kernel.py:752-762), instead of the packed records, so that a driver's
    points or normals leaf reaches it; the neighbor records stay packed, as
    the reference's do.
    """
    n_prims = geometry.num_primitives
    if geometry.kind != "disk":
        return torch.clamp(hit_prim, min=0), wdep
    R = org.shape[0]
    collide = hit_prim >= 0
    prim_c = torch.clamp(hit_prim, min=0).long()
    zero = torch.zeros((), dtype=wdep.dtype, device=wdep.device)
    if settings is not None and settings.deposit_kind(geometry) == "window":
        W = geometry.window_ids.shape[1]
        listed = geometry.window_ids[prim_c]
        ids = torch.clamp(listed, 0, n_prims - 1)
        if differentiable:
            c = geometry.points[ids]
            n = geometry.normals[ids]
            r = geometry.radii[ids]
            rec = torch.cat([c, n, (r * r)[..., None],
                             vec.dot(c, n)[..., None]], dim=-1)
        else:
            rec = geometry.window_pack[prim_c].reshape(R, W, 8)
        ok, t = intersect.disk_hit_packed(org, dirn, rec, settings.t_near)
        tau = torch.tensor(geometry.window_tau, dtype=org.dtype,
                           device=org.device)
        ok = (ok & (t <= (t_hit + tau)[:, None]) & collide[:, None]
              & (listed >= 0))
        return ids.reshape(-1), torch.where(ok, wdep[:, None], zero).reshape(-1)
    K = geometry.neighbors.shape[1]
    rec = geometry.neighbor_pack[prim_c].reshape(R, K, 8)
    nb_ok, nb_dist = intersect.check_neighbors_packed(org, dirn, rec)
    nb_ok = nb_ok & collide[:, None]
    hits = torch.cat([collide[:, None], nb_ok], dim=1)
    if use_wdist:
        hitpoint = org + dirn * t_hit[:, None]
        prim_dist = vec.norm(hitpoint - geometry.points[prim_c]) + 1e-6
        dists = torch.cat([prim_dist[:, None], nb_dist + 1e-6], dim=1)
        inv_sum = torch.where(hits, 1.0 / dists, zero).sum(dim=1, keepdim=True)
        num_hits = hits.sum(dim=1, keepdim=True).to(wdep.dtype)
        w_all = (wdep[:, None] / dists / torch.clamp(inv_sum, min=1e-30)
                 * num_hits)
        w_all = torch.where(hits, w_all, zero)
    else:
        w_all = torch.where(hits, wdep[:, None], zero)
    nb_c = torch.clamp(geometry.neighbors[prim_c], 0, n_prims - 1)
    ids_all = torch.cat([prim_c[:, None].to(torch.int32), nb_c], dim=1)
    return ids_all.reshape(-1), w_all.reshape(-1)


def _deposit_tables(geometry, settings):
    """(ids, records) the kernel's deposit gathers: the window list under the
    window model, else the neighbor list of disks; None for triangles and
    lines."""
    kind = settings.deposit_kind(geometry)
    if kind == "window":
        if geometry.window_pack is None:
            raise ValueError(
                "the window flux model needs the geometry's window list: "
                "call geometry.with_window_list()"
            )
        return geometry.window_ids, geometry.window_pack
    if kind == "disk":
        return geometry.neighbors, geometry.neighbor_pack
    return None


def _check_inputs(state, uniforms, geometry, walls, settings, n_sub,
                  deposit_in_kernel, stick_lanes):
    """Shape, type, device and contiguity the kernel takes; raises otherwise."""
    ReflectionKind(settings.refl_kind)  # raises on a kind that is none
    if n_sub < 1:
        raise ValueError("n_sub must be at least 1")
    if not deposit_in_kernel and n_sub != 1:
        raise ValueError("deposits can be handed out only with n_sub == 1")
    org = state.org
    R = org.shape[0]
    if org.ndim != 2 or org.shape[1] != 3:
        raise ValueError("org must be (R, 3)")
    n_prims = geometry.num_primitives
    rows = _KINDS[geometry.kind][1]
    npad = geometry.prims_soa.shape[1]
    n_chunks = geometry.soa_chunk_bbs.shape[0]
    if n_chunks == 0 or npad % n_chunks:
        raise ValueError("Npad must be a whole number of chunks")
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    optional_tables = ()
    if stick_lanes is not None:
        optional_tables = (("stick_lanes", stick_lanes, (npad,), f32),)
    tables = _deposit_tables(geometry, settings)
    if tables is not None:
        K = tables[0].shape[1]
        optional_tables += (
            ("deposit ids", tables[0], (n_prims, K), i32),
            ("deposit records", tables[1], (n_prims, K * 8), f32),
        )
    for name, x, shape, dt in (
        ("org", org, (R, 3), f32), ("dirn", state.dirn, (R, 3), f32),
        ("weight", state.weight, (R,), f32), ("w0", state.w0, (R,), f32),
        ("alive", state.alive, (R,), b8), ("hfb", state.hfb, (R,), b8),
        ("n_refl", state.n_refl, (R,), i32),
        ("n_bdry", state.n_bdry, (R,), i32),
        ("uniforms", uniforms, (R, settings.n_uni * n_sub), f32),
        ("prims_soa", geometry.prims_soa, (rows, npad), f32),
        ("soa_perm", geometry.soa_perm, (npad,), i32),
        ("soa_chunk_bbs", geometry.soa_chunk_bbs, (n_chunks, 8), f32),
        ("normals", geometry.normals, (n_prims, 3), f32),
        ("walls", walls, (9,), f32),
        *optional_tables,
    ):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")
        if x.device != org.device:
            raise ValueError(f"{name} is on {x.device}, org on {org.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_bounce_ref(state: RayState, uniforms, geometry, walls, settings,
                     n_sub: int = 1, deposit_in_kernel: bool = True,
                     stick_lanes=None):
    """Plain PyTorch version of ``fused_bounce``, on any device: ``n_sub``
    applications of ``bounce_step``. Deposits in the kernel are summed in
    float64 over all sub-bounces and rounded to float32 once, as the kernel's
    fixed-point bins are."""
    n_uni = settings.n_uni
    counts = torch.zeros(len(COUNT_NAMES), dtype=torch.int64,
                         device=state.org.device)
    acc = torch.zeros(
        geometry.num_primitives, dtype=torch.float64, device=state.org.device
    )
    hit_prim = wdep = t_hit = None
    search = _KINDS[geometry.kind][2]
    for k in range(n_sub):
        org, dirn = state.org, state.dirn
        state, hit_prim, wdep, t_hit, step_counts = bounce_step(
            state, uniforms[:, n_uni * k: n_uni * (k + 1)], geometry, walls,
            settings, search, stick_lanes,
        )
        counts[:N_EVENTS] += step_counts
        if deposit_in_kernel:
            ids, w = deposit_entries(org, dirn, hit_prim, wdep, geometry,
                                     t_hit, settings)
            acc.index_add_(0, ids.long(), w.double())
    counts[N_EVENTS] = state.alive.sum()
    if deposit_in_kernel:
        return BounceResult(state, counts, acc.float(), None, None)
    if settings.deposit_kind(geometry) != "window":
        t_hit = None
    return BounceResult(state, counts, None, hit_prim, wdep, t_hit)


def fused_bounce(state: RayState, uniforms, geometry, walls, settings,
                 n_sub: int = 1, deposit_in_kernel: bool = True,
                 stick_lanes=None, group=None):
    """Advance every ray through ``n_sub`` whole bounces; any R.

    state: ``RayState``; uniforms (R, n_uni n_sub) float32 with the columns
    of ``BounceSettings.n_uni`` per sub-bounce (column 0 carries the sampled
    theta of a coned-cosine particle); geometry: a ``DiskGeometry``, a
    ``TriangleGeometry`` or a ``LineGeometry`` on the rays' device (its
    ``kind`` picks the kernel's instantiation, and the settings' ``window``
    the window form on disks, which needs ``with_window_list``); walls:
    ``make_walls``;
    settings: ``BounceSettings``; stick_lanes: ``sticking_lanes`` (``None``:
    the settings' one value). Returns a ``BounceResult`` with fresh tensors: the new
    state, the counts (``COUNT_NAMES``), and either the flux (n_prims,) in
    original numbering (``deposit_in_kernel``) or, with ``n_sub == 1``, each
    ray's (hit primitive or -1, deposit weight), and in the window form its
    hit time, for ``deposit_entries``. Weights must be finite and never
    exceed their ray's ``w0``.

    On CUDA tensors this launches the kernel of ``csrc/bounce.cu`` (or
    raises); on CPU tensors it runs the plain version. Two calls on the same
    inputs give bitwise the same outputs on either device. ``group`` (one of
    ``GROUPS``; None: ``group_for``) forces the threads per ray, to
    compare two mappings: every G gives the same outputs bit for bit but the
    two search counts. The trace never sets it.
    """
    state = RayState(*state)
    s = settings
    _check_inputs(state, uniforms, geometry, walls, settings, n_sub,
                  deposit_in_kernel, stick_lanes)
    if group is not None and group not in GROUPS:
        raise ValueError(f"group must be one of {GROUPS}, got {group}")
    dev = state.org.device
    if dev.type == "cpu":
        return fused_bounce_ref(
            state, uniforms, geometry, walls, settings, n_sub,
            deposit_in_kernel, stick_lanes,
        )
    if dev.type != "cuda":
        raise RuntimeError(f"fused_bounce: unsupported device {dev}")
    R = state.org.shape[0]
    n_prims = geometry.num_primitives
    npad = geometry.prims_soa.shape[1]
    window = settings.deposit_kind(geometry) == "window"
    tables = _deposit_tables(geometry, settings)
    if tables is not None:  # the neighbor or the window list
        K = tables[0].shape[1]
        neighbor_ptrs = (tables[0].data_ptr(), tables[1].data_ptr())
    else:  # the single closest hit: no tables
        K = 0
        neighbor_ptrs = (None, None)
    new = RayState(*(torch.empty_like(x) for x in state[:3]), state.w0,
                   *(torch.empty_like(x) for x in state[4:]))
    # n_prims fixed-point bins, the largest w0, the counts; cleared by the
    # kernel's entry
    scratch = torch.empty(n_prims + 1 + len(COUNT_NAMES), dtype=torch.int64,
                          device=dev)
    t_hit = None
    if deposit_in_kernel:
        flux = torch.empty(n_prims, dtype=torch.float32, device=dev)
        hit_prim = wdep = None
        outs = (flux.data_ptr(), None, None, None)
    else:
        flux = None
        hit_prim = torch.empty(R, dtype=torch.int32, device=dev)
        wdep = torch.empty(R, dtype=torch.float32, device=dev)
        if window:
            t_hit = torch.empty(R, dtype=torch.float32, device=dev)
        outs = (None, hit_prim.data_ptr(), wdep.data_ptr(),
                None if t_hit is None else t_hit.data_ptr())
    n_chunks = geometry.soa_chunk_bbs.shape[0]
    g = group_for(R, n_chunks) if group is None else group
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.vr_fused_bounce(
            state.org.data_ptr(), state.dirn.data_ptr(),
            state.weight.data_ptr(), state.w0.data_ptr(),
            state.alive.data_ptr(), state.hfb.data_ptr(),
            state.n_refl.data_ptr(), state.n_bdry.data_ptr(),
            uniforms.data_ptr(), geometry.prims_soa.data_ptr(),
            geometry.soa_chunk_bbs.data_ptr(), geometry.soa_perm.data_ptr(),
            *neighbor_ptrs, walls.data_ptr(),
            None if stick_lanes is None else stick_lanes.data_ptr(),
            R, npad, npad // n_chunks, n_prims, K,
            n_sub, WINDOW_KIND if window else _KINDS[geometry.kind][0],
            s.dim, s.first_dir,
            s.second_dir, s.ray_axis, s.bc1, s.bc2, int(s.refl_kind),
            s.max_reflections, s.max_boundary_hits, int(s.roulette),
            int(deposit_in_kernel),
            s.t_near, s.sticking, s.weight_threshold_frac,
            s.renew_weight_frac, max(s.mean_free_path, 0.0),
            g, new.org.data_ptr(), new.dirn.data_ptr(), new.weight.data_ptr(),
            new.alive.data_ptr(), new.hfb.data_ptr(), new.n_refl.data_ptr(),
            new.n_bdry.data_ptr(), *outs, scratch.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"vr_fused_bounce: CUDA error {err}")
    fused_bounce.launches += 1
    fused_bounce.sub_bounces += n_sub
    fused_bounce.launches_by_group[g] += 1
    return BounceResult(new, scratch[n_prims + 1:], flux, hit_prim, wdep,
                        t_hit)


fused_bounce.launches = 0  # kernel launches
fused_bounce.sub_bounces = 0  # bounces those launches ran, n_sub each
fused_bounce.launches_by_group = dict.fromkeys(GROUPS, 0)  # launches by G
