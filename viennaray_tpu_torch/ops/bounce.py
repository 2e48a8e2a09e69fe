"""Whole bounces of a ray batch: plain version and CUDA wrapper.

Counterpart of ``viennaray_tpu/ops/pallas_bounce.py`` for disks.

- ``bounce_step`` is one bounce of every ray on tensors: search bound,
  closest disk hit, event (geometry / wall / escape), wall handling, backface
  pass or kill, the deposit weight, reflection, sticking, roulette, state
  update. The unfused wavefront body of ``trace/kernel.py`` calls it once per
  iteration; ``fused_bounce_ref`` calls it ``n_sub`` times.
- ``fused_bounce_ref`` is the plain PyTorch version of the fused kernel.
- ``fused_bounce`` wraps the CUDA kernel ``csrc/bounce.cu``: on CUDA tensors
  it launches the kernel or raises, on CPU tensors it runs the plain version.

Deposits have two placements. Handed out (``deposit_in_kernel=False``, one
bounce per launch): the launch returns each ray's (hit disk or -1, deposit
weight) and the caller lands them with ``deposit_entries`` and the histogram
kernel. In the kernel (``deposit_in_kernel=True``, any ``n_sub``): the launch
returns the flux of all its sub-bounces, in original disk numbering. Both
follow the neighbor-list contract (rayTraceKernel.hpp:255-300): the hit disk
takes the pre-sticking weight, and so does every disk of its neighbor list
that passes ``intersect.check_local_intersection`` against the ray as it was
before that bounce.

Numbers: the plain version does one float32 operation per tensor op, in a
fixed order (``vec.dot`` sums (x + y) + z), and the kernel repeats those
operations with round-to-nearest intrinsics, IEEE division and square root.
Only ``sinf`` / ``cosf`` of the diffuse reflection come from two libraries.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import _build
from ..config import BoundaryCondition, ReflectionKind, get_trace_settings
from ..physics import reflection
from . import intersect, vec
from .nearest_hit import BIG, PRIM_ROWS, disk_nearest_hit_ref

# order of the counts a launch returns (int64): events summed over lanes and
# sub-bounces, and the lanes still alive after the launch
COUNT_NAMES = ("collide", "wall", "exit", "traces", "survivors")


class RayState(NamedTuple):
    """Per-ray state, one row per lane."""

    org: torch.Tensor  # (R, 3) float32
    dirn: torch.Tensor  # (R, 3) float32
    weight: torch.Tensor  # (R,) float32
    w0: torch.Tensor  # (R,) float32, the weight the ray started with
    alive: torch.Tensor  # (R,) bool
    hfb: torch.Tensor  # (R,) bool, the ray has passed a disk from behind
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

    @classmethod
    def from_config(cls, config, particle) -> "BounceSettings":
        ray_axis, first_dir, second_dir, _, _ = get_trace_settings(
            config.source_direction
        )
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
            refl_kind=int(ReflectionKind(particle.reflection_kind)),
            sticking=float(particle.sticking), t_near=float(config.t_near),
            # the counters are int32
            max_reflections=min(int(config.max_reflections), 2**31 - 1),
            max_boundary_hits=min(int(config.max_boundary_hits), 2**31 - 1),
            roulette=bool(config.roulette),
            weight_threshold_frac=float(config.weight_threshold_frac),
            renew_weight_frac=float(config.renew_weight_frac),
        )


class BounceResult(NamedTuple):
    state: RayState
    counts: torch.Tensor  # (5,) int64, see COUNT_NAMES
    flux: Optional[torch.Tensor]  # (n_prims,) float32, deposits in the kernel
    hit_prim: Optional[torch.Tensor]  # (R,) int32, -1 where no deposit
    wdep: Optional[torch.Tensor]  # (R,) float32


def make_walls(bbox, geometry, settings: BounceSettings):
    """The nine wall values of a launch, (9,) float32 on the geometry's
    device: [lo1 hi1 lo2 hi2 lo_r hi_r tau nbr2 r_over] of the source-adjusted
    bounding box ``bbox`` (2, 3). tau (1.1 grid_delta, the window model's
    width) and nbr2 ((2 disk_radius)^2) keep the reference's layout; r_over is
    how far a disk can reach beyond the box of the centres."""
    s = settings
    f32 = dict(dtype=torch.float32, device=geometry.device)
    r_over = torch.maximum(
        torch.tensor(geometry.disk_radius, **f32), geometry.radii.max()
    )
    return torch.stack([
        bbox[0, s.first_dir], bbox[1, s.first_dir],
        bbox[0, s.second_dir], bbox[1, s.second_dir],
        bbox[0, s.ray_axis], bbox[1, s.ray_axis],
        torch.tensor(1.1 * geometry.grid_delta, **f32),
        torch.tensor((2.0 * geometry.disk_radius) ** 2, **f32),
        r_over,
    ]).to(torch.float32)


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

    ``tmin0`` bounds the search for the closest disk: every disk lies inside
    the walls box inflated by ``r_over``, so no hit lies beyond the ray's exit
    of that box; and a hit beyond the nearest wall crossing never wins the
    event. Ties go to the geometry, so the bound sits a hair ABOVE the wall
    time: (1 + 1e-4) t + t_near.
    """
    big = torch.tensor(BIG, device=org.device)
    tn = torch.tensor(t_near, dtype=torch.float32, device=org.device)
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


def bounce_step(state: RayState, u, geometry, walls, settings, search):
    """One bounce of every lane.

    u: (R, 3) uniforms [reflection 1, reflection 2, roulette]. ``search`` is
    the closest-hit function (``disk_nearest_hit`` or its plain version).
    Returns (new state, hit_prim (R,) int32: the disk that takes a deposit or
    -1, wdep (R,) float32: the pre-sticking weight it takes, counts (4,)
    int64: collide, wall, exit, traces). Dead lanes pass through unchanged.
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

    # ---- 2. closest disk below the bound (ref: rayTraceKernel.hpp:163-167)
    t_geo, prim, hit_geo = search(
        org.contiguous(), dirn.contiguous(), geometry.prims_soa,
        geometry.soa_perm, geometry.soa_chunk_bbs, t_near=s.t_near,
    )
    hit_geo = hit_geo & (t_geo < tmin0)

    # ---- 3. event: geometry wins ties over the walls, wall 1 over wall 2,
    # written out rather than left to argmin's choice among equal values
    t_geo_m = torch.where(hit_geo, t_geo, big)
    geo_first = (t_geo_m <= t_w1) & (t_geo_m <= t_w2)
    w1_first = t_w1 <= t_w2
    t_ev = torch.minimum(t_geo_m, torch.minimum(t_w1, t_w2))
    escaped = t_ev >= big  # no hit anywhere (Embree miss)

    is_exit = alive & escaped
    is_geo_ev = alive & ~escaped & geo_first
    is_wall1 = alive & ~escaped & ~geo_first & w1_first
    is_wall2 = alive & ~escaped & ~geo_first & ~w1_first
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
    # through, the second kills (ref: rayTraceKernel.hpp:225-241)
    n_hit = geometry.normals[prim.long()]
    backface = vec.dot(dirn, n_hit) > 0.0
    bf_kill = is_geo_ev & backface & hfb
    bf_pass = is_geo_ev & backface & ~hfb
    collide = is_geo_ev & ~backface

    # the deposit: the weight before sticking, where the ray collides
    hit_prim = torch.where(collide, prim, torch.full_like(prim, -1))
    wdep = torch.where(collide, weight, torch.zeros_like(weight))

    # ---- 6. reflection + sticking (ref: rayTraceKernel.hpp:309-335) ------
    if s.refl_kind == ReflectionKind.DIFFUSE:
        refl_dir = reflection.diffuse(u[:, 0], u[:, 1], n_hit, s.dim)
    elif s.refl_kind == ReflectionKind.SPECULAR:
        refl_dir = reflection.specular(dirn, n_hit, s.dim)
    else:
        raise NotImplementedError("coned-cosine reflection is not ported yet")
    new_weight = weight - weight * s.sticking
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
    ])
    new_state = RayState(
        new_org, new_dir, weight_out, w0, alive_out, hfb_out, n_refl_new,
        n_bdry_new,
    )
    return new_state, hit_prim, wdep, counts


def deposit_entries(org, dirn, hit_prim, wdep, geometry):
    """The histogram entries of one bounce's deposits: (ids, w), both
    (R * (K + 1),), for the hit disk and its K neighbor slots.

    org, dirn: the rays as they were BEFORE the bounce. Per ray the hit disk
    takes ``wdep``, and so does every disk of its neighbor list that passes
    the local re-test; every other slot carries weight 0.
    """
    n_prims = geometry.num_primitives
    R = org.shape[0]
    K = geometry.neighbors.shape[1]
    collide = hit_prim >= 0
    prim_c = torch.clamp(hit_prim, min=0).long()
    rec = geometry.neighbor_pack[prim_c].reshape(R, K, 8)
    nb_ok, _ = intersect.check_neighbors_packed(org, dirn, rec)
    nb_ok = nb_ok & collide[:, None]
    w_all = torch.where(
        torch.cat([collide[:, None], nb_ok], dim=1),
        wdep[:, None],
        torch.zeros((), dtype=wdep.dtype, device=wdep.device),
    )
    nb_c = torch.clamp(geometry.neighbors[prim_c], 0, n_prims - 1)
    ids_all = torch.cat([prim_c[:, None].to(torch.int32), nb_c], dim=1)
    return ids_all.reshape(-1), w_all.reshape(-1)


def _check_inputs(state, uniforms, geometry, walls, n_sub, deposit_in_kernel):
    """Shape, type, device and contiguity the kernel takes; raises otherwise."""
    if n_sub < 1:
        raise ValueError("n_sub must be at least 1")
    if not deposit_in_kernel and n_sub != 1:
        raise ValueError("deposits can be handed out only with n_sub == 1")
    org = state.org
    R = org.shape[0]
    if org.ndim != 2 or org.shape[1] != 3:
        raise ValueError("org must be (R, 3)")
    n_prims = geometry.num_primitives
    K = geometry.neighbors.shape[1]
    npad = geometry.prims_soa.shape[1]
    n_chunks = geometry.soa_chunk_bbs.shape[0]
    if n_chunks == 0 or npad % n_chunks:
        raise ValueError("Npad must be a whole number of chunks")
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    for name, x, shape, dt in (
        ("org", org, (R, 3), f32), ("dirn", state.dirn, (R, 3), f32),
        ("weight", state.weight, (R,), f32), ("w0", state.w0, (R,), f32),
        ("alive", state.alive, (R,), b8), ("hfb", state.hfb, (R,), b8),
        ("n_refl", state.n_refl, (R,), i32),
        ("n_bdry", state.n_bdry, (R,), i32),
        ("uniforms", uniforms, (R, 3 * n_sub), f32),
        ("prims_soa", geometry.prims_soa, (PRIM_ROWS, npad), f32),
        ("soa_perm", geometry.soa_perm, (npad,), i32),
        ("soa_chunk_bbs", geometry.soa_chunk_bbs, (n_chunks, 8), f32),
        ("normals", geometry.normals, (n_prims, 3), f32),
        ("neighbors", geometry.neighbors, (n_prims, K), i32),
        ("neighbor_pack", geometry.neighbor_pack, (n_prims, K * 8), f32),
        ("walls", walls, (9,), f32),
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
                     n_sub: int = 1, deposit_in_kernel: bool = True):
    """Plain PyTorch version of ``fused_bounce``, on any device: ``n_sub``
    applications of ``bounce_step``. Deposits in the kernel are summed in
    float64 over all sub-bounces and rounded to float32 once, as the kernel's
    fixed-point bins are."""
    counts = torch.zeros(5, dtype=torch.int64, device=state.org.device)
    acc = torch.zeros(
        geometry.num_primitives, dtype=torch.float64, device=state.org.device
    )
    hit_prim = wdep = None
    for k in range(n_sub):
        org, dirn = state.org, state.dirn
        state, hit_prim, wdep, step_counts = bounce_step(
            state, uniforms[:, 3 * k: 3 * k + 3], geometry, walls, settings,
            disk_nearest_hit_ref,
        )
        counts[:4] += step_counts
        if deposit_in_kernel:
            ids, w = deposit_entries(org, dirn, hit_prim, wdep, geometry)
            acc.index_add_(0, ids.long(), w.double())
    counts[4] = state.alive.sum()
    if deposit_in_kernel:
        return BounceResult(state, counts, acc.float(), None, None)
    return BounceResult(state, counts, None, hit_prim, wdep)


def fused_bounce(state: RayState, uniforms, geometry, walls, settings,
                 n_sub: int = 1, deposit_in_kernel: bool = True):
    """Advance every ray through ``n_sub`` whole bounces; any R.

    state: ``RayState``; uniforms (R, 3 n_sub) float32 with the columns
    [reflection 1, reflection 2, roulette] per sub-bounce; geometry: a
    ``DiskGeometry`` on the rays' device; walls: ``make_walls``; settings:
    ``BounceSettings``. Returns a ``BounceResult`` with fresh tensors: the new
    state, the counts (``COUNT_NAMES``), and either the flux (n_prims,) in
    original numbering (``deposit_in_kernel``) or, with ``n_sub == 1``, each
    ray's (hit disk or -1, deposit weight) for ``deposit_entries``. Weights
    must be finite and never exceed their ray's ``w0``.

    On CUDA tensors this launches the kernel of ``csrc/bounce.cu`` (or
    raises); on CPU tensors it runs the plain version. Two calls on the same
    inputs give bitwise the same outputs on either device.
    """
    state = RayState(*state)
    s = settings
    if ReflectionKind(s.refl_kind) not in (
        ReflectionKind.DIFFUSE, ReflectionKind.SPECULAR
    ):
        raise NotImplementedError("coned-cosine reflection is not ported yet")
    _check_inputs(state, uniforms, geometry, walls, n_sub, deposit_in_kernel)
    dev = state.org.device
    if dev.type == "cpu":
        return fused_bounce_ref(
            state, uniforms, geometry, walls, settings, n_sub,
            deposit_in_kernel,
        )
    if dev.type != "cuda":
        raise RuntimeError(f"fused_bounce: unsupported device {dev}")
    R = state.org.shape[0]
    n_prims = geometry.num_primitives
    K = geometry.neighbors.shape[1]
    npad = geometry.prims_soa.shape[1]
    new = RayState(*(torch.empty_like(x) for x in state[:3]), state.w0,
                   *(torch.empty_like(x) for x in state[4:]))
    # n_prims fixed-point bins, the largest w0, the five counts; cleared by
    # the kernel's entry
    scratch = torch.empty(n_prims + 6, dtype=torch.int64, device=dev)
    if deposit_in_kernel:
        flux = torch.empty(n_prims, dtype=torch.float32, device=dev)
        hit_prim = wdep = None
        outs = (flux.data_ptr(), None, None)
    else:
        flux = None
        hit_prim = torch.empty(R, dtype=torch.int32, device=dev)
        wdep = torch.empty(R, dtype=torch.float32, device=dev)
        outs = (None, hit_prim.data_ptr(), wdep.data_ptr())
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.vr_fused_bounce(
            state.org.data_ptr(), state.dirn.data_ptr(),
            state.weight.data_ptr(), state.w0.data_ptr(),
            state.alive.data_ptr(), state.hfb.data_ptr(),
            state.n_refl.data_ptr(), state.n_bdry.data_ptr(),
            uniforms.data_ptr(), geometry.prims_soa.data_ptr(),
            geometry.soa_chunk_bbs.data_ptr(), geometry.soa_perm.data_ptr(),
            geometry.neighbors.data_ptr(), geometry.neighbor_pack.data_ptr(),
            walls.data_ptr(),
            R, npad, npad // geometry.soa_chunk_bbs.shape[0], n_prims, K,
            n_sub, s.dim, s.first_dir, s.second_dir, s.ray_axis, s.bc1,
            s.bc2, int(s.refl_kind == ReflectionKind.SPECULAR),
            s.max_reflections, s.max_boundary_hits, int(s.roulette),
            int(deposit_in_kernel),
            s.t_near, s.sticking, s.weight_threshold_frac,
            s.renew_weight_frac,
            new.org.data_ptr(), new.dirn.data_ptr(), new.weight.data_ptr(),
            new.alive.data_ptr(), new.hfb.data_ptr(), new.n_refl.data_ptr(),
            new.n_bdry.data_ptr(), *outs, scratch.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"vr_fused_bounce: CUDA error {err}")
    fused_bounce.launches += 1
    fused_bounce.sub_bounces += n_sub
    return BounceResult(new, scratch[n_prims + 1:], flux, hit_prim, wdep)


fused_bounce.launches = 0  # kernel launches
fused_bounce.sub_bounces = 0  # bounces those launches ran, n_sub each
