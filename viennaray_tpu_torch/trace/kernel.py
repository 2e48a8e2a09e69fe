"""The wavefront trace of one mega-batch.

Counterpart of ``viennaray_tpu/trace/kernel.py`` with the fused megakernel
switched off: the unfused wavefront body. The reference traces each ray
through a private ``do {} while(reflect)`` bounce loop
(rayTraceKernel.hpp:20-527); here the whole ray batch advances together.
Every iteration finds all active rays' closest disk (the CUDA kernel behind
``ops.nearest_hit.disk_nearest_hit``), resolves the per-ray event (geometry
hit / domain-wall hit / escape) with ``torch.where`` lattices, deposits flux
(the CUDA kernel behind ``ops.histogram.flux_histogram``) and samples
reflections. A Python loop drives the iterations; it reads the survivor count
from the device once per bounce to decide when to compact.

Event semantics mirrored 1:1 from rayTraceKernel.hpp:
- miss (escape through the source-axis faces) -> nonGeometryHits (:172-176)
- boundary hits capped at max_boundary_hits, then reflective wall = specular
  flip / periodic wall = teleport to opposite wall / ignore = kill
  (:206-214, rayBoundary.hpp:29-127)
- disk backface: first hit passes through, second kills (:225-241)
- disk neighbor multi-hit via ``check_neighbors_packed`` over the packed
  neighbor records (:255-300)
- sticking update w -= w*s, max-reflections cap, Russian roulette
  (kill below 0.1 w0, renew to 0.3 w0, :309-335, :435-460)

Not ported yet, and refused by name (``check_supported``): gas scattering,
1/distance weighting, the window flux model, custom hooks and multi-channel
flux, per-material sticking, coned-cosine reflection. The per-bounce
coherence re-sort of the reference only engages from 8 geometry chunks on and
is not ported yet either; it changes the lane order, not the physics.

Determinism: every reduction on the path has a fixed order (stable sorts, the
integer-atomic histogram), and all uniforms come from the ``RayRNG`` keyed by
the global batch index, so a fixed seed and batch size give bitwise the same
flux on the same device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import rng as rng_streams
from ..config import (
    BoundaryCondition,
    ReflectionKind,
    TraceConfig,
    get_trace_settings,
)
from ..ops import intersect
from ..ops.histogram import flux_histogram
from ..ops.nearest_hit import BIG, disk_nearest_hit
from ..physics.source import RandomSource

# event codes
EV_GEO = 0
EV_WALL1 = 1
EV_WALL2 = 2
EV_EXIT = 3

# ray-compaction ladder: halve the width per stage, floored at MIN_STAGE
MIN_STAGE = 512
STAGE_SHRINK = 2


class BatchCounters(NamedTuple):
    """Per-batch counters (ref: TraceInfo, rayUtil.hpp:65-76), as Python ints
    fetched from the device once per batch."""

    total_traces: int
    non_geometry_hits: int
    geometry_hits: int
    particle_hits: int
    boundary_hits: int
    reflections: int


def check_supported(config: TraceConfig, particle, source) -> None:
    """Raise NotImplementedError, naming the setting, for anything the port
    does not trace yet. Nothing unsupported is silently ignored."""
    if particle.mean_free_path > 0.0:
        raise NotImplementedError(
            "gas scattering (mean_free_path > 0) is not ported yet"
        )
    if config.use_wdist:
        raise NotImplementedError("use_wdist is not ported yet")
    if config.flux_model != "neighbor":
        raise NotImplementedError(
            f"flux_model={config.flux_model!r} is not ported yet"
        )
    if len(particle.data_labels) != 1:
        raise NotImplementedError("multi-channel flux is not ported yet")
    if particle.material_sticking is not None:
        raise NotImplementedError("per-material sticking is not ported yet")
    kind = ReflectionKind(particle.reflection_kind)
    if kind not in (ReflectionKind.DIFFUSE, ReflectionKind.SPECULAR):
        raise NotImplementedError("coned-cosine reflection is not ported yet")
    if not isinstance(source, RandomSource):
        raise NotImplementedError(
            f"source {type(source).__name__} is not ported yet "
            "(GridSource and SurfaceSource wait for a later slice)"
        )
    if source.bbox.dtype != torch.float32:
        raise NotImplementedError("f64 tracing is not ported yet")


def _flux_add(ids, weights, n_prims):
    """Histogram of weights into prim bins: one route at every ``n_prims``,
    the deterministic histogram kernel. (The reference's one-hot contraction
    would materialize R x (K+1) x n_prims floats in eager PyTorch, and
    ``index_add_`` on CUDA adds floats in an order that changes from run to
    run, which breaks the per-seed contract.)"""
    return flux_histogram(ids, weights, n_prims)


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


def _spatial_key(org, dirn, alive, bb_lo, bb_ext):
    """Compaction sort key: position-major (16^3 cells of the bounding box),
    direction-octant minor; dead lanes last."""
    cell = torch.clamp(
        ((org - bb_lo) / bb_ext * 16.0).to(torch.int32), 0, 15
    )
    octant = (
        (dirn[:, 0] > 0).to(torch.int32)
        + 2 * (dirn[:, 1] > 0).to(torch.int32)
        + 4 * (dirn[:, 2] > 0).to(torch.int32)
    )
    key = ((cell[:, 0] * 16 + cell[:, 1]) * 16 + cell[:, 2]) * 8 + octant
    return torch.where(alive, key, torch.full_like(key, 1 << 30))


def trace_batch(
    geometry,
    source,
    particle,
    bbox,
    rng,
    batch_index: int,
    ray_indices,
    valid,
    config: TraceConfig,
):
    """Trace one mega-batch of rays to extinction; returns (flux, counters).

    geometry: DiskGeometry. bbox: (2, 3) float32 tensor, the source-adjusted
    bounding box (ref: rayUtil.hpp:104-143). rng: a ``RayRNG`` whose
    ``begin_batch(batch_index)`` has been called. ray_indices: (R,) global
    ray indices. valid: (R,) bool — lanes beyond the total ray count start
    dead. Returns flux (n_prims,) float32 on the device and ``BatchCounters``.
    """
    check_supported(config, particle, source)
    dim = config.dim
    ray_axis, first_dir, second_dir, _, _ = get_trace_settings(
        config.source_direction
    )
    bc1 = BoundaryCondition(config.boundary_conditions[first_dir])
    bc2 = (
        BoundaryCondition(config.boundary_conditions[second_dir])
        if dim == 3
        else BoundaryCondition.IGNORE
    )

    dev = geometry.device
    R = ray_indices.shape[0]
    n_prims = geometry.num_primitives
    K = geometry.neighbors.shape[1]
    big = torch.tensor(BIG, device=dev)
    t_near = torch.tensor(config.t_near, dtype=torch.float32, device=dev)

    lo1, hi1 = bbox[0, first_dir], bbox[1, first_dir]
    lo2, hi2 = bbox[0, second_dir], bbox[1, second_dir]
    lo_r, hi_r = bbox[0, ray_axis], bbox[1, ray_axis]

    # ---- source sampling -------------------------------------------------
    org, dirn, w0 = source.sample(rng, batch_index, R)

    # particle-controlled initial direction (ref: initNewWithDirection,
    # rayParticle.hpp:31,92; the zero vector means "use the source's")
    if particle.direction is not None and any(particle.direction):
        cand = torch.tensor(particle.direction, dtype=torch.float32, device=dev)
        if dim == 2:
            cand[2] = 0.0
        n = torch.linalg.norm(cand)
        cand = cand / torch.where(n > 0.0, n, torch.ones_like(n))
        dirn = cand.expand(R, 3).contiguous()

    weight = torch.where(valid, w0, torch.zeros_like(w0))
    alive = valid
    hfb = torch.zeros(R, dtype=torch.bool, device=dev)
    n_refl = torch.zeros(R, dtype=torch.int32, device=dev)
    n_bdry = torch.zeros(R, dtype=torch.int32, device=dev)
    flux = torch.zeros(n_prims, dtype=torch.float32, device=dev)
    counts = torch.zeros(4, dtype=torch.int64, device=dev)

    def body(it, flux, org, dirn, weight, w0, alive, hfb, n_refl, n_bdry):
        """One bounce of the whole stage; returns (flux, survivor count,
        new state)."""
        Rb = org.shape[0]  # stage width (shrinks after compaction)

        # ---- 1. intersect geometry (ref: rayTraceKernel.hpp:163-167) ----
        t_geo, prim, hit_geo = disk_nearest_hit(
            org.contiguous(), dirn.contiguous(), geometry.prims_soa,
            geometry.soa_perm, geometry.soa_chunk_bbs, t_near=config.t_near,
        )

        # ---- 2. boundary-wall crossings ---------------------------------
        # The walls are FINITE rectangles spanning the adjusted bbox on the
        # two lateral axes only (ref: rayBoundary.hpp:164-245, 8 triangles);
        # a crossing whose hit point lies outside the rectangle (e.g. below
        # the geometry or above the source plane) is not a wall hit — the ray
        # simply flies on and, with nothing else ahead, escapes (Embree miss,
        # rayTraceKernel.hpp:172-176).
        def wall_t(axis, lo, hi, other_axis, other_lo, other_hi):
            t = _wall_crossing(org, dirn, axis, lo, hi, t_near, big)
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
            t_w2 = big.expand(Rb)

        # first minimum of (geometry, wall 1, wall 2): geometry wins ties
        # over the walls, wall 1 over wall 2 — written out rather than left
        # to argmin's choice among equal values
        t_geo_m = torch.where(hit_geo, t_geo, big)
        geo_first = (t_geo_m <= t_w1) & (t_geo_m <= t_w2)
        w1_first = t_w1 <= t_w2
        event = torch.where(
            geo_first,
            EV_GEO,
            torch.where(w1_first, EV_WALL1, EV_WALL2),
        )
        t_ev = torch.minimum(t_geo_m, torch.minimum(t_w1, t_w2))
        # no hit anywhere -> escape (Embree miss)
        event = torch.where(t_ev >= big, EV_EXIT, event)

        is_exit = alive & (event == EV_EXIT)
        is_wall1 = alive & (event == EV_WALL1)
        is_wall2 = alive & (event == EV_WALL2)
        is_wall = is_wall1 | is_wall2
        is_geo_ev = alive & (event == EV_GEO)

        hitpoint = org + dirn * t_ev[:, None]

        # ---- 3. boundary processing (ref: rayBoundary.hpp:29-127) -------
        n_bdry_new = n_bdry + is_wall.to(torch.int32)
        bdry_overflow = is_wall & (n_bdry_new > config.max_boundary_hits)

        # the deposits below read the pre-bounce org and dirn: new_org and
        # new_dir are fresh tensors, never views of them
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
            is_wall1 & ~bdry_overflow, first_dir, lo1, hi1, bc1,
            new_org, new_dir, dead,
        )
        if dim == 3:
            new_org, new_dir, dead = apply_wall(
                is_wall2 & ~bdry_overflow, second_dir, lo2, hi2, bc2,
                new_org, new_dir, dead,
            )

        # ---- 4. surface interaction -------------------------------------
        prim_c = torch.clamp(prim, 0, n_prims - 1).long()
        n_hit = geometry.normals[prim_c]
        backface = torch.sum(dirn * n_hit, dim=1) > 0.0
        bf_kill = is_geo_ev & backface & hfb
        bf_pass = is_geo_ev & backface & ~hfb
        collide = is_geo_ev & ~backface

        # flux accumulation (ref: DiffuseParticle::surfaceCollision adds the
        # current rayWeight, rayParticle.hpp:148-156): the hit disk and every
        # neighbor-list disk that passes the local re-test take the weight
        rec = geometry.neighbor_pack[prim_c].reshape(Rb, K, 8)
        nb_ok, _ = intersect.check_neighbors_packed(org, dirn, rec)
        nb_ok = nb_ok & collide[:, None]
        w_all = torch.where(
            torch.cat([collide[:, None], nb_ok], dim=1),
            weight[:, None],
            torch.zeros((), dtype=weight.dtype, device=dev),
        )
        nb_c = torch.clamp(geometry.neighbors[prim_c], 0, n_prims - 1)
        ids_all = torch.cat([prim_c[:, None].to(torch.int32), nb_c], dim=1)
        flux = flux + _flux_add(
            ids_all.reshape(-1), w_all.reshape(-1), n_prims
        )

        # ---- 5. reflection + sticking (ref: rayTraceKernel.hpp:309-335) --
        refl_dir = particle.reflect(rng, batch_index, it, dirn, n_hit, dim)
        new_weight = weight - weight * particle.sticking
        died_absorb = collide & (new_weight <= 0.0)
        n_refl_new = n_refl + collide.to(torch.int32)
        died_max_refl = collide & (n_refl_new > config.max_reflections)

        # Russian roulette (ref: rejectionControl, rayTraceKernel.hpp:435-460)
        if config.roulette:
            low = config.weight_threshold_frac * w0
            renew = config.renew_weight_frac * w0
            needs_roulette = collide & (new_weight < low)
            u_roul = rng.uniform(rng_streams.ROULETTE, batch_index, it, Rb)
            kill_prob = 1.0 - new_weight / torch.clamp(renew, min=1e-30)
            died_roulette = needs_roulette & (u_roul < kill_prob)
            renewed = needs_roulette & ~died_roulette
            new_weight = torch.where(renewed, renew, new_weight)
        else:
            died_roulette = torch.zeros(Rb, dtype=torch.bool, device=dev)

        survived_collide = (
            collide & ~died_absorb & ~died_max_refl & ~died_roulette
        )

        # ---- 6. state update --------------------------------------------
        new_org = torch.where(
            (bf_pass | survived_collide)[:, None], hitpoint, new_org
        )
        new_dir = torch.where(survived_collide[:, None], refl_dir, new_dir)
        if dim == 2:
            zeroed = new_dir.clone()
            zeroed[:, 2] = 0.0
            new_dir = zeroed / torch.clamp(
                torch.linalg.norm(zeroed, dim=1, keepdim=True), min=1e-12
            )

        weight_out = torch.where(collide, new_weight, weight)
        hfb_out = hfb | bf_pass
        dead = (
            dead | is_exit | bdry_overflow | bf_kill | died_absorb
            | died_max_refl | died_roulette
        )
        alive_out = alive & ~dead

        counts.add_(torch.stack([
            alive.sum(), is_exit.sum(), collide.sum(), is_wall.sum(),
        ]))
        return flux, alive_out.sum(), (
            new_org, new_dir, weight_out, w0, alive_out, hfb_out,
            n_refl_new, n_bdry_new,
        )

    # ---- source-coherence sort -------------------------------------------
    # Random source origins scatter neighbouring lanes over the whole domain.
    # Sorting the batch by source-plane Morton cell makes blocks of lanes
    # spatially compact (deterministic per seed; deposits are
    # order-independent sums, and each lane's uniforms remain i.i.d.).
    if R >= 2048:
        nb = 6  # 64x64 source-plane cells
        one = torch.tensor(1e-30, dtype=torch.float32, device=dev)
        c1 = torch.clamp(
            ((org[:, first_dir] - lo1) / torch.maximum(hi1 - lo1, one)
             * (1 << nb)).to(torch.int32),
            0, (1 << nb) - 1,
        )
        if dim == 3:
            c2 = torch.clamp(
                ((org[:, second_dir] - lo2) / torch.maximum(hi2 - lo2, one)
                 * (1 << nb)).to(torch.int32),
                0, (1 << nb) - 1,
            )
            key_m = torch.zeros_like(c1)
            for bit in range(nb):
                key_m = key_m | (((c1 >> bit) & 1) << (2 * bit))
                key_m = key_m | (((c2 >> bit) & 1) << (2 * bit + 1))
        else:
            key_m = c1
        take = torch.argsort(key_m, stable=True)
        org, dirn = org[take], dirn[take]
        weight, w0, alive = weight[take], w0[take], alive[take]

    # ---- staged execution with ray compaction ---------------------------
    # Roulette kills rays at different bounce counts, so a fixed-size
    # wavefront wastes whole-batch work on a tail of stragglers. Run the loop
    # until the survivor count fits a 2x smaller batch, compact the survivors
    # to the front (stable argsort — deterministic), and continue at the
    # smaller width, floored at MIN_STAGE. The long tail — e.g.
    # near-horizontal rays ping-ponging between periodic walls until the
    # max_boundary_hits cap — then runs at minimal width.
    stage_caps = []
    cap = R
    while cap > MIN_STAGE:
        cap //= STAGE_SHRINK
        stage_caps.append(max(cap, MIN_STAGE))
    stage_caps.append(0)  # final stage: run to extinction

    bb_lo = bbox[0]
    bb_ext = torch.clamp(bbox[1] - bbox[0], min=1e-6)

    state = (org, dirn, weight, w0, alive, hfb, n_refl, n_bdry)
    it = 0
    n_alive = int(alive.sum())
    sorted_since_bounce = False
    for cap in stage_caps:
        while it < config.max_bounces and n_alive > cap:
            flux, alive_count, state = body(it, flux, *state)
            it += 1
            # the one host read per bounce: the ladder needs the survivor count
            n_alive = int(alive_count)
            sorted_since_bounce = False
        if cap == 0:
            break
        org, dirn, weight, w0, alive, hfb, n_refl, n_bdry = state
        if sorted_since_bounce:
            # no bounce since the last compaction: the lanes are still in
            # key order, so the stable sort would be the identity
            state = tuple(x[:cap] for x in state)
        else:
            # spatial compaction: survivors sorted by origin cell and
            # direction octant, so neighbouring lanes stay coherent after
            # diffuse bounces decohere the source order
            key_s = _spatial_key(org, dirn, alive, bb_lo, bb_ext)
            take = torch.argsort(key_s, stable=True)[:cap]
            state = tuple(x[take] for x in state)
            sorted_since_bounce = True

    c = counts.tolist()  # the one counter fetch per batch
    counters = BatchCounters(
        total_traces=c[0], non_geometry_hits=c[1], geometry_hits=c[2],
        particle_hits=0, boundary_hits=c[3], reflections=c[2],
    )
    return flux, counters
