"""The wavefront trace of one mega-batch.

Counterpart of ``viennaray_tpu/trace/kernel.py``. The reference traces each
ray through a private ``do {} while(reflect)`` bounce loop
(rayTraceKernel.hpp:20-527); here the whole ray batch advances together,
through one of two bodies:

- the fused body (the default): one launch of the CUDA kernel behind
  ``ops.bounce.fused_bounce`` advances every ray through ``n_sub`` whole
  bounces. Wide stages run one bounce per launch and, for a diffuse particle
  on a geometry of at least 4 chunks, hand their deposits out to the
  histogram kernel; every other launch deposits in the kernel. Narrower
  stages run 4, then 16 bounces per launch;
- the unfused body (``fused=False``): every iteration finds all active rays'
  closest disk (the CUDA kernel behind ``ops.nearest_hit.disk_nearest_hit``),
  resolves the bounce with the tensor code of ``ops.bounce.bounce_step``
  (which is also the arithmetic of the fused kernel's plain version) and
  deposits through ``ops.histogram.flux_histogram``.

A Python loop drives the launches; it reads the survivor count from the
device once per launch to decide when to compact.

Event semantics mirrored 1:1 from rayTraceKernel.hpp:
- miss (escape through the source-axis faces) -> nonGeometryHits (:172-176)
- boundary hits capped at max_boundary_hits, then reflective wall = specular
  flip / periodic wall = teleport to opposite wall / ignore = kill
  (:206-214, rayBoundary.hpp:29-127)
- disk backface: first hit passes through, second kills (:225-241)
- disk neighbor multi-hit via the packed neighbor records (:255-300)
- sticking update w -= w*s, max-reflections cap, Russian roulette
  (kill below 0.1 w0, renew to 0.3 w0, :309-335, :435-460)

Not ported yet, and refused by name (``check_supported``): gas scattering,
1/distance weighting, the window flux model, custom hooks and multi-channel
flux, per-material sticking, coned-cosine reflection. The per-bounce
coherence re-sort of the reference only engages from 8 geometry chunks on and
is not ported yet either; it changes the lane order, not the physics.

Determinism: every reduction on the path has a fixed order or is a sum of
integers (stable sorts, the fixed-point bins of the histogram and bounce
kernels), and all uniforms come from the ``RayRNG`` keyed by the global batch
index, so a fixed seed and batch size give bitwise the same flux on the same
device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import rng as rng_streams
from ..config import ReflectionKind, TraceConfig
from ..ops.bounce import (
    BounceSettings,
    RayState,
    bounce_step,
    deposit_entries,
    fused_bounce,
    make_walls,
)
from ..ops.histogram import flux_histogram
from ..ops.nearest_hit import disk_nearest_hit
from ..physics.source import RandomSource

# ray-compaction ladder: halve the width per stage, floored at MIN_STAGE
MIN_STAGE = 512
STAGE_SHRINK = 2

# the fused body's bounces per launch: (wide, mid, tail) stages
N_SUB = (1, 4, 16)
# a diffuse launch of one bounce hands its deposits out from this many
# geometry chunks on (the reference's choice, kernel.py:1049-1065)
HAND_OUT_MIN_CHUNKS = 4


def n_sub_for(width: int, n_sub) -> int:
    """Bounces per fused launch at a stage width: wide stages are bound by
    the device and check the compaction thresholds every bounce, narrow ones
    by the launches (ref: kernel.py:1372-1381)."""
    if width > 16384:
        return n_sub[0]
    if width > 2048:
        return n_sub[1]
    return n_sub[2]


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


def _bounce_uniforms(rng, batch_index, it, n, n_sub, settings, dev):
    """The (n, 3 n_sub) uniforms of one launch starting at iteration ``it``.
    One bounce draws the reflection pair (diffuse only) and the roulette
    number as separate streams, in that order, whichever body runs; several
    bounces draw one block."""
    if n_sub > 1:
        return rng.uniform_block(batch_index, it, n, 3 * n_sub)
    zero = torch.zeros(n, dtype=torch.float32, device=dev)
    u1 = u2 = u3 = zero
    if settings.refl_kind == ReflectionKind.DIFFUSE:
        u1 = rng.uniform(rng_streams.REFLECT_1, batch_index, it, n)
        u2 = rng.uniform(rng_streams.REFLECT_2, batch_index, it, n)
    if settings.roulette:
        u3 = rng.uniform(rng_streams.ROULETTE, batch_index, it, n)
    return torch.stack([u1, u2, u3], dim=1)


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
    fused: bool = True,
    n_sub=N_SUB,
):
    """Trace one mega-batch of rays to extinction; returns (flux, counters).

    geometry: DiskGeometry. bbox: (2, 3) float32 tensor, the source-adjusted
    bounding box (ref: rayUtil.hpp:104-143). rng: a ``RayRNG`` whose
    ``begin_batch(batch_index)`` has been called. ray_indices: (R,) global
    ray indices. valid: (R,) bool — lanes beyond the total ray count start
    dead. fused: the fused body (one kernel launch per ``n_sub`` bounces) or
    the unfused one. n_sub: the fused body's bounces per launch at (wide,
    mid, tail) stage widths. Returns flux (n_prims,) float32 on the device
    and ``BatchCounters``.
    """
    check_supported(config, particle, source)
    dim = config.dim
    settings = BounceSettings.from_config(config, particle)
    first_dir, second_dir = settings.first_dir, settings.second_dir

    dev = geometry.device
    R = ray_indices.shape[0]
    n_prims = geometry.num_primitives
    walls = make_walls(bbox, geometry, settings)
    lo1, hi1, lo2, hi2 = (walls[i] for i in range(4))

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
    # collide, wall, exit, traces
    counts = torch.zeros(4, dtype=torch.int64, device=dev)

    def land(flux, org, dirn, hit_prim, wdep):
        """Deposits handed out by a bounce (ref: DiffuseParticle::
        surfaceCollision adds the current rayWeight, rayParticle.hpp:148-156):
        the hit disk and every neighbor-list disk that passes the local
        re-test take the weight."""
        ids, w = deposit_entries(org, dirn, hit_prim, wdep, geometry)
        return flux + _flux_add(ids, w, n_prims)

    def unfused_body(it, flux, state):
        """One bounce of the whole stage by tensor ops around the closest-hit
        and histogram kernels; returns (flux, survivor count, new state,
        iterations done)."""
        u = _bounce_uniforms(
            rng, batch_index, it, state.org.shape[0], 1, settings, dev
        )
        new_state, hit_prim, wdep, step_counts = bounce_step(
            state, u, geometry, walls, settings, disk_nearest_hit
        )
        flux = land(flux, state.org, state.dirn, hit_prim, wdep)
        counts.add_(step_counts)
        return flux, new_state.alive.sum(), new_state, 1

    def fused_body(it, flux, state):
        """One launch of the bounce kernel: ``n_sub`` bounces of the whole
        stage; same returns."""
        width = state.org.shape[0]
        k = n_sub_for(width, n_sub)
        hand_out = (
            k == 1
            and settings.refl_kind == ReflectionKind.DIFFUSE
            and geometry.soa_chunk_bbs.shape[0] >= HAND_OUT_MIN_CHUNKS
        )
        u = _bounce_uniforms(rng, batch_index, it, width, k, settings, dev)
        state = RayState(*(x.contiguous() for x in state))
        res = fused_bounce(
            state, u.contiguous(), geometry, walls, settings, n_sub=k,
            deposit_in_kernel=not hand_out,
        )
        if hand_out:
            flux = land(flux, state.org, state.dirn, res.hit_prim, res.wdep)
        else:
            flux = flux + res.flux
        counts.add_(res.counts[:4])
        return flux, res.counts[4], res.state, k

    body = fused_body if fused else unfused_body

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
    # max_boundary_hits cap — then runs at minimal width. A fused launch of
    # several bounces may pass several caps at once: dead lanes are no-ops,
    # and a stage whose cap is already met runs no iteration.
    stage_caps = []
    cap = R
    while cap > MIN_STAGE:
        cap //= STAGE_SHRINK
        stage_caps.append(max(cap, MIN_STAGE))
    stage_caps.append(0)  # final stage: run to extinction

    bb_lo = bbox[0]
    bb_ext = torch.clamp(bbox[1] - bbox[0], min=1e-6)

    state = RayState(org, dirn, weight, w0, alive, hfb, n_refl, n_bdry)
    it = 0
    n_alive = int(alive.sum())
    sorted_since_bounce = False
    for cap in stage_caps:
        while it < config.max_bounces and n_alive > cap:
            flux, alive_count, state, done = body(it, flux, state)
            it += done
            # the one host read per launch: the ladder needs the survivor
            # count
            n_alive = int(alive_count)
            sorted_since_bounce = False
        if cap == 0:
            break
        if sorted_since_bounce:
            # no bounce since the last compaction: the lanes are still in
            # key order, so the stable sort would be the identity
            state = RayState(*(x[:cap] for x in state))
        else:
            # spatial compaction: survivors sorted by origin cell and
            # direction octant, so neighbouring lanes stay coherent after
            # diffuse bounces decohere the source order
            key_s = _spatial_key(
                state.org, state.dirn, state.alive, bb_lo, bb_ext
            )
            take = torch.argsort(key_s, stable=True)[:cap]
            state = RayState(*(x[take] for x in state))
            sorted_since_bounce = True

    c = counts.tolist()  # the one counter fetch per batch
    counters = BatchCounters(
        total_traces=c[3], non_geometry_hits=c[2], geometry_hits=c[0],
        particle_hits=0, boundary_hits=c[1], reflections=c[0],
    )
    return flux, counters
