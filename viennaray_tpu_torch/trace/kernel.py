"""The wavefront trace of one mega-batch.

Counterpart of ``viennaray_tpu/trace/kernel.py``. The reference traces each
ray through a private ``do {} while(reflect)`` bounce loop
(rayTraceKernel.hpp:20-527); here the whole ray batch advances together,
through one of two bodies:

- the fused body (the default): one launch of the CUDA kernel behind
  ``ops.bounce.fused_bounce`` advances every ray through ``n_sub`` whole
  bounces. Wide stages run one bounce per launch and, for a diffuse particle
  on a disk geometry of at least 4 chunks under the neighbor flux model, hand
  their deposits out to the histogram kernel; every other launch deposits in
  the kernel (``hand_out_for`` holds the rule and its measurements). Narrower
  stages run 4, then 16 bounces per launch;
- the unfused body (``fused=False``): every iteration finds all active rays'
  closest hit (the CUDA kernels behind ``ops.nearest_hit.disk_nearest_hit``,
  ``triangle_nearest_hit`` and ``line_nearest_hit``, by the geometry's
  ``kind``),
  resolves the bounce with the tensor code of ``ops.bounce.bounce_step``
  (which is also the arithmetic of the fused kernel's plain version) and
  deposits through ``ops.histogram.flux_histogram``. 1/distance weighting
  (``use_wdist``) and a custom particle's ``collision_fn``, ``reflection_fn``
  or ``aux_init_fn`` run this body whatever ``fused`` says, as the
  reference's do (kernel.py:959-976): its fused kernel has no such deposit
  and no hook. ``init_dir_fn`` and ``log_fn`` run before the first bounce
  and keep the fused body.

A Python loop drives the launches; it reads the survivor count from the
device once per launch to decide when to compact.

Event semantics mirrored 1:1 from rayTraceKernel.hpp:
- miss (escape through the source-axis faces) -> nonGeometryHits (:172-176)
- boundary hits capped at max_boundary_hits, then reflective wall = specular
  flip / periodic wall = teleport to opposite wall / ignore = kill
  (:206-214, rayBoundary.hpp:29-127)
- gas scattering with probability 1 - exp(-t / mean_free_path) before the
  walls and the geometry take their event (:179-203)
- disk backface: first hit passes through, second kills (:225-241);
  triangle and line backface kills (:243-248)
- disk neighbor multi-hit via the packed neighbor records (:255-300), with
  optional 1/distance weights (:258-296), or the window flux model (the GPU
  candidate-window contract, GeneralPipelineDisk.cu:51-59) via the hit
  disk's window list; triangles and lines deposit on the single closest hit
  (:301-307) whatever the flux model
- sticking update w -= w*s with one sticking value or one per material,
  diffuse, specular or coned-cosine reflection, max-reflections cap, Russian
  roulette (kill below 0.1 w0, renew to 0.3 w0, :309-335, :435-460)

- custom particles (``trace_batch``'s hooks, the reference's
  surfaceCollision / surfaceReflection / initNew / logData,
  rayParticle.hpp:30-66): a ``collision_fn`` owns the deposits and fills one
  channel, or L channels for a particle of L data labels (the GPU's species
  x label buffer, gpu/raygTrace.hpp:97-99); without it a particle's flux is
  one channel, and with several data labels the first receives it

Float64 tracing (the JAX package's ``jax_enable_x64`` mode, the analog of
the reference's ``NumericType=double``): a geometry widened by
``to(torch.float64)``, a source of the same type (``to``) and a ``RayRNG``
drawing float64 (``GeneratorRNG(..., dtype=torch.float64)``) trace the
unfused body in float64 end to end, on the float64 forms of the closest-hit
and histogram kernels; the counters stay int. The fused body is float32
only, as the JAX package's megakernel is (its walls and loop carries are
float32): ``check_supported`` refuses float64 where the fused body would run,
by name. The tracers (``TraceDisk`` and the others) are float32 only, as the
JAX package's are.

Refused by name (``check_supported``), as in the reference: the window flux
model together with 1/distance weighting or with a ``collision_fn``. The
per-bounce coherence re-sort of the reference only engages from 8 geometry
chunks on and is not ported yet; it changes the lane order, not the physics.

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
from ..rng import HookRNG
from ..config import ReflectionKind, TraceConfig
from ..ops.bounce import (
    COUNT_NAMES,
    N_EVENTS,
    BounceSettings,
    RayState,
    bounce_step,
    deposit_entries,
    fused_bounce,
    make_walls,
    sticking_lanes,
)
from ..ops.histogram import flux_histogram
from ..ops.nearest_hit import (
    disk_nearest_hit,
    line_nearest_hit,
    triangle_nearest_hit,
)
from ..physics.source import (
    GridSource,
    RandomSource,
    SurfaceSource,
    check_sample,
    check_source,
)

# ray-compaction ladder: halve the width per stage, floored at MIN_STAGE
MIN_STAGE = 512
STAGE_SHRINK = 2

# the fused body's bounces per launch: (wide, mid, tail) stages
N_SUB = (1, 4, 16)
# a diffuse launch of one bounce on disks hands its deposits out from this
# many geometry chunks on (the reference's choice, kernel.py:1049-1065)
HAND_OUT_MIN_CHUNKS = 4

# the closest-hit kernel's wrapper of each geometry kind
_SEARCH = {
    "disk": disk_nearest_hit,
    "triangle": triangle_nearest_hit,
    "line": line_nearest_hit,
}


def hand_out_for(kind: str, n_chunks: int, refl_kind, n_sub: int) -> bool:
    """Whether a fused launch hands its deposits out to the histogram kernel
    (True) or deposits in the kernel (False). ``kind``: how a colliding ray
    deposits, ``BounceSettings.deposit_kind``: "disk", "window", "triangle"
    or "line".

    Only a launch of one bounce can hand out. Window deposits never do, as
    in the reference (kernel.py:1049-1052). Disks: a diffuse launch on at
    least ``HAND_OUT_MIN_CHUNKS`` chunks does (the reference's rule): its
    deposit in the kernel is a gather of K neighbor records and up to K + 1
    atomics per colliding ray. Triangles and lines: never. (The reference's
    rule, kernel.py:1049-1065, treats all three kinds alike: a diffuse launch
    of one bounce on 4 chunks or more hands out.) Their deposit in the kernel
    is one integer atomic per colliding ray, which the kernel's time does not
    show, and handing out adds a histogram launch per wide launch: on an H100
    the 5,760-triangle trench's apply was 1.5 % slower handed out
    (``chip_diagnose.py --triangles``, ``PERF.md``). Both give the same flux
    up to the fixed point's rounding.
    """
    return (
        kind == "disk"
        and n_sub == 1
        and refl_kind == ReflectionKind.DIFFUSE
        and n_chunks >= HAND_OUT_MIN_CHUNKS
    )


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
    fetched from the device once per batch. The last three say how hard the
    fused kernel's search worked (``ops.bounce.COUNT_NAMES``): chunks woken
    and sub-bounces run by its search groups, summed over the batch's
    launches; 0 on the unfused body, and on the CPU, where the plain version
    sweeps no chunks. ``chunks_deposited`` is always 0: the reference's
    kernel sweeps the chunks a second time for its deposits, the port's
    gathers the hit disk's neighbor or window list instead."""

    total_traces: int
    non_geometry_hits: int
    geometry_hits: int
    particle_hits: int
    boundary_hits: int
    reflections: int
    chunks_swept: int = 0
    chunks_deposited: int = 0
    tile_bounces: int = 0


SOURCES = (RandomSource, GridSource, SurfaceSource)


def check_supported(config: TraceConfig, particle, source,
                    collision_fn=None, geometry=None, fused=False) -> None:
    """Raise NotImplementedError, naming the setting, for anything the port
    does not trace. Nothing unsupported is silently ignored. ``geometry``:
    the trace's, whose ``dtype`` is the trace's float type (None: float32,
    as the tracers trace); ``fused``: whether the fused body would run."""
    if config.flux_model == "window" and config.use_wdist:
        # the reference refuses it too (kernel.py:336-342): the window
        # contract has no neighbor distances to weight by
        raise NotImplementedError(
            "flux_model='window' does not take use_wdist"
        )
    if config.flux_model == "window" and collision_fn is not None:
        # as the reference (kernel.py:336-343): the window contract has no
        # neighbor-id list to hand to a custom collision
        raise NotImplementedError(
            "flux_model='window' does not take a collision_fn"
        )
    ReflectionKind(particle.reflection_kind)  # raises on a kind that is none
    check_source(source)
    dtype = torch.float32 if geometry is None else geometry.dtype
    if dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(f"a trace runs float32 or float64, not "
                                  f"{dtype}")
    if dtype == torch.float64 and fused:
        # as the JAX package: its megakernel casts the walls to float32 and
        # carries float32 state (kernel.py:995-997)
        raise NotImplementedError(
            "float64 tracing runs the unfused body only: pass fused=False "
            "(fused=True is float32 only)")
    if isinstance(source, SOURCES) and source.dtype != dtype:
        raise NotImplementedError(
            f"the source samples {source.dtype} but the trace is {dtype}: "
            "cast the source with to(dtype), as the geometry")


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


def _bounce_uniforms(rng, batch_index, it, n, n_sub, settings, dev,
                     dtype=torch.float32):
    """The (n, n_uni n_sub) uniforms of one launch starting at iteration
    ``it``; ``n_uni`` = 3, or 6 with gas scattering. One bounce draws its
    numbers as separate streams, whichever body runs, in this order: the
    reflection pair (diffuse: two uniforms; coned-cosine: the sampled theta
    and the azimuth's uniform; specular: none), the roulette number, the
    three of gas scattering. Several bounces draw one block, and a
    coned-cosine launch then overwrites each bounce's column 0 with its theta
    (ref: kernel.py:1084-1128)."""
    n_uni = settings.n_uni
    coned = settings.refl_kind == ReflectionKind.CONED_COSINE
    if n_sub > 1:
        u = rng.uniform_block(batch_index, it, n, n_uni * n_sub)
        if coned:
            u[:, 0::n_uni] = rng.cone_theta(
                batch_index, it, (n, n_sub), settings.cone_angle
            )
        return u
    zero = torch.zeros(n, dtype=dtype, device=dev)
    cols = [zero] * n_uni
    if settings.refl_kind == ReflectionKind.DIFFUSE:
        cols[0] = rng.uniform(rng_streams.REFLECT_1, batch_index, it, n)
        cols[1] = rng.uniform(rng_streams.REFLECT_2, batch_index, it, n)
    elif coned:
        cols[0] = rng.cone_theta(batch_index, it, (n,), settings.cone_angle)
        cols[1] = rng.uniform(rng_streams.CONE_PHI, batch_index, it, n)
    if settings.roulette:
        cols[2] = rng.uniform(rng_streams.ROULETTE, batch_index, it, n)
    if n_uni == 6:
        cols[3] = rng.uniform(rng_streams.SCATTER, batch_index, it, n)
        cols[4] = rng.uniform(rng_streams.SCATTER_Z, batch_index, it, n)
        cols[5] = rng.uniform(rng_streams.SCATTER_PHI, batch_index, it, n)
    return torch.stack(cols, dim=1)


def _use_dir(cand, dirn, dim):
    """Initial directions from a particle: rows of ``cand`` that are exactly
    zero keep the source's direction (the reference's isZero check,
    rayTraceKernel.hpp:133-139); the others, with z zeroed first in 2D, are
    normalized (ref: kernel.py:291-297)."""
    cand = cand.to(dirn.dtype).clone()
    nonzero = (cand != 0.0).any(dim=1, keepdim=True)
    if dim == 2:
        cand[:, 2] = 0.0
    n = torch.linalg.norm(cand, dim=1, keepdim=True)
    cand = cand / torch.where(n > 0.0, n, torch.ones_like(n))
    return torch.where(nonzero, cand, dirn)


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
    collision_fn=None,
    reflection_fn=None,
    aux_init_fn=None,
    init_dir_fn=None,
    log_fn=None,
    differentiable=False,
    num_bounces=None,
):
    """Trace one mega-batch of rays to extinction; returns (flux, counters),
    or (flux, counters, logs) with a ``log_fn``.

    geometry: DiskGeometry, TriangleGeometry or LineGeometry (its ``kind``
    picks the kernels, its ``dtype`` the float type of the trace). source:
    any object with ``sample(rng, batch_index, n, ray_indices)``
    (``physics.source``) in that type. bbox: (2, 3) tensor, the
    source-adjusted bounding box (ref: rayUtil.hpp:104-143), read in the
    trace's type. rng: a ``RayRNG`` of the trace's type whose
    ``begin_batch(batch_index)`` has been called.
    ray_indices: (R,) global ray indices (a grid or surface source picks its
    points by them). valid: (R,) bool — lanes beyond the total ray count
    start dead. fused: the fused body (one kernel launch per ``n_sub``
    bounces) or the unfused one; ``config.use_wdist``, ``collision_fn``,
    ``reflection_fn`` and ``aux_init_fn`` take the unfused body whatever
    ``fused`` says (the reference's rule, kernel.py:959-976). n_sub: the
    fused body's bounces per launch at (wide, mid, tail) stage widths. Under
    the window flux model a disk geometry without a window list gets one
    here (``DiskGeometry.with_window_list``; the tracers build it once).
    Returns flux (n_prims,) on the device in the trace's type, or (L,
    n_prims) for a ``collision_fn`` and a particle of L > 1 ``data_labels``,
    and ``BatchCounters``.

    Float64 (``geometry.dtype`` float64; the JAX package's trace under
    ``jax_enable_x64``, kernel.py:263-286): source, rays, weights, flux and
    the hooks' tensors are float64, the bounce runs ``bounce_step`` in
    float64 on the float64 forms of the closest-hit and histogram kernels,
    and the counters stay int. It takes ``fused=False`` (or runs unfused
    anyway: ``differentiable``, ``use_wdist``, a hook); ``fused=True`` is
    refused by name.

    ``differentiable`` (the JAX package's differentiable trace,
    viennaray_tpu/trace/kernel.py:1260-1330): the unfused body for exactly
    ``num_bounces`` iterations (default 32; dead lanes pass through), with
    roulette off, no source sort, no compaction and no host read of the
    survivor count, so lanes keep their places. The closest-hit search runs
    on detached rays and the hit time is recomputed from the selected
    primitive (``ops.bounce.bounce_step``); the deposits go through
    ``ops.histogram.flux_histogram``, whose backward is a kernel too. The
    flux then carries the graph of the particle's sticking (a tensor, or a
    tensor table) and of the geometry's points and normals where they are
    tensors that require a gradient. Discrete events (the hit's selection,
    walls, backfaces) are piecewise constant: straight-through. The hooks
    are refused by name: the JAX package's differentiable trace takes none.

    **The hook contract** (custom particles: the reference's virtual
    surfaceCollision / surfaceReflection / initNew / logData,
    rayParticle.hpp:30-66, and the GPU's callable table; the JAX package's
    hooks, viennaray_tpu/trace/kernel.py:219-246, with torch tensors on the
    trace's device). Every hook is optional. In place of a key each gets
    ``rng``, a ``rng.HookRNG`` bound to (batch, bounce, hook) that draws
    numbers (``rng.uniform(shape)``, ``rng.normal(shape)``) from the trace's
    ``RayRNG``, in its type, under the hook's own stream, keyed by (batch,
    bounce, hook, call): a hook's draws never move the trace's own, so a
    trace draws the same built-in numbers with hooks and without, as it did
    before hooks existed. Every float tensor a hook gets or returns is of
    the trace's type (float32 below; float64 in the float64 trace). Per
    batch, in this order:

    - ``init_dir_fn(rng, ray_indices) -> (R, 3)``: initial directions after
      the source's; zero rows keep the source's, the others are normalized
      (in 2D with z zeroed first). The analog of initNewWithDirection.
    - ``aux_init_fn(rng, ray_indices) -> (R, A)`` float32: per-ray state
      (e.g. an ion's energy, initNew). It runs before the source-coherence
      sort; the rows then move with their rays through that sort and every
      compaction. Given it, ``collision_fn`` and ``reflection_fn`` take
      ``aux`` as their last argument and ``reflection_fn`` returns the new
      aux, which only colliding lanes take.
    - ``log_fn(rng, aux, ray_indices, valid) -> sequence of 1-D tensors``:
      one row each for the tracer's ``DataLog`` (logData), summed over
      batches and applies as float64; ``aux`` is (R, 1) zeros without an
      ``aux_init_fn``.

    Per bounce, on every lane of the stage (dead and non-colliding lanes
    included: their weights are 0 and what a hook returns for them is
    dropped):

    - ``reflection_fn(rng, dirn, normal, prim, mat, weight[, aux]) ->
      (sticking (R,), new_dir (R, 3)[, aux])``, in place of the particle's
      reflection and sticking: ``dirn`` the incoming direction, ``normal``
      and ``mat`` the hit primitive's stored normal and material, ``prim``
      its index, ``weight`` the ray's weight before sticking. The sticking
      update w -= w * sticking, the max-reflection cap and the roulette then
      run as for the built-in (ref: kernel.py:845-881). Its ``rng`` also
      carries ``reflect_uniforms``, the built-in reflection's two uniforms
      of this bounce: ``physics.reflection.diffuse(*rng.reflect_uniforms,
      normal, dim)`` is the built-in diffuse reflection bit for bit.
    - ``collision_fn(flux, ids, weights, dirn, normal, mat, rng[, aux]) ->
      flux``, in place of the built-in deposit: ``flux`` is (N,) float32, or
      (L, N) for a particle of L > 1 data labels, and the hook returns it
      with the bounce's deposits added. ``ids`` (int32) and ``weights``
      (float32) are (R, K + 1) on disks (the hit disk, then its K
      neighbor-list disks; weight 0 where a disk takes nothing) and (R, 1)
      on triangles and lines, ids in original numbering as the flux is
      indexed (ref: kernel.py:810-843). The weights are the pre-sticking
      weights, 1/distance weighted under ``use_wdist``. ``dirn`` is the
      incoming direction, ``normal`` and ``mat`` the hit primitive's
      (primitive 0's where the lane does not collide).

    Deposit with ``ops.histogram.flux_histogram(ids.reshape(-1),
    w.reshape(-1), N)`` (the histogram kernel; the port's spelling of JAX's
    ``flux.at[ids].add(w)``): it sums in a fixed order, so a fixed seed
    gives the same flux. ``index_add_`` on CUDA adds floats in an order that
    changes from run to run. For L channels call it once per channel, or
    once with ``ids + c * N`` into L x N bins.
    """
    hooked = (collision_fn is not None or reflection_fn is not None
              or aux_init_fn is not None)
    fused = (fused and not config.use_wdist and not hooked
             and not differentiable)
    check_supported(config, particle, source, collision_fn, geometry, fused)
    dtype = geometry.dtype
    rng_dtype = getattr(rng, "dtype", torch.float32)
    if rng_dtype != dtype:
        raise NotImplementedError(
            f"the rng draws {rng_dtype} but the trace is {dtype}: give a "
            f"RayRNG of the trace's type (GeneratorRNG(seed, device, "
            f"dtype={dtype}))")
    if differentiable:
        given = [name for name, fn in (
            ("collision_fn", collision_fn), ("reflection_fn", reflection_fn),
            ("aux_init_fn", aux_init_fn), ("init_dir_fn", init_dir_fn),
            ("log_fn", log_fn)) if fn is not None]
        if given:
            raise NotImplementedError(
                "the differentiable trace takes no " + ", ".join(given))
    dim = config.dim
    settings = BounceSettings.from_config(config, particle, fused=fused)
    first_dir, second_dir = settings.first_dir, settings.second_dir
    deposit_kind = settings.deposit_kind(geometry)
    if deposit_kind == "window":
        geometry = geometry.with_window_list()
    wdist = config.use_wdist and deposit_kind == "disk"

    dev = geometry.device
    if differentiable:
        # roulette's renewal zeroes d w / d sticking (ref: diff/trace_grad.py)
        settings = settings._replace(roulette=False)
        if torch.is_tensor(particle.sticking):
            settings = settings._replace(sticking=particle.sticking.to(
                device=dev, dtype=dtype))
    R = ray_indices.shape[0]
    n_prims = geometry.num_primitives
    walls = make_walls(bbox, geometry, settings)
    stick_lanes = sticking_lanes(particle, geometry)
    lo1, hi1, lo2, hi2 = (walls[i] for i in range(4))

    # ---- source sampling -------------------------------------------------
    org, dirn, w0 = source.sample(rng, batch_index, R, ray_indices)
    if not isinstance(source, SOURCES):
        check_sample(org, dirn, w0, R, dev, dtype)

    # particle-controlled initial direction (ref: initNewWithDirection,
    # rayParticle.hpp:31,92; the zero vector means "use the source's")
    if particle.direction is not None:
        dirn = _use_dir(torch.tensor(particle.direction, device=dev).expand(
            R, 3), dirn, dim)
    if init_dir_fn is not None:
        dirn = _use_dir(
            init_dir_fn(HookRNG(rng, rng_streams.HOOK_INIT_DIR, batch_index),
                        ray_indices),
            dirn, dim,
        )
    aux = None
    if aux_init_fn is not None:
        aux = aux_init_fn(HookRNG(rng, rng_streams.HOOK_AUX_INIT, batch_index),
                          ray_indices)
        if aux.ndim != 2 or aux.shape[0] != R or aux.dtype != dtype:
            raise ValueError(
                f"aux_init_fn must return (R, A) {dtype} with R = {R}, got "
                f"{tuple(aux.shape)} {aux.dtype}")
    logs = None
    if log_fn is not None:
        logs = tuple(log_fn(
            HookRNG(rng, rng_streams.HOOK_LOG, batch_index),
            aux if aux is not None
            else torch.zeros((R, 1), dtype=dtype, device=dev),
            ray_indices, valid,
        ))

    weight = torch.where(valid, w0, torch.zeros_like(w0))
    alive = valid
    hfb = torch.zeros(R, dtype=torch.bool, device=dev)
    n_refl = torch.zeros(R, dtype=torch.int32, device=dev)
    n_bdry = torch.zeros(R, dtype=torch.int32, device=dev)
    # a collision_fn fills one channel per data label (ref: kernel.py:324-334)
    n_chan = len(particle.data_labels) if collision_fn is not None else 1
    flux_shape = (n_chan, n_prims) if n_chan > 1 else (n_prims,)
    flux = torch.zeros(flux_shape, dtype=dtype, device=dev)
    # a launch's counts summed (COUNT_NAMES; the survivors' slot is not read)
    counts = torch.zeros(len(COUNT_NAMES), dtype=torch.int64, device=dev)

    def land(flux, org, dirn, hit_prim, wdep, t_hit):
        """Deposits handed out by a bounce (ref: DiffuseParticle::
        surfaceCollision adds the current rayWeight, rayParticle.hpp:148-156):
        the hit disk and every neighbor-list disk that passes the local
        re-test take the weight (with ``use_wdist`` weighted by 1/distance),
        or under the window model every window-list disk within tau past the
        hit; of triangles and lines, the single closest hit."""
        ids, w = deposit_entries(org, dirn, hit_prim, wdep, geometry, t_hit,
                                 settings, use_wdist=wdist,
                                 differentiable=differentiable)
        return flux + _flux_add(ids, w, n_prims)

    def with_aux(args, aux):
        return args if aux is None else args + (aux,)

    def hook_reflect(it, u, aux, new_aux):
        """``bounce_step``'s ``reflect`` around the reflection_fn; the new
        aux of colliding lanes lands in ``new_aux[0]``."""
        handle = HookRNG(rng, rng_streams.HOOK_REFLECTION, batch_index, it,
                         reflect_uniforms=(u[:, 0], u[:, 1]))

        def reflect(dirn, normal, prim, weight, collide):
            mat = geometry.material_ids[prim.long()]
            out = reflection_fn(*with_aux(
                (handle, dirn, normal, prim, mat, weight), aux))
            if aux is not None:
                new_aux[0] = torch.where(collide[:, None], out[2], aux)
            sticking = torch.as_tensor(out[0], dtype=dtype, device=dev)
            return sticking, out[1].to(dtype)

        return reflect

    def hook_collide(it, flux, org, dirn, hit_prim, wdep, t_hit, aux):
        """The bounce's deposits through the collision_fn, ids and weights
        (R, K + 1) or (R, 1)."""
        ids, w = deposit_entries(org, dirn, hit_prim, wdep, geometry, t_hit,
                                 settings, use_wdist=wdist)
        width = org.shape[0]
        prim_c = torch.clamp(hit_prim, min=0).long()
        out = collision_fn(*with_aux((
            flux, ids.view(width, -1), w.view(width, -1), dirn,
            geometry.normals[prim_c], geometry.material_ids[prim_c],
            HookRNG(rng, rng_streams.HOOK_COLLISION, batch_index, it),
        ), aux))
        if out.shape != flux.shape or out.dtype != flux.dtype:
            raise ValueError(
                f"collision_fn must return the flux {tuple(flux.shape)} "
                f"{flux.dtype}, got {tuple(out.shape)} {out.dtype}")
        return out

    def unfused_body(it, flux, state, aux):
        """One bounce of the whole stage by tensor ops around the closest-hit
        and histogram kernels; returns (flux, survivor count, new state,
        iterations done, new aux)."""
        u = _bounce_uniforms(
            rng, batch_index, it, state.org.shape[0], 1, settings, dev, dtype
        )
        new_aux = [aux]
        reflect = (None if reflection_fn is None
                   else hook_reflect(it, u, aux, new_aux))
        new_state, hit_prim, wdep, t_hit, step_counts = bounce_step(
            state, u, geometry, walls, settings, _SEARCH[geometry.kind],
            stick_lanes, reflect=reflect, differentiable=differentiable,
        )
        if collision_fn is not None:
            flux = hook_collide(it, flux, state.org, state.dirn, hit_prim,
                                wdep, t_hit, aux)
        else:
            flux = land(flux, state.org, state.dirn, hit_prim, wdep, t_hit)
        counts[:N_EVENTS].add_(step_counts)
        return flux, new_state.alive.sum(), new_state, 1, new_aux[0]

    def fused_body(it, flux, state, aux):
        """One launch of the bounce kernel: ``n_sub`` bounces of the whole
        stage; same returns (no hook reaches it: ``aux`` is None)."""
        width = state.org.shape[0]
        k = n_sub_for(width, n_sub)
        hand_out = hand_out_for(
            deposit_kind, geometry.soa_chunk_bbs.shape[0],
            settings.refl_kind, k,
        )
        u = _bounce_uniforms(rng, batch_index, it, width, k, settings, dev)
        state = RayState(*(x.contiguous() for x in state))
        res = fused_bounce(
            state, u.contiguous(), geometry, walls, settings, n_sub=k,
            deposit_in_kernel=not hand_out, stick_lanes=stick_lanes,
        )
        if hand_out:
            flux = land(flux, state.org, state.dirn, res.hit_prim, res.wdep,
                        res.t_hit)
        else:
            flux = flux + res.flux
        counts.add_(res.counts)
        return flux, res.counts[N_EVENTS], res.state, k, aux

    body = fused_body if fused else unfused_body

    # ---- source-coherence sort -------------------------------------------
    # Random source origins scatter neighbouring lanes over the whole domain.
    # Sorting the batch by source-plane Morton cell makes blocks of lanes
    # spatially compact (deterministic per seed; deposits are
    # order-independent sums, and each lane's uniforms remain i.i.d.).
    if R >= 2048 and not differentiable:
        nb = 6  # 64x64 source-plane cells
        one = torch.tensor(1e-30, dtype=dtype, device=dev)
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
        if aux is not None:
            aux = aux[take]

    # ---- staged execution with ray compaction ---------------------------
    # Roulette kills rays at different bounce counts, so a fixed-size
    # wavefront wastes whole-batch work on a tail of stragglers. Run the loop
    # until the survivor count fits a 2x smaller batch, compact the survivors
    # to the front (stable argsort — deterministic), and continue at the
    # smaller width, floored at MIN_STAGE. The long tail — e.g.
    # near-horizontal rays ping-ponging between periodic walls until the
    # max_boundary_hits cap — then runs at minimal width. A fused launch of
    # several bounces may pass several caps at once: dead lanes are no-ops,
    # and a stage whose cap is already met runs no iteration. The
    # differentiable trace has no ladder: a fixed bounce count at full width
    # (the reference's scan).
    stage_caps = []
    cap = R
    while cap > MIN_STAGE and not differentiable:
        cap //= STAGE_SHRINK
        stage_caps.append(max(cap, MIN_STAGE))
    if not differentiable:
        stage_caps.append(0)  # final stage: run to extinction

    bb_lo = bbox[0]
    bb_ext = torch.clamp(bbox[1] - bbox[0], min=1e-6)

    state = RayState(org, dirn, weight, w0, alive, hfb, n_refl, n_bdry)
    if differentiable:
        for it in range(32 if num_bounces is None else int(num_bounces)):
            flux, _, state, _, _ = body(it, flux, state, None)
    it = 0
    n_alive = 0 if differentiable else int(alive.sum())
    sorted_since_bounce = False
    for cap in stage_caps:
        while it < config.max_bounces and n_alive > cap:
            flux, alive_count, state, done, aux = body(it, flux, state, aux)
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
            if aux is not None:
                aux = aux[:cap]
        else:
            # spatial compaction: survivors sorted by origin cell and
            # direction octant, so neighbouring lanes stay coherent after
            # diffuse bounces decohere the source order
            key_s = _spatial_key(
                state.org, state.dirn, state.alive, bb_lo, bb_ext
            )
            take = torch.argsort(key_s, stable=True)[:cap]
            state = RayState(*(x[take] for x in state))
            if aux is not None:
                aux = aux[take]
            sorted_since_bounce = True

    c = dict(zip(COUNT_NAMES, counts.tolist()))  # the one fetch per batch
    counters = BatchCounters(
        total_traces=c["traces"], non_geometry_hits=c["exit"],
        geometry_hits=c["collide"], particle_hits=c["scatter"],
        boundary_hits=c["wall"], reflections=c["collide"],
        chunks_swept=c["chunks_swept"], tile_bounces=c["tile_bounces"],
    )
    if log_fn is not None:
        return flux, counters, logs
    return flux, counters
