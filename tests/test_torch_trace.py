"""The port's trace against the JAX package's, at small sizes on the CPU.

(a) one mega-batch, lane-matched: both packages trace the same tables with
    the same uniforms, through the unfused and the fused body; (b) end to end
    through ``TraceDisk`` against the ``disk3d_trench`` golden; (c)
    determinism; (d) refusals. Several data labels on a built-in particle are
    traced, not refused: ``test_torch_repairs.py`` holds them to the JAX
    package.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viennaray_tpu as vrt
from viennaray_tpu.trace import kernel as ref_kernel

import viennaray_tpu_torch as vrtt
from viennaray_tpu_torch.config import adjust_bounding_box
from viennaray_tpu_torch.io import fixtures
from viennaray_tpu_torch.physics.source import RandomSource
from viennaray_tpu_torch.trace.kernel import trace_batch

from torch_port_helpers import JaxKeyedRNG, port_geometry, reference_geometry

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "benchmarks", "golden",
)


def _rel_l2(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


# ---- (a) lane-matched against the reference's bodies ----------------------
def _lane_matched(ref_knobs, max_bounces=3000, **port_kwargs):
    """One mega-batch of R = 4,096 through both packages on the same tables
    with the same uniforms; returns (flux, counters) of the port and of the
    reference. The source sort and the ladder's caps 2048 / 1024 / 512 / 0
    run, the per-bounce resort is off in the reference (fewer than 8 chunks).

    Equal t: on the CPU the reference's unfused body searches by brute force
    and gives a tie to the lowest ORIGINAL index, where its TPU kernels and
    the port give it to the lowest sorted lane. Ties are common (overlapping
    disks of one flat face), and near an edge the two choices have different
    neighbor lists, so whole deposits move. The cloud is therefore handed to
    both packages in packed order, where the two rules pick the same disk.
    """
    R, batch_index, seed = 4096, 2, 12346
    pts, nrm, grid_delta, first_build = reference_geometry("trench_0.5")
    order = np.asarray(first_build.soa_perm)[: len(pts)]
    ref_geo = vrt.DiskGeometry.build(pts[order], nrm[order], grid_delta, dim=3)
    np.testing.assert_array_equal(
        np.asarray(ref_geo.soa_perm)[: len(pts)], np.arange(len(pts))
    )
    conds = [vrt.BoundaryCondition.PERIODIC] * 3
    ref_geo = ref_geo.with_areas((0, 1), conds)
    geo = port_geometry(ref_geo)
    assert geo.soa_chunk_bbs.shape[0] < 8

    bbox = adjust_bounding_box(
        np.asarray(ref_geo.bbox), vrtt.TraceDirection.POS_Z,
        ref_geo.disk_radius, 3,
    ).astype(np.float32)
    ref_config = vrt.TraceConfig(
        dim=3, boundary_conditions=tuple(conds), ray_batch_size=R,
        rng_seed=seed, use_random_seed=False, max_bounces=max_bounces,
    )
    ref_source = vrt.RandomSource(
        bbox=jnp.asarray(bbox), cosine_power=jnp.float32(1.0), ray_dir=2,
        first_dir=0, second_dir=1, min_max=1, pos_neg=-1.0, dim=3,
    )
    base_key = jax.random.PRNGKey(seed)
    ray_indices = np.arange(batch_index * R, (batch_index + 1) * R)
    valid = ray_indices < (batch_index + 1) * R - 100  # the last lanes start dead
    ref_trace = jax.jit(functools.partial(
        ref_kernel.trace_batch, config=ref_config, geo_type="disk",
        knobs=ref_knobs,
    ))
    ref_flux, ref_cnt = ref_trace(
        ref_geo, ref_source, vrt.DiffuseParticle(0.1, "flux"),
        jnp.asarray(bbox), jax.random.fold_in(base_key, batch_index),
        jnp.asarray(ray_indices, jnp.int32), jnp.asarray(valid),
    )

    config = vrtt.TraceConfig(
        dim=3, boundary_conditions=(vrtt.BoundaryCondition.PERIODIC,) * 3,
        ray_batch_size=R, rng_seed=seed, use_random_seed=False,
        max_bounces=max_bounces,
    )
    source = RandomSource(
        bbox=torch.from_numpy(bbox), cosine_power=1.0, ray_dir=2,
        first_dir=0, second_dir=1, min_max=1, pos_neg=-1.0, dim=3,
    )
    rng = JaxKeyedRNG(base_key)
    rng.begin_batch(batch_index)
    flux, cnt = trace_batch(
        geo, source, vrtt.DiffuseParticle(0.1, "flux"),
        torch.from_numpy(bbox), rng, batch_index,
        torch.from_numpy(ray_indices), torch.from_numpy(valid), config,
        **port_kwargs,
    )
    return flux.numpy(), cnt, np.asarray(ref_flux), ref_cnt, int(valid.sum())


def _assert_lane_matched(flux, cnt, ref_flux, ref_cnt, n_valid,
                         counters=0.002, rel_l2=1e-3, bins_off=2):
    for name in ("total_traces", "geometry_hits", "boundary_hits",
                 "non_geometry_hits"):
        want = int(getattr(ref_cnt, name))
        got = getattr(cnt, name)
        assert want > 800, name
        assert abs(got - want) <= counters * want, (name, got, want)
    assert cnt.non_geometry_hits <= n_valid
    assert _rel_l2(flux, ref_flux) < rel_l2
    if bins_off is not None:
        off = np.abs(flux - ref_flux) > 1e-5 * np.abs(ref_flux).max()
        assert off.sum() <= bins_off


def test_trace_batch_lane_matched_with_reference():
    """The port's unfused body against the reference's.

    Tolerances: counters within 0.2 %, flux rel-L2 < 1e-3 (measured: counters
    equal, flux 7e-8). XLA:CPU fuses and contracts differently from eager
    PyTorch, and the brute force expands the squared distance, so a last-bit
    difference can flip a rare test on a disk's very rim. At this seed none
    flips: besides the norm over all bins, at most two bins may differ by
    more than 1e-5 of the largest flux.
    """
    _assert_lane_matched(*_lane_matched(
        ref_kernel.EnvKnobs(fused=False), fused=False
    ))


def _fused_knobs(n_sub):
    return ref_kernel.EnvKnobs(
        fused=True, fused_interpret=True, nsub_wide=n_sub[0],
        nsub_mid=n_sub[1], nsub_tail=n_sub[2],
    )


@pytest.mark.parametrize(
    "n_sub,max_bounces", [((1, 1, 1), 3), ((1, 4, 4), 4)]
)
def test_trace_batch_fused_lane_matched_with_reference(n_sub, max_bounces):
    """The port's fused body against the reference's megakernel in interpret
    mode, up to the first compaction: three launches of one bounce (the
    unfused key schedule), or one launch of four bounces at width 4,096 (one
    block of uniforms). With 2 chunks both packages deposit in the kernel:
    the port through the neighbor lists, the reference by its 2r-ball sweep.

    Why only up to the first compaction: the reference's approximate
    reciprocal moves a hit time by up to 1.4e-5 relative, which flips about
    one ray in 4,000 between a wall and an escape or between two overlapping
    disks. The compaction sorts the survivors, so one lane more or less moves
    every later lane by one, and a lane's uniforms go by its position: from
    there on the two runs are two samples (the next test).

    Tolerances: counters within 0.2 % (measured: at most 2 apart). Flux
    rel-L2 < 1e-2 and at most 10 bins off by more than 1e-5 of the largest
    (measured 3.9e-3 with 3 bins, 5.2e-3 with 7): a ray whose hit goes to the
    other of two overlapping disks moves a whole deposit, which 1e-3 and two
    bins do not allow at 4,096 rays.
    """
    _assert_lane_matched(
        *_lane_matched(_fused_knobs(n_sub), max_bounces=max_bounces,
                       fused=True, n_sub=n_sub),
        rel_l2=1e-2, bins_off=10,
    )


def test_trace_batch_fused_whole_run_agrees_with_reference_within_noise():
    """The whole ladder against the reference's fused body: width 4,096 runs
    4 bounces per launch, the stages from 2,048 down run 4 as well on both
    sides (the reference's 16-fold unrolled kernel takes over a minute to
    compile in interpret mode; the port's 16 is held to repeated single
    bounces in ``test_torch_bounce.py`` and runs in the golden test below).
    After the first compaction the runs are two samples of about 4,000 rays
    (see the test above): counters within 3 % (measured 0.2 to 0.6 %), flux
    rel-L2 < 0.15 (measured 0.053), the bound that
    ``test_same_seed_is_bitwise_equal_and_batch_size_only_changes_bits`` puts
    on two samples of 20,000 rays.
    """
    n_sub = (1, 4, 4)
    _assert_lane_matched(
        *_lane_matched(_fused_knobs(n_sub), fused=True, n_sub=n_sub),
        counters=0.03, rel_l2=0.15, bins_off=None,
    )


def test_fused_equals_unfused_with_one_bounce_per_launch():
    """With n_sub = (1, 1, 1) and ``GeneratorRNG`` both bodies draw the same
    numbers in the same order and go through one step function and the exact
    histogram: on the CPU the counters are equal and the flux is bitwise
    equal, with deposits in the kernel (2 chunks) and handed out (a cloud
    packed into 4 chunks)."""
    from viennaray_tpu_torch.geometry.disk_geometry import DiskGeometry
    from viennaray_tpu_torch.ops.nearest_hit import pack_disk_prims
    from viennaray_tpu_torch.rng import GeneratorRNG

    pts, nrm = fixtures.create_trench_grid_3d(grid_delta=0.5)
    geo = DiskGeometry.build(pts, nrm, 0.5, device="cpu")
    soa, perm, bbs = pack_disk_prims(
        geo.points.numpy(), geo.normals.numpy(), geo.radii.numpy(), pad_to=256
    )
    inv = np.zeros(len(pts), np.int32)
    inv[perm[: len(pts)]] = np.arange(len(pts), dtype=np.int32)
    geo4 = geo.replace(
        prims_soa=torch.from_numpy(soa), soa_perm=torch.from_numpy(perm),
        soa_chunk_bbs=torch.from_numpy(bbs), soa_inv_perm=torch.from_numpy(inv),
    )
    assert geo.soa_chunk_bbs.shape[0] == 2 and geo4.soa_chunk_bbs.shape[0] >= 4
    bbox = torch.from_numpy(adjust_bounding_box(
        geo.bbox.numpy(), vrtt.TraceDirection.POS_Z, geo.disk_radius, 3,
    ).astype(np.float32))
    R = 4096
    config = vrtt.TraceConfig(
        dim=3, boundary_conditions=(vrtt.BoundaryCondition.PERIODIC,) * 3,
        ray_batch_size=R,
    )
    source = RandomSource(
        bbox=bbox, cosine_power=1.0, ray_dir=2, first_dir=0, second_dir=1,
        min_max=1, pos_neg=-1.0, dim=3,
    )
    for geometry in (geo, geo4):
        runs = []
        for kwargs in (dict(fused=False), dict(fused=True, n_sub=(1, 1, 1))):
            rng = GeneratorRNG(21, "cpu")
            rng.begin_batch(0)
            runs.append(trace_batch(
                geometry, source, vrtt.DiffuseParticle(0.2, "flux"), bbox,
                rng, 0, torch.arange(R), torch.ones(R, dtype=torch.bool),
                config, **kwargs,
            ))
        (flux_u, cnt_u), (flux_f, cnt_f) = runs
        assert cnt_u == cnt_f and cnt_u.geometry_hits > 1000
        assert torch.equal(flux_u, flux_f)


# ---- (b) end to end through TraceDisk against the golden ------------------
def _golden_tracer(seed=12345, batch=16384, rays=200_000, fused=True):
    """The ``disk3d_trench`` configuration of benchmarks/make_goldens.py."""
    pts, nrm = fixtures.create_trench_grid_3d(grid_delta=0.5)
    t = vrtt.TraceDisk(dim=3, device="cpu", fused=fused)
    t.set_geometry(pts, nrm, 0.5)
    t.set_boundary_conditions([vrtt.BoundaryCondition.PERIODIC] * 3)
    t.set_particle_type(vrtt.SpecularParticle(0.5, 2.0, "flux"))
    t.set_number_of_rays_fixed(rays)
    t.set_rng_seed(seed)
    t.set_ray_batch_size(batch)
    return t


def test_trace_disk_matches_disk3d_trench_golden():
    """Through the default tracer: the fused body with its ladder of 1, 4 and
    16 bounces per launch."""
    golden = np.load(os.path.join(GOLDEN_DIR, "disk3d_trench.npy"))
    with open(os.path.join(GOLDEN_DIR, "manifest.json")) as f:
        meta = json.load(f)["disk3d_trench"]
    t = _golden_tracer(rays=meta["num_rays"])
    flux = t.apply()
    norm = t.smooth_flux(t.normalize_flux(flux), 1)
    assert norm.shape == golden.shape and np.isfinite(norm).all()
    # the tolerance of tests/test_goldens.py: Monte Carlo sized
    assert _rel_l2(norm, golden) < 0.05
    info = t.get_ray_trace_info()
    want = meta["geometry_hits"] / meta["num_rays"]
    assert abs(info.geometry_hits / info.num_rays - want) <= 0.02 * want
    assert info.num_rays == meta["num_rays"]
    # the labelled channel holds the raw flux
    np.testing.assert_array_equal(
        t.get_local_data().get_vector_data("flux"), flux
    )


def test_unfused_trace_disk_matches_disk3d_trench_golden():
    """``TraceDisk(fused=False)`` at a quarter of the golden's rays: the same
    bounds (measured rel-L2 0.0393, twice the noise of the full count)."""
    golden = np.load(os.path.join(GOLDEN_DIR, "disk3d_trench.npy"))
    with open(os.path.join(GOLDEN_DIR, "manifest.json")) as f:
        meta = json.load(f)["disk3d_trench"]
    t = _golden_tracer(rays=meta["num_rays"] // 4, fused=False)
    norm = t.smooth_flux(t.normalize_flux(t.apply()), 1)
    assert _rel_l2(norm, golden) < 0.05
    info = t.get_ray_trace_info()
    want = meta["geometry_hits"] / meta["num_rays"]
    assert abs(info.geometry_hits / info.num_rays - want) <= 0.02 * want


# ---- (c) determinism ------------------------------------------------------
def test_same_seed_is_bitwise_equal_and_batch_size_only_changes_bits():
    """Through the default (fused) tracer."""
    runs = {}
    for name, batch in (("a", 4096), ("b", 4096), ("c", 8192)):
        t = _golden_tracer(seed=7, batch=batch, rays=20_000)
        flux = t.apply()
        runs[name] = (flux, t.get_ray_trace_info(), t)
    np.testing.assert_array_equal(runs["a"][0], runs["b"][0])
    assert runs["a"][1].geometry_hits == runs["b"][1].geometry_hits
    # another batch size draws other numbers: same statistics, other bits
    assert not np.array_equal(runs["a"][0], runs["c"][0])
    ha, hc = runs["a"][1].geometry_hits, runs["c"][1].geometry_hits
    assert abs(ha - hc) <= 0.03 * ha
    ta, tc = runs["a"][2], runs["c"][2]
    na = ta.smooth_flux(ta.normalize_flux(runs["a"][0]), 1)
    nc = tc.smooth_flux(tc.normalize_flux(runs["c"][0]), 1)
    assert _rel_l2(na, nc) < 0.15
    # a second apply on one tracer is a new run number: other numbers
    assert not np.array_equal(ta.apply(), runs["a"][0])


# ---- (d) refusals ---------------------------------------------------------
def _small_tracer():
    pts, nrm = fixtures.create_plane_grid(1.0, 2.0, (0, 1, 2))
    t = vrtt.TraceDisk(dim=3, device="cpu")
    t.set_geometry(pts, nrm, 1.0)
    t.set_particle_type(vrtt.DiffuseParticle(0.5, "flux"))
    t.set_number_of_rays_fixed(512)
    t.set_rng_seed(1)
    return t


def _apply_with_particle(**fields):
    t = _small_tracer()
    t.set_particle_type(vrtt.Particle(**{"sticking": 0.5, **fields}))
    t.apply()


REFUSALS = {
    # the JAX package refuses this pair too (trace/kernel.py:336-342)
    "window_with_wdist": lambda: trace_batch(
        None, None, vrtt.DiffuseParticle(0.5), None, None, 0, None, None,
        vrtt.TraceConfig(flux_model="window", use_wdist=True),
    ),
    "custom_hooks": lambda: _small_tracer().set_custom_functions(
        collision_fn=lambda *a: None
    ),
    "data_log_hook": lambda: _small_tracer().set_data_log_fn(lambda *a: []),
    "other_sources": lambda: _small_tracer().set_source(object()),
    "f64_tracing": lambda: vrtt.TraceDisk(
        dim=3, device="cpu", dtype=torch.float64
    ),
}


@pytest.mark.parametrize("setting", sorted(REFUSALS))
def test_unsupported_setting_raises(setting):
    with pytest.raises(NotImplementedError):
        REFUSALS[setting]()


def test_supported_small_run_and_no_cuda_refusal():
    """The refusal cases' tracer does run when nothing unsupported is set;
    without a CUDA device the default device raises instead of tracing on
    the CPU."""
    t = _small_tracer()
    flux = t.apply()
    assert flux.shape == (25,) and flux.dtype == np.float64 and flux.sum() > 0
    assert t.get_ray_trace_info().num_rays == 512
    norm_max = t.normalize_flux(flux, vrtt.NormalizationType.MAX)
    assert np.isclose(norm_max.max(), 1.0, rtol=0.2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            vrtt.TraceDisk(dim=3)
    # what earlier slices refused now traces: gas scattering, per-material
    # sticking and the coned-cosine reflection
    _apply_with_particle(
        mean_free_path=0.5, material_sticking=(0.1, 0.2),
        reflection_kind=int(vrtt.ReflectionKind.CONED_COSINE), cone_angle=0.3,
    )
    # a particle's fixed initial direction overrides the source's: straight
    # down onto the plane with sticking 1, every ray hits exactly once
    t = _small_tracer()
    t.set_particle_type(vrtt.SpecularParticle(1.0, 1.0, direction=(0, 0, -2)))
    t.apply()
    info = t.get_ray_trace_info()
    assert info.geometry_hits == info.total_rays_traced == 512
