"""Shared helpers of the ``test_torch_*`` files: the same geometry built by
both packages, and a ``RayRNG`` that hands the port the JAX package's own
uniforms, drawn with ``jax.random`` under the reference's key schedule."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import viennaray_tpu as vrt
from viennaray_tpu.config import BoundaryCondition as RefBC
from viennaray_tpu.config import ReflectionKind as RefKind
from viennaray_tpu.io import fixtures as ref_fixtures
from viennaray_tpu.ops import pallas_bounce
from viennaray_tpu.ops import sampling as ref_sampling
from viennaray_tpu_torch import rng as streams
from viennaray_tpu_torch.geometry.disk_geometry import DiskGeometry
from viennaray_tpu_torch.geometry.line_geometry import LineGeometry
from viennaray_tpu_torch.geometry.triangle_geometry import TriangleGeometry
from viennaray_tpu_torch.ops import bounce

GEOMETRY_FIELDS = (
    "points", "normals", "radii", "material_ids", "neighbors", "areas",
    "bbox", "prims_soa", "soa_perm", "soa_chunk_bbs", "soa_inv_perm",
    "neighbor_pack",
)

# name -> (maker of (points, normals) in the reference's fixtures, grid delta)
CLOUDS = {
    "trench_0.5": (lambda f: f.create_trench_grid_3d(grid_delta=0.5), 0.5),
    "trench_1.0": (lambda f: f.create_trench_grid_3d(grid_delta=1.0), 1.0),
    "plane": (lambda f: f.create_plane_grid(0.5, 3.0, (0, 1, 2)), 0.5),
}


def reference_geometry(name):
    """(points, normals, grid_delta, JAX-package DiskGeometry) of a cloud."""
    make, grid_delta = CLOUDS[name]
    pts, nrm = make(ref_fixtures)
    return pts, nrm, grid_delta, vrt.DiskGeometry.build(pts, nrm, grid_delta, dim=3)


def reference_arrays(ref_geo):
    return {f: np.asarray(getattr(ref_geo, f)) for f in GEOMETRY_FIELDS}


def port_geometry(ref_geo):
    """The port's geometry on the very tables of the reference's."""
    return DiskGeometry.from_reference_arrays(
        reference_arrays(ref_geo), dim=ref_geo.dim,
        grid_delta=ref_geo.grid_delta, disk_radius=ref_geo.disk_radius,
        device="cpu",
    )


TRIANGLE_FIELDS = (
    "vertices", "triangles", "normals", "areas", "material_ids", "bbox",
    "prims_soa", "soa_perm", "soa_chunk_bbs", "soa_inv_perm",
)


def reference_triangle_arrays(ref_geo):
    """The array fields of a JAX-package ``TriangleGeometry`` as numpy."""
    return {f: np.asarray(getattr(ref_geo, f)) for f in TRIANGLE_FIELDS}


def port_triangle_geometry(ref_geo):
    """The port's triangle geometry on the very tables of the reference's."""
    return TriangleGeometry.from_reference_arrays(
        reference_triangle_arrays(ref_geo), dim=ref_geo.dim,
        grid_delta=ref_geo.grid_delta, device="cpu",
    )


LINE_FIELDS = (
    "p0", "p1", "normals", "areas", "material_ids", "bbox", "prims_soa",
    "soa_perm", "soa_chunk_bbs", "soa_inv_perm",
)


def reference_line_arrays(ref_geo):
    """The array fields of a JAX-package ``LineGeometry`` as numpy."""
    return {f: np.asarray(getattr(ref_geo, f)) for f in LINE_FIELDS}


def port_line_geometry(ref_geo):
    """The port's line geometry on the very tables of the reference's."""
    return LineGeometry.from_reference_arrays(
        reference_line_arrays(ref_geo), grid_delta=ref_geo.grid_delta,
        device="cpu",
    )


# ---- one launch of the bounce against the reference's megakernel ----------
MAX_BDRY = 5
MAX_REFL = 7


def make_settings(kind, bc, dim=3, mean_free_path=-1.0, cone_angle=0.5):
    """3D: source on +z, walls on x and y; 2D: source on +y, walls on x (the
    second wall axis is z and never met)."""
    first_dir, second_dir, ray_axis = (0, 1, 2) if dim == 3 else (0, 2, 1)
    return bounce.BounceSettings(
        dim=dim, first_dir=first_dir, second_dir=second_dir,
        ray_axis=ray_axis, bc1=int(bc),
        bc2=int(bc), refl_kind=int(kind), sticking=0.3, t_near=1e-4,
        max_reflections=MAX_REFL, max_boundary_hits=MAX_BDRY, roulette=True,
        weight_threshold_frac=0.1, renew_weight_frac=0.3,
        cone_angle=cone_angle, mean_free_path=mean_free_path,
    )


def make_state(bbox, n, n_sub, seed, n_uni=3, dim=3, theta_max=None):
    """Seeded state by numpy: the first half source rays (top plane, cosine
    lobe), the second half interior rays (anywhere in the box, any
    direction); some lanes dead, some that have passed a disk from behind,
    some with a counter at its cap, weights from full down to the roulette
    threshold. ``n_uni`` uniforms per sub-bounce; with ``theta_max`` column 0
    of each holds an angle in [0, theta_max) as a coned-cosine launch's does.
    ``dim=2``: the same in the plane z = 0 with the source on the +y face."""
    if dim == 2:
        return _make_state_2d(bbox, n, n_sub, seed, n_uni, theta_max)
    rng = np.random.default_rng(seed)
    lo, hi = bbox[0], bbox[1]
    org = (lo + (hi - lo) * rng.random((n, 3))).astype(np.float32)
    v = rng.normal(size=(n, 3))
    dirn = (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
    half = n // 2
    org[:half, 2] = hi[2]
    phi = 2 * np.pi * rng.random(half)
    cos_t = np.sqrt(rng.random(half))
    sin_t = np.sqrt(1 - cos_t * cos_t)
    dirn[:half] = np.stack(
        [sin_t * np.cos(phi), sin_t * np.sin(phi), -cos_t], axis=1
    ).astype(np.float32)
    w0 = np.ones(n, np.float32)
    weight = rng.choice(
        np.array([1.0, 0.7, 0.3, 0.14, 0.11], np.float32), size=n
    )
    alive = rng.random(n) > 0.1
    hfb = rng.random(n) < 0.2
    n_refl = rng.integers(0, MAX_REFL + 1, n).astype(np.int32)
    n_bdry = rng.integers(0, MAX_BDRY + 1, n).astype(np.int32)
    uniforms = _uniforms(rng, n, n_sub, n_uni, theta_max)
    return org, dirn, weight, w0, alive, hfb, n_refl, n_bdry, uniforms


def _uniforms(rng, n, n_sub, n_uni, theta_max):
    uniforms = rng.random((n, n_uni * n_sub), dtype=np.float32)
    if theta_max is not None:
        uniforms[:, 0::n_uni] *= np.float32(theta_max)
    return uniforms


def _make_state_2d(bbox, n, n_sub, seed, n_uni, theta_max):
    rng = np.random.default_rng(seed)
    lo, hi = bbox[0], bbox[1]
    org = (lo + (hi - lo) * rng.random((n, 3))).astype(np.float32)
    org[:, 2] = 0.0
    ang = 2 * np.pi * rng.random(n)
    dirn = np.stack([np.cos(ang), np.sin(ang), 0 * ang], axis=1).astype(np.float32)
    half = n // 2
    org[:half, 1] = hi[1]
    tilt = np.arcsin(2 * rng.random(half) - 1)  # the flattened cosine lobe
    dirn[:half] = np.stack(
        [np.sin(tilt), -np.cos(tilt), 0 * tilt], axis=1
    ).astype(np.float32)
    w0 = np.ones(n, np.float32)
    weight = rng.choice(
        np.array([1.0, 0.7, 0.3, 0.14, 0.11], np.float32), size=n
    )
    alive = rng.random(n) > 0.1
    hfb = rng.random(n) < 0.2
    n_refl = rng.integers(0, MAX_REFL + 1, n).astype(np.int32)
    n_bdry = rng.integers(0, MAX_BDRY + 1, n).astype(np.int32)
    uniforms = _uniforms(rng, n, n_sub, n_uni, theta_max)
    return org, dirn, weight, w0, alive, hfb, n_refl, n_bdry, uniforms


def port_state(arrays):
    return bounce.RayState(*(torch.from_numpy(np.array(a)) for a in arrays[:8]))


def reference_bounce(ref_geo, walls, arrays, settings, n_sub, hand_out,
                     geo_kind="disk", stick_lanes=None, flux_model="neighbor"):
    """The megakernel in interpret mode, as the JAX package's own tests run
    it on the CPU; outputs as numpy in the port's layout. ``stick_lanes``:
    the per-lane sticking table (``per_mat``), else the settings' value;
    ``flux_model``: the disks' deposit model ("window" deposits in the
    kernel only)."""
    org, dirn, weight, w0, alive, hfb, n_refl, n_bdry, uniforms = arrays
    flags = np.stack(
        [alive, hfb, n_refl, n_bdry], axis=1
    ).astype(np.float32)
    n_chunks = ref_geo.soa_chunk_bbs.shape[0]
    outs = pallas_bounce.fused_bounce(
        jnp.asarray(org), jnp.asarray(dirn), jnp.asarray(weight[:, None]),
        jnp.asarray(w0[:, None]), jnp.asarray(flags), jnp.asarray(uniforms),
        ref_geo.prims_soa, ref_geo.soa_chunk_bbs,
        jnp.asarray(walls.numpy().reshape(1, 9)),
        jnp.full((1, 1), settings.sticking, jnp.float32)
        if stick_lanes is None
        else jnp.asarray(np.asarray(stick_lanes, np.float32).reshape(1, -1)),
        per_mat=stick_lanes is not None,
        mfp=max(float(settings.mean_free_path), 0.0),
        pt=ref_geo.prims_soa.shape[1] // n_chunks, t_near=settings.t_near,
        dim=settings.dim, first_dir=settings.first_dir,
        second_dir=settings.second_dir, ray_axis=settings.ray_axis,
        bc1=RefBC(settings.bc1), bc2=RefBC(settings.bc2),
        refl_kind=RefKind(settings.refl_kind),
        max_bounces_cfg=settings.max_reflections,
        max_bdry=settings.max_boundary_hits,
        wthresh=settings.weight_threshold_frac,
        wrenew=settings.renew_weight_frac, roulette=True, interpret=True,
        n_sub=n_sub, xla_deposit=hand_out, rt=256, mxu_pick=False,
        # the window deposit pass reads the ordered sweep's drift, which the
        # pre-computed candidate path does not set: that path is off for it
        precand=flux_model != "window", slice_w=1 << 19,
        entry_aux=flux_model != "window", geo_kind=geo_kind,
        flux_model=flux_model,
    )
    org2, dir2, w2, flags2, stats, flux_sorted = (np.asarray(o) for o in outs[:6])
    res = dict(
        org=org2, dirn=dir2, weight=w2[:, 0], alive=flags2[:, 0] > 0.5,
        hfb=flags2[:, 1] > 0.5, n_refl=flags2[:, 2].astype(np.int32),
        n_bdry=flags2[:, 3].astype(np.int32),
        counts=stats[:, 0:5].sum(axis=0),
        flux=flux_sorted.reshape(-1)[np.asarray(ref_geo.soa_inv_perm)],
    )
    if hand_out:
        lane = np.asarray(outs[6])[:, 0].astype(np.int64)
        perm = np.asarray(ref_geo.soa_perm)
        res["hit_prim"] = np.where(lane >= 0, perm[np.clip(lane, 0, None)], -1)
        res["wdep"] = np.asarray(outs[7])[:, 0]
    return res


def check_state_and_counts(res, ref, org_in, flight=None):
    """Flags and counters equal on at least 99.9 % of lanes; on agreeing
    lanes weight, direction and deposit weight within 1e-5 and the origin
    within 3e-5 of its flight (the distance it moved in one bounce, or the
    bound ``flight`` on the path of several); the four count sums within
    0.2 %.

    Why any tolerance: the Pallas kernel divides by an approximate reciprocal
    plus one Newton step, so its hit time is off by up to 1.4e-5 relative
    from the port's IEEE division. The new origin org + t dir carries that
    error times the flight (up to 12 units here, so 1e-5 absolute does not
    hold for it), and it can flip a test on a disk's very rim; with several
    sub-bounces a flipped lane goes another way from there on.
    """
    st = res.state
    same = (
        (st.alive.numpy() == ref["alive"]) & (st.hfb.numpy() == ref["hfb"])
        & (st.n_refl.numpy() == ref["n_refl"])
        & (st.n_bdry.numpy() == ref["n_bdry"])
    )
    if res.hit_prim is not None:
        same &= res.hit_prim.numpy() == ref["hit_prim"]
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_allclose(
        st.weight.numpy()[same], ref["weight"][same], atol=1e-5, rtol=0
    )
    # a lane that died moved on in the reference and stays put in the port
    live = same & ref["alive"]
    assert live.sum() > 10
    if flight is None:
        flight = np.linalg.norm(ref["org"][live] - org_in[live], axis=1)
    err = np.abs(st.org.numpy() - ref["org"])[live].max(axis=1)
    assert (err <= 3e-5 * flight + 2e-6).all(), (err / (flight + 1e-6)).max()
    np.testing.assert_allclose(
        st.dirn.numpy()[live], ref["dirn"][live], atol=1e-5, rtol=0
    )
    if res.wdep is not None:
        np.testing.assert_allclose(
            res.wdep.numpy()[same], ref["wdep"][same], atol=1e-5, rtol=0
        )
    counts = res.counts.numpy()
    for i, name in enumerate(bounce.COUNT_NAMES[:bounce.N_EVENTS]):
        want = ref["counts"][i]
        assert abs(counts[i] - want) <= max(1, 0.002 * want), (name, counts, want)
    assert counts[bounce.N_EVENTS] == int(st.alive.sum())


class JaxKeyedRNG(streams.RayRNG):
    """The reference's uniforms by purpose.

    Key schedule of the JAX package: batch key = fold_in(base, batch)
    (tracer.py:350); source key = fold_in(batch key, 0x5EED) split into
    origin and direction keys (kernel.py:282-283, source.py:109-112), each
    split again for its two draws (source.py:58, sampling.py:44); a tilted
    source's round i folds i into the direction key (sampling.py:74) and its
    fallback folds 987654 (source.py:106); a grid or surface source feeds
    the source key itself to the lobe's two draws (source.py:143, 194,
    sampling.py:44); bounce ``it`` uses
    fold_in(batch key, it + 1) split four ways into scatter, scatter
    direction, reflection and roulette keys (kernel.py:531-532), the
    reflection key split for the sphere point's two draws (sampling.py:31).
    Gas scattering draws its probability from the scatter key and its
    direction from the scatter-direction key's two splits (kernel.py:680-684,
    1106-1116). A coned-cosine bounce splits the reflection key three ways
    into theta, phi and (unused here) diffuse keys (reflection.py:44,
    kernel.py:1088-1097); theta is the reference's own accept-reject under
    that key. A fused launch of several bounces starting at ``it`` draws its
    whole block from fold_in(batch key, it + 1) in one call and a
    coned-cosine launch its thetas from fold_in of 0x7E7A into that key
    (kernel.py:1118-1128).
    """

    def __init__(self, base_key, tilted=False):
        self.base_key = base_key
        self.tilted = tilted
        self.batch_key = None

    def begin_batch(self, batch_index):
        self.batch_key = jax.random.fold_in(self.base_key, batch_index)

    def _key(self, stream, bounce):
        if stream.startswith("source"):
            k_src = jax.random.fold_in(self.batch_key, 0x5EED)
            if stream in (streams.SOURCE_LOBE_1, streams.SOURCE_LOBE_2):
                pair = jax.random.split(k_src)
                return pair[0 if stream == streams.SOURCE_LOBE_1 else 1]
            k_o, k_d = jax.random.split(k_src)
            if stream in (streams.SOURCE_ORIGIN_1, streams.SOURCE_ORIGIN_2):
                pair = jax.random.split(k_o)
                return pair[0 if stream == streams.SOURCE_ORIGIN_1 else 1]
            if bounce == -1:
                k_d = jax.random.fold_in(k_d, 987654)
            elif self.tilted:
                k_d = jax.random.fold_in(k_d, bounce)
            pair = jax.random.split(k_d)
            return pair[0 if stream == streams.SOURCE_DIR_1 else 1]
        key_b = jax.random.fold_in(self.batch_key, bounce + 1)
        k_scat, k_scat_dir, k_refl, k_roul = jax.random.split(key_b, 4)
        if stream == streams.ROULETTE:
            return k_roul
        if stream == streams.SCATTER:
            return k_scat
        if stream in (streams.SCATTER_Z, streams.SCATTER_PHI):
            pair = jax.random.split(k_scat_dir)
            return pair[0 if stream == streams.SCATTER_Z else 1]
        if stream == streams.CONE_PHI:
            return jax.random.split(k_refl, 3)[1]
        pair = jax.random.split(k_refl)
        return pair[0 if stream == streams.REFLECT_1 else 1]

    def uniform(self, stream, batch_index, bounce, n):
        u = jax.random.uniform(self._key(stream, bounce), (n,), dtype=np.float32)
        return torch.from_numpy(np.array(u))

    def uniform_block(self, batch_index, bounce, n, n_cols):
        key_b = jax.random.fold_in(self.batch_key, bounce + 1)
        u = jax.random.uniform(key_b, (n, n_cols), dtype=np.float32)
        return torch.from_numpy(np.array(u))

    def cone_theta(self, batch_index, bounce, shape, cone_angle):
        key_b = jax.random.fold_in(self.batch_key, bounce + 1)
        if len(shape) == 1:
            key = jax.random.split(jax.random.split(key_b, 4)[2], 3)[0]
        else:
            key = jax.random.fold_in(key_b, 0x7E7A)
        theta = ref_sampling.coned_cosine_theta(
            key, tuple(shape), jnp.float32(cone_angle), dtype=jnp.float32
        )
        return torch.from_numpy(np.array(theta))


# ---- one mega-batch through both packages, lane by lane ----------------------
def lane_matched_batch(ref_particle, particle, ref_knobs, *, flux_model="neighbor",
                       use_wdist=False, source="random", max_bounces=3000,
                       R=4096, **port_kwargs):
    """One mega-batch of ``R`` rays on the 777-disk trench (grid delta 0.5)
    through both packages' ``trace_batch`` on the same tables with the same
    uniforms (``JaxKeyedRNG``); the cloud in packed order, where the two tie
    rules coincide. ``source``: "random" (the +z face), "grid"
    (``create_source_grid`` on that face, 400 points) or "surface" (every
    disk along its normal, ``surface_source_of``). Returns (port flux,
    port counters, reference flux, reference counters)."""
    import functools

    from viennaray_tpu.config import TraceConfig as RefConfig
    from viennaray_tpu.trace import kernel as ref_kernel
    from viennaray_tpu_torch.config import (
        BoundaryCondition, TraceConfig, TraceDirection, adjust_bounding_box,
    )
    from viennaray_tpu_torch.io import fixtures
    from viennaray_tpu_torch.physics.source import GridSource, RandomSource
    from viennaray_tpu_torch.trace.kernel import trace_batch
    import viennaray_tpu_torch as vrtt

    batch_index, seed = 1, 4321
    pts, nrm, grid_delta, first_build = reference_geometry("trench_0.5")
    order = np.asarray(first_build.soa_perm)[: len(pts)]
    pts, nrm = pts[order], nrm[order]
    ref_geo = vrt.DiskGeometry.build(pts, nrm, grid_delta, dim=3)
    conds = [vrt.BoundaryCondition.PERIODIC] * 3
    ref_geo = ref_geo.with_areas((0, 1), conds)
    geo = port_geometry(ref_geo)
    bbox = adjust_bounding_box(
        np.asarray(ref_geo.bbox), TraceDirection.POS_Z, ref_geo.disk_radius, 3,
    ).astype(np.float32)
    common = dict(dim=3, ray_batch_size=R, rng_seed=seed,
                  use_random_seed=False, max_bounces=max_bounces,
                  flux_model=flux_model, use_wdist=use_wdist)
    ref_config = RefConfig(boundary_conditions=tuple(conds), **common)
    config = TraceConfig(
        boundary_conditions=(BoundaryCondition.PERIODIC,) * 3, **common)
    axes = dict(ray_dir=2, first_dir=0, second_dir=1, pos_neg=-1.0, dim=3)
    if source == "random":
        ref_source = vrt.RandomSource(
            bbox=jnp.asarray(bbox), cosine_power=jnp.float32(1.0), min_max=1,
            **axes)
        port_source = RandomSource(bbox=torch.from_numpy(bbox),
                                   cosine_power=1.0, min_max=1, **axes)
    elif source == "grid":
        grid = fixtures.create_source_grid(bbox, 400, grid_delta,
                                           TraceDirection.POS_Z)
        ref_source = vrt.GridSource(
            bbox=jnp.asarray(bbox), grid=jnp.asarray(grid),
            cosine_power=jnp.asarray(1.0), **axes)
        port_source = GridSource(bbox=torch.from_numpy(bbox),
                                 grid=torch.from_numpy(grid),
                                 cosine_power=1.0, **axes)
    else:
        ref_source = surface_source_of(vrt, pts, nrm)
        port_source = surface_source_of(vrtt, pts, nrm)
    base_key = jax.random.PRNGKey(seed)
    ray_indices = np.arange(batch_index * R, (batch_index + 1) * R)
    valid = np.ones(R, bool)
    ref_trace = jax.jit(functools.partial(
        ref_kernel.trace_batch, config=ref_config, geo_type="disk",
        knobs=ref_knobs,
    ))
    ref_flux, ref_cnt = ref_trace(
        ref_geo, ref_source, ref_particle, jnp.asarray(bbox),
        jax.random.fold_in(base_key, batch_index),
        jnp.asarray(ray_indices, jnp.int32), jnp.asarray(valid),
    )
    rng = JaxKeyedRNG(base_key)
    rng.begin_batch(batch_index)
    flux, cnt = trace_batch(
        geo, port_source, particle, torch.from_numpy(bbox), rng, batch_index,
        torch.from_numpy(ray_indices), torch.from_numpy(valid), config,
        **port_kwargs,
    )
    return flux.numpy(), cnt, np.asarray(ref_flux), ref_cnt


# ---- goldens made by the JAX package on the CPU -----------------------------
# Configurations that no scalar oracle runs: the window flux model, and the
# surface source. The JAX package traces them on the CPU through its unfused
# body, in batches of 65,536 rays (its window deposit holds (R, 1024) arrays),
# on the disk flagship: create_trench_grid_3d at grid_delta 0.25 (2,993
# disks), diffuse particle with sticking 0.1, periodic walls.
JAX_GOLDEN_SEEDS = (101, 202)
JAX_GOLDEN_BATCH = 1 << 16
JAX_GOLDEN_TRENCH = dict(grid_delta=0.25, extent=5.0, trench_width=4.0,
                         trench_depth=4.0)
JAX_GOLDENS = {
    # flux_model="window", random source on the +z face; the same seeds also
    # run under "neighbor", so the record says how far the two models part
    "window3d_trench_jax": dict(flux_model="window", source="random"),
    # flux_model="neighbor", rays from every disk centre along its normal
    # (offset 0.01, unit weights, source area 100)
    "surface3d_trench_jax": dict(flux_model="neighbor", source="surface"),
}


def surface_source_of(module, points, normals, dim=3):
    """The golden's surface source in either package (``module`` is
    ``viennaray_tpu`` or ``viennaray_tpu_torch``): every point emits along
    its normal from 0.01 above it, unit weights, source area 100."""
    n = len(points)
    if module.__name__ == "viennaray_tpu":
        arr = lambda x: jnp.asarray(np.asarray(x, np.float32))  # noqa: E731
        return module.SurfaceSource(
            points=arr(points), normals=arr(normals), weights=arr(np.ones(n)),
            cosine_power=jnp.asarray(1.0), offset=jnp.asarray(0.01),
            area=jnp.asarray(100.0), dim=dim,
        )
    return module.SurfaceSource.build(
        points, normals, weights=np.ones(n), cosine_power=1.0, offset=0.01,
        area=100.0, dim=dim, device=torch.device("cpu"),
    )


def _jax_golden_run(args):
    """One seed of a JAX golden (a process of its own): (normalized flux,
    counters, seconds) for ``flux_model``."""
    name, flux_model, seed, rays_per_point = args
    jax.config.update("jax_platforms", "cpu")
    import time

    cfg = JAX_GOLDENS[name]
    pts, nrm = ref_fixtures.create_trench_grid_3d(**JAX_GOLDEN_TRENCH)
    t = vrt.TraceDisk(dim=3)
    t.set_geometry(pts, nrm, JAX_GOLDEN_TRENCH["grid_delta"])
    t.set_boundary_conditions([vrt.BoundaryCondition.PERIODIC] * 3)
    t.set_particle_type(vrt.DiffuseParticle(0.1, "flux"))
    t.set_number_of_rays_per_point(rays_per_point)
    t.set_rng_seed(seed)
    t.set_ray_batch_size(JAX_GOLDEN_BATCH)
    t.set_flux_model(flux_model)
    if cfg["source"] == "surface":
        t.set_source(surface_source_of(vrt, pts, nrm))
    t0 = time.perf_counter()
    flux = t.apply()
    seconds = time.perf_counter() - t0
    info = t.get_ray_trace_info()
    counters = {k: int(getattr(info, k)) for k in (
        "num_rays", "total_rays_traced", "non_geometry_hits", "geometry_hits",
        "boundary_hits")}
    return np.asarray(t.normalize_flux(flux), np.float64), counters, seconds


def make_jax_golden(name, rays_per_point, out_dir):
    """Traces a configuration of ``JAX_GOLDENS`` with the JAX package on the
    CPU, one process per seed and flux model, and writes
    ``<out_dir>/<name>.npy`` (the mean of the seeds' SOURCE-normalized
    fluxes) and ``<name>.json`` (rays, seeds, rel-L2 between the seeds, hits
    per ray, seconds; for the window model also the rel-L2 between the
    window and the neighbor flux of each seed)."""
    import json
    import multiprocessing
    import os
    import time

    cfg = JAX_GOLDENS[name]
    models = [cfg["flux_model"]]
    if cfg["flux_model"] == "window":
        models.append("neighbor")
    jobs = [(name, m, s, rays_per_point) for m in models
            for s in JAX_GOLDEN_SEEDS]
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(len(jobs)) as pool:
        runs = dict(zip([(m, s) for _, m, s, _ in jobs],
                        pool.map(_jax_golden_run, jobs)))
    wall = time.perf_counter() - t0

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    main = [runs[(cfg["flux_model"], s)] for s in JAX_GOLDEN_SEEDS]
    rays = main[0][1]["num_rays"]
    hits = [c["geometry_hits"] / c["num_rays"] for _, c, _ in main]
    record = {
        "mesh": {"fixture": "create_trench_grid_3d", **JAX_GOLDEN_TRENCH,
                 "disks": int(len(main[0][0]))},
        "physics": {"particle": "diffuse", "sticking": 0.1,
                    "boundary": "periodic", "flux_model": cfg["flux_model"],
                    "source": ("+z face, cosine lobe" if cfg["source"] == "random"
                               else "surface: every disk centre along its "
                                    "normal, offset 0.01, unit weights, "
                                    "area 100, cosine lobe")},
        "maker": "JAX package on the CPU, unfused body "
                 "(tests/torch_port_helpers.py:make_jax_golden)",
        "ray_batch": JAX_GOLDEN_BATCH,
        "normalization": "SOURCE: flux * source_area / (rays * area)",
        "rays_per_point": rays_per_point, "rays_per_seed": rays,
        "seeds": list(JAX_GOLDEN_SEEDS),
        "rel_l2_between_seeds": rel(main[1][0], main[0][0]),
        "geometry_hits_per_ray": float(np.mean(hits)),
        "geometry_hits_per_ray_by_seed": hits,
        "counters": [c for _, c, _ in main],
        "seconds_by_seed": [s for _, _, s in main],
        "wall_seconds": wall,
    }
    if cfg["flux_model"] == "window":
        record["rel_l2_window_vs_neighbor_by_seed"] = [
            rel(runs[("window", s)][0], runs[("neighbor", s)][0])
            for s in JAX_GOLDEN_SEEDS
        ]
        record["neighbor_geometry_hits_per_ray_by_seed"] = [
            runs[("neighbor", s)][1]["geometry_hits"] / rays
            for s in JAX_GOLDEN_SEEDS
        ]
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, name + ".npy"),
            np.mean([f for f, _, _ in main], axis=0))
    with open(os.path.join(out_dir, name + ".json"), "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    return record


if __name__ == "__main__":
    # python3 tests/torch_port_helpers.py NAME RAYS_PER_POINT [OUT_DIR]
    import sys

    out = sys.argv[3] if len(sys.argv) > 3 else "viennaray_tpu_torch/io/golden"
    print(make_jax_golden(sys.argv[1], int(sys.argv[2]), out))
