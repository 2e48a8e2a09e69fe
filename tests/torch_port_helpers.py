"""Shared helpers of the ``test_torch_*`` files: the same geometry built by
both packages, and a ``RayRNG`` that hands the port the JAX package's own
uniforms, drawn with ``jax.random`` under the reference's key schedule."""

import dataclasses
import sys

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
    "trench_0.22": (lambda f: f.create_trench_grid_3d(grid_delta=0.22), 0.22),
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


# ---- the scalar oracle, loaded steadily ---------------------------------------
def oracle_available():
    """``oracle_ref.available()``, steady when several processes load it at
    once into an empty cache. ``oracle_ref._load`` compiles into one shared
    ``<name>.so.tmp`` path, so concurrent first loads can race and the
    losers keep ``None``. After such a failure this rebuilds the library
    under an exclusive ``fcntl.flock`` into a temporary file of its own,
    moves it into place, resets the module's cached state and loads again.
    """
    import fcntl
    import os
    import subprocess
    import tempfile

    import oracle_ref

    if oracle_ref.available():
        return True
    src = os.path.join(os.path.dirname(os.path.abspath(oracle_ref.__file__)),
                       "oracle_ref.cpp")
    cache = os.path.expanduser("~/.cache/viennaray_tpu_native")
    os.makedirs(cache, exist_ok=True)
    with open(os.path.join(cache, "oracle_ref.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        fd, tmp = tempfile.mkstemp(dir=cache, suffix=".so")
        os.close(fd)
        try:
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", src, "-o",
                 tmp], check=True, capture_output=True, timeout=180,
            )
            os.replace(tmp, os.path.join(cache, "oracle_ref.so"))
        except (OSError, subprocess.SubprocessError):
            return False
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
            oracle_ref._LIB, oracle_ref._TRIED = None, False
        return oracle_ref.available()


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

    The hooks' keys (kernel.py:301-315, 816-859): ``init_dir_fn`` gets
    fold_in(batch key, 0xD1B), ``aux_init_fn`` 0xA0C, ``log_fn`` 0x10C;
    ``collision_fn`` at bounce ``it`` gets fold_in(batch key, it + 1) itself
    and ``reflection_fn`` its reflection key. A hook's ``rng.uniform(shape)``
    is ``jax.random.uniform(key, shape)`` at its first call and under
    fold_in(key, c) at call c > 0: a JAX hook that draws so sees the port
    hook's numbers.

    ``dtype``: torch.float32, or torch.float64 for the float64 trace, whose
    numbers are ``jax.random.uniform(..., dtype=jnp.float64)`` as the JAX
    package draws them under ``jax_enable_x64`` (which must be on while it
    draws).
    """

    def __init__(self, base_key, tilted=False, dtype=torch.float32):
        self.base_key = base_key
        self.tilted = tilted
        self.batch_key = None
        self.dtype = dtype
        self._np_dtype = np.float64 if dtype == torch.float64 else np.float32

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

    def _draw(self, key, shape):
        u = np.array(jax.random.uniform(key, shape, dtype=self._np_dtype))
        assert u.dtype == self._np_dtype, "float64 draws need jax_enable_x64"
        return torch.from_numpy(u)

    def uniform(self, stream, batch_index, bounce, n):
        return self._draw(self._key(stream, bounce), (n,))

    def uniform_block(self, batch_index, bounce, n, n_cols):
        key_b = jax.random.fold_in(self.batch_key, bounce + 1)
        return self._draw(key_b, (n, n_cols))

    def hook_key(self, stream, bounce):
        """The reference's key of a hook (see the class's docstring)."""
        once = {streams.HOOK_INIT_DIR: 0xD1B, streams.HOOK_AUX_INIT: 0xA0C,
                streams.HOOK_LOG: 0x10C}
        if stream in once:
            return jax.random.fold_in(self.batch_key, once[stream])
        key_b = jax.random.fold_in(self.batch_key, bounce + 1)
        if stream == streams.HOOK_COLLISION:
            return key_b
        return jax.random.split(key_b, 4)[2]

    def hook_uniform(self, stream, batch_index, bounce, shape, call):
        key = self.hook_key(stream, bounce)
        if call:
            key = jax.random.fold_in(key, call)
        return self._draw(key, tuple(shape))

    def cone_theta(self, batch_index, bounce, shape, cone_angle):
        key_b = jax.random.fold_in(self.batch_key, bounce + 1)
        if len(shape) == 1:
            key = jax.random.split(jax.random.split(key_b, 4)[2], 3)[0]
        else:
            key = jax.random.fold_in(key_b, 0x7E7A)
        theta = ref_sampling.coned_cosine_theta(
            key, tuple(shape), jnp.asarray(cone_angle, self._np_dtype),
            dtype=self._np_dtype,
        )
        return torch.from_numpy(np.array(theta))


# ---- one mega-batch through both packages, lane by lane ----------------------
def packed_geometries(geo_kind):
    """(reference geometry, port geometry, adjusted box, dim) of the
    lane-matched batch's geometry, in packed order, where the reference's tie
    rule (lowest original index) and the port's (lowest sorted lane)
    coincide: the 777-disk trench at grid delta 0.5 (periodic areas), the
    1,440-triangle trench mesh at 0.5, or the 72-segment 2D trench at 0.25
    with two materials; ``geo_kind`` "disk_0.22": the 3,818-disk trench at
    grid delta 0.22 (8 chunks, so the per-bounce resort engages; below
    ``grid_min_prims``, so neither package walks a grid). Not the 4,590
    disks at 0.2: their packing is no fixed point (packing the packed
    order rotates 91 disks by 3 lanes), so no order makes the two tie rules
    coincide."""
    from viennaray_tpu.geometry.line_geometry import (
        LineGeometry as RefLineGeometry,
    )
    from viennaray_tpu_torch.config import TraceDirection, adjust_bounding_box

    if geo_kind in ("disk", "disk_0.22"):
        pts, nrm, grid_delta, first_build = reference_geometry(
            "trench_0.5" if geo_kind == "disk" else "trench_0.22")
        order = np.asarray(first_build.soa_perm)[: len(pts)]
        pts, nrm = pts[order], nrm[order]
        ref_geo = vrt.DiskGeometry.build(pts, nrm, grid_delta, dim=3)
        conds = [vrt.BoundaryCondition.PERIODIC] * 3
        ref_geo = ref_geo.with_areas((0, 1), conds)
        geo, margin, dim = port_geometry(ref_geo), ref_geo.disk_radius, 3
    elif geo_kind == "triangle":
        verts, tris = ref_fixtures.create_trench_mesh_3d(grid_delta=0.5)
        first = vrt.TriangleGeometry.build(verts, tris, 0.5, dim=3)
        tris = tris[np.asarray(first.soa_perm)[: len(tris)]]
        ref_geo = vrt.TriangleGeometry.build(verts, tris, 0.5, dim=3)
        geo, margin, dim = port_triangle_geometry(ref_geo), 0.5, 3
    else:
        from viennaray_tpu_torch.io import fixtures

        nodes, lines = fixtures.create_trench_line_mesh(0.25)
        first = RefLineGeometry.from_mesh(
            vrt.LineMesh(nodes=nodes, lines=lines, grid_delta=0.25))
        lines = lines[np.asarray(first.soa_perm)[: len(lines)]]
        ids = np.zeros(len(lines), np.int32)
        ids[len(lines) // 2:] = 1
        ref_geo = RefLineGeometry.from_mesh(
            vrt.LineMesh(nodes=nodes, lines=lines, grid_delta=0.25),
            material_ids=ids)
        geo, margin, dim = port_line_geometry(ref_geo), 0.25, 2
    n = ref_geo.num_primitives
    np.testing.assert_array_equal(np.asarray(ref_geo.soa_perm)[:n],
                                  np.arange(n))
    direction = TraceDirection.POS_Z if dim == 3 else TraceDirection.POS_Y
    bbox = adjust_bounding_box(
        np.asarray(ref_geo.bbox), direction, margin, dim).astype(np.float32)
    return ref_geo, geo, bbox, dim


def lane_matched_batch(ref_particle, particle, ref_knobs, *, flux_model="neighbor",
                       use_wdist=False, source="random", max_bounces=3000,
                       R=4096, geo_kind="disk", ref_hooks=None, user_source=None,
                       **port_kwargs):
    """One mega-batch of ``R`` rays through both packages' ``trace_batch`` on
    the same tables with the same uniforms (``JaxKeyedRNG``), on a geometry
    of ``packed_geometries`` (``geo_kind`` "disk", "disk_0.22", "triangle" or
    "line").
    ``source``: "random" (the +z face, or +y in 2D), "grid"
    (``create_source_grid`` on that face, 400 points) or "surface" (every
    disk along its normal, ``surface_source_of``); ``user_source(source)``
    wraps the port's. ``ref_hooks``: the reference's hooks (``port_kwargs`` carry
    the port's). Returns (port flux, port counters, reference flux,
    reference counters), and both packages' logs after them with a
    ``log_fn``."""
    import functools

    from viennaray_tpu.config import TraceConfig as RefConfig
    from viennaray_tpu.trace import kernel as ref_kernel
    from viennaray_tpu_torch.config import (
        BoundaryCondition, TraceConfig, TraceDirection,
    )
    from viennaray_tpu_torch.io import fixtures
    from viennaray_tpu_torch.physics.source import GridSource, RandomSource
    from viennaray_tpu_torch.trace.kernel import trace_batch
    import viennaray_tpu_torch as vrtt

    batch_index, seed = 1, 4321
    ref_geo, geo, bbox, dim = packed_geometries(geo_kind)
    grid_delta = ref_geo.grid_delta
    conds = [vrt.BoundaryCondition.PERIODIC] * 3
    direction = TraceDirection.POS_Z if dim == 3 else TraceDirection.POS_Y
    common = dict(dim=dim, ray_batch_size=R, rng_seed=seed,
                  use_random_seed=False, max_bounces=max_bounces,
                  flux_model=flux_model, use_wdist=use_wdist)
    ref_config = RefConfig(boundary_conditions=tuple(conds),
                           source_direction=vrt.TraceDirection(int(direction)),
                           **common)
    config = TraceConfig(
        boundary_conditions=(BoundaryCondition.PERIODIC,) * 3,
        source_direction=direction, **common)
    axes = dict(ray_dir=2, first_dir=0, second_dir=1, pos_neg=-1.0, dim=3)
    if dim == 2:
        axes = dict(ray_dir=1, first_dir=0, second_dir=2, pos_neg=-1.0, dim=2)
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
        pts, nrm = np.asarray(ref_geo.points), np.asarray(ref_geo.normals)
        ref_source = surface_source_of(vrt, pts, nrm)
        port_source = surface_source_of(vrtt, pts, nrm)
    if user_source is not None:
        port_source = user_source(port_source)
    base_key = jax.random.PRNGKey(seed)
    ray_indices = np.arange(batch_index * R, (batch_index + 1) * R)
    valid = np.ones(R, bool)
    ref_trace = jax.jit(functools.partial(
        ref_kernel.trace_batch, config=ref_config,
        geo_type=geo_kind.split("_")[0],
        knobs=ref_knobs, **(ref_hooks or {}),
    ))
    ref_out = ref_trace(
        ref_geo, ref_source, ref_particle, jnp.asarray(bbox),
        jax.random.fold_in(base_key, batch_index),
        jnp.asarray(ray_indices, jnp.int32), jnp.asarray(valid),
    )
    rng = JaxKeyedRNG(base_key)
    rng.begin_batch(batch_index)
    out = trace_batch(
        geo, port_source, particle, torch.from_numpy(bbox), rng, batch_index,
        torch.from_numpy(ray_indices), torch.from_numpy(valid), config,
        **port_kwargs,
    )
    res = (out[0].numpy(), out[1], np.asarray(ref_out[0]), ref_out[1])
    if len(out) == 3:
        res += (out[2], ref_out[2])
    return res


# ---- the differentiable trace through both packages --------------------------
def diff_setups(geo_kind, sticking=0.3, **config_changes):
    """(reference, port) dicts of ``geometry``, ``source``, ``particle``,
    ``bbox``, ``config`` and ``geo_type`` for the differentiable trace on one
    set of tables. ``geo_kind`` "disk2d": ``tests/test_diff.py:_setup``'s 2D
    trench (180 disks, reflective walls, source +y, 2,048 rays) in packed
    order; "disk", "triangle", "line": ``packed_geometries``' (periodic
    walls). A diffuse particle with ``sticking``; roulette off."""
    from viennaray_tpu.config import TraceConfig as RefConfig
    from viennaray_tpu.config import get_trace_settings as ref_settings
    import viennaray_tpu_torch as vrtt
    from viennaray_tpu_torch.config import adjust_bounding_box

    if geo_kind == "disk2d":
        pts, nrm = ref_fixtures.create_trench_grid_2d(grid_delta=0.1)
        first = vrt.DiskGeometry.build(pts, nrm, 0.1, dim=2)
        order = np.asarray(first.soa_perm)[: len(pts)]
        ref_geo = vrt.DiskGeometry.build(pts[order], nrm[order], 0.1, dim=2)
        geo, dim = port_geometry(ref_geo), 2
        bbox = adjust_bounding_box(
            np.asarray(ref_geo.bbox), vrtt.TraceDirection.POS_Y,
            ref_geo.disk_radius, 2).astype(np.float32)
        bc = "REFLECTIVE"
        geo_type = "disk"
    else:
        ref_geo, geo, bbox, dim = packed_geometries(geo_kind)
        bc = "PERIODIC"
        geo_type = geo_kind
    direction = "POS_Z" if dim == 3 else "POS_Y"
    common = dict(dim=dim, num_rays_fixed=2048, rng_seed=11,
                  use_random_seed=False, ray_batch_size=2048, roulette=False)
    common.update(config_changes)
    out = []
    for pkg, make_geo in ((vrt, ref_geo), (vrtt, geo)):
        config_cls = RefConfig if pkg is vrt else vrtt.TraceConfig
        config = config_cls(
            source_direction=getattr(pkg.TraceDirection, direction),
            boundary_conditions=(getattr(pkg.BoundaryCondition, bc),) * 3,
            **common)
        s = ref_settings(config.source_direction)
        axes = dict(ray_dir=s[0], first_dir=s[1], second_dir=s[2],
                    min_max=s[3], pos_neg=float(s[4]), dim=dim,
                    num_points=ref_geo.num_primitives)
        if pkg is vrt:
            source = vrt.RandomSource(bbox=jnp.asarray(bbox),
                                      cosine_power=jnp.float32(1.0), **axes)
            box = jnp.asarray(bbox)
        else:
            source = vrtt.RandomSource(bbox=torch.from_numpy(bbox),
                                       cosine_power=1.0, **axes)
            box = torch.from_numpy(bbox)
        out.append(dict(geometry=make_geo, source=source,
                        particle=pkg.DiffuseParticle(sticking, "flux"),
                        bbox=box, config=config, geo_type=geo_type))
    return tuple(out)


def reference_trace_flux(ref, key, R, num_bounces, **changes):
    """The JAX package's ``trace_flux`` of ``R`` rays (indices 0 to R - 1)
    under ``key`` on a ``diff_setups`` reference, with ``changes`` (a
    ``particle`` or ``geometry`` in place of the setup's)."""
    from viennaray_tpu.diff.trace_grad import trace_flux as ref_trace_flux

    args = {**ref, **changes}
    return ref_trace_flux(
        args["geometry"], args["source"], args["particle"], args["bbox"], key,
        jnp.arange(R, dtype=jnp.int32), jnp.ones((R,), bool), args["config"],
        args["geo_type"], num_bounces=num_bounces,
    )


def port_trace_flux(port, rng, R, num_bounces, **changes):
    """The port's ``trace_flux`` of ``R`` rays (indices 0 to R - 1, batch 0)
    on a ``diff_setups`` port, on the CPU."""
    from viennaray_tpu_torch.diff import trace_flux

    args = {**port, **changes}
    return trace_flux(
        args["geometry"], args["source"], args["particle"], args["bbox"], rng,
        torch.arange(R), torch.ones(R, dtype=torch.bool), args["config"],
        args["geo_type"], num_bounces=num_bounces, device="cpu",
    )


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
    # custom particles, through the reference's hooks (both neighbor model,
    # random source): SpecularParticle(0.4, 100) filling "ionFlux" and
    # "energyFlux" (weight times the incidence cosine), the JAX package's
    # examples/multi_channel.py; and an energy-carrying ion (energy
    # N(100, 10), diffuse reflection with sticking 0.2 losing 30 % of the
    # energy per bounce, energy-weighted deposits), the pattern of
    # tests/test_stateful_particle.py
    "multichannel3d_trench_jax": dict(flux_model="neighbor", source="random",
                                      particle="multichannel"),
    "stateful3d_trench_jax": dict(flux_model="neighbor", source="random",
                                  particle="stateful"),
}


def jax_hooked_particle(name, dim=3):
    """(particle, hooks for ``set_custom_functions``) of a hooked golden's
    ``particle`` in the JAX package."""
    from viennaray_tpu.physics import reflection as ref_reflection

    if name == "multichannel":
        def collision_fn(flux, ids, w, dirn, normal, mat, key):
            cosi = jnp.abs(jnp.sum(dirn * normal, axis=1, keepdims=True))
            f_ion = flux[0].at[ids.reshape(-1)].add(w.reshape(-1))
            f_en = flux[1].at[ids.reshape(-1)].add((w * cosi).reshape(-1))
            return jnp.stack([f_ion, f_en])

        particle = vrt.SpecularParticle(0.4, 100.0).replace(
            data_labels=("ionFlux", "energyFlux"))
        return particle, dict(collision_fn=collision_fn)

    def aux_init_fn(key, ray_indices):
        e = 100.0 + 10.0 * jax.random.normal(key, (ray_indices.shape[0],))
        return e[:, None]

    def collision_fn(flux, ids, weights, dirn, normal, mat, key, aux):
        energy = jnp.clip(aux[:, 0:1], 0.0, None)
        return flux.at[ids.reshape(-1)].add((weights * energy).reshape(-1))

    def reflection_fn(key, dirn, normal, prim, mat, weight, aux):
        new_dir = ref_reflection.diffuse(key, normal, dim)
        return jnp.full(dirn.shape[:1], 0.2), new_dir, aux * 0.7

    return vrt.DiffuseParticle(0.2, "flux"), dict(
        collision_fn=collision_fn, reflection_fn=reflection_fn,
        aux_init_fn=aux_init_fn)


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
    if "particle" in cfg:
        particle, hooks = jax_hooked_particle(cfg["particle"])
        t.set_particle_type(particle)
        t.set_custom_functions(**hooks)
    else:
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
    flux = np.asarray(flux, np.float64)
    # raw sums: the energy ratio of two channels, the deposit per hit
    counters["flux_sum"] = [float(x) for x in flux.reshape(-1, len(pts)).sum(1)]
    if flux.ndim == 2:
        norm = np.stack([np.asarray(t.normalize_flux(f), np.float64)
                         for f in flux])
    else:
        norm = np.asarray(t.normalize_flux(flux), np.float64)
    return norm, counters, seconds


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
    physics = {"particle": "diffuse", "sticking": 0.1}
    if cfg.get("particle") == "multichannel":
        physics = {"particle": "specular, sticking 0.4, source power 100",
                   "channels": ["ionFlux: weight",
                                "energyFlux: weight * |cos incidence|"]}
    elif cfg.get("particle") == "stateful":
        physics = {"particle": "energy-carrying ion: energy N(100, 10), "
                               "diffuse reflection, sticking 0.2, energy "
                               "* 0.7 per bounce, deposits weight * energy"}
    record = {
        "mesh": {"fixture": "create_trench_grid_3d", **JAX_GOLDEN_TRENCH,
                 "disks": int(main[0][0].shape[-1])},
        "physics": {**physics,
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
    sums = [c["flux_sum"] for _, c, _ in main]
    if cfg.get("particle") == "multichannel":
        record["rel_l2_between_seeds_by_channel"] = [
            rel(main[1][0][i], main[0][0][i]) for i in range(2)]
        ratios = [s[1] / s[0] for s in sums]
        record["energy_ratio_by_seed"] = ratios
        record["energy_ratio"] = float(np.mean(ratios))
    elif cfg.get("particle") == "stateful":
        per_hit = [s[0] / c["geometry_hits"]
                   for s, (_, c, _) in zip(sums, main)]
        record["deposit_per_hit_by_seed"] = per_hit
        record["deposit_per_hit"] = float(np.mean(per_hit))
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


# The gradient golden: BASELINE config 5 (benchmarks/grad_bench.py:33-75) on
# the JAX package's flux_and_grad_sticking_batched, 8 bounces, roulette off,
# in batches small enough for its brute-force search on the CPU.
GRAD_GOLDEN = "grad3d_trench_jax"
GRAD_GOLDEN_BATCH = 1 << 15
GRAD_GOLDEN_BOUNCES = 8


def _jax_grad_golden_run(args):
    """One seed of the gradient golden (a process of its own): (raw flux
    (N,) float64, d sum(flux) / d sticking, seconds)."""
    seed, total_rays = args
    jax.config.update("jax_platforms", "cpu")
    import time

    from viennaray_tpu.config import (
        TraceConfig as RefConfig, adjust_bounding_box as ref_adjust,
        get_trace_settings as ref_settings,
    )
    from viennaray_tpu.diff.trace_grad import flux_and_grad_sticking_batched

    pts, nrm = ref_fixtures.create_trench_grid_3d(**JAX_GOLDEN_TRENCH)
    grid_delta = JAX_GOLDEN_TRENCH["grid_delta"]
    # in packed order, where the CPU search's tie rule (lowest original
    # index) is the kernels' (lowest sorted lane): ties decide which disk's
    # neighbor list deposits
    first = vrt.DiskGeometry.build(pts, nrm, grid_delta, dim=3)
    order = np.asarray(first.soa_perm)[: len(pts)]
    geometry = vrt.DiskGeometry.build(pts[order], nrm[order], grid_delta,
                                      dim=3)
    particle = vrt.DiffuseParticle(0.1, "flux")
    config = RefConfig(
        dim=3, num_rays_fixed=total_rays,
        source_direction=vrt.TraceDirection.POS_Z,
        boundary_conditions=(vrt.BoundaryCondition.PERIODIC,) * 3,
        ray_batch_size=GRAD_GOLDEN_BATCH, rng_seed=seed,
        use_random_seed=False, roulette=False,
    )
    bbox = ref_adjust(np.asarray(geometry.bbox), config.source_direction,
                      geometry.disk_radius, 3)
    s = ref_settings(config.source_direction)
    source = vrt.RandomSource(
        bbox=jnp.asarray(bbox, jnp.float32),
        cosine_power=particle.cosine_exponent, ray_dir=s[0], first_dir=s[1],
        second_dir=s[2], min_max=s[3], pos_neg=float(s[4]), dim=3,
        num_points=geometry.num_primitives,
    )
    t0 = time.perf_counter()
    flux, grad = flux_and_grad_sticking_batched(
        geometry, source, particle, jnp.asarray(bbox, jnp.float32),
        jax.random.PRNGKey(seed), total_rays, config, "disk",
        num_bounces=GRAD_GOLDEN_BOUNCES,
    )
    seconds = time.perf_counter() - t0
    original = np.empty(len(pts), np.float64)
    original[order] = np.asarray(flux, np.float64)
    return original, float(grad), seconds


def make_jax_grad_golden(rays_per_seed, out_dir):
    """Runs BASELINE config 5's gradient with the JAX package on the CPU at
    the two ``JAX_GOLDEN_SEEDS``, one process each, and writes
    ``<out_dir>/grad3d_trench_jax.npy`` (the seeds' mean raw flux per ray,
    (N,) float64) and ``.json`` (the flux sum and d sum(flux) / d sticking
    per ray for each seed, the flux rel-L2 and the gradient's relative
    difference between the seeds, seconds)."""
    import json
    import multiprocessing
    import os

    jobs = [(s, rays_per_seed) for s in JAX_GOLDEN_SEEDS]
    with multiprocessing.get_context("spawn").Pool(len(jobs)) as pool:
        runs = pool.map(_jax_grad_golden_run, jobs)
    per_ray = [f / rays_per_seed for f, _, _ in runs]
    grads = [g / rays_per_seed for _, g, _ in runs]
    record = {
        "mesh": {"fixture": "create_trench_grid_3d", **JAX_GOLDEN_TRENCH,
                 "disks": int(per_ray[0].shape[0])},
        "physics": {"particle": "diffuse", "sticking": 0.1,
                    "boundary": "periodic", "flux_model": "neighbor",
                    "source": "+z face, cosine lobe", "roulette": False,
                    "bounces": GRAD_GOLDEN_BOUNCES},
        "config": "BASELINE config 5 (benchmarks/grad_bench.py:33-75) but "
                  "for the ray count and the batch",
        "maker": "JAX package on the CPU, viennaray_tpu.diff.trace_grad."
                 "flux_and_grad_sticking_batched, the disks in packed order "
                 "(the kernels' tie rule), flux in original numbering "
                 "(tests/torch_port_helpers.py:make_jax_grad_golden)",
        "ray_batch": GRAD_GOLDEN_BATCH,
        "normalization": "raw flux and d sum(flux) / d sticking divided by "
                         "the rays",
        "rays_per_seed": rays_per_seed, "seeds": list(JAX_GOLDEN_SEEDS),
        "flux_sum_per_ray_by_seed": [float(f.sum()) for f in per_ray],
        "grad_per_ray_by_seed": grads,
        "grad_per_ray": float(np.mean(grads)),
        "rel_l2_between_seeds": float(np.linalg.norm(per_ray[1] - per_ray[0])
                                      / np.linalg.norm(per_ray[0])),
        "grad_rel_diff_between_seeds": abs(grads[1] - grads[0])
        / abs(grads[0]),
        "seconds_by_seed": [s for _, _, s in runs],
    }
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, GRAD_GOLDEN + ".npy"),
            np.mean(per_ray, axis=0))
    with open(os.path.join(out_dir, GRAD_GOLDEN + ".json"), "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    return record


if __name__ == "__main__" and sys.argv[1] not in ("--record-draws",
                                                  "--record-f32-digests"):
    # python3 tests/torch_port_helpers.py NAME RAYS_PER_POINT [OUT_DIR]
    # (grad3d_trench_jax: RAYS_PER_SEED)
    out = sys.argv[3] if len(sys.argv) > 3 else "viennaray_tpu_torch/io/golden"
    if sys.argv[1] == GRAD_GOLDEN:
        print(make_jax_grad_golden(int(sys.argv[2]), out))
    else:
        print(make_jax_golden(sys.argv[1], int(sys.argv[2]), out))


# ---- the order of a trace's draws ---------------------------------------------
# Small traces without hooks, fused and unfused on disks (diffuse), triangles
# (coned-cosine) and lines (gas scattering): every stream and draw method of
# ``GeneratorRNG`` is met. ``record_draws`` lists each trace's draws as
# (method and stream, bounce, shape); ``tests/torch_parent_draws.json`` holds
# the list recorded from the tree before hooks existed (``python3
# tests/torch_port_helpers.py --record-draws OUT`` with that tree's package
# first on the path), and a trace without hooks must keep drawing exactly it.
DRAW_TRACES = ("disks_fused", "disks_unfused", "triangles_fused",
               "triangles_unfused", "lines_fused", "lines_unfused")


def draw_trace(name):
    """The tracer of one of ``DRAW_TRACES``, on the CPU."""
    import viennaray_tpu_torch as vrtt
    from viennaray_tpu_torch.io import fixtures

    kind, body = name.split("_")
    fused = body == "fused"
    if kind == "disks":
        pts, nrm = fixtures.create_trench_grid_3d(grid_delta=0.5)
        t = vrtt.TraceDisk(dim=3, device="cpu", fused=fused)
        t.set_geometry(pts, nrm, 0.5)
        particle = vrtt.DiffuseParticle(0.1)
        rays, batch = 20000, 1 << 15
    elif kind == "triangles":
        verts, tris = fixtures.create_trench_mesh_3d(grid_delta=1.0)
        t = vrtt.TraceTriangle(dim=3, device="cpu", fused=fused)
        t.set_geometry(verts, tris, 1.0)
        particle = vrtt.ConedCosineParticle(0.5, 0.5, 20.0)
        rays, batch = 3000, 1 << 12
    else:
        nodes, lines = fixtures.create_trench_line_mesh(grid_delta=0.2)
        t = vrtt.TraceLine(device="cpu", fused=fused)
        t.set_geometry(vrtt.LineMesh(nodes, lines, grid_delta=0.2))
        particle = vrtt.Particle(sticking=0.3, mean_free_path=2.0)
        rays, batch = 3000, 1 << 11
    t.set_boundary_conditions([vrtt.BoundaryCondition.PERIODIC] * 3)
    t.set_particle_type(particle)
    t.set_number_of_rays_fixed(rays)
    t.set_ray_batch_size(batch)
    t.set_rng_seed(7)
    return t


def record_draws(name):
    """Apply one of ``DRAW_TRACES`` through a ``GeneratorRNG`` that notes
    every draw; returns [[method:stream, bounce, shape], ...]."""
    from viennaray_tpu_torch import rng as rng_mod
    from viennaray_tpu_torch.trace import tracer as tracer_mod

    log = []

    class Recording(rng_mod.GeneratorRNG):
        def uniform(self, stream, batch_index, bounce, n):
            log.append([f"uniform:{stream}", int(bounce), [int(n)]])
            return super().uniform(stream, batch_index, bounce, n)

        def uniform_block(self, batch_index, bounce, n, n_cols):
            log.append(["uniform_block", int(bounce), [int(n), int(n_cols)]])
            return super().uniform_block(batch_index, bounce, n, n_cols)

        def cone_theta(self, batch_index, bounce, shape, cone_angle):
            log.append(["cone_theta", int(bounce), [int(x) for x in shape]])
            return super().cone_theta(batch_index, bounce, shape, cone_angle)

    t = draw_trace(name)
    saved = tracer_mod.GeneratorRNG
    tracer_mod.GeneratorRNG = Recording
    try:
        t.apply()
    finally:
        tracer_mod.GeneratorRNG = saved
    return log


# ---- float32 traces as the tree before float64 tracing traced them ---------
# sha256 of the flux bytes and counters of small float32 ``trace_batch``
# runs on the CPU, recorded from the tree before float64 tracing existed
# (``python3 tests/torch_port_helpers.py --record-f32-digests OUT`` with that
# tree's package first on the path): a float32 trace must keep giving them.
# A beam of one fixed direction with specular reflection: no sine, cosine,
# power or exponential on the path (only IEEE arithmetic and square roots),
# so the bits do not depend on the CPU's vector library.
F32_DIGEST_TRACES = ("disks_unfused", "disks_fused", "triangles_unfused",
                     "lines_unfused")


class Beam:
    """A source of origins uniform on the source face (+z, or +y in 2D) and
    one fixed direction, from the streams of the random source's origins."""

    def __init__(self, bbox, direction, dim):
        self.bbox = torch.as_tensor(np.asarray(bbox, np.float32))
        d = np.asarray(direction, np.float64)
        self.direction = torch.tensor(d / np.linalg.norm(d), dtype=torch.float32)
        self.dim = dim

    def sample(self, rng, batch_index, n, ray_indices):
        lo, hi = self.bbox[0], self.bbox[1]
        u1 = rng.uniform(streams.SOURCE_ORIGIN_1, batch_index, 0, n)
        org = torch.zeros((n, 3), dtype=torch.float32)
        org[:, 0] = lo[0] + (hi[0] - lo[0]) * u1
        if self.dim == 3:
            u2 = rng.uniform(streams.SOURCE_ORIGIN_2, batch_index, 0, n)
            org[:, 1] = lo[1] + (hi[1] - lo[1]) * u2
            org[:, 2] = hi[2]
        else:
            org[:, 1] = hi[1]
        return (org, self.direction.expand(n, 3).contiguous(),
                torch.ones(n, dtype=torch.float32))

    def source_area(self):
        return 1.0


def f32_digest(name, grid_min_prims=None):
    """sha256 of one of ``F32_DIGEST_TRACES``: a float32 ``trace_batch`` of
    4,096 rays (batch 1, seed 5) on the CPU, with roulette, periodic walls
    and the compaction ladder, through only what the tree before float64
    tracing had. ``grid_min_prims``: the config's, in place of its default
    (0: the geometry's uniform grid is walked, where it has one)."""
    import hashlib

    import viennaray_tpu_torch as vrtt
    from viennaray_tpu_torch.config import adjust_bounding_box
    from viennaray_tpu_torch.io import fixtures
    from viennaray_tpu_torch.trace.kernel import trace_batch

    kind, body = name.split("_")
    if kind == "disks":
        pts, nrm = fixtures.create_trench_grid_3d(grid_delta=0.5)
        geo = vrtt.DiskGeometry.build(pts, nrm, 0.5, device="cpu")
        margin, dim, direction = geo.disk_radius, 3, (0.31, 0.17, -1.0)
    elif kind == "triangles":
        verts, tris = fixtures.create_trench_mesh_3d(grid_delta=0.5)
        geo = vrtt.TriangleGeometry.build(verts, tris, 0.5, device="cpu")
        margin, dim, direction = 0.5, 3, (0.31, 0.17, -1.0)
    else:
        nodes, lines = fixtures.create_trench_line_mesh(0.25)
        geo = vrtt.LineGeometry.from_mesh(
            vrtt.LineMesh(nodes=nodes, lines=lines, grid_delta=0.25),
            device="cpu")
        margin, dim, direction = 0.25, 2, (0.29, -1.0, 0.0)
    face = vrtt.TraceDirection.POS_Z if dim == 3 else vrtt.TraceDirection.POS_Y
    bbox = adjust_bounding_box(geo.bbox.numpy(), face, margin,
                               dim).astype(np.float32)
    config = vrtt.TraceConfig(
        dim=dim, source_direction=face,
        boundary_conditions=(vrtt.BoundaryCondition.PERIODIC,) * 3,
        ray_batch_size=4096, rng_seed=5, use_random_seed=False)
    if grid_min_prims is not None:
        config = dataclasses.replace(config, grid_min_prims=grid_min_prims)
    rng = streams.GeneratorRNG(5, "cpu")
    rng.begin_batch(1)
    idx = torch.arange(4096, 8192)
    flux, counters = trace_batch(
        geo, Beam(bbox, direction, dim), vrtt.SpecularParticle(0.2, 100.0),
        torch.from_numpy(bbox), rng, 1, idx, idx < 8100, config,
        fused=body == "fused")
    h = hashlib.sha256(flux.numpy().tobytes())
    h.update(repr(tuple(int(c) for c in counters)).encode())
    return h.hexdigest()


if __name__ == "__main__" and sys.argv[1:2] == ["--record-f32-digests"]:
    import json

    with open(sys.argv[2], "w") as f:
        json.dump({name: f32_digest(name) for name in F32_DIGEST_TRACES}, f,
                  indent=1)
        f.write("\n")
    sys.exit(0)


if __name__ == "__main__" and sys.argv[1:2] == ["--record-draws"]:
    import json

    with open(sys.argv[2], "w") as f:
        json.dump({name: record_draws(name) for name in DRAW_TRACES}, f,
                  separators=(",", ":"))
        f.write("\n")
    sys.exit(0)
