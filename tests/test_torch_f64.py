"""Float64 tracing in the port against the JAX package under
``jax_enable_x64``, on the CPU.

The JAX package's float64 mode (the analog of the reference's
``NumericType=double``) runs its unfused trace and its gradients in the
geometry's type, searching by XLA brute force. The port widens a geometry
with ``to(torch.float64)`` and traces it on the float64 forms of its kernels,
whose plain versions run here. ``jax_enable_x64`` is switched on for each
comparison and restored in ``try / finally``, as tests/test_diff.py:228,
286-287 does.

Tolerances, with the worst relative differences measured here:
- searches in packed order: hit and primitive equal, t within rtol 1e-12
  (the brute force takes n . o from a matrix product and triangles' and
  lines' quotients as products with one reciprocal; measured 0, 2.2e-16,
  2.2e-16 on disks, triangles, lines);
- the histogram's float64 form against a float64 sum: rtol 1e-13 (two
  fixed-point words resolve 2^-(k + L), about 2^-100 of the largest weight
  here, and the read-back rounds twice; measured 4.5e-16);
- lane-matched traces: counters equal, flux within rtol 1e-10 per bin
  (measured 3.7e-16, 3.7e-16, 8.0e-16);
- the normals gradient: within 1e-3 of a one-sided difference (the JAX
  test's bound) and within 1e-8 of the JAX package's own gradient
  (measured 1.3e-15).
A float32 trace keeps the bits it had before float64 tracing existed
(``tests/torch_parent_f32_digests.json``).
"""

import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viennaray_tpu as vrt
import viennaray_tpu_torch as vrtt
from viennaray_tpu.ops import intersect as ref_intersect
from viennaray_tpu.trace import kernel as ref_kernel
from viennaray_tpu_torch import rng as rng_mod
from viennaray_tpu_torch.ops import histogram as H
from viennaray_tpu_torch.ops import nearest_hit as NH
from viennaray_tpu_torch.physics.source import RandomSource
from viennaray_tpu_torch.trace.kernel import trace_batch

from torch_port_helpers import (
    F32_DIGEST_TRACES,
    JaxKeyedRNG,
    diff_setups,
    f32_digest,
    packed_geometries,
    port_trace_flux,
    reference_trace_flux,
)

torch.set_num_threads(1)
F64 = torch.float64
HERE = os.path.dirname(os.path.abspath(__file__))


@contextlib.contextmanager
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _cast(tree):
    """A JAX pytree with every float32 array widened (test_diff.py:231-239);
    call under ``x64``."""
    return jax.tree.map(
        lambda a: a.astype(jnp.float64)
        if hasattr(a, "dtype") and a.dtype == jnp.float32 else a, tree)


def _rays(bbox, n, dim, seed):
    """numpy-seeded rays in the box, directions all over the sphere (in the
    plane z = 0 in 2D), float64."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(bbox, np.float64)
    org = rng.uniform(lo, hi, (n, 3))
    d = rng.normal(size=(n, 3))
    if dim == 2:
        org[:, 2] = 0.0
        d[:, 2] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d


# ---- the geometry in float64 -----------------------------------------------
@pytest.mark.parametrize("geo_kind", ["disk", "triangle", "line"])
def test_to_float64_widens_and_keeps_the_packing(geo_kind):
    """``to(torch.float64)``: the permutation, chunk boxes and integer
    tables of the float32 packing, every float table widened, the SoA's
    derived rows recomputed in float64; back to the same geometry for
    ``to(torch.float32)`` of a float32 one."""
    _, geo, _, _ = packed_geometries(geo_kind)
    assert geo.to(torch.float32) is geo
    g64 = geo.to(F64)
    assert g64.dtype == F64 and g64.prims_soa.dtype == F64
    np.testing.assert_array_equal(g64.soa_perm, geo.soa_perm)
    np.testing.assert_array_equal(g64.soa_chunk_bbs, geo.soa_chunk_bbs.double())
    np.testing.assert_array_equal(g64.material_ids, geo.material_ids)
    soa, soa32 = g64.prims_soa.numpy(), geo.prims_soa.double().numpy()
    derived = {"disk": [6, 7], "triangle": list(range(3, 9)),
               "line": [2, 3]}[geo_kind]
    kept = [r for r in range(soa.shape[0]) if r not in derived]
    np.testing.assert_array_equal(soa[kept], soa32[kept])
    n = geo.num_primitives
    np.testing.assert_allclose(soa[derived, :n], soa32[derived, :n],
                               rtol=1e-6, atol=1e-6)
    if geo_kind == "disk":
        c, nrm = g64.points.numpy(), g64.normals.numpy()
        lanes = g64.soa_inv_perm.numpy()
        ndc = (nrm[:, 0] * c[:, 0] + nrm[:, 1] * c[:, 1]) + nrm[:, 2] * c[:, 2]
        np.testing.assert_array_equal(soa[7, lanes], ndc)
        win = g64.with_window_list()
        assert win.window_pack.dtype == F64
        np.testing.assert_array_equal(
            win.window_pack.reshape(n, -1, 8)[:, 0].numpy(), soa[:, lanes].T)
        np.testing.assert_array_equal(
            geo.with_window_list().to(F64).window_pack, win.window_pack)


# ---- the closest-hit searches ------------------------------------------------
@pytest.mark.parametrize("geo_kind", ["disk", "triangle", "line"])
def test_plain_search_matches_reference_f64(geo_kind):
    """The float64 plain versions (the float64 kernels' twins) against the
    JAX package's float64 searches ``intersect.{disk,triangle,line}_
    nearest_hit`` on 2,048 rays in packed order, and the constants they
    widen: equal hits and primitives, t within rtol 1e-12."""
    ref_geo, geo, bbox, dim = packed_geometries(geo_kind)
    g64 = geo.to(F64)
    org, d = _rays(bbox, 2048, dim, seed=5)
    name = f"{geo_kind}_nearest_hit"
    t, prim, hit = getattr(NH, name)(
        torch.from_numpy(org), torch.from_numpy(d), g64.prims_soa,
        g64.soa_perm, g64.soa_chunk_bbs, t_near=1e-4)
    assert t.dtype == F64
    with x64():
        o, dd = jnp.asarray(org), jnp.asarray(d)
        f = _cast(ref_geo)
        if geo_kind == "disk":
            want = ref_intersect.disk_nearest_hit(o, dd, f.points, f.normals,
                                                  f.radii, 1e-4)
        elif geo_kind == "triangle":
            want = ref_intersect.triangle_nearest_hit(o, dd, f.vertices,
                                                      f.triangles, 1e-4)
        else:
            want = ref_intersect.line_nearest_hit(o, dd, f.p0, f.p1, 1e-4)
        t_w, prim_w, hit_w = (np.asarray(x) for x in want)
    assert t_w.dtype == np.float64
    hit = hit.numpy()
    np.testing.assert_array_equal(hit, hit_w)
    assert 0.2 < hit.mean() < 1.0
    np.testing.assert_array_equal(prim.numpy()[hit], prim_w[hit])
    np.testing.assert_allclose(t.numpy()[hit], t_w[hit], rtol=1e-12)


def test_line_clip_is_the_widened_float32_pair():
    """The float64 line test clips 1e-5 < s < 1 - 1e-5 at the float32 values
    widened, as the JAX package's float64 search (ops/intersect.py:188):
    float32(1e-5) and float32(1) - float32(1e-5) both lie below their
    float64 counterparts, so a ray through s between float32(1e-5) and
    1e-5 hits and one through s between float32(1) - float32(1e-5) and
    1 - 1e-5 misses, where a float64 clip would decide the other way."""
    prims = torch.zeros((NH.LINE_ROWS, 512), dtype=F64)
    prims[0:2, 1:] = 1e18
    prims[2, 0] = 1.0  # the segment (0, 0) to (1, 0)
    prims[5, 0] = 1.0
    perm = torch.zeros(512, dtype=torch.int32)
    bbs = torch.tensor([[0.0, -1.0, -1.0, 1.0, 1.0, 1.0, 0.0, 0.0]], dtype=F64)
    lo = float(NH.LINE_S_MIN)
    hi = float(NH.LINE_S_MAX)
    xs = [lo * (1 - 1e-9), (lo + 1e-5) / 2, hi * (1 - 1e-12),
          (hi + (1 - 1e-5)) / 2, 0.5]
    org = torch.tensor([[x, 1.0, 0.0] for x in xs], dtype=F64)
    d = torch.tensor([[0.0, -1.0, 0.0]] * len(xs), dtype=F64)
    _, _, hit = NH.line_nearest_hit(org, d, prims, perm, bbs, t_near=1e-4)
    assert hit.tolist() == [False, True, True, False, True]
    assert lo < 1e-5 and hi < 1 - 1e-5


# ---- kernel 2's float64 form --------------------------------------------------
@pytest.mark.parametrize("n_entries", [6144, 65536])
def test_histogram_f64_plain_version(n_entries):
    """The histogram's float64 form on the CPU (its plain version, the
    kernel's integer sums): within rtol 1e-13 of a float64 sum, the same
    bits for the entries in any order (integer sums), float64 out, zeros
    for all-zero weights."""
    rng = np.random.default_rng(n_entries)
    n_bins = 2993
    ids = rng.integers(0, n_bins, n_entries).astype(np.int32)
    w = rng.uniform(0.1, 1.0, n_entries) * (rng.random(n_entries) < 0.5)
    w[::97] *= 1e-9  # weights far below the largest
    out = H.flux_histogram(torch.from_numpy(ids), torch.from_numpy(w), n_bins)
    assert out.dtype == F64 and out.shape == (n_bins,)
    want = np.zeros(n_bins)
    np.add.at(want, ids, w)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-13, atol=1e-300)
    order = rng.permutation(n_entries)
    shuffled = H.flux_histogram(torch.from_numpy(ids[order]),
                                torch.from_numpy(w[order]), n_bins)
    assert torch.equal(out, shuffled)
    zero = H.flux_histogram(torch.from_numpy(ids),
                            torch.zeros(n_entries, dtype=F64), n_bins)
    assert zero.dtype == F64 and not zero.any()
    k, low = H.fixed_point_f64(float(w.max()), n_entries)
    assert (k, low) == (62 - 0 - n_entries.bit_length(),
                        63 - n_entries.bit_length())


def test_histogram_f64_backward_is_the_gather():
    """The float64 histogram's gradient: the gather grad_out[ids], float64,
    through ``FluxHistogramFn`` and ``flux_histogram_grad``."""
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(0, 50, 4000).astype(np.int32))
    w = torch.from_numpy(rng.random(4000)).requires_grad_(True)
    g = torch.from_numpy(rng.normal(size=50))
    out = H.flux_histogram(ids, w, 50)
    (grad,) = torch.autograd.grad(torch.dot(out, g), w)
    assert grad.dtype == F64
    assert torch.equal(grad, g[ids.long()])
    assert torch.equal(H.flux_histogram_grad(g, ids), g[ids.long()])


# ---- trace_batch in float64, lane by lane ------------------------------------
@pytest.mark.parametrize("geo_kind", ["disk", "triangle", "line"])
def test_trace_batch_f64_lane_matched(geo_kind):
    """One mega-batch of 2,048 rays through both packages' unfused bodies
    in float64 on the same tables (packed order) with the same float64
    uniforms (``JaxKeyedRNG``): the source sort, the compaction ladder and
    roulette run. Counters equal; flux within rtol 1e-10 per bin."""
    ref_geo, geo, bbox32, dim = packed_geometries(geo_kind)
    bbox = bbox32.astype(np.float64)
    R, batch_index, seed = 2048, 1, 777
    face = "POS_Z" if dim == 3 else "POS_Y"
    common = dict(dim=dim, ray_batch_size=R, rng_seed=seed,
                  use_random_seed=False, max_bounces=3000)
    axes = dict(ray_dir=2, first_dir=0, second_dir=1, pos_neg=-1.0, dim=3)
    if dim == 2:
        axes = dict(ray_dir=1, first_dir=0, second_dir=2, pos_neg=-1.0, dim=2)
    ray_indices = np.arange(batch_index * R, (batch_index + 1) * R)
    valid = ray_indices < (batch_index + 1) * R - 50
    base = jax.random.PRNGKey(seed)
    with x64():
        ref_config = vrt.TraceConfig(
            source_direction=getattr(vrt.TraceDirection, face),
            boundary_conditions=(vrt.BoundaryCondition.PERIODIC,) * 3,
            **common)
        ref_source = vrt.RandomSource(
            bbox=jnp.asarray(bbox), cosine_power=jnp.float64(1.0), min_max=1,
            **axes)
        ref_flux, ref_cnt = jax.jit(
            lambda g, s, p, b, k, i, v: ref_kernel.trace_batch(
                g, s, p, b, k, i, v, config=ref_config, geo_type=geo_kind,
                knobs=ref_kernel.EnvKnobs(fused=False)))(
            _cast(ref_geo), ref_source,
            vrt.DiffuseParticle(0.2, "flux", dtype=jnp.float64),
            jnp.asarray(bbox), jax.random.fold_in(base, batch_index),
            jnp.asarray(ray_indices, jnp.int32), jnp.asarray(valid))
        ref_flux = np.asarray(ref_flux)
        config = vrtt.TraceConfig(
            source_direction=getattr(vrtt.TraceDirection, face),
            boundary_conditions=(vrtt.BoundaryCondition.PERIODIC,) * 3,
            **common)
        source = RandomSource(bbox=torch.from_numpy(bbox), cosine_power=1.0,
                              min_max=1, **axes)
        rng = JaxKeyedRNG(base, dtype=F64)
        rng.begin_batch(batch_index)
        flux, cnt = trace_batch(
            geo.to(F64), source, vrtt.DiffuseParticle(0.2), torch.from_numpy(
                bbox), rng, batch_index, torch.from_numpy(ray_indices),
            torch.from_numpy(valid), config, fused=False)
    assert ref_flux.dtype == np.float64 and flux.dtype == F64
    for name in ("total_traces", "geometry_hits", "boundary_hits",
                 "non_geometry_hits", "reflections"):
        assert getattr(cnt, name) == int(getattr(ref_cnt, name)), name
    assert cnt.geometry_hits > 1000
    np.testing.assert_allclose(flux.numpy(), ref_flux, rtol=1e-10, atol=0)


# ---- the normals gradient in float64 ----------------------------------------
def test_grad_normals_f64_matches_fd_and_reference():
    """The port's counterpart of tests/test_diff.py:215-287: d dot(lw, flux)
    / d (x of an off-centre bottom disk's normal) on the 2D trench (180
    disks, 2,048 rays, 1/distance weighting, 4 bounces) in float64 through
    ``diff.trace_flux``: within 1e-3 of either one-sided difference at eps
    1e-6 (the JAX test's bound; a selection tie can put a kink at 0), and
    within 1e-8 of the JAX package's gradient on the same lanes."""
    ref, port = diff_setups("disk2d", use_wdist=True)
    pts = port["geometry"].points.numpy()
    bot = np.where((np.abs(pts[:, 1] - pts[:, 1].min()) < 1e-6)
                   & (np.abs(pts[:, 0] + 0.5) < 0.2))[0]
    pi = int(bot[0])
    n = len(pts)
    base = jax.random.PRNGKey(7)
    sticking = float(np.float32(0.3))  # the JAX setup's float32 value
    with x64():
        lw = np.array(jax.random.uniform(jax.random.PRNGKey(5), (n,),
                                         dtype=jnp.float64))
        r64 = dict(ref, geometry=_cast(ref["geometry"]),
                   source=_cast(ref["source"]),
                   particle=_cast(ref["particle"]),
                   bbox=ref["bbox"].astype(jnp.float64))

        def ref_loss(du):
            g = r64["geometry"].replace(
                normals=r64["geometry"].normals.at[pi, 0].add(du))
            return jnp.sum(reference_trace_flux(
                r64, jax.random.fold_in(base, 0), 2048, 4, geometry=g) * lw)

        ref_grad = float(jax.grad(ref_loss)(jnp.float64(0.0)))
        geo64 = port["geometry"].to(F64)
        p64 = dict(port, geometry=geo64, source=port["source"].to(F64),
                   particle=port["particle"].replace(sticking=sticking),
                   bbox=port["bbox"].double())
        onehot = torch.zeros((n, 3), dtype=F64)
        onehot[pi, 0] = 1.0

        def loss(du):
            g = geo64.replace(normals=geo64.normals + du * onehot)
            return torch.dot(torch.from_numpy(lw), port_trace_flux(
                p64, JaxKeyedRNG(base, dtype=F64), 2048, 4, geometry=g))

        du = torch.zeros((), dtype=F64, requires_grad=True)
        value = loss(du)
        (grad,) = torch.autograd.grad(value, du)
        grad = float(grad)
        eps = 1e-6
        with torch.no_grad():
            f0 = float(loss(torch.tensor(0.0, dtype=F64)))
            fwd = (float(loss(torch.tensor(eps, dtype=F64))) - f0) / eps
            bwd = (f0 - float(loss(torch.tensor(-eps, dtype=F64)))) / eps
    assert value.dtype == F64
    assert np.isfinite(grad) and grad != 0.0
    err = min(abs(grad - fwd) / max(abs(fwd), 1e-12),
              abs(grad - bwd) / max(abs(bwd), 1e-12))
    assert err < 1e-3, (grad, fwd, bwd)
    np.testing.assert_allclose(grad, ref_grad, rtol=1e-8)


# ---- hooks in float64 ----------------------------------------------------------
def test_hooks_reimplementing_the_builtin_f64():
    """Custom hooks in float64: a collision_fn depositing the hook's ids and
    float64 weights with the histogram, a reflection_fn giving the built-in
    diffuse reflection from its handle's float64 uniforms and an
    aux_init_fn's float64 rows; the built-in unfused float64 trace's flux
    and counters bit for bit."""
    from viennaray_tpu_torch.ops.histogram import flux_histogram
    from viennaray_tpu_torch.physics import reflection

    _, geo, bbox32, _ = packed_geometries("disk")
    bbox = torch.from_numpy(bbox32.astype(np.float64))
    config = vrtt.TraceConfig(
        dim=3, boundary_conditions=(vrtt.BoundaryCondition.PERIODIC,) * 3,
        ray_batch_size=2048, rng_seed=3, use_random_seed=False)
    source = RandomSource(bbox=bbox, cosine_power=1.0, ray_dir=2,
                          first_dir=0, second_dir=1, min_max=1, pos_neg=-1.0,
                          dim=3)
    seen = {}

    def collision_fn(flux, ids, w, dirn, normal, mat, rng, aux):
        seen["dtypes"] = (w.dtype, dirn.dtype, normal.dtype, aux.dtype,
                          rng.uniform(4).dtype)
        return flux + flux_histogram(ids.reshape(-1), w.reshape(-1),
                                     flux.shape[0])

    def reflection_fn(rng, dirn, normal, prim, mat, weight, aux):
        u1, u2 = rng.reflect_uniforms
        return 0.1, reflection.diffuse(u1, u2, normal, 3), aux

    def aux_init_fn(rng, ray_indices):
        return rng.uniform((len(ray_indices), 1))

    out = []
    for hooks in ({}, dict(collision_fn=collision_fn,
                           reflection_fn=reflection_fn,
                           aux_init_fn=aux_init_fn)):
        rng = rng_mod.GeneratorRNG(8, "cpu", dtype=F64)
        rng.begin_batch(0)
        idx = torch.arange(2048)
        out.append(trace_batch(
            geo.to(F64), source, vrtt.DiffuseParticle(0.1), bbox, rng, 0,
            idx, torch.ones(2048, dtype=torch.bool), config, fused=False,
            **hooks))
    (want, want_cnt), (got, got_cnt) = out
    assert want.dtype == got.dtype == F64 and float(want.sum()) > 0
    assert torch.equal(got, want) and tuple(got_cnt) == tuple(want_cnt)
    assert seen["dtypes"] == (F64,) * 5


# ---- refusals by name --------------------------------------------------------
def _f64_problem():
    ref, port = diff_setups("disk2d")
    return (port["geometry"].to(F64), port["source"].to(F64),
            port["particle"], port["bbox"].double(), port["config"])


@pytest.mark.parametrize("case", ["fused", "rng", "source", "tracer"])
def test_f64_refusals_by_name(case):
    """Float64 with the fused body (``fused=True``), with a float32 rng or
    source, and through a tracer (``TraceDisk(dtype=torch.float64)``)
    raise, each naming the setting."""
    if case == "tracer":
        with pytest.raises(NotImplementedError, match="trace_batch"):
            vrtt.TraceDisk(dim=3, device="cpu", dtype=F64)
        return
    geo, source, particle, bbox, config = _f64_problem()
    rng = rng_mod.GeneratorRNG(1, "cpu", dtype=F64)
    kwargs = dict(fused=False)
    if case == "fused":
        kwargs, match = dict(fused=True), "fused=False"
    elif case == "rng":
        rng, match = rng_mod.GeneratorRNG(1, "cpu"), "rng draws"
    else:
        source, match = source.to(torch.float32), "source samples"
    rng.begin_batch(0)
    idx = torch.arange(512)
    with pytest.raises(NotImplementedError, match=match):
        trace_batch(geo, source, particle, bbox, rng, 0, idx,
                    torch.ones(512, dtype=torch.bool), config, **kwargs)


# ---- float32 stays what it was -----------------------------------------------
@pytest.fixture(scope="module")
def parent_digests():
    with open(os.path.join(HERE, "torch_parent_f32_digests.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", F32_DIGEST_TRACES)
def test_float32_trace_batch_is_what_it_was(name, parent_digests):
    """A float32 ``trace_batch`` (disks unfused and fused, triangles and
    lines unfused; specular beams, roulette, periodic walls, the ladder)
    gives the flux and counters bit for bit that the tree before float64
    tracing gave (their sha256, recorded from that tree)."""
    assert f32_digest(name) == parent_digests[name]
