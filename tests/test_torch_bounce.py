"""The port's fused bounce (``ops/bounce.py``) against the JAX package's
megakernel in interpret mode, and the plain version against itself.

On the CPU ``fused_bounce`` runs its plain version, ``fused_bounce_ref``; the
CUDA kernel is held to that plain version on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viennaray_tpu.config import BoundaryCondition as RefBC
from viennaray_tpu.config import ReflectionKind as RefKind
from viennaray_tpu.ops import pallas_bounce

from viennaray_tpu_torch.config import (
    BoundaryCondition,
    ReflectionKind,
    TraceDirection,
    adjust_bounding_box,
)
from viennaray_tpu_torch.ops import bounce
from viennaray_tpu_torch.ops.nearest_hit import BIG

from torch_port_helpers import port_geometry, reference_geometry

torch.set_num_threads(1)

MAX_BDRY = 5
MAX_REFL = 7
CASES = {
    "diffuse_periodic": (ReflectionKind.DIFFUSE, BoundaryCondition.PERIODIC),
    "specular_reflective": (
        ReflectionKind.SPECULAR, BoundaryCondition.REFLECTIVE
    ),
    "diffuse_ignore": (ReflectionKind.DIFFUSE, BoundaryCondition.IGNORE),
}


@pytest.fixture(scope="module")
def trench():
    """The ``trench_0.5`` cloud (2 chunks) in both packages, its adjusted box."""
    _, _, _, ref_geo = reference_geometry("trench_0.5")
    geo = port_geometry(ref_geo)
    bbox = adjust_bounding_box(
        np.asarray(ref_geo.bbox), TraceDirection.POS_Z, ref_geo.disk_radius, 3
    ).astype(np.float32)
    return ref_geo, geo, bbox


def make_settings(kind, bc, dim=3):
    return bounce.BounceSettings(
        dim=dim, first_dir=0, second_dir=1, ray_axis=2, bc1=int(bc),
        bc2=int(bc), refl_kind=int(kind), sticking=0.3, t_near=1e-4,
        max_reflections=MAX_REFL, max_boundary_hits=MAX_BDRY, roulette=True,
        weight_threshold_frac=0.1, renew_weight_frac=0.3,
    )


def make_state(bbox, n, n_sub, seed):
    """Seeded state by numpy: the first half source rays (top plane, cosine
    lobe), the second half interior rays (anywhere in the box, any
    direction); some lanes dead, some that have passed a disk from behind,
    some with a counter at its cap, weights from full down to the roulette
    threshold."""
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
    uniforms = rng.random((n, 3 * n_sub), dtype=np.float32)
    return org, dirn, weight, w0, alive, hfb, n_refl, n_bdry, uniforms


def port_state(arrays):
    return bounce.RayState(*(torch.from_numpy(np.array(a)) for a in arrays[:8]))


def reference_bounce(ref_geo, walls, arrays, settings, n_sub, hand_out):
    """The megakernel in interpret mode, as the JAX package's own tests run
    it on the CPU; outputs as numpy in the port's layout."""
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
        jnp.full((1, 1), settings.sticking, jnp.float32),
        pt=ref_geo.prims_soa.shape[1] // n_chunks, t_near=settings.t_near,
        dim=settings.dim, first_dir=0, second_dir=1, ray_axis=2,
        bc1=RefBC(settings.bc1), bc2=RefBC(settings.bc2),
        refl_kind=RefKind(settings.refl_kind),
        max_bounces_cfg=settings.max_reflections,
        max_bdry=settings.max_boundary_hits,
        wthresh=settings.weight_threshold_frac,
        wrenew=settings.renew_weight_frac, roulette=True, interpret=True,
        n_sub=n_sub, xla_deposit=hand_out, rt=256, mxu_pick=False,
        precand=True, slice_w=1 << 19, entry_aux=True,
    )
    org2, dir2, w2, flags2, stats, flux_sorted = (np.asarray(o) for o in outs[:6])
    res = dict(
        org=org2, dirn=dir2, weight=w2[:, 0], alive=flags2[:, 0] > 0.5,
        hfb=flags2[:, 1] > 0.5, n_refl=flags2[:, 2].astype(np.int32),
        n_bdry=flags2[:, 3].astype(np.int32),
        counts=stats[:, 0:4].sum(axis=0),
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
    for i, name in enumerate(bounce.COUNT_NAMES[:4]):
        want = ref["counts"][i]
        assert abs(counts[i] - want) <= max(1, 0.002 * want), (name, counts, want)
    assert counts[4] == int(st.alive.sum())


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_bounce_handed_out_matches_reference_kernel(trench, case):
    ref_geo, geo, bbox = trench
    settings = make_settings(*CASES[case])
    walls = bounce.make_walls(torch.from_numpy(bbox), geo, settings)
    arrays = make_state(bbox, 1024, 1, seed=5)
    res = bounce.fused_bounce(
        port_state(arrays), torch.from_numpy(arrays[8]), geo, walls, settings,
        n_sub=1, deposit_in_kernel=False,
    )
    ref = reference_bounce(ref_geo, walls, arrays, settings, 1, True)
    assert res.flux is None and (ref["hit_prim"] >= 0).sum() > 100
    check_state_and_counts(res, ref, arrays[0])


@pytest.mark.parametrize("case", sorted(CASES))
def test_four_bounces_deposits_in_kernel_match_reference_kernel(trench, case):
    """The port deposits through the neighbor lists, the reference by a
    second chunk sweep with the 2r ball: flux rel-L2 < 1e-3 with at most two
    bins off by more than 1e-5 of the largest."""
    ref_geo, geo, bbox = trench
    settings = make_settings(*CASES[case])
    walls = bounce.make_walls(torch.from_numpy(bbox), geo, settings)
    arrays = make_state(bbox, 1024, 4, seed=6)
    res = bounce.fused_bounce(
        port_state(arrays), torch.from_numpy(arrays[8]), geo, walls, settings,
        n_sub=4, deposit_in_kernel=True,
    )
    ref = reference_bounce(ref_geo, walls, arrays, settings, 4, False)
    assert res.hit_prim is None and res.wdep is None
    check_state_and_counts(
        res, ref, arrays[0], flight=4 * np.linalg.norm(bbox[1] - bbox[0])
    )
    flux = res.flux.numpy()
    assert ref["flux"].sum() > 100
    rel = np.linalg.norm(flux - ref["flux"]) / np.linalg.norm(ref["flux"])
    assert rel < 1e-3, rel
    off = np.abs(flux - ref["flux"]) > 1e-5 * ref["flux"].max()
    assert off.sum() <= 2, off.sum()


def test_entry_bound_matches_reference(trench):
    """1e-6 relative, BIG where the reference has BIG (the reference
    multiplies by a reciprocal where the port divides)."""
    _, geo, bbox = trench
    settings = make_settings(ReflectionKind.DIFFUSE, BoundaryCondition.PERIODIC)
    walls = bounce.make_walls(torch.from_numpy(bbox), geo, settings)
    org, dirn = make_state(bbox, 1024, 1, seed=8)[:2]
    for dim in (3, 2):
        axes = dict(dim=dim, first_dir=0, second_dir=1, ray_axis=2, t_near=1e-4)
        got = bounce.entry_bound(
            torch.from_numpy(org), torch.from_numpy(dirn), walls, **axes
        )
        want = pallas_bounce._entry_bound(
            jnp.asarray(org), jnp.asarray(dirn),
            jnp.asarray(walls.numpy().reshape(1, 9)), **axes
        )
        for g, w in zip(got, want):
            g, w = g.numpy(), np.asarray(w)
            np.testing.assert_array_equal(g >= BIG, w >= BIG)
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
        assert (got[1].numpy() < BIG).sum() > 50


@pytest.mark.parametrize("k", [4, 16])
def test_n_sub_equals_repeated_single_bounces(trench, k):
    """The state and the counts bit for bit; the flux of one launch is the
    float64 sum of its sub-bounces rounded once, so against the sum of the
    single launches' float32 fluxes it holds to float32 rounding."""
    _, geo, bbox = trench
    settings = make_settings(ReflectionKind.DIFFUSE, BoundaryCondition.PERIODIC)
    walls = bounce.make_walls(torch.from_numpy(bbox), geo, settings)
    arrays = make_state(bbox, 1000, k, seed=9)  # a ragged R
    uniforms = torch.from_numpy(arrays[8])
    whole = bounce.fused_bounce(
        port_state(arrays), uniforms, geo, walls, settings, n_sub=k
    )
    state = port_state(arrays)
    counts = torch.zeros(4, dtype=torch.int64)
    flux = torch.zeros(geo.num_primitives, dtype=torch.float64)
    for j in range(k):
        step = bounce.fused_bounce(
            state, uniforms[:, 3 * j: 3 * j + 3].contiguous(), geo, walls,
            settings, n_sub=1,
        )
        state = step.state
        counts += step.counts[:4]
        flux += step.flux.double()
    for got, want in zip(whole.state, state):
        assert torch.equal(got, want)
    assert torch.equal(whole.counts[:4], counts)
    assert whole.counts[4] == state.alive.sum()
    assert flux.sum() > 100
    np.testing.assert_allclose(
        whole.flux.numpy(), flux.numpy(), rtol=1e-6, atol=0
    )


def test_all_dead_batch_returns_its_input_and_zero_flux(trench):
    _, geo, bbox = trench
    for dim, kind in ((3, ReflectionKind.DIFFUSE), (2, ReflectionKind.SPECULAR)):
        settings = make_settings(kind, BoundaryCondition.REFLECTIVE, dim=dim)
        walls = bounce.make_walls(torch.from_numpy(bbox), geo, settings)
        arrays = list(make_state(bbox, 600, 4, seed=10))
        arrays[4] = np.zeros(600, bool)
        state = port_state(arrays)
        res = bounce.fused_bounce(
            state, torch.from_numpy(arrays[8]), geo, walls, settings, n_sub=4
        )
        for got, want in zip(res.state, state):
            assert torch.equal(got, want)
        assert not res.flux.any() and not res.counts.any()


def test_wrapper_refuses_what_the_kernel_does_not_take(trench):
    _, geo, bbox = trench
    settings = make_settings(ReflectionKind.DIFFUSE, BoundaryCondition.PERIODIC)
    walls = bounce.make_walls(torch.from_numpy(bbox), geo, settings)
    arrays = make_state(bbox, 64, 2, seed=11)
    state, uniforms = port_state(arrays), torch.from_numpy(arrays[8])
    with pytest.raises(ValueError):  # deposits handed out need n_sub == 1
        bounce.fused_bounce(state, uniforms, geo, walls, settings, n_sub=2,
                            deposit_in_kernel=False)
    with pytest.raises(ValueError):  # uniforms of another n_sub
        bounce.fused_bounce(state, uniforms, geo, walls, settings, n_sub=4)
    with pytest.raises(TypeError):
        bounce.fused_bounce(
            state._replace(n_refl=state.n_refl.long()), uniforms, geo, walls,
            settings, n_sub=2,
        )
    with pytest.raises(ValueError):
        bounce.fused_bounce(
            state._replace(org=state.org.T.contiguous().T), uniforms, geo,
            walls, settings, n_sub=2,
        )
    coned = settings._replace(refl_kind=int(ReflectionKind.CONED_COSINE))
    with pytest.raises(NotImplementedError):
        bounce.fused_bounce(state, uniforms, geo, walls, coned, n_sub=2)
