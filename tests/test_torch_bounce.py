"""The port's fused bounce (``ops/bounce.py``) against the JAX package's
megakernel in interpret mode, and the plain version against itself.

On the CPU ``fused_bounce`` runs its plain version, ``fused_bounce_ref``; the
CUDA kernel is held to that plain version on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viennaray_tpu.ops import pallas_bounce

from viennaray_tpu_torch.config import (
    BoundaryCondition,
    ReflectionKind,
    TraceDirection,
    adjust_bounding_box,
)
from viennaray_tpu_torch.ops import bounce
from viennaray_tpu_torch.ops.nearest_hit import BIG

from torch_port_helpers import (
    check_state_and_counts,
    make_settings,
    make_state,
    port_geometry,
    port_state,
    reference_bounce,
    reference_geometry,
)

torch.set_num_threads(1)

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
    assert whole.counts[bounce.N_EVENTS] == state.alive.sum()
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
    # the coned-cosine model is taken; a reflection kind that is none is not
    coned = settings._replace(refl_kind=int(ReflectionKind.CONED_COSINE))
    res = bounce.fused_bounce(state, uniforms, geo, walls, coned, n_sub=2)
    assert res.counts[3] > 0
    with pytest.raises(ValueError):
        bounce.fused_bounce(state, uniforms, geo, walls,
                            settings._replace(refl_kind=3), n_sub=2)
