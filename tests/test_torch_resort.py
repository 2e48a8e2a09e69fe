"""The per-bounce coherence resort (``trace/kernel.py:resort``,
``resort_for``, ``dirbins_for``; ``ops/permute.py``) against the JAX
package's, on the CPU.

(a) One mega-batch of 4,096 rays lane-matched through both packages'
    unfused bodies on the 3,818-disk trench at grid delta 0.22 (8 chunks,
    so both resort), at 8, 32 and 64 direction bins, every bounce and every
    second one, and with a stateful hook whose aux must move with its lanes;
    the port without the resort must fail the same bound. (b) The key
    against a numpy transcription of the JAX package's ``_coherence_key``
    and against that function itself past the kernel's quads of lanes and
    on views at an offset, and the permutation against per-array indexing.
    (c) The gate and the direction bins. (d) The recorded digests and draw
    logs keep guarding the path without the resort. (e) Same-seed applies
    and the sharded trace with the resort on.

On the CPU the wrappers run their plain versions; the CUDA kernels
(``csrc/permute.cu``) are held to them on the card by ``chip_smoke.py``.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import viennaray_tpu as vrt
from viennaray_tpu.trace import kernel as ref_kernel

import viennaray_tpu_torch as vrtt
from viennaray_tpu_torch.io import fixtures
from viennaray_tpu_torch.ops import permute as P
from viennaray_tpu_torch.ops.bounce import RayState
from viennaray_tpu_torch.parallel import mesh as port_mesh
from viennaray_tpu_torch.trace import kernel as TK

from test_torch_hooks import (
    aux_init, energy_collision, lossy_reflection, ref_aux_init,
    ref_energy_collision, ref_lossy_reflection,
)
from test_torch_trace import _assert_lane_matched
from torch_port_helpers import (
    DRAW_TRACES, F32_DIGEST_TRACES, draw_trace, f32_digest, lane_matched_batch,
)

torch.set_num_threads(1)

R = 4096


# ---- (a) lane-matched against the JAX package --------------------------------
def _resort_batch(ref_knobs, ref_hooks=None, **port_kwargs):
    """``lane_matched_batch`` of 4,096 rays (all valid) on the 8-chunk
    trench, both bodies unfused, the port's resort asked for unless
    ``port_kwargs`` say otherwise; returns what ``_assert_lane_matched``
    takes."""
    port_kwargs.setdefault("bounce_sort", True)
    out = lane_matched_batch(
        vrt.DiffuseParticle(0.1, "flux"), vrtt.DiffuseParticle(0.1, "flux"),
        ref_knobs, geo_kind="disk_0.22", R=R, ref_hooks=ref_hooks,
        fused=False, **port_kwargs)
    return (*out[:4], R)


def _assert_resort_matched(flux, cnt, ref_flux, ref_cnt, n_valid):
    """``test_torch_trace.py:_assert_lane_matched`` (counters within 0.2 %,
    at most two bins off by more than 1e-5 of the largest, flux rel-L2 <
    1e-3) with the rel-L2 taken over the bins that are not off, and each
    bin off by at most one ray's weight (1). The two packages' deposit
    re-tests round differently, so a ray on a disk's very rim may deposit in
    one and not the other (``_assert_lane_matched``'s allowance of two bins);
    on these 3,818 smaller disks one such deposit alone moves the rel-L2 over
    all bins to 2e-3 (measured at 8 bins, every bounce: one bin off by
    0.59, the rest within 2.5e-8)."""
    off = np.abs(flux - ref_flux) > 1e-5 * np.abs(ref_flux).max()
    assert off.sum() <= 2
    assert np.abs(flux - ref_flux)[off].max(initial=0.0) <= 1.0
    _assert_lane_matched(flux[~off], cnt, ref_flux[~off], ref_cnt, n_valid)


def _knobs(dirbins, sort_every):
    """The reference's knobs; at 32 bins every bounce its defaults (its
    "auto" is 32 at 8 chunks), which the control below shares, so that the
    two compile one trace."""
    if (dirbins, sort_every) == (32, 1):
        return ref_kernel.EnvKnobs(fused=False)
    return ref_kernel.EnvKnobs(fused=False, bounce_sort=True,
                               sort_dirbins=str(dirbins),
                               sort_every=sort_every)


@pytest.mark.parametrize("sort_every", [1, 2])
@pytest.mark.parametrize("dirbins", [8, 32, 64])
def test_resort_lane_matched_with_reference(dirbins, sort_every):
    """The port's resort against the JAX package's at ``dirbins`` direction
    bins, every ``sort_every`` bounces: the lanes are ordered by the same
    key before every bounce's uniforms are drawn, so each lane meets the
    reference's numbers and the whole ladder stays lane-matched:
    ``_assert_resort_matched`` (measured: counters equal, rel-L2 2.5e-8 to
    2.7e-8, one bin off at 8 bins every bounce). A lane on another side of
    a key boundary would move every later lane and part the two runs."""
    _assert_resort_matched(*_resort_batch(
        _knobs(dirbins, sort_every), sort_dirbins=dirbins,
        sort_every=sort_every))


def test_resort_moves_the_aux_with_its_lanes():
    """A stateful hook (an energy per ray, lost by 30 % a reflection, drawn
    from the hooks' own streams; ``test_torch_hooks.py``) under the resort
    at the default bins ("auto": 32 at 8 chunks): an aux row left behind by
    a permutation would deposit another ray's energy."""
    hooks = dict(collision_fn=energy_collision, reflection_fn=lossy_reflection,
                 aux_init_fn=aux_init)
    ref_hooks = dict(collision_fn=ref_energy_collision,
                     reflection_fn=ref_lossy_reflection,
                     aux_init_fn=ref_aux_init)
    _assert_resort_matched(*_resort_batch(
        ref_kernel.EnvKnobs(fused=False), ref_hooks=ref_hooks, **hooks))


def test_without_the_resort_the_bound_fails():
    """The control: the port with ``bounce_sort=False`` against the
    reference with its resort on must fail the bound the tests above pass,
    so that they are known to see the resort (measured: total traces 13,413
    against 13,539, flux rel-L2 0.34)."""
    with pytest.raises(AssertionError):
        _assert_resort_matched(*_resort_batch(
            _knobs(32, 1), bounce_sort=False))


# ---- (b) the key and the permutation -----------------------------------------
def numpy_coherence_key(org, dirn, alive, lo, ext, dirbins):
    """``_coherence_key`` of viennaray_tpu/trace/kernel.py:397-426 in numpy,
    in the inputs' float type."""
    f = org.dtype.type
    cell = np.clip(((org - lo) / ext * f(16.0)).astype(np.int32), 0, 15)
    if dirbins >= 32:
        nb_pol = 8 if dirbins >= 64 else 4
        dbin = (
            (dirn[:, 0] > 0).astype(np.int32)
            + 2 * (dirn[:, 1] > 0).astype(np.int32)
            + 4 * (np.abs(dirn[:, 0]) > np.abs(dirn[:, 1])).astype(np.int32)
            + 8 * np.clip(((dirn[:, 2] + f(1.0)) * f(nb_pol / 2.0))
                          .astype(np.int32), 0, nb_pol - 1)
        )
        nb_d = 8 * nb_pol
    else:
        dbin = ((dirn[:, 0] > 0).astype(np.int32)
                + 2 * (dirn[:, 1] > 0).astype(np.int32)
                + 4 * (dirn[:, 2] > 0).astype(np.int32))
        nb_d = 8
    key = ((cell[:, 0] * 16 + cell[:, 1]) * 16 + cell[:, 2]) * nb_d + dbin
    return np.where(alive, key, np.int32(1 << 30)).astype(np.int32)


# positions as fractions of the box: both faces exactly, cell faces, just
# outside
FRACTIONS = (0.0, 1.0, 0.5, 1.0 / 16.0, 15.0 / 16.0, -0.01, 1.01, 0.3)
# direction components: the poles, the equator, the band edges, |x| = |y|
COMPONENTS = (1.0, -1.0, 0.0, 0.5, -0.5, 0.75, -0.25, 0.6)
LO = (-2.5, -3.0, -1.25)
EXT = (5.0, 6.0, 5.5)

lanes = st.tuples(
    st.tuples(*[st.one_of(st.sampled_from(FRACTIONS),
                          st.floats(-0.05, 1.05))] * 3),
    st.one_of(
        st.tuples(*[st.sampled_from(COMPONENTS)] * 3),
        st.tuples(*[st.floats(-1.0, 1.0)] * 3),
        st.sampled_from([(0.6, 0.6, 0.2), (-0.6, 0.6, -1.0),
                         (0.0, 0.0, 1.0), (0.0, 0.0, -1.0)]),
    ),
    st.booleans(),
)


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(lanes, min_size=1, max_size=48),
       st.sampled_from([np.float32, np.float64]),
       st.sampled_from([8, 32, 64, 16, 100]))
def test_key_against_numpy_transcription(lanes, np_dtype, dirbins):
    """``coherence_key_ref`` (and the wrapper on the CPU) against the numpy
    transcription bit for bit, on lanes exactly on ``bb_lo`` and on
    ``bb_lo + bb_ext``, on cell faces and just outside the box, with z = +-1
    and 0, |x| == |y|, dead lanes, in float32 and float64. Positions on the
    far face are ``lo + ext`` rounded in the type, as a trace would hold
    them."""
    lo = np.asarray(LO, np_dtype)
    ext = np.asarray(EXT, np_dtype)
    frac = np.asarray([lane[0] for lane in lanes], np_dtype)
    org = (lo + frac * ext).astype(np_dtype)
    dirn = np.asarray([lane[1] for lane in lanes], np_dtype)
    alive = np.asarray([lane[2] for lane in lanes], bool)
    want = numpy_coherence_key(org, dirn, alive, lo, ext, dirbins)
    args = (torch.from_numpy(org), torch.from_numpy(dirn),
            torch.from_numpy(alive), torch.from_numpy(lo),
            torch.from_numpy(ext), dirbins)
    got = P.coherence_key_ref(*args)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(P.coherence_key(*args).numpy(), want)


def jax_coherence_key(lo, ext, dirbins):
    """The JAX package's own ``_coherence_key`` (a closure of
    ``trace_batch``, viennaray_tpu/trace/kernel.py:397-426), made from its
    code object with this box and number of direction bins in its cells."""
    code = next(c for c in ref_kernel.trace_batch.__code__.co_consts
                if isinstance(c, types.CodeType)
                and c.co_name == "_coherence_key")
    cells = {"bbs_lo": jnp.asarray(lo), "bbs_ext": jnp.asarray(ext),
             "dirbins": dirbins}
    return types.FunctionType(
        code, ref_kernel.__dict__, code.co_name, None,
        tuple(types.CellType(cells[name]) for name in code.co_freevars))


@pytest.mark.parametrize("dirbins", [8, 32, 64])
@pytest.mark.parametrize("lanes, offset", [(4097, 0), (4098, 0), (4099, 0),
                                           (4096, 1), (4099, 3)])
def test_key_past_the_quads_and_at_an_offset(lanes, offset, dirbins):
    """The key at R mod 4 = 1, 2, 3 (the kernel's lanes past its last quad
    of four) and on a state viewed from lane 1 or 3 on (arrays not aligned
    for the quads), against the JAX package's ``_coherence_key`` in
    float32, bit for bit: the wrapper takes the views as they are."""
    gen = np.random.default_rng(lanes + offset)
    n = lanes + offset
    lo = np.asarray(LO, np.float32)
    ext = np.asarray(EXT, np.float32)
    frac = gen.uniform(-0.05, 1.05, (n, 3)).astype(np.float32)
    frac[::7] = np.asarray(FRACTIONS, np.float32)[gen.integers(0, 8, (
        len(frac[::7]), 3))]
    org = (lo + frac * ext).astype(np.float32)
    dirn = gen.normal(size=(n, 3)).astype(np.float32)
    dirn /= np.linalg.norm(dirn, axis=1, keepdims=True)
    dirn[::5] = np.asarray(COMPONENTS, np.float32)[gen.integers(0, 8, (
        len(dirn[::5]), 3))]
    alive = gen.random(n) < 0.7
    view = (torch.from_numpy(org)[offset:], torch.from_numpy(dirn)[offset:],
            torch.from_numpy(alive)[offset:])
    assert all(x.is_contiguous() and x.storage_offset() == offset * (
        3 if x.ndim == 2 else 1) for x in view)
    got = P.coherence_key(*view, torch.from_numpy(lo), torch.from_numpy(ext),
                          dirbins)
    want = jax_coherence_key(lo, ext, dirbins)(
        jnp.asarray(org[offset:]), jnp.asarray(dirn[offset:]),
        jnp.asarray(alive[offset:]))
    assert got.shape == (lanes,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _state(n, dtype, seed):
    gen = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(gen.normal(size=shape)).to(dtype)
    return RayState(
        f(n, 3), f(n, 3), f(n), f(n), torch.from_numpy(gen.random(n) < 0.5),
        torch.from_numpy(gen.random(n) < 0.5),
        torch.from_numpy(gen.integers(0, 9, n).astype(np.int32)),
        torch.from_numpy(gen.integers(0, 9, n).astype(np.int32)),
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_take", [1000, 517])
@pytest.mark.parametrize("with_aux", [False, True])
def test_permutation_is_per_array_indexing(dtype, n_take, with_aux):
    """``permute_state_ref`` and the wrapper (on the CPU) against per-array
    indexing bit for bit: every array, the aux rows where given, and a
    ``take`` shorter than R (a compaction keeps the first lanes of its
    order); the outputs contiguous, of the inputs' types."""
    n = 1000
    state = _state(n, dtype, seed=n_take)
    aux = (torch.from_numpy(np.random.default_rng(1).normal(size=(n, 2)))
           .to(dtype) if with_aux else None)
    take = torch.from_numpy(np.random.default_rng(2).permutation(n)[:n_take])
    for fn in (P.permute_state_ref, P.permute_state):
        got, got_aux = fn(take, state, aux)
        for name, x, y in zip(RayState._fields, got, state):
            assert x.dtype == y.dtype and x.is_contiguous(), name
            assert torch.equal(x, y[take]), name
        if with_aux:
            assert torch.equal(got_aux, aux[take])
        else:
            assert got_aux is None


def test_resort_is_a_stable_argsort_and_a_gather():
    """``resort`` gives the lanes of numpy's stable argsort of the
    transcribed key and a gather of every array (the JAX package's
    ``_coherence_perm`` and ``_permute_state``), aux included."""
    n = 3000
    state = _state(n, torch.float32, seed=5)
    org = torch.rand(n, 3, generator=torch.Generator().manual_seed(4)) * 4
    state = state._replace(org=org)
    aux = torch.arange(2 * n, dtype=torch.float32).reshape(n, 2)
    lo = torch.zeros(3)
    ext = torch.full((3,), 4.0)
    got, got_aux = TK.resort(state, aux, lo, ext, 32)
    key = numpy_coherence_key(state.org.numpy(), state.dirn.numpy(),
                              state.alive.numpy(), lo.numpy(), ext.numpy(), 32)
    take = torch.from_numpy(np.argsort(key, kind="stable"))
    for x, y in zip(got, state):
        assert torch.equal(x, y[take])
    assert torch.equal(got_aux, aux[take])


def test_the_wrappers_refuse_what_the_kernels_do_not_take():
    """By name: a non-contiguous array, a wrong type, a take longer than the
    state, an aux of another type."""
    state = _state(64, torch.float32, seed=0)
    take = torch.arange(64)
    with pytest.raises(ValueError, match="dirn must be contiguous"):
        P.permute_state(take, state._replace(
            dirn=torch.zeros(3, 64).t()))
    with pytest.raises(ValueError, match="n_refl"):
        P.permute_state(take, state._replace(
            n_refl=state.n_refl.to(torch.int64)))
    with pytest.raises(ValueError, match="take has 65 lanes"):
        P.permute_state(torch.arange(65), state)
    with pytest.raises(TypeError, match="take must be"):
        P.permute_state(take.to(torch.int32), state)
    with pytest.raises(ValueError, match="aux must be"):
        P.permute_state(take, state, torch.zeros(64, 2, dtype=torch.float64))
    lo, ext = torch.zeros(3), torch.ones(3)
    with pytest.raises(TypeError, match="bb_lo must be"):
        P.coherence_key(state.org, state.dirn, state.alive, lo.double(), ext,
                        32)
    with pytest.raises(ValueError, match="org must be contiguous"):
        P.coherence_key(torch.zeros(3, 64).t(), state.dirn, state.alive, lo,
                        ext, 32)


# ---- (c) the gate, the default and the direction bins ---------------------------
def _chunks(n):
    return types.SimpleNamespace(soa_chunk_bbs=torch.zeros(n, 8))


def test_the_gate_is_the_jax_packages():
    """``resort_for``: at least 4,096 lanes (4,095 do not), at least 8
    chunks (7 do not), not differentiable, and asked for."""
    assert TK.resort_for(4096, _chunks(8), False, True)
    assert not TK.resort_for(4095, _chunks(8), False, True)
    assert not TK.resort_for(4096, _chunks(7), False, True)
    assert TK.resort_for(1 << 20, _chunks(344), False, True)
    assert not TK.resort_for(4096, _chunks(8), True, True)
    assert not TK.resort_for(4096, _chunks(8), False, False)


def test_the_resort_is_off_unless_asked_for():
    """The port's default departs from the JAX package's (``BOUNCE_SORT``,
    whose docstring holds the card's measurement): every entry point that
    takes ``bounce_sort`` defaults to off, and the tracers keep what they
    are given."""
    import inspect

    assert TK.BOUNCE_SORT is False
    for fn in (TK.trace_batch, port_mesh.trace_sharded,
               port_mesh.trace_batch_sharded, vrtt.TraceDisk,
               vrtt.TraceTriangle, vrtt.TraceLine):
        assert inspect.signature(fn).parameters["bounce_sort"].default \
            is False, fn
    assert not vrtt.TraceDisk(device="cpu")._bounce_sort
    assert vrtt.TraceLine(device="cpu", bounce_sort=True)._bounce_sort


def test_the_direction_bins_are_the_jax_packages():
    """``dirbins_for``: "auto" is 32 below 64 chunks and 64 from 64 on; an
    integer (or its string, as the JAX package's knob) is taken as given."""
    assert TK.dirbins_for(63) == 32
    assert TK.dirbins_for(64) == 64
    assert TK.dirbins_for(8, "auto") == 32
    assert TK.dirbins_for(344, 8) == 8
    assert TK.dirbins_for(8, "64") == 64


# ---- (d) the recorded traces keep their path ------------------------------------
@pytest.mark.parametrize("name", F32_DIGEST_TRACES)
def test_the_gate_is_off_for_the_recorded_digests(name, monkeypatch):
    """``tests/torch_parent_f32_digests.json`` was recorded without the
    resort: every trace of it stays below the gate even with the resort
    asked for (so it keeps guarding the path without the resort, and is not
    re-recorded)."""
    gates = []
    real = TK.resort_for

    def spy(R, geometry, differentiable, bounce_sort):
        gates.append(real(R, geometry, differentiable, True))
        return real(R, geometry, differentiable, bounce_sort)

    monkeypatch.setattr(TK, "resort_for", spy)
    f32_digest(name)
    assert gates and not any(gates)


@pytest.mark.parametrize("name", DRAW_TRACES)
def test_the_gate_is_off_for_the_recorded_draws(name):
    """``tests/torch_parent_draws.json``'s traces: their geometries have
    fewer than 8 chunks, so no batch width resorts them, asked or not."""
    tracer = draw_trace(name)
    assert not TK.resort_for(1 << 30, tracer.geometry, False, True)


# ---- (e) the per-seed contract and the sharded trace --------------------------------
def _tracer():
    """``TraceDisk`` on the 8-chunk trench (fused, periodic walls), 4,096 +
    300 rays in batches of 4,096: two batches, both resorted (the resort
    asked for)."""
    pts, nrm = fixtures.create_trench_grid_3d(grid_delta=0.22)
    tracer = vrtt.TraceDisk(dim=3, device="cpu", bounce_sort=True)
    tracer.set_geometry(pts, nrm, 0.22)
    tracer.set_boundary_conditions([vrtt.BoundaryCondition.PERIODIC] * 3)
    tracer.set_particle_type(vrtt.DiffuseParticle(0.1, "flux"))
    tracer.set_number_of_rays_fixed(R + 300)
    tracer.set_ray_batch_size(R)
    tracer.set_rng_seed(5)
    return tracer


def _counting_resorts(monkeypatch):
    """The widths of the batches ``trace_batch`` resorts, call by call."""
    calls = []
    real = TK.resort

    def counted(*args):
        calls.append(args[0].org.shape[0])
        return real(*args)

    monkeypatch.setattr(TK, "resort", counted)
    return calls


@pytest.fixture(scope="module")
def resorted_apply():
    """One apply of ``_tracer()`` with its resorts counted: (tracer, flux,
    TraceInfo, the widths resorted)."""
    with pytest.MonkeyPatch.context() as monkeypatch:
        calls = _counting_resorts(monkeypatch)
        tracer = _tracer()
        flux = tracer.apply()
    return tracer, flux, tracer.get_ray_trace_info(), calls


def test_same_seed_applies_with_the_resort_are_bitwise_equal(resorted_apply):
    """Two fresh tracers of one seed, both resorting before every fused
    launch (at the batch's width and down the ladder to 512), give the same
    flux and counters bit for bit."""
    _, want, info, calls = resorted_apply
    assert set(calls) >= {4096, 512}
    again = _tracer()
    np.testing.assert_array_equal(again.apply(), want)
    info_again = again.get_ray_trace_info()
    assert info_again == dataclasses.replace(info, time=info_again.time)


@pytest.mark.parametrize("shards", [1, 2])
def test_sharded_trace_with_the_resort_is_the_tracer(shards, resorted_apply,
                                                     monkeypatch):
    """``trace_sharded`` on 1 and 2 CPU shards against ``TraceDisk.apply``
    with the resort on: the shards trace the tracer's batches (each resorted
    alike, as many times), so flux and counters are bit for bit the
    tracer's."""
    tracer, want, info, tracer_calls = resorted_apply
    calls = _counting_resorts(monkeypatch)
    geometry = tracer.geometry
    config = tracer._make_config()
    source = vrtt.RandomSource.default(geometry, config, 1.0)
    mesh = port_mesh.make_ray_mesh(["cpu"] * shards)
    flux, counters = port_mesh.trace_sharded(
        geometry, source, vrtt.DiffuseParticle(0.1, "flux"), source.bbox,
        config, vrtt.GeneratorRNG(5 + 1, "cpu"), R + 300, mesh,
        bounce_sort=True)
    assert calls == tracer_calls
    np.testing.assert_array_equal(flux.numpy(), want)
    assert counters.tolist()[:6] == [
        info.total_rays_traced, info.non_geometry_hits, info.geometry_hits,
        info.particle_hits, info.boundary_hits, info.reflections]
