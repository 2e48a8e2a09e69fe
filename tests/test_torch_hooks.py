"""A custom particle's hooks in the port against the JAX package's, lane by
lane: one mega-batch through both packages' unfused bodies on the same tables
under the reference's uniforms (``lane_matched_batch``, ``JaxKeyedRNG``,
whose hook streams are keyed as the reference keys its hooks). Each JAX hook
below draws with its key exactly what the port's draws with its ``rng``
handle.

On the CPU the port's wrappers run their plain versions; the CUDA kernels
are held to their plain versions on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viennaray_tpu as vrt
from viennaray_tpu.physics import reflection as ref_reflection
from viennaray_tpu.trace import kernel as ref_kernel

import viennaray_tpu_torch as vrtt
from viennaray_tpu_torch.ops.histogram import flux_histogram
from viennaray_tpu_torch.physics import reflection

from torch_port_helpers import lane_matched_batch

torch.set_num_threads(1)

UNFUSED = ref_kernel.EnvKnobs(fused=False)
LABELS = ("ionFlux", "energyFlux")


def _rel_l2(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


def _counters_equal(cnt, ref_cnt, least=300):
    for name in ("total_traces", "geometry_hits", "boundary_hits",
                 "non_geometry_hits"):
        assert getattr(cnt, name) == int(getattr(ref_cnt, name)) > least, name


def _deposit(flux, ids, w):
    """The port's spelling of ``flux.at[ids].add(w)``: the histogram kernel."""
    return flux + flux_histogram(ids.reshape(-1).contiguous(),
                                 w.reshape(-1).contiguous(), flux.shape[-1])


# ---- the hooks, in both packages ----------------------------------------------
def ref_two_channels(flux, ids, w, dirn, normal, mat, key):
    """Channel 0 the weight, channel 1 the weight times the incidence cosine
    (examples/multi_channel.py)."""
    cosi = jnp.abs(jnp.sum(dirn * normal, axis=1, keepdims=True))
    f0 = flux[0].at[ids.reshape(-1)].add(w.reshape(-1))
    f1 = flux[1].at[ids.reshape(-1)].add((w * cosi).reshape(-1))
    return jnp.stack([f0, f1])


def two_channels(flux, ids, w, dirn, normal, mat, rng):
    cosi = (dirn * normal).sum(dim=1, keepdim=True).abs()
    return torch.stack([_deposit(flux[0], ids, w),
                        _deposit(flux[1], ids, w * cosi)])


def ref_aux_init(key, ray_indices):
    return 50.0 + 100.0 * jax.random.uniform(key, (ray_indices.shape[0], 1))


def aux_init(rng, ray_indices):
    return 50.0 + 100.0 * rng.uniform((ray_indices.shape[0], 1))


def ref_energy_collision(flux, ids, w, dirn, normal, mat, key, aux):
    return flux.at[ids.reshape(-1)].add((w * aux[:, 0:1]).reshape(-1))


def energy_collision(flux, ids, w, dirn, normal, mat, rng, aux):
    return _deposit(flux, ids, w * aux[:, 0:1])


def ref_lossy_reflection(key, dirn, normal, prim, mat, weight, aux):
    """Sticking drawn per lane from the key, the built-in diffuse
    reflection under the same key, 30 % of the energy lost."""
    u = jax.random.uniform(key, dirn.shape[:1])
    return 0.1 + 0.3 * u, ref_reflection.diffuse(key, normal, 3), aux * 0.7


def lossy_reflection(rng, dirn, normal, prim, mat, weight, aux):
    u = rng.uniform(dirn.shape[:1])
    u1, u2 = rng.reflect_uniforms
    return 0.1 + 0.3 * u, reflection.diffuse(u1, u2, normal, 3), aux * 0.7


# ---- disks ----------------------------------------------------------------------
def test_two_channel_collision_fn_lane_matched():
    """A collision_fn filling two labelled channels, (R, K + 1) ids and
    weights: every counter equal, each channel within rel-L2 1e-5 of the
    reference's (float32 sums in another order; measured 7.7e-8 and
    8.5e-8)."""
    particle = vrtt.DiffuseParticle(0.2).replace(data_labels=LABELS)
    flux, cnt, ref_flux, ref_cnt = lane_matched_batch(
        vrt.DiffuseParticle(0.2).replace(data_labels=LABELS), particle,
        UNFUSED, ref_hooks=dict(collision_fn=ref_two_channels),
        collision_fn=two_channels,
    )
    assert flux.shape == ref_flux.shape == (2, 777)
    _counters_equal(cnt, ref_cnt)
    for c in range(2):
        assert _rel_l2(flux[c], ref_flux[c]) < 1e-5, c
    assert 0.3 < flux[1].sum() / flux[0].sum() < 1.0


def test_stateful_hooks_lane_matched():
    """aux_init_fn and reflection_fn drawing from their handles, the aux
    carried through the source sort and every compaction of a 4,096-ray
    ladder, energy-weighted deposits: every counter equal and the flux within
    rel-L2 1e-5 (measured 8.6e-8). A lane whose aux row stayed behind in a
    permutation would deposit another ray's energy."""
    hooks = dict(collision_fn=energy_collision, reflection_fn=lossy_reflection,
                 aux_init_fn=aux_init)
    ref_hooks = dict(collision_fn=ref_energy_collision,
                     reflection_fn=ref_lossy_reflection,
                     aux_init_fn=ref_aux_init)
    flux, cnt, ref_flux, ref_cnt = lane_matched_batch(
        vrt.DiffuseParticle(0.2), vrtt.DiffuseParticle(0.2), UNFUSED,
        ref_hooks=ref_hooks, **hooks,
    )
    _counters_equal(cnt, ref_cnt)
    assert _rel_l2(flux, ref_flux) < 1e-5
    # energy-weighted (50 to 150 at the source, 30 % lost a bounce), on the
    # hit disk and its neighbor-list disks the ray crosses
    assert 20.0 < flux.sum() / cnt.geometry_hits < 1000.0


def _tilted(u, ray_indices, xp):
    """Every third ray keeps the source's direction (a zero row); the others
    lean by the draws."""
    tilt = xp.stack([u[:, 0] - 0.5, u[:, 1] - 0.5, -1.0 - u[:, 2]], 1)
    keep = (ray_indices % 3 == 0)[:, None]
    return xp.where(keep, xp.zeros_like(tilt), tilt)


def test_init_dir_fn_and_log_fn_lane_matched():
    """init_dir_fn and log_fn (with an aux_init_fn whose energies the log
    histograms, and a draw of the log's own): every counter equal, flux
    within rel-L2 1e-5, the histograms equal and the log's draw equal."""
    n_bins = 8

    def ref_init_dir(key, ray_indices):
        return _tilted(jax.random.uniform(key, (ray_indices.shape[0], 3)),
                       ray_indices, jnp)

    def init_dir(rng, ray_indices):
        return _tilted(rng.uniform((ray_indices.shape[0], 3)), ray_indices,
                       torch)

    def ref_log(key, aux, ray_indices, valid):
        bins = jnp.clip((aux[:, 0] / 200.0 * n_bins).astype(jnp.int32), 0,
                        n_bins - 1)
        hist = jnp.sum(jax.nn.one_hot(bins, n_bins) * valid[:, None], axis=0)
        return [hist, jnp.sum(jax.random.uniform(key, (4,)))[None]]

    def log_fn(rng, aux, ray_indices, valid):
        bins = torch.clamp((aux[:, 0] / 200.0 * n_bins).to(torch.int32), 0,
                           n_bins - 1)
        hist = torch.bincount(bins[valid].long(), minlength=n_bins)
        return [hist, rng.uniform(4).sum()[None]]

    out = lane_matched_batch(
        vrt.DiffuseParticle(0.2), vrtt.DiffuseParticle(0.2), UNFUSED,
        ref_hooks=dict(init_dir_fn=ref_init_dir, aux_init_fn=ref_aux_init,
                       log_fn=ref_log),
        init_dir_fn=init_dir, aux_init_fn=aux_init, log_fn=log_fn,
    )
    flux, cnt, ref_flux, ref_cnt, logs, ref_logs = out
    _counters_equal(cnt, ref_cnt)
    assert _rel_l2(flux, ref_flux) < 1e-5
    np.testing.assert_array_equal(logs[0].numpy(), np.asarray(ref_logs[0]))
    assert logs[0].sum() == 4096
    np.testing.assert_allclose(logs[1].numpy(), np.asarray(ref_logs[1]),
                               rtol=1e-6)


# ---- triangles and lines: (R, 1) ids -----------------------------------------------
@pytest.mark.parametrize("geo_kind", ["triangle", "line"])
def test_single_hit_kinds_lane_matched(geo_kind):
    """The two-channel collision_fn and the stateful reflection on triangles
    and lines, where ids and weights are (R, 1): counters within 0.2 % and
    each channel within rel-L2 1e-2, at most 10 bins off by more than 1e-5
    of the largest (a ray on a shared edge or node may fall to the
    neighbouring primitive, the port dividing where the reference multiplies
    by a reciprocal, and moves one deposit: the bound of the unhooked
    triangle batch, ``tests/test_torch_triangle.py``). Measured on this seed:
    every counter equal, rel-L2 2e-8 to 1.2e-7."""
    dim = 3 if geo_kind == "triangle" else 2
    shapes = []

    def ref_refl(key, dirn, normal, prim, mat, weight):
        u = jax.random.uniform(key, dirn.shape[:1])
        return 0.1 + 0.3 * u, ref_reflection.diffuse(key, normal, dim)

    def refl(rng, dirn, normal, prim, mat, weight):
        u = rng.uniform(dirn.shape[:1])
        return 0.1 + 0.3 * u, reflection.diffuse(*rng.reflect_uniforms,
                                                 normal, dim)

    def collide(flux, ids, w, *rest):
        shapes.append((tuple(ids.shape), tuple(w.shape)))
        return two_channels(flux, ids, w, *rest)

    particle = vrtt.DiffuseParticle(0.2).replace(data_labels=LABELS)
    flux, cnt, ref_flux, ref_cnt = lane_matched_batch(
        vrt.DiffuseParticle(0.2).replace(data_labels=LABELS), particle,
        UNFUSED, geo_kind=geo_kind, R=2048,
        ref_hooks=dict(collision_fn=ref_two_channels, reflection_fn=ref_refl),
        collision_fn=collide, reflection_fn=refl,
    )
    assert shapes[0][0] == (2048, 1)
    assert all(ids[1] == 1 and w == ids for ids, w in shapes)
    for name in ("total_traces", "geometry_hits", "boundary_hits",
                 "non_geometry_hits"):
        want = int(getattr(ref_cnt, name))
        assert want > 100, name
        assert abs(getattr(cnt, name) - want) <= 0.002 * want, name
    for c in range(2):
        assert _rel_l2(flux[c], ref_flux[c]) < 1e-2, c
        off = np.abs(flux[c] - ref_flux[c]) > 1e-5 * np.abs(ref_flux[c]).max()
        assert off.sum() <= 10, off.sum()
