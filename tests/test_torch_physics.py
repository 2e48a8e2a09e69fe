"""The port's source, reflection and neighbor re-test against the JAX
package's, fed the same uniforms (drawn with ``jax.random`` under the
reference's key schedule) or the same numpy-seeded rays.

Tolerance 1e-6 absolute: the arithmetic is the same, but XLA:CPU and eager
PyTorch evaluate ``sin``/``cos``/``pow`` with different last-bit rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viennaray_tpu.ops import intersect as ref_intersect
from viennaray_tpu.ops import vec as ref_vec
from viennaray_tpu.physics import reflection as ref_reflection
from viennaray_tpu.physics import source as ref_source

from viennaray_tpu_torch import rng as streams
from viennaray_tpu_torch.ops import intersect, vec
from viennaray_tpu_torch.physics import reflection
from viennaray_tpu_torch.physics.source import RandomSource

from torch_port_helpers import JaxKeyedRNG, port_geometry, reference_geometry

torch.set_num_threads(1)

BBOX = np.array([[-5.0, -4.0, -4.0], [5.0, 4.0, 0.9]], np.float32)
ATOL = 1e-6


def _source_pair(cosine_power, primary_direction=None):
    basis_ref = basis_port = None
    if primary_direction is not None:
        d = np.asarray(primary_direction, np.float32)
        d = d / np.linalg.norm(d)
        basis_ref = ref_vec.orthonormal_basis(jnp.asarray(d))
        basis_port = vec.orthonormal_basis(torch.from_numpy(d))
        np.testing.assert_allclose(
            basis_port.numpy(), np.asarray(basis_ref), atol=ATOL
        )
    ref = ref_source.RandomSource(
        bbox=jnp.asarray(BBOX), cosine_power=jnp.float32(cosine_power),
        basis=basis_ref, ray_dir=2, first_dir=0, second_dir=1, min_max=1,
        pos_neg=-1.0, dim=3,
    )
    port = RandomSource(
        bbox=torch.from_numpy(BBOX), cosine_power=float(cosine_power),
        basis=basis_port, ray_dir=2, first_dir=0, second_dir=1, min_max=1,
        pos_neg=-1.0, dim=3,
    )
    return ref, port


@pytest.mark.parametrize(
    "cosine_power,primary_direction",
    [(1.0, None), (2.0, None), (1.0, (0.6, 0.1, -1.0))],
    ids=["cosine", "power2", "tilted"],
)
def test_random_source_matches_reference(cosine_power, primary_direction):
    n, batch = 2048, 3
    ref, port = _source_pair(cosine_power, primary_direction)
    base_key = jax.random.PRNGKey(17)
    rng = JaxKeyedRNG(base_key, tilted=primary_direction is not None)
    rng.begin_batch(batch)
    k_src = jax.random.fold_in(jax.random.fold_in(base_key, batch), 0x5EED)
    want_o, want_d, want_w = ref.sample(k_src, jnp.arange(n))
    org, dirn, w = port.sample(rng, batch, n)
    np.testing.assert_allclose(org.numpy(), np.asarray(want_o), atol=ATOL)
    np.testing.assert_allclose(dirn.numpy(), np.asarray(want_d), atol=ATOL)
    np.testing.assert_array_equal(w.numpy(), np.asarray(want_w))
    assert float(port.source_area()) == float(ref.source_area())
    assert (dirn[:, 2] <= 0).all()


def test_diffuse_and_specular_reflection_match_reference():
    n = 4096
    rng_np = np.random.default_rng(5)
    normal = rng_np.normal(size=(n, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    ray_dir = rng_np.normal(size=(n, 3)).astype(np.float32)
    ray_dir /= np.linalg.norm(ray_dir, axis=1, keepdims=True)
    key = jax.random.PRNGKey(99)
    k1, k2 = jax.random.split(key)
    u1 = torch.from_numpy(np.array(jax.random.uniform(k1, (n,))))
    u2 = torch.from_numpy(np.array(jax.random.uniform(k2, (n,))))
    for dim in (3, 2):
        want = ref_reflection.diffuse(key, jnp.asarray(normal), dim)
        got = reflection.diffuse(u1, u2, torch.from_numpy(normal), dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        want = ref_reflection.specular(
            jnp.asarray(ray_dir), jnp.asarray(normal), dim
        )
        got = reflection.specular(
            torch.from_numpy(ray_dir), torch.from_numpy(normal), dim
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_check_neighbors_packed_matches_reference():
    _, _, _, ref_geo = reference_geometry("trench_0.5")
    geo = port_geometry(ref_geo)
    n = 2048
    rng_np = np.random.default_rng(8)
    prim = rng_np.integers(0, geo.num_primitives, n)
    pts = np.asarray(ref_geo.points)
    # rays aimed near their disk, from its front side, so many neighbors hit
    target = pts[prim] + rng_np.normal(scale=0.3, size=(n, 3)).astype(np.float32)
    org = (target + np.asarray(ref_geo.normals)[prim] * 1.5
           + rng_np.normal(scale=0.5, size=(n, 3))).astype(np.float32)
    d = target - org
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    k = geo.neighbors.shape[1]
    rec_ref = ref_geo.neighbor_pack[prim].reshape(n, k, 8)
    want_ok, want_dist = ref_intersect.check_neighbors_packed(
        jnp.asarray(org), jnp.asarray(d), rec_ref
    )
    rec = geo.neighbor_pack[torch.from_numpy(prim)].reshape(n, k, 8)
    ok, dist = intersect.check_neighbors_packed(
        torch.from_numpy(org), torch.from_numpy(d), rec
    )
    want_ok = np.asarray(want_ok)
    assert want_ok.sum() > n  # the re-test fires often on these rays
    # a hit exactly on a rim may flip with the last bit of dist
    assert (ok.numpy() != want_ok).mean() <= 1e-4
    both = ok.numpy() & want_ok
    np.testing.assert_allclose(
        dist.numpy()[both], np.asarray(want_dist)[both], rtol=1e-5, atol=ATOL
    )


def test_generator_rng_is_keyed_by_seed_and_batch():
    a = streams.GeneratorRNG(7, "cpu")
    b = streams.GeneratorRNG(7, "cpu")
    a.begin_batch(2)
    first = a.uniform(streams.ROULETTE, 2, 0, 64)
    a.begin_batch(0)  # another batch in between changes nothing
    a.uniform(streams.ROULETTE, 0, 0, 64)
    b.begin_batch(2)
    again = b.uniform(streams.ROULETTE, 2, 0, 64)
    assert torch.equal(first, again)
    assert first.dtype == torch.float32
    assert 0.0 <= float(first.min()) and float(first.max()) < 1.0
    c = streams.GeneratorRNG(8, "cpu")
    c.begin_batch(2)
    assert not torch.equal(first, c.uniform(streams.ROULETTE, 2, 0, 64))
    with pytest.raises(RuntimeError):
        b.uniform(streams.ROULETTE, 5, 0, 64)  # batch 5 was never begun
    with pytest.raises(ValueError):
        b.uniform("no_such_stream", 2, 0, 64)
