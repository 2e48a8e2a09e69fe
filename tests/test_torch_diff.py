"""The port's differentiable trace and gradient drivers against the JAX
package's ``diff/trace_grad.py``, lane by lane on the CPU.

Both packages trace the same tables (in packed order, where the reference's
CPU tie rule and the port's coincide) with the same uniforms
(``JaxKeyedRNG``); the differentiable trace never sorts or compacts, so the
lanes stay matched through every bounce. On the CPU the JAX package searches
by brute force and differentiates through it; the port searches with its
kernels' plain versions on detached rays and recomputes the hit time.

Tolerances (measured values in each test): flux rel-L2 < 2e-3 with at most
two bins off by more than 1e-5 of the largest, gradients within 1e-3
relative (a scalar) or rel-L2 < 2e-3 (an array). XLA:CPU contracts its dot
products differently from eager PyTorch, so a last-bit difference in a hit
point can flip a disk's rim test: under the window model one ray of 2,048
does (two bins off, by at most 0.118 of 23), elsewhere none does. The port's own central differences are held to
``tests/test_diff.py``'s bounds (rtol 5e-3, a point 0.01).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viennaray_tpu_torch as vrtt
from viennaray_tpu_torch import rng as rng_mod
from viennaray_tpu_torch.diff import trace_grad
from viennaray_tpu_torch.ops import histogram
from viennaray_tpu_torch.trace import kernel as trace_kernel
from viennaray_tpu_torch.trace import tracer as tracer_mod

from torch_port_helpers import (
    JaxKeyedRNG,
    diff_setups,
    port_trace_flux,
    reference_trace_flux,
)

torch.set_num_threads(1)

R = 2048
BOUNCES = 8


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _assert_flux_matched(flux, ref_flux):
    assert _rel_l2(flux, ref_flux) < 2e-3
    off = np.abs(flux - ref_flux) > 1e-5 * np.abs(ref_flux).max()
    assert off.sum() <= 2


def _materials(geometry_points):
    """Two materials: the left half 0, the right half 1 (test_diff.py)."""
    return (np.asarray(geometry_points)[:, 0] > 0).astype(np.int32)


# ---- the histogram kernel's gradient --------------------------------------
def test_histogram_gradient_is_the_gather_and_never_silently_zero():
    """The deposit's weights get grad_out[ids[e]]: bit for bit the gather,
    non-zero, through ``FluxHistogramFn`` (a call on raw pointers with no
    autograd node would return a flux without a graph, whose gradient comes
    back missing or zero)."""
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, 300, 5000).astype(np.int32))
    w = torch.from_numpy(rng.random(5000).astype(np.float32))
    w[::3] = 0.0
    grad_out = torch.from_numpy(rng.normal(size=300).astype(np.float32))
    leaf = w.clone().requires_grad_(True)
    flux = histogram.flux_histogram(ids, leaf, 300)
    assert flux.grad_fn is not None
    assert torch.equal(flux.detach(), histogram.flux_histogram(ids, w, 300))
    (flux * grad_out).sum().backward()
    assert leaf.grad is not None and bool((leaf.grad != 0).all())
    assert torch.equal(leaf.grad, grad_out[ids.long()])
    assert torch.equal(histogram.flux_histogram_grad(grad_out, ids),
                       histogram.flux_histogram_grad_ref(grad_out, ids))
    # the one-block path, forced, carries the same gradient
    leaf.grad = None
    (histogram.flux_histogram(ids, leaf, 300, path="small")
     * grad_out).sum().backward()
    assert torch.equal(leaf.grad, grad_out[ids.long()])
    with pytest.raises(TypeError):
        histogram.flux_histogram_grad(grad_out, ids.long())
    with pytest.raises(ValueError):
        histogram.flux_histogram_grad(grad_out[:, None], ids)


# ---- lane-matched against the JAX package ---------------------------------
@pytest.mark.parametrize("geo_kind", ["disk2d", "disk", "triangle", "line"])
def test_flux_and_sticking_gradient_lane_matched(geo_kind):
    """``flux_and_grad_sticking`` against the JAX package's value and
    gradient of sum(trace_flux) on the same lanes: 2,048 rays, 8 bounces,
    sticking 0.3; ``tests/test_diff.py:_setup``'s 2D trench (reflective
    walls) and the packed 3D disks, triangles and lines (periodic).
    Measured: flux rel-L2 at most 2.6e-7 (lines), gradient within 1.4e-7
    (triangles)."""
    ref, port = diff_setups(geo_kind)
    base = jax.random.PRNGKey(11)
    key = jax.random.fold_in(base, 0)

    def total(s):
        flux = reference_trace_flux(
            ref, key, R, BOUNCES, particle=ref["particle"].replace(sticking=s))
        return jnp.sum(flux), flux

    (_, ref_flux), ref_grad = jax.value_and_grad(total, has_aux=True)(
        jnp.float32(0.3))
    flux, grad = trace_grad.flux_and_grad_sticking(
        port["geometry"], port["source"], port["particle"], port["bbox"],
        JaxKeyedRNG(base), torch.arange(R), torch.ones(R, dtype=torch.bool),
        port["config"], port["geo_type"], num_bounces=BOUNCES, device="cpu",
    )
    _assert_flux_matched(flux.numpy(), np.asarray(ref_flux))
    assert grad.shape == () and float(grad) < 0
    np.testing.assert_allclose(float(grad), float(ref_grad), rtol=1e-3)


def test_material_table_gradient_lane_matched_and_finite_differences():
    """d sum(flux) / d material_sticking through the per-material gather:
    against the JAX package's on the same lanes (measured within 3.3e-7
    relative), and against the port's own central differences (rtol 5e-3,
    test_diff.py:109; measured 2.4e-5)."""
    ref, port = diff_setups("disk2d")
    mats = _materials(port["geometry"].points)
    ref_geo = ref["geometry"].replace(material_ids=jnp.asarray(mats))
    geo = port["geometry"].replace(material_ids=torch.from_numpy(mats))
    base = jax.random.PRNGKey(11)
    table0 = np.array([0.2, 0.5], np.float32)

    def ref_total(table):
        return jnp.sum(reference_trace_flux(
            ref, jax.random.fold_in(base, 0), R, BOUNCES, geometry=ref_geo,
            particle=ref["particle"].replace(material_sticking=table)))

    ref_grad = np.asarray(jax.grad(ref_total)(jnp.asarray(table0)))

    def total(table):
        return port_trace_flux(
            port, JaxKeyedRNG(base), R, BOUNCES, geometry=geo,
            particle=port["particle"].replace(material_sticking=table)).sum()

    leaf = torch.tensor(table0, requires_grad=True)
    (grad,) = torch.autograd.grad(total(leaf), leaf)
    grad = grad.numpy()
    np.testing.assert_allclose(grad, ref_grad, rtol=1e-3)
    eps = 3e-3
    for m in range(2):
        e = torch.zeros(2)
        e[m] = eps
        with torch.no_grad():
            fd = (float(total(torch.from_numpy(table0) + e))
                  - float(total(torch.from_numpy(table0) - e))) / (2 * eps)
        assert grad[m] < 0
        np.testing.assert_allclose(grad[m], fd, rtol=5e-3)


def _interior_point(points):
    """The trench-bottom point at x = 0.1. test_diff.py:128-133 takes the
    one at x = 0, on the trench's mirror axis, where the gradient under
    these loss weights nearly cancels (5.7e-6, against 20.8 and -34.7 at
    x = -0.1 and 0.1: the reference's values on these lanes)."""
    pts = np.asarray(points)
    bottom = np.abs(pts[:, 1] - pts[:, 1].min()) < 1e-6
    return int(np.where(bottom & (np.abs(pts[:, 0] - 0.1) < 1e-3))[0][0])


def test_point_gradient_wdist_lane_matched_and_finite_differences():
    """d loss / d one interior point's x under 1/distance weighting
    (test_diff.py:112-155: loss = dot(lw, flux), 4 bounces, key 7): against
    the JAX package's gradient on the same lanes (measured 8.8e-7 relative)
    and the port's own central differences at eps 3e-3 (rtol 0.01; measured
    8.2e-4)."""
    ref, port = diff_setups("disk2d", use_wdist=True)
    pi = _interior_point(port["geometry"].points)
    n = port["geometry"].num_primitives
    lw = np.random.default_rng(3).random(n).astype(np.float32)
    base = jax.random.PRNGKey(7)

    def ref_loss(du):
        g = ref["geometry"].replace(
            points=ref["geometry"].points.at[pi, 0].add(du))
        return jnp.sum(reference_trace_flux(
            ref, jax.random.fold_in(base, 0), R, 4, geometry=g) * lw)

    ref_grad = float(jax.grad(ref_loss)(jnp.float32(0.0)))
    onehot = torch.zeros((n, 3))
    onehot[pi, 0] = 1.0

    def loss(du):
        g = port["geometry"].replace(points=port["geometry"].points
                                     + du * onehot)
        return torch.dot(torch.from_numpy(lw), port_trace_flux(
            port, JaxKeyedRNG(base), R, 4, geometry=g))

    du = torch.zeros((), requires_grad=True)
    (grad,) = torch.autograd.grad(loss(du), du)
    grad = float(grad)
    assert np.isfinite(grad) and grad != 0.0
    np.testing.assert_allclose(grad, ref_grad, rtol=1e-3)
    eps = 3e-3
    with torch.no_grad():
        fd = (float(loss(torch.tensor(eps)))
              - float(loss(torch.tensor(-eps)))) / (2 * eps)
    np.testing.assert_allclose(grad, fd, rtol=0.01)


@pytest.mark.parametrize("field", ["points", "normals"])
def test_geometry_gradient_drivers_lane_matched(field):
    """``flux_and_grad_points_batched`` / ``flux_and_grad_normals_batched``
    against the JAX package's drivers: the packed 3D disks under 1/distance
    weighting, 2,048 rays in two batches of 1,024 (batch b under
    ``rng.begin_batch(b)`` = the reference's fold_in(key, b)), 4 bounces,
    loss weights from numpy seed 3, in float32. Measured: flux rel-L2
    6.2e-7, gradient rel-L2 4.1e-4 (points) and 1.7e-4 (normals): the
    1/distance weights' gradient sums many lanes in another order."""
    from viennaray_tpu.diff import trace_grad as ref_grad_mod

    ref, port = diff_setups("disk", use_wdist=True, ray_batch_size=1024)
    n = port["geometry"].num_primitives
    lw = np.random.default_rng(3).random(n).astype(np.float32)
    base = jax.random.PRNGKey(7)
    name = f"flux_and_grad_{field}_batched"
    ref_flux, ref_g = getattr(ref_grad_mod, name)(
        ref["geometry"], ref["source"], ref["particle"], ref["bbox"], base, R,
        ref["config"], "disk", num_bounces=4, loss_weights=jnp.asarray(lw))
    flux, g = getattr(trace_grad, name)(
        port["geometry"], port["source"], port["particle"], port["bbox"],
        JaxKeyedRNG(base), R, port["config"], "disk", num_bounces=4,
        loss_weights=lw, device="cpu")
    assert flux.dtype == g.dtype == np.float64 and g.shape == (n, 3)
    _assert_flux_matched(flux, np.asarray(ref_flux))
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    assert _rel_l2(g, np.asarray(ref_g, np.float64)) < 2e-3


def test_window_model_retests_the_moved_points():
    """Under the window flux model the differentiable trace re-tests the hit
    disk's window list on the geometry's own points (the JAX package's
    window deposit reads them), not on the packed records: with one trench
    disk moved 0.05 along its normal the flux matches the JAX package's on
    the same lanes (measured rel-L2 6.9e-4: one ray's window test flips at
    a rim, two bins)."""
    ref, port = diff_setups("disk", flux_model="window")
    pts = np.asarray(port["geometry"].points).copy()
    nrm = np.asarray(port["geometry"].normals)
    pi = int(np.argmin(pts[:, 2]))
    pts[pi] += 0.05 * nrm[pi]
    base = jax.random.PRNGKey(5)
    ref_flux = reference_trace_flux(
        ref, jax.random.fold_in(base, 0), R, BOUNCES,
        geometry=ref["geometry"].replace(points=jnp.asarray(pts)))
    flux = port_trace_flux(
        port, JaxKeyedRNG(base), R, BOUNCES,
        geometry=port["geometry"].replace(points=torch.from_numpy(pts)))
    _assert_flux_matched(flux.numpy(), np.asarray(ref_flux))


# ---- the port on its own --------------------------------------------------
@pytest.mark.parametrize("geo_kind", ["disk2d", "disk", "triangle", "line"])
def test_sticking_gradient_matches_central_differences(geo_kind):
    """Under a shared RNG the paths do not depend on the sticking, so
    sum(flux) is a polynomial in it and the gradient equals central
    differences up to float32 noise (rtol 5e-3, test_diff.py:78)."""
    _, port = diff_setups(geo_kind)
    rng = rng_mod.GeneratorRNG(11, "cpu")

    def total(s):
        return port_trace_flux(
            port, rng, R, BOUNCES,
            particle=port["particle"].replace(sticking=s)).sum()

    leaf = torch.tensor(0.3, requires_grad=True)
    (grad,) = torch.autograd.grad(total(leaf), leaf)
    eps = 3e-3
    with torch.no_grad():
        fd = (float(total(torch.tensor(0.3 + eps)))
              - float(total(torch.tensor(0.3 - eps)))) / (2 * eps)
    assert float(grad) < 0
    np.testing.assert_allclose(float(grad), fd, rtol=5e-3)


def test_differentiable_flux_equals_the_unfused_trace():
    """With roulette off and enough bounces the differentiable trace's flux
    is the unfused trace's (test_diff.py:158-190): 512 rays, where the
    unfused trace neither sorts nor compacts, sticking 0.9, 64 bounces,
    rtol 1e-6 (measured: equal)."""
    _, port = diff_setups("disk2d", sticking=0.9, num_rays_fixed=512,
                          ray_batch_size=512)
    n = 512
    ray_indices = torch.arange(n)
    valid = torch.ones(n, dtype=torch.bool)
    rng = rng_mod.GeneratorRNG(4, "cpu")
    rng.begin_batch(0)
    unfused, _ = trace_kernel.trace_batch(
        port["geometry"], port["source"], port["particle"], port["bbox"], rng,
        0, ray_indices, valid, port["config"], fused=False)
    flux = port_trace_flux(port, rng_mod.GeneratorRNG(4, "cpu"), n, 64)
    np.testing.assert_allclose(flux.detach().numpy(), unfused.numpy(),
                               rtol=1e-6)


class _Recording(rng_mod.GeneratorRNG):
    """A ``GeneratorRNG`` that notes each batch's uniforms by stream."""

    def __init__(self, seed, device):
        super().__init__(seed, device)
        self.log = []

    def uniform(self, stream, batch_index, bounce, n):
        u = super().uniform(stream, batch_index, bounce, n)
        self.log.append((batch_index, stream, bounce, u.clone()))
        return u


def test_batched_drivers_add_up_their_batches_and_draw_the_tracers():
    """The batched drivers sum their batches' flux and gradient (float64 on
    the host, equal to separate calls of each batch), and batch b draws
    what the tracer's batch b draws from the same seed: the source and the
    first bounce's reflection (the tracer's roulette draws come after)."""
    _, port = diff_setups("disk2d", ray_batch_size=1024)
    args = (port["geometry"], port["source"], port["particle"], port["bbox"])
    flux, grad = trace_grad.flux_and_grad_sticking_batched(
        *args, _Recording(5, "cpu"), R, port["config"], num_bounces=4,
        device="cpu")
    assert flux.dtype == np.float64 and flux.shape == (180,)
    flux_sum, grad_sum = np.zeros(180), 0.0
    for b in range(2):
        f, g = trace_grad.flux_and_grad_sticking(
            *args, rng_mod.GeneratorRNG(5, "cpu"),
            torch.arange(b * 1024, (b + 1) * 1024),
            torch.ones(1024, dtype=torch.bool), port["config"],
            num_bounces=4, batch_index=b, device="cpu")
        flux_sum += f.double().numpy()
        grad_sum += float(g)
    np.testing.assert_array_equal(flux, flux_sum)
    assert grad == grad_sum

    batched_rng = _Recording(5, "cpu")
    trace_grad.flux_and_grad_points_batched(
        *args, batched_rng, R, port["config"], num_bounces=4, device="cpu")
    traced = []

    def recording(seed, device):
        rng = _Recording(seed, device)
        traced.append(rng)
        return rng

    pts = port["geometry"].points.numpy()
    tracer = vrtt.TraceDisk(dim=2, device="cpu", fused=False)
    tracer.set_geometry(pts, port["geometry"].normals.numpy(), 0.1)
    tracer.set_boundary_conditions([vrtt.BoundaryCondition.REFLECTIVE] * 3)
    tracer.set_source_direction(vrtt.TraceDirection.POS_Y)
    tracer.set_particle_type(port["particle"])
    tracer.set_number_of_rays_fixed(R)
    tracer.set_ray_batch_size(1024)
    tracer.set_rng_seed(4)  # its first apply seeds 4 + run number 1
    saved = tracer_mod.GeneratorRNG
    tracer_mod.GeneratorRNG = recording
    try:
        tracer.apply()
    finally:
        tracer_mod.GeneratorRNG = saved

    def first_draws(log, b):
        return [(s, k, u) for batch, s, k, u in log
                if batch == b and (s.startswith("source")
                                   or (k == 0 and s.startswith("reflect")))]

    for b in range(2):
        mine = first_draws(batched_rng.log, b)
        theirs = first_draws(traced[0].log, b)
        assert [x[:2] for x in mine] == [x[:2] for x in theirs]
        assert len(mine) == 5  # in 2D: one origin draw, two each else
        assert all(torch.equal(a[2], c[2]) for a, c in zip(mine, theirs))


def test_refusals_by_name_and_the_device():
    """The hooks are refused by name in the differentiable mode (the JAX
    package's trace_flux takes none); the drivers run on the CUDA device
    unless ``device="cpu"`` is given, and raise without one; a geometry on
    another device or of another kind than ``geo_type`` is refused."""
    _, port = diff_setups("disk", num_rays_fixed=64, ray_batch_size=64)
    args = (port["geometry"], port["source"], port["particle"], port["bbox"])
    rng = rng_mod.GeneratorRNG(1, "cpu")
    rng.begin_batch(0)
    def hook(*args):
        raise AssertionError("a refused hook ran")

    for name in ("collision_fn", "reflection_fn", "aux_init_fn",
                 "init_dir_fn", "log_fn"):
        with pytest.raises(NotImplementedError, match=name):
            trace_kernel.trace_batch(
                *args, rng, 0, torch.arange(64),
                torch.ones(64, dtype=torch.bool), port["config"],
                differentiable=True, **{name: hook})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            trace_grad.flux_and_grad_sticking_batched(
                *args, rng, 64, port["config"])
    with pytest.raises(ValueError, match="triangle"):
        trace_grad.flux_and_grad_sticking_batched(
            *args, rng, 64, port["config"], geo_type="triangle",
            device="cpu")
    with pytest.raises(ValueError, match="cpu"):
        trace_grad.flux_and_grad_sticking_batched(
            *args, rng, 64, port["config"], device="meta")
