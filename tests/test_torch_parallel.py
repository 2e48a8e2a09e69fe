"""The port's sharded trace (``viennaray_tpu_torch/parallel/mesh.py``) on the
CPU: 8 shards, 1 shard and the single-device tracer bit for bit; the port
against the JAX package's ``trace_sharded`` on its 8-device CPU mesh; the
differentiable leg at 1 and 8 shards. Several processes over gloo:
``test_torch_distributed.py``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import viennaray_tpu as vrt
from viennaray_tpu.parallel import mesh as ref_mesh
from viennaray_tpu.physics.source import RandomSource as RefRandomSource
import viennaray_tpu_torch as vrtt
from viennaray_tpu_torch.io import fixtures
from viennaray_tpu_torch.parallel import mesh as port_mesh

from torch_port_helpers import JaxKeyedRNG, packed_geometries

torch.set_num_threads(1)

INFO_FIELDS = ("total_rays_traced", "non_geometry_hits", "geometry_hits",
               "particle_hits", "boundary_hits", "reflections",
               "chunks_swept", "chunks_deposited", "tile_bounces")


def plane_setup(rays_per_point=50, sticking=1.0):
    """``tests/test_parallel.py:_setup``'s plane on the port: 81 disks at grid
    delta 0.5, diffuse particle, reflective walls, seed 5, batches of
    2,048."""
    pts, nrm = fixtures.create_plane_grid(0.5, 2.0, (0, 1, 2))
    geometry = vrtt.DiskGeometry.build(pts, nrm, 0.5, dim=3, device="cpu")
    particle = vrtt.DiffuseParticle(sticking, "flux")
    config = vrtt.TraceConfig(
        dim=3, num_rays_per_point=rays_per_point, rng_seed=5,
        use_random_seed=False, ray_batch_size=2048,
        boundary_conditions=(vrtt.BoundaryCondition.REFLECTIVE,) * 3)
    source = vrtt.RandomSource.default(geometry, config,
                                       particle.cosine_exponent)
    return geometry, source, particle, source.bbox, config, pts, nrm


@pytest.mark.parametrize("accumulate_f64", [True, False])
def test_eight_shards_one_shard_and_the_tracer_agree_bit_for_bit(
        accumulate_f64):
    """Flux and counters of an 8-shard ``["cpu"] * 8`` mesh, a 1-shard mesh
    and ``TraceDisk.apply`` (whose first apply draws under seed 5 + 1) on
    4,050 rays in batches of 2,048: the same batches summed in the same
    order, so bit for bit, in float64 and in float32 accumulation."""
    geometry, source, particle, bbox, config, pts, nrm = plane_setup()
    total = config.total_rays(geometry.num_primitives)
    runs = {}
    for n in (8, 1):
        mesh = port_mesh.make_ray_mesh(["cpu"] * n)
        assert mesh.size == n and mesh.group is None
        runs[n] = port_mesh.trace_sharded(
            geometry, source, particle, bbox, config,
            vrtt.GeneratorRNG(6, "cpu"), total, mesh,
            accumulate_f64=accumulate_f64)
    tracer = vrtt.TraceDisk(dim=3, device="cpu")
    tracer.set_geometry(pts, nrm, 0.5)
    tracer.set_boundary_conditions([vrtt.BoundaryCondition.REFLECTIVE] * 3)
    tracer.set_particle_type(particle)
    tracer.set_number_of_rays_per_point(50)
    tracer.set_ray_batch_size(2048)
    tracer.set_rng_seed(5)
    tracer.set_f64_accumulation(accumulate_f64)
    want = tracer.apply()
    info = tracer.get_ray_trace_info()
    dtype = torch.float64 if accumulate_f64 else torch.float32
    for n, (flux, counters) in runs.items():
        assert flux.dtype == dtype
        np.testing.assert_array_equal(flux.double().numpy(), want)
        assert counters.tolist() == [getattr(info, f) for f in INFO_FIELDS]
    assert want.sum() > 0.99 * total  # sticking 1 on a plane: nearly all land


def test_a_mega_batch_shard_is_the_tracers_batch():
    """``trace_batch_sharded``'s shard g of a mega-batch starting at global
    sub-batch 3 is ``trace_batch``'s batch 3 + g: two shards of 2,048 rays
    against batches 3 and 4 of ``trace_batch`` summed in float64."""
    from viennaray_tpu_torch.trace.kernel import trace_batch

    geometry, source, particle, bbox, config, _, _ = plane_setup()
    rng = vrtt.GeneratorRNG(11, "cpu")
    idx = torch.arange(6144, 6144 + 4096)
    valid = idx < 6144 + 4000
    mesh = port_mesh.make_ray_mesh(["cpu", "cpu"])
    flux, counters = port_mesh.trace_batch_sharded(
        geometry, source, particle, bbox, rng, idx, valid, config, mesh,
        sub_batch_start=3)
    want = torch.zeros(geometry.num_primitives, dtype=torch.float64)
    totals = np.zeros(9, np.int64)
    for g in (3, 4):
        rng.begin_batch(g)
        part = slice((g - 3) * 2048, (g - 2) * 2048)
        f, c = trace_batch(geometry, source, particle, bbox, rng, g,
                           idx[part], valid[part], config)
        want += f.double()
        totals += np.asarray(c, np.int64)
    np.testing.assert_array_equal(flux.numpy(), want.numpy())
    assert counters.tolist() == totals.tolist()


def test_port_agrees_with_the_jax_packages_sharded_trace(monkeypatch):
    """The port's ``trace_sharded`` on an 8-shard CPU mesh with the JAX
    package's own numbers (``JaxKeyedRNG``: shard g draws fold_in(base, g),
    the reference's shard key) against the JAX package's ``trace_sharded``
    on its 8-device CPU mesh, on the same packed tables (the 777-disk
    trench, periodic walls), 8 shards of 1,024 rays, both unfused bodies.
    Tolerances of the lane-matched unfused tests
    (``test_torch_trace.py:test_trace_batch_lane_matched_with_reference``):
    counters within 0.2 %, flux rel-L2 < 1e-3, at most two bins off by more
    than 1e-5 of the largest (measured: counters equal, rel-L2 3.3e-8, no
    bin off). The sums differ in type (the JAX package adds float32 shard
    fluxes; the port adds them into float64), which moves the flux by
    rounding only."""
    monkeypatch.setenv("VIENNARAY_TPU_FUSED", "0")
    monkeypatch.delenv("VIENNARAY_TPU_FUSED_INTERPRET", raising=False)
    assert len(jax.devices()) == 8
    ref_geo, geo, bbox, _ = packed_geometries("disk")
    per_shard, seed = 1024, 77
    common = dict(dim=3, num_rays_fixed=8 * per_shard, rng_seed=seed,
                  use_random_seed=False, ray_batch_size=per_shard)
    ref_config = vrt.TraceConfig(
        boundary_conditions=(vrt.BoundaryCondition.PERIODIC,) * 3, **common)
    config = vrtt.TraceConfig(
        boundary_conditions=(vrtt.BoundaryCondition.PERIODIC,) * 3, **common)
    axes = dict(ray_dir=2, first_dir=0, second_dir=1, min_max=1,
                pos_neg=-1.0, dim=3)
    ref_source = RefRandomSource(bbox=jax.numpy.asarray(bbox),
                                 cosine_power=jax.numpy.float32(1.0), **axes)
    source = vrtt.RandomSource(bbox=torch.from_numpy(bbox), cosine_power=1.0,
                               **axes)
    key = jax.random.PRNGKey(seed)
    ref_flux, ref_totals = ref_mesh.trace_sharded(
        ref_geo, ref_source, vrt.DiffuseParticle(0.1, "flux"),
        jax.numpy.asarray(bbox), ref_config, "disk", key, 8 * per_shard,
        ref_mesh.make_ray_mesh())
    flux, totals = port_mesh.trace_sharded(
        geo, source, vrtt.DiffuseParticle(0.1, "flux"),
        torch.from_numpy(bbox), config, JaxKeyedRNG(key), 8 * per_shard,
        port_mesh.make_ray_mesh(["cpu"] * 8), fused=False)
    ref_flux = np.asarray(ref_flux, np.float64)
    flux = flux.numpy()
    for i in (0, 1, 2, 4):  # traces, exits, geometry hits, wall hits
        want = int(ref_totals[i])
        assert want > 800, i
        assert abs(int(totals[i]) - want) <= 0.002 * want, (i, totals, want)
    rel = np.linalg.norm(flux - ref_flux) / np.linalg.norm(ref_flux)
    assert rel < 1e-3, rel
    off = np.abs(flux - ref_flux) > 1e-5 * np.abs(ref_flux).max()
    assert off.sum() <= 2


def test_differentiable_leg_one_shard_equals_eight():
    """``__graft_entry__.py:dryrun_multichip``'s first leg on the port: loss
    = sum(flux^2) over a sharded ``differentiable=True, num_bounces=4``
    trace of the 777-disk trench (periodic walls, sticking 0.1, roulette
    off), 8 sub-batches of 256 rays. Loss, flux and d loss / d sticking are
    finite, and 8 shards give the 1-shard values bit for bit: both sum the
    same sub-batches' fluxes and gradients in global sub-batch order."""
    _, geo, bbox, _ = packed_geometries("disk")
    config = vrtt.TraceConfig(
        dim=3, boundary_conditions=(vrtt.BoundaryCondition.PERIODIC,) * 3,
        ray_batch_size=256, roulette=False)
    source = vrtt.RandomSource(bbox=torch.from_numpy(bbox), cosine_power=1.0)
    out = {}
    for n in (8, 1):
        sticking = torch.tensor(0.1, requires_grad=True)
        particle = vrtt.DiffuseParticle(0.1).replace(sticking=sticking)
        flux, counters = port_mesh.trace_sharded(
            geo, source, particle, torch.from_numpy(bbox), config,
            vrtt.GeneratorRNG(3, "cpu"), 8 * 256,
            port_mesh.make_ray_mesh(["cpu"] * n), differentiable=True,
            num_bounces=4)
        loss = (flux * flux).sum()
        loss.backward()
        out[n] = (loss.item(), flux.detach().numpy(), sticking.grad.item(),
                  counters.tolist())
    loss, flux, grad, counters = out[8]
    assert np.isfinite(loss) and np.isfinite(flux).all() and np.isfinite(grad)
    assert flux.sum() > 0 and grad < 0
    assert out[8][0] == out[1][0] and out[8][2] == out[1][2]
    np.testing.assert_array_equal(out[8][1], out[1][1])
    assert out[8][3] == out[1][3]


def test_mesh_entry_points_refuse_what_they_cannot_do():
    """Without a card: the default mesh and a CUDA process group raise, and
    several processes without a rendezvous address are refused; a process's
    shards lie on one device; a mesh's shard count must divide the
    mega-batch."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusals of a machine without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_mesh.make_ray_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        port_mesh.initialize_distributed("cuda")
    with pytest.raises(ValueError, match="init_method"):
        port_mesh.initialize_distributed("cpu", rank=0, world_size=2)
    for device_type in ("cpu", "cuda"):
        with pytest.raises(ValueError, match="no backend is chosen"):
            port_mesh.initialize_distributed(device_type, backend="gloo")
    with pytest.raises(ValueError, match="one device"):
        port_mesh.make_ray_mesh(["cpu", "meta"])
    geometry, source, particle, bbox, config, _, _ = plane_setup()
    with pytest.raises(ValueError, match="shards"):
        port_mesh.trace_batch_sharded(
            geometry, source, particle, bbox, vrtt.GeneratorRNG(1, "cpu"),
            torch.arange(1000), torch.ones(1000, dtype=torch.bool), config,
            port_mesh.make_ray_mesh(["cpu"] * 3))


def test_a_mesh_runs_over_its_own_backend_only():
    """In a gloo group (one process) a CPU mesh forms and a CUDA mesh is
    refused: CUDA shards reduce over NCCL and never over gloo."""
    port_mesh.initialize_distributed("cpu")
    try:
        assert torch.distributed.get_backend() == "gloo"
        mesh = port_mesh.make_ray_mesh(["cpu"] * 2)
        assert mesh.size == 2 and mesh.group is not None
        with pytest.raises(ValueError, match="nccl"):
            port_mesh.make_ray_mesh(["cuda:0"] * 2)
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("entry", ["trace_sharded", "differentiable",
                                   "grad_batched"])
def test_a_geometry_without_neighbor_records_gathers_them_once(
        entry, monkeypatch):
    """A geometry built with ``pack_neighbors=False`` through the sharded
    trace (8 shards, 2 mega-batches; the fused body, and the differentiable
    leg) and through ``diff.flux_and_grad_sticking_batched`` (4 batches):
    the records are gathered once for the whole run, not by every shard's or
    batch's ``trace_batch``, and flux, counters and gradient equal the
    packed geometry's bit for bit."""
    from viennaray_tpu_torch import diff
    from viennaray_tpu_torch.geometry.disk_geometry import DiskGeometry

    geometry, source, particle, bbox, config, pts, nrm = plane_setup(
        rays_per_point=20, sticking=0.2)
    config = dataclasses.replace(config, ray_batch_size=256, roulette=False)
    bare = DiskGeometry.build(pts, nrm, 0.5, dim=3, device="cpu",
                              pack_neighbors=False)
    gathers = []
    gather = DiskGeometry.with_neighbor_pack

    def counted(self):
        if self.neighbor_pack is None:
            gathers.append(1)
        return gather(self)

    monkeypatch.setattr(DiskGeometry, "with_neighbor_pack", counted)

    def run(geo):
        sticking = torch.tensor(0.2, requires_grad=True)
        rng = vrtt.GeneratorRNG(4, "cpu")
        if entry == "grad_batched":
            flux, grad = diff.flux_and_grad_sticking_batched(
                geo, source, particle, bbox, rng, 4 * 256, config,
                num_bounces=4, device="cpu")
            return flux, grad, None
        flux, counters = port_mesh.trace_sharded(
            geo, source, particle.replace(sticking=sticking), bbox, config,
            rng, 2 * 8 * 256, port_mesh.make_ray_mesh(["cpu"] * 8),
            differentiable=entry == "differentiable", num_bounces=4)
        if entry == "differentiable":
            flux.sum().backward()
            return flux.detach().numpy(), sticking.grad.item(), counters
        return flux.numpy(), None, counters

    want = run(geometry)
    assert not gathers
    got = run(bare)
    assert len(gathers) == 1
    np.testing.assert_array_equal(got[0], want[0])
    assert np.asarray(want[0]).sum() > 0
    assert got[1] == want[1]
    if got[2] is not None:
        np.testing.assert_array_equal(got[2], want[2])
