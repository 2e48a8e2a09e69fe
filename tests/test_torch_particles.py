"""The particle physics of the port against the JAX package's, at small sizes
on the CPU: per-material sticking, the coned-cosine reflection and gas
scattering, from their host code and samplers through one bounce (kernel 4's
branches, against the megakernel in interpret mode) and one mega-batch to
whole runs against the scalar oracle.

On the CPU the port's wrappers run their plain versions; the CUDA kernel is
held to its plain version on the card by ``chip_smoke.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viennaray_tpu as vrt
from viennaray_tpu.geometry.line_geometry import LineGeometry as RefLineGeometry
from viennaray_tpu.ops import sampling as ref_sampling
from viennaray_tpu.ops import vec as ref_vec
from viennaray_tpu.physics import reflection as ref_reflection
from viennaray_tpu.trace import kernel as ref_kernel
from viennaray_tpu.utils import materials as ref_materials

import viennaray_tpu_torch as vrtt
from viennaray_tpu_torch import rng as streams
from viennaray_tpu_torch.config import adjust_bounding_box
from viennaray_tpu_torch.geometry.disk_geometry import DiskGeometry
from viennaray_tpu_torch.geometry.line_geometry import LineGeometry
from viennaray_tpu_torch.geometry.triangle_geometry import TriangleGeometry
from viennaray_tpu_torch.io import fixtures
from viennaray_tpu_torch.ops import bounce, sampling, vec
from viennaray_tpu_torch.physics import reflection
from viennaray_tpu_torch.physics.source import RandomSource
from viennaray_tpu_torch.rng import GeneratorRNG
from viennaray_tpu_torch.trace.kernel import hand_out_for, trace_batch
from viennaray_tpu_torch.utils import materials

import oracle_ref
from torch_port_helpers import (
    JaxKeyedRNG,
    check_state_and_counts,
    make_settings,
    make_state,
    oracle_available,
    port_geometry,
    port_line_geometry,
    port_state,
    reference_bounce,
    reference_geometry,
)

torch.set_num_threads(1)

DIFFUSE = vrtt.ReflectionKind.DIFFUSE
SPECULAR = vrtt.ReflectionKind.SPECULAR
CONED = vrtt.ReflectionKind.CONED_COSINE
PERIODIC = vrtt.BoundaryCondition.PERIODIC
REFLECTIVE = vrtt.BoundaryCondition.REFLECTIVE
CONE = float(np.pi / 6)


def _rel_l2(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


def _gas(particle, mean_free_path):
    return dataclasses.replace(particle, mean_free_path=mean_free_path)


# ---- materials and particles (host code) -------------------------------------
def test_material_utilities_equal_reference():
    ids = np.array([7, 7, 3, 42, 3, 7, -1, 42])
    dense, mapping = materials.remap_material_ids(ids)
    dense_w, mapping_w = ref_materials.remap_material_ids(ids)
    np.testing.assert_array_equal(dense, dense_w)
    assert dense.dtype == dense_w.dtype == np.int32 and mapping == mapping_w
    assert mapping == {7: 0, 3: 1, 42: 2, -1: 3}
    sticking_map = {7: 0.5, 42: 0.1}
    table = materials.sticking_table_from_map(mapping, sticking_map, 0.9)
    table_w = ref_materials.sticking_table_from_map(mapping_w, sticking_map, 0.9)
    np.testing.assert_array_equal(table, table_w)
    np.testing.assert_array_equal(table, np.float32([0.5, 0.9, 0.1, 0.9]))


def test_particles_carry_the_reference_fields():
    ref = vrt.ConedCosineParticle(0.5, CONE, 100.0, "ions")
    got = vrtt.ConedCosineParticle(0.5, CONE, 100.0, "ions")
    assert got.reflection_kind == ref.reflection_kind == int(CONED)
    assert got.data_labels == ref.data_labels and got.name == ref.name
    np.testing.assert_allclose(
        [got.sticking, got.cosine_exponent, got.cone_angle],
        [float(ref.sticking), float(ref.cosine_exponent), float(ref.cone_angle)],
        rtol=1e-7,
    )
    assert got.mean_free_path == ref.mean_free_path == -1.0
    assert _gas(got, 2.5).mean_free_path == 2.5
    # the settings of a bounce: the cone is clipped as the reference's fused
    # path clips it, and gas scattering widens the uniforms
    config = vrtt.TraceConfig(dim=3)
    for angle, want in ((CONE, CONE), (0.0, 1e-6), (-1.0, 1e-6),
                        (2.0, np.pi / 2 - 1e-6)):
        s = bounce.BounceSettings.from_config(
            config, vrtt.ConedCosineParticle(0.5, angle)
        )
        assert s.cone_angle == want and s.refl_kind == int(CONED)
        assert s.n_uni == 3 and s.mean_free_path == -1.0
    s = bounce.BounceSettings.from_config(
        config, _gas(vrtt.DiffuseParticle(0.1), 4.0)
    )
    assert s.n_uni == 6 and s.mean_free_path == 4.0


def test_sticking_for_and_the_per_lane_table_match_reference():
    """``sticking_for`` on tensors against the reference's, and the table in
    sorted lane order against the reference's fused path
    (trace/kernel.py:1005-1014)."""
    table = [0.5, 0.1, 0.9]
    ids = np.array([0, 2, 1, 1, -3, 0, 2], np.int32)
    ref = vrt.DiffuseParticle(0.3, material_sticking=table)
    got = vrtt.DiffuseParticle(0.3, material_sticking=table)
    out = got.sticking_for(torch.from_numpy(ids))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(ref.sticking_for(jnp.asarray(ids)))
    )
    scalar = vrtt.DiffuseParticle(0.3).sticking_for(torch.from_numpy(ids))
    np.testing.assert_array_equal(scalar.numpy(), np.full(7, 0.3, np.float32))

    _, _, _, ref_geo = reference_geometry("trench_0.5")
    n = ref_geo.num_primitives
    mat = (np.arange(n) % 3).astype(np.int32)
    ref_geo = ref_geo.replace(material_ids=jnp.asarray(mat))
    geo = port_geometry(ref_geo)
    want = np.asarray(
        ref.sticking_for(ref_geo.material_ids)[ref_geo.soa_perm]
    ).astype(np.float32)
    lanes = bounce.sticking_lanes(got, geo)
    assert lanes.shape == (geo.prims_soa.shape[1],) and lanes.is_contiguous()
    np.testing.assert_array_equal(lanes.numpy(), want)
    assert bounce.sticking_lanes(vrtt.DiffuseParticle(0.3), geo) is None


# ---- samplers and the coned-cosine reflection ----------------------------------
def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def test_frisvad_basis_matches_reference():
    rng = np.random.default_rng(0)
    w = _unit(rng, 512)
    w[:3] = [[0, 0, -1], [1e-4, 0, -1], [0, 0, 1]]
    w[1] /= np.linalg.norm(w[1])
    t, b = vec.frisvad_basis(torch.from_numpy(w))
    t_w, b_w = ref_vec.frisvad_basis(jnp.asarray(w))
    np.testing.assert_allclose(t.numpy(), np.asarray(t_w), atol=1e-6)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_w), atol=1e-6)
    np.testing.assert_array_equal(t[0].numpy(), [0, -1, 0])  # the pole
    np.testing.assert_array_equal(b[0].numpy(), [-1, 0, 0])
    wt = torch.from_numpy(w)
    for a, c in ((t, b), (t, wt), (b, wt)):
        assert vec.dot(a, c).abs().max() < 2e-3  # a = 1 / (1 + wz) near -1
    np.testing.assert_allclose(vec.norm(t).numpy()[3:], 1.0, atol=1e-3)


@pytest.mark.parametrize("shape", [(4096,), (1024, 4)])
def test_cone_theta_from_reference_keys_matches_reference(shape):
    """Fed the reference's own uniforms round by round, the port's sampler
    gives the reference's thetas: equal on at least 99.9 % of lanes within
    1e-6 (a last bit of cos or sin can move one acceptance). ``JaxKeyedRNG``
    hands the trace the reference's thetas themselves."""
    key = jax.random.PRNGKey(5)

    def draw(i):
        k1, k2 = jax.random.split(jax.random.fold_in(key, i))
        return tuple(
            torch.from_numpy(np.array(jax.random.uniform(k, shape, dtype=np.float32)))
            for k in (k1, k2)
        )

    got = sampling.coned_cosine_theta(draw, shape, CONE, "cpu").numpy()
    want = np.asarray(ref_sampling.coned_cosine_theta(
        key, shape, jnp.float32(CONE), dtype=jnp.float32
    ))
    assert got.shape == want.shape == shape and got.dtype == np.float32
    assert (np.abs(got - want) <= 1e-6).mean() >= 0.999
    assert 0.0 <= got.min() and got.max() <= np.float32(CONE)

    rng = JaxKeyedRNG(jax.random.PRNGKey(9))
    rng.begin_batch(3)
    key_b = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(9), 3), 8)
    if len(shape) == 1:
        k_theta = jax.random.split(jax.random.split(key_b, 4)[2], 3)[0]
    else:
        k_theta = jax.random.fold_in(key_b, 0x7E7A)
    np.testing.assert_array_equal(
        rng.cone_theta(3, 7, shape, CONE).numpy(),
        np.asarray(ref_sampling.coned_cosine_theta(
            k_theta, shape, jnp.float32(CONE), dtype=jnp.float32)),
    )


@pytest.mark.parametrize("angle", [CONE, 1.2])
def test_generator_cone_theta_follows_the_lobe_density(angle):
    """The default generator's thetas against the lobe's density
    p(theta) ~ cos(pi theta / (2 A)) sin(theta) on [0, A] (what the
    accept-reject of rayReflection.hpp:86-94 samples): 20 bins, 200,000
    draws, every bin within 5 standard deviations of its expectation."""
    rng = GeneratorRNG(4, "cpu")
    rng.begin_batch(0)
    n = 200_000
    theta = rng.cone_theta(0, 0, (n,), angle).numpy()
    assert theta.dtype == np.float32 and theta.min() >= 0 and theta.max() <= angle
    edges = np.linspace(0.0, angle, 21)
    fine = np.linspace(0.0, angle, 20 * 500 + 1)
    dens = np.cos(np.pi * fine / (2 * angle)) * np.sin(fine)
    cum = np.concatenate([[0], np.cumsum(0.5 * (dens[1:] + dens[:-1]))])
    expect = np.diff(cum[::500]) / cum[-1] * n
    counts, _ = np.histogram(theta, bins=edges)
    assert (np.abs(counts - expect) <= 5 * np.sqrt(expect) + 5).all()
    # the same seed and batch give the same thetas, (n, n_sub) blocks too
    rng.begin_batch(0)
    np.testing.assert_array_equal(rng.cone_theta(0, 0, (n,), angle).numpy(), theta)
    assert rng.cone_theta(0, 1, (256, 4), angle).shape == (256, 4)


@pytest.mark.parametrize("dim", [3, 2])
def test_coned_cosine_reflection_matches_reference(dim):
    """The reference draws theta and phi from its key; the port takes them
    from the caller. With the reference's own numbers the directions agree
    within 1e-5; they are unit vectors that leave the surface."""
    rng = np.random.default_rng(1)
    n = 4096
    normal = _unit(rng, n)
    ray_dir = _unit(rng, n)
    if dim == 2:
        normal[:, 2] = 0
        normal /= np.linalg.norm(normal, axis=1, keepdims=True)
        ray_dir[:, 2] = 0
        ray_dir /= np.linalg.norm(ray_dir, axis=1, keepdims=True)
    facing = (ray_dir * normal).sum(axis=1) < 0
    ray_dir[~facing] *= -1  # every ray comes in from the front
    key = jax.random.PRNGKey(2)
    want = np.asarray(ref_reflection.coned_cosine(
        key, jnp.asarray(ray_dir), jnp.asarray(normal), jnp.float32(CONE), dim
    ))
    k_theta, k_phi, _ = jax.random.split(key, 3)
    theta = np.asarray(ref_sampling.coned_cosine_theta(
        k_theta, (n,), jnp.float32(CONE), dtype=jnp.float32))
    u_phi = np.asarray(jax.random.uniform(k_phi, (n,), dtype=np.float32))
    got = reflection.coned_cosine(
        torch.from_numpy(theta.copy()), torch.from_numpy(u_phi.copy()),
        torch.from_numpy(ray_dir), torch.from_numpy(normal), dim,
    ).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    assert ((got * normal).sum(axis=1) >= -1e-6).all()
    if dim == 2:
        assert not got[:, 2].any()
    else:
        # within the cone around the mirror direction, unless mirrored back
        mirror = ray_dir - 2 * (ray_dir * normal).sum(1, keepdims=True) * normal
        inside = (got * mirror).sum(axis=1) >= np.cos(CONE) - 1e-5
        assert inside.mean() > 0.9


# ---- one bounce against the megakernel ---------------------------------------
@pytest.fixture(scope="module")
def disks():
    """The 800-disk trench with three materials in both packages."""
    _, _, _, ref_geo = reference_geometry("trench_0.5")
    mat = (np.arange(ref_geo.num_primitives) % 3).astype(np.int32)
    ref_geo = ref_geo.replace(material_ids=jnp.asarray(mat)).with_areas(
        (0, 1), [vrt.BoundaryCondition.PERIODIC] * 3
    )
    geo = port_geometry(ref_geo)
    bbox = adjust_bounding_box(
        np.asarray(ref_geo.bbox), vrtt.TraceDirection.POS_Z,
        ref_geo.disk_radius, 3,
    ).astype(np.float32)
    return ref_geo, geo, bbox


@pytest.fixture(scope="module")
def lines():
    """The 72-segment 2D trench with two materials in both packages."""
    nodes, segs = fixtures.create_trench_line_mesh(0.25)
    ids = np.zeros(len(segs), np.int32)
    ids[len(ids) // 2:] = 1
    ref_geo = RefLineGeometry.from_mesh(
        vrt.LineMesh(nodes=nodes, lines=segs, grid_delta=0.25),
        material_ids=ids,
    )
    bbox = adjust_bounding_box(
        np.asarray(ref_geo.bbox), vrtt.TraceDirection.POS_Y, 0.25, 2,
    ).astype(np.float32)
    return ref_geo, port_line_geometry(ref_geo), bbox


def _one_launch(fixture, geo_kind, settings, n_sub, hand_out, seed,
                particle=None, theta_max=None):
    """One launch of the port and of the megakernel on one seeded state."""
    ref_geo, geo, bbox = fixture
    walls = bounce.make_walls(torch.from_numpy(bbox), geo, settings)
    arrays = make_state(bbox, 1024, n_sub, seed=seed, n_uni=settings.n_uni,
                        dim=settings.dim, theta_max=theta_max)
    stick = None if particle is None else bounce.sticking_lanes(particle, geo)
    res = bounce.fused_bounce(
        port_state(arrays), torch.from_numpy(arrays[8]), geo, walls, settings,
        n_sub=n_sub, deposit_in_kernel=not hand_out, stick_lanes=stick,
    )
    ref = reference_bounce(
        ref_geo, walls, arrays, settings, n_sub, hand_out, geo_kind=geo_kind,
        stick_lanes=None if stick is None else stick.numpy(),
    )
    return res, ref, arrays, bbox


@pytest.mark.parametrize("geo_kind", ["disk", "line"])
def test_per_material_bounce_matches_reference_kernel(geo_kind, disks, lines):
    """Against the megakernel with ``per_mat=True``: the hit primitive's
    material decides the weight a ray keeps; the bounds of
    ``check_state_and_counts``."""
    fixture = disks if geo_kind == "disk" else lines
    dim = 3 if geo_kind == "disk" else 2
    particle = vrtt.DiffuseParticle(0.3, material_sticking=[0.5, 0.1, 0.9])
    settings = make_settings(DIFFUSE, PERIODIC, dim=dim)
    res, ref, arrays, _ = _one_launch(
        fixture, geo_kind, settings, 1, True, 21, particle=particle
    )
    check_state_and_counts(res, ref, arrays[0])
    # the weights a colliding ray can keep: w (1 - s) for its material's s,
    # or the roulette's renewal
    geo = fixture[1]
    hit = res.hit_prim >= 0
    assert hit.sum() > 200
    s_hit = particle.sticking_for(geo.material_ids)[res.hit_prim[hit].long()]
    w_in = torch.from_numpy(arrays[2])[hit]
    kept = w_in - w_in * s_hit
    w_out = res.state.weight[hit]
    assert ((w_out == kept) | (w_out == 0.3)).all()
    assert len(torch.unique(s_hit)) >= 2


@pytest.mark.parametrize("geo_kind,n_sub", [("disk", 1), ("disk", 4),
                                            ("line", 1), ("line", 4)])
def test_coned_bounce_matches_reference_kernel(geo_kind, n_sub, disks, lines):
    """Against the megakernel with the coned-cosine reflection, in 3D on
    disks and in 2D on lines; column 0 of a sub-bounce's uniforms is theta
    on both sides."""
    fixture = disks if geo_kind == "disk" else lines
    dim = 3 if geo_kind == "disk" else 2
    settings = make_settings(CONED, PERIODIC, dim=dim, cone_angle=CONE)
    hand_out = n_sub == 1
    res, ref, arrays, bbox = _one_launch(
        fixture, geo_kind, settings, n_sub, hand_out, 22, theta_max=CONE
    )
    flight = None if n_sub == 1 else n_sub * np.linalg.norm(bbox[1] - bbox[0])
    check_state_and_counts(res, ref, arrays[0], flight=flight)
    assert res.counts[0] > 300
    if dim == 2:
        assert not res.state.dirn[:, 2].any()
    if not hand_out:
        assert _rel_l2(res.flux.numpy(), ref["flux"]) < 2e-2


@pytest.mark.parametrize("geo_kind,n_sub", [("disk", 1), ("disk", 4),
                                            ("line", 1), ("line", 4)])
def test_gas_scattering_bounce_matches_reference_kernel(geo_kind, n_sub,
                                                        disks, lines):
    """Against the megakernel with ``mfp > 0`` (six uniforms a sub-bounce):
    the scatter count with the other counts, and the scattered lanes' new
    origin and direction with the state."""
    fixture = disks if geo_kind == "disk" else lines
    dim = 3 if geo_kind == "disk" else 2
    settings = make_settings(DIFFUSE, PERIODIC, dim=dim, mean_free_path=2.0)
    assert settings.n_uni == 6
    hand_out = n_sub == 1
    res, ref, arrays, bbox = _one_launch(
        fixture, geo_kind, settings, n_sub, hand_out, 23
    )
    flight = None if n_sub == 1 else n_sub * np.linalg.norm(bbox[1] - bbox[0])
    check_state_and_counts(res, ref, arrays[0], flight=flight)
    scatter = int(res.counts[bounce.COUNT_NAMES.index("scatter")])
    assert scatter > 100
    if n_sub == 1:
        # what a scattering lane does, lane by lane: it moves by its draw
        # along its old direction and keeps weight and counters
        org, dirn = torch.from_numpy(arrays[0]), torch.from_numpy(arrays[1])
        u_scat = torch.from_numpy(arrays[8])[:, 3]
        moved = (res.state.org == org + dirn * u_scat[:, None]).all(dim=1)
        moved &= torch.from_numpy(arrays[4])  # alive on entry
        assert int(moved.sum()) == scatter
        assert torch.equal(res.state.weight[moved],
                           torch.from_numpy(arrays[2])[moved])
        assert torch.equal(res.state.n_refl[moved],
                           torch.from_numpy(arrays[6])[moved])
        assert res.state.alive[moved].all()
        assert (res.hit_prim[moved] == -1).all()
        np.testing.assert_allclose(
            vec.norm(res.state.dirn[moved]).numpy(), 1.0, atol=1e-6
        )
        if dim == 2:
            assert not res.state.dirn[moved][:, 2].any()


def test_bounce_wrapper_checks_the_new_arguments(disks):
    _, geo, bbox = disks
    settings = make_settings(DIFFUSE, PERIODIC, mean_free_path=2.0)
    walls = bounce.make_walls(torch.from_numpy(bbox), geo, settings)
    arrays = make_state(bbox, 64, 1, seed=3, n_uni=6)
    state, uniforms = port_state(arrays), torch.from_numpy(arrays[8])
    with pytest.raises(ValueError, match="uniforms"):  # 3 columns, 6 wanted
        bounce.fused_bounce(state, uniforms[:, :3].contiguous(), geo, walls,
                            settings)
    with pytest.raises(ValueError, match="stick_lanes"):
        bounce.fused_bounce(state, uniforms, geo, walls, settings,
                            stick_lanes=torch.zeros(7))
    with pytest.raises(ValueError):  # no such reflection model
        bounce.fused_bounce(state, uniforms, geo, walls,
                            settings._replace(refl_kind=5))
    res = bounce.fused_bounce(state, uniforms, geo, walls, settings)
    assert res.counts.shape == (len(bounce.COUNT_NAMES),)
    # only a diffuse launch of one bounce on disks hands its deposits out
    assert hand_out_for("disk", 6, DIFFUSE, 1)
    assert not hand_out_for("disk", 6, CONED, 1)
    assert not hand_out_for("disk", 6, SPECULAR, 1)


# ---- one mega-batch ------------------------------------------------------------
def _batch_setup(kind):
    """Geometry, adjusted box, source and config of a 4,096-ray batch on a
    small trench of ``kind``, on the CPU."""
    if kind == "line":
        nodes, segs = fixtures.create_trench_line_mesh(0.1)
        ids = np.zeros(len(segs), np.int32)
        ids[len(ids) // 2:] = 1
        geo = LineGeometry.from_mesh(
            vrtt.LineMesh(nodes, segs, grid_delta=0.1), material_ids=ids,
            device="cpu",
        )
        dim, direction, margin = 2, vrtt.TraceDirection.POS_Y, geo.grid_delta
        axes = dict(ray_dir=1, first_dir=0, second_dir=2)
    else:
        dim, direction = 3, vrtt.TraceDirection.POS_Z
        axes = dict(ray_dir=2, first_dir=0, second_dir=1)
        if kind == "disk":
            pts, nrm = fixtures.create_trench_grid_3d(grid_delta=0.5)
            geo = DiskGeometry.build(pts, nrm, 0.5, device="cpu")
            geo = geo.replace(material_ids=(
                torch.arange(len(pts)) % 2).to(torch.int32))
            margin = geo.disk_radius
        else:
            geo = TriangleGeometry.build(
                *fixtures.create_trench_mesh_3d(grid_delta=0.5), 0.5,
                device="cpu",
            )
            margin = geo.grid_delta
    bbox = torch.from_numpy(adjust_bounding_box(
        geo.bbox.numpy(), direction, margin, dim).astype(np.float32))
    config = vrtt.TraceConfig(
        dim=dim, boundary_conditions=(PERIODIC,) * 3, ray_batch_size=4096,
        source_direction=direction,
    )
    source = RandomSource(bbox=bbox, cosine_power=1.0, min_max=1,
                          pos_neg=-1.0, dim=dim, **axes)
    return geo, bbox, source, config


PARTICLES = {
    "coned": lambda: vrtt.ConedCosineParticle(0.3, CONE),
    "gas": lambda: _gas(vrtt.DiffuseParticle(0.2), 3.0),
    "per_material": lambda: vrtt.DiffuseParticle(
        0.2, material_sticking=[0.5, 0.1]),
    "coned_gas_per_material": lambda: _gas(dataclasses.replace(
        vrtt.ConedCosineParticle(0.3, CONE), material_sticking=(0.5, 0.1)),
        3.0),
}


@pytest.mark.parametrize("kind,particle", [
    ("disk", "coned"), ("disk", "gas"), ("disk", "per_material"),
    ("disk", "coned_gas_per_material"), ("triangle", "coned"),
    ("triangle", "gas"), ("line", "coned"), ("line", "gas"),
])
def test_fused_equals_unfused_with_one_bounce_per_launch(kind, particle):
    """With n_sub = (1, 1, 1) and ``GeneratorRNG`` both bodies draw the same
    numbers in the same order (theta's rejection rounds included) and go
    through one step function and the exact histogram: on the CPU the
    counters are equal and the flux is bitwise equal, for every new branch
    on every geometry kind."""
    geo, bbox, source, config = _batch_setup(kind)
    R = 4096
    runs = []
    for kwargs in (dict(fused=False), dict(fused=True, n_sub=(1, 1, 1))):
        rng = GeneratorRNG(33, "cpu")
        rng.begin_batch(0)
        runs.append(trace_batch(
            geo, source, PARTICLES[particle](), bbox, rng, 0, torch.arange(R),
            torch.ones(R, dtype=torch.bool), config, **kwargs,
        ))
    (flux_u, cnt_u), (flux_f, cnt_f) = runs
    assert cnt_u == cnt_f and cnt_u.geometry_hits > 2000
    assert torch.equal(flux_u, flux_f) and flux_u.sum() > 1000
    assert (cnt_u.particle_hits > 500) == ("gas" in particle)


def _lane_matched(particle_name, ref_knobs, max_bounces=3000, **port_kwargs):
    """One mega-batch of 4,096 rays on the 800-disk trench through both
    packages on the same tables with the same uniforms (``JaxKeyedRNG``);
    the cloud in packed order, where the two tie rules coincide."""
    R, batch_index, seed = 4096, 1, 4321
    pts, nrm, grid_delta, first_build = reference_geometry("trench_0.5")
    order = np.asarray(first_build.soa_perm)[: len(pts)]
    ref_geo = vrt.DiskGeometry.build(pts[order], nrm[order], grid_delta, dim=3)
    conds = [vrt.BoundaryCondition.PERIODIC] * 3
    ref_geo = ref_geo.with_areas((0, 1), conds)
    geo = port_geometry(ref_geo)
    bbox = adjust_bounding_box(
        np.asarray(ref_geo.bbox), vrtt.TraceDirection.POS_Z,
        ref_geo.disk_radius, 3,
    ).astype(np.float32)
    ref_particle = {
        "coned": vrt.ConedCosineParticle(0.3, CONE),
        "gas": vrt.DiffuseParticle(0.2, "flux").replace(mean_free_path=3.0),
    }[particle_name]
    ref_config = vrt.TraceConfig(
        dim=3, boundary_conditions=tuple(conds), ray_batch_size=R,
        rng_seed=seed, use_random_seed=False, max_bounces=max_bounces,
    )
    ref_source = vrt.RandomSource(
        bbox=jnp.asarray(bbox), cosine_power=jnp.float32(1.0), ray_dir=2,
        first_dir=0, second_dir=1, min_max=1, pos_neg=-1.0, dim=3,
    )
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
    config = vrtt.TraceConfig(
        dim=3, boundary_conditions=(PERIODIC,) * 3, ray_batch_size=R,
        rng_seed=seed, use_random_seed=False, max_bounces=max_bounces,
    )
    source = RandomSource(
        bbox=torch.from_numpy(bbox), cosine_power=1.0, ray_dir=2,
        first_dir=0, second_dir=1, min_max=1, pos_neg=-1.0, dim=3,
    )
    rng = JaxKeyedRNG(base_key)
    rng.begin_batch(batch_index)
    flux, cnt = trace_batch(
        geo, source, PARTICLES[particle_name](), torch.from_numpy(bbox), rng,
        batch_index, torch.from_numpy(ray_indices), torch.from_numpy(valid),
        config, **port_kwargs,
    )
    return flux.numpy(), cnt, np.asarray(ref_flux), ref_cnt


def _assert_close_runs(flux, cnt, ref_flux, ref_cnt, counters, rel_l2, names):
    for name in names:
        want = int(getattr(ref_cnt, name))
        got = getattr(cnt, name)
        assert want > 300, name
        assert abs(got - want) <= counters * want, (name, got, want)
    assert _rel_l2(flux, ref_flux) < rel_l2


@pytest.mark.parametrize("particle", ["coned", "gas"])
def test_trace_batch_unfused_lane_matched_with_reference(particle):
    """The port's unfused body against the reference's over the whole
    ladder, lane by lane under the reference's uniforms and thetas: the
    diffuse particle's bounds of ``test_torch_trace.py``, counters within
    0.2 % and flux rel-L2 < 1e-3 (measured: every counter equal, scatter
    events included, flux 5.7e-8 coned and 2.7e-8 with gas). A last bit of
    the cone's sines and cosines or of exp could move a rare lane to the
    other side of a disk's rim or of u < p; at this seed none does."""
    names = ["total_traces", "geometry_hits", "boundary_hits",
             "non_geometry_hits"] + (["particle_hits"] if particle == "gas" else [])
    _assert_close_runs(
        *_lane_matched(particle, ref_kernel.EnvKnobs(fused=False), fused=False),
        counters=0.002, rel_l2=1e-3, names=names,
    )


@pytest.mark.parametrize("particle", ["coned", "gas"])
def test_trace_batch_fused_lane_matched_up_to_first_compaction(particle):
    """The port's fused body against the megakernel in interpret mode: three
    launches of one bounce at width 4,096 (the unfused key schedule), before
    any compaction; counters within 0.2 %, flux rel-L2 < 1e-2, the bounds
    of the diffuse particle (measured: counters equal, flux 2.2e-3 coned,
    where a hit goes to the other of two overlapping disks under the
    megakernel's approximate reciprocal, and 8e-10 with gas)."""
    knobs = ref_kernel.EnvKnobs(
        fused=True, fused_interpret=True, nsub_wide=1, nsub_mid=1, nsub_tail=1,
    )
    names = ["total_traces", "geometry_hits", "non_geometry_hits"] + (
        ["particle_hits"] if particle == "gas" else [])
    _assert_close_runs(
        *_lane_matched(particle, knobs, max_bounces=3, fused=True,
                       n_sub=(1, 1, 1)),
        counters=0.002, rel_l2=1e-2, names=names,
    )


# ---- whole runs against the oracle -------------------------------------------
def _disk_tracer(particle, rays, seed=19, **kwargs):
    pts, nrm = fixtures.create_trench_grid_3d(grid_delta=0.5)
    t = vrtt.TraceDisk(dim=3, device="cpu", **kwargs)
    t.set_geometry(pts, nrm, 0.5)
    t.set_boundary_conditions([PERIODIC] * 3)
    t.set_particle_type(particle)
    t.set_number_of_rays_fixed(rays)
    t.set_rng_seed(seed)
    t.set_ray_batch_size(1 << 15)
    return t, pts, nrm


def _oracle_norm(t, pts, nrm, rays, sticking, **kwargs):
    """The oracle's flux under the tracer's SOURCE normalization."""
    radius = t.geometry.disk_radius
    flux, counters = oracle_ref.trace_disks_oracle(
        pts, nrm, np.full(len(pts), radius), dim=3, disk_radius=radius,
        num_rays=rays, sticking=sticking, seed=5,
        boundary=("periodic", "periodic"), **kwargs,
    )
    areas = t.geometry.areas.numpy().astype(np.float64)
    return flux * (100.0 / rays) / areas, counters


@pytest.mark.parametrize("fused", [True, False])
def test_ion_run_agrees_with_oracle(fused):
    """The ion particle (coned-cosine, sticking 0.5, cone pi/6, source power
    100) on the 800-disk trench, 100,000 rays against the oracle's 400,000:
    hits per ray within 2 %, normalized flux rel-L2 < 0.1."""
    if not oracle_available():
        pytest.skip("the oracle needs g++")
    t, pts, nrm = _disk_tracer(
        vrtt.ConedCosineParticle(0.5, CONE, 100.0), 100_000, fused=fused
    )
    norm = t.normalize_flux(t.apply())
    want, counters = _oracle_norm(
        t, pts, nrm, 400_000, 0.5, reflection="coned", cone_angle=CONE,
        cosine_exponent=100.0,
    )
    info = t.get_ray_trace_info()
    hits = counters["geometry_hits"] / 400_000
    assert abs(info.geometry_hits / info.num_rays - hits) <= 0.02 * hits
    assert _rel_l2(norm, want) < 0.1
    assert info.particle_hits == 0


def test_two_material_disk_run_agrees_with_oracle():
    """Disks of two materials (sticking 0.5 and 0.1 by the parity of the
    disk's index) through ``set_material_ids``: hits per ray within 2 % of
    the oracle's, which takes the sticking per disk; flux rel-L2 < 0.1."""
    if not oracle_available():
        pytest.skip("the oracle needs g++")
    particle = vrtt.DiffuseParticle(0.3, material_sticking=[0.5, 0.1])
    t, pts, nrm = _disk_tracer(particle, 100_000)
    ids = np.arange(len(pts)) % 2
    t.set_material_ids(ids)
    norm = t.normalize_flux(t.apply())
    want, counters = _oracle_norm(
        t, pts, nrm, 400_000, np.float64([0.5, 0.1])[ids],
    )
    info = t.get_ray_trace_info()
    hits = counters["geometry_hits"] / 400_000
    assert abs(info.geometry_hits / info.num_rays - hits) <= 0.02 * hits
    assert _rel_l2(norm, want) < 0.1
    # one sticking value for all would give other statistics
    assert hits > 1.3


def test_gas_run_agrees_with_oracle():
    """A diffuse particle with a mean free path of 4 on the 800-disk trench:
    scatter events and hits per ray within 3 % of the oracle's, flux rel-L2
    < 0.12 (scattering spreads the flux over more bounces per ray)."""
    if not oracle_available():
        pytest.skip("the oracle needs g++")
    t, pts, nrm = _disk_tracer(_gas(vrtt.DiffuseParticle(0.1), 4.0), 100_000)
    norm = t.normalize_flux(t.apply())
    want, counters = _oracle_norm(t, pts, nrm, 400_000, 0.1,
                                  mean_free_path=4.0)
    info = t.get_ray_trace_info()
    for got, key in ((info.geometry_hits, "geometry_hits"),
                     (info.particle_hits, "scattered")):
        per_ray = counters[key] / 400_000
        assert abs(got / info.num_rays - per_ray) <= 0.03 * per_ray, key
    assert info.particle_hits > 50_000
    assert _rel_l2(norm, want) < 0.12


@pytest.mark.parametrize("tracer", ["triangle", "line"])
def test_new_particles_trace_on_triangles_and_lines(tracer):
    """Where the reference allows them (every geometry kind), the coned
    particle, gas scattering and per-material sticking trace instead of
    raising, and the same seed gives the same flux."""
    runs = []
    for _ in range(2):
        if tracer == "triangle":
            t = vrtt.TraceTriangle(dim=3, device="cpu")
            t.set_geometry(*fixtures.create_trench_mesh_3d(grid_delta=1.0), 1.0)
            bcs = [PERIODIC] * 3
        else:
            nodes, segs = fixtures.create_trench_line_mesh(0.5)
            t = vrtt.TraceLine(device="cpu")
            t.set_geometry(vrtt.LineMesh(nodes, segs, grid_delta=0.5))
            bcs = [REFLECTIVE] * 2
        n = t.geometry.num_primitives
        t.set_material_ids(np.arange(n) % 2)
        t.set_boundary_conditions(bcs)
        t.set_particle_type(PARTICLES["coned_gas_per_material"]())
        t.set_number_of_rays_fixed(8192)
        t.set_rng_seed(3)
        flux = t.apply()
        info = t.get_ray_trace_info()
        assert info.particle_hits > 0 and info.geometry_hits > 4000
        assert np.isfinite(flux).all() and flux.sum() > 0
        runs.append(flux)
    np.testing.assert_array_equal(runs[0], runs[1])
