"""A custom particle's hooks against the port's own built-in body, on the
CPU: hooks that reimplement the built-in physics give the built-in flux and
counters bit for bit; a trace without hooks draws exactly what the tree
before hooks drew; the aux rows move with their rays; which body runs; what
stays refused.

On the CPU the port's wrappers run their plain versions; the CUDA kernels
are held to their plain versions on the card by ``chip_smoke.py``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import viennaray_tpu_torch as vrtt
from viennaray_tpu_torch import rng as rng_mod
from viennaray_tpu_torch.io import fixtures
from viennaray_tpu_torch.ops.histogram import flux_histogram
from viennaray_tpu_torch.physics import reflection
from viennaray_tpu_torch.trace import kernel as trace_kernel

from torch_port_helpers import DRAW_TRACES, record_draws

torch.set_num_threads(1)

PERIODIC = vrtt.BoundaryCondition.PERIODIC
HERE = os.path.dirname(os.path.abspath(__file__))


def _deposit(flux, ids, w):
    return flux + flux_histogram(ids.reshape(-1).contiguous(),
                                 w.reshape(-1).contiguous(), flux.shape[-1])


# ---- a trace without hooks draws what it drew before hooks existed -----------
@pytest.fixture(scope="module")
def parent_draws():
    with open(os.path.join(HERE, "torch_parent_draws.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", DRAW_TRACES)
def test_no_hook_trace_draws_what_the_parent_drew(name, parent_draws):
    """Every draw of a small trace without hooks, fused and unfused, on
    disks, triangles and lines, as (method and stream, bounce, shape) in
    call order, equals the list recorded from the tree before hooks existed:
    ``GeneratorRNG`` draws from one generator in call order, so one draw
    more or moved would shift every later number of the batch."""
    assert record_draws(name) == parent_draws[name]


# ---- hooks that reimplement the built-in: the built-in bits -------------------
def _tracer(kind, fused=False):
    """Small tracers on the CPU: the 777-disk trench, the 1,440-triangle trench
    mesh, the 2D trench's lines in two materials; periodic walls, seed 9."""
    if kind == "disk":
        pts, nrm = fixtures.create_trench_grid_3d(grid_delta=0.5)
        t = vrtt.TraceDisk(dim=3, device="cpu", fused=fused)
        t.set_geometry(pts, nrm, 0.5)
        particle = vrtt.DiffuseParticle(0.1)
        rays = 12000
    elif kind == "triangle":
        t = vrtt.TraceTriangle(dim=3, device="cpu", fused=fused)
        t.set_geometry(*fixtures.create_trench_mesh_3d(grid_delta=0.5), 0.5)
        particle = vrtt.DiffuseParticle(0.1)
        rays = 6000
    else:
        nodes, lines = fixtures.create_trench_line_mesh(grid_delta=0.1)
        t = vrtt.TraceLine(device="cpu", fused=fused)
        ids = np.zeros(len(lines), np.int32)
        ids[len(lines) // 2:] = 1
        t.set_geometry(vrtt.LineMesh(nodes, lines, grid_delta=0.1),
                       material_ids=ids)
        particle = vrtt.DiffuseParticle(0.5, material_sticking=[0.5, 0.1])
        rays = 6000
    t.set_boundary_conditions([PERIODIC] * 3)
    t.set_particle_type(particle)
    t.set_number_of_rays_fixed(rays)
    t.set_ray_batch_size(8192)
    t.set_rng_seed(9)
    return t


def builtin_hooks(particle, dim):
    """collision_fn and reflection_fn that do what the particle's built-in
    deposit and diffuse reflection do, sticking per material included."""
    table = torch.tensor(particle.material_sticking or [particle.sticking],
                         dtype=torch.float32)

    def collision_fn(flux, ids, w, dirn, normal, mat, rng):
        rng.uniform(ids.shape)  # a hook's draws move none of the trace's
        return _deposit(flux, ids, w)

    def reflection_fn(rng, dirn, normal, prim, mat, weight):
        sticking = table[torch.clamp(mat, 0, len(table) - 1).long()]
        u1, u2 = rng.reflect_uniforms
        return sticking, reflection.diffuse(u1, u2, normal, dim)

    return dict(collision_fn=collision_fn, reflection_fn=reflection_fn)


INFO_FIELDS = ("num_rays", "total_rays_traced", "non_geometry_hits",
               "geometry_hits", "particle_hits", "boundary_hits", "reflections")


@pytest.mark.parametrize("kind", ["disk", "triangle", "line"])
def test_hooks_reimplementing_the_builtin_give_its_bits(kind):
    """The reimplemented deposit (the histogram kernel on the hook's ids
    and weights) and diffuse reflection (the handle's reflection uniforms,
    the material's sticking) against the built-in unfused body at the same
    seed: flux and counters bit for bit. The hook plumbing adds nothing."""
    builtin = _tracer(kind)
    want = builtin.apply()
    hooked = _tracer(kind, fused=True)  # the hooks take the unfused body
    hooked.set_custom_functions(**builtin_hooks(hooked._particle,
                                                3 if kind != "line" else 2))
    got = hooked.apply()
    assert want.sum() > 0
    np.testing.assert_array_equal(got, want)
    a, b = builtin.get_ray_trace_info(), hooked.get_ray_trace_info()
    assert all(getattr(a, f) == getattr(b, f) for f in INFO_FIELDS)


@pytest.mark.parametrize("fused", [True, False])
def test_all_zero_init_dir_fn_keeps_the_source_direction(fused):
    """An init_dir_fn of zero rows changes nothing, bit for bit, on either
    body (the reference's tests/test_round2_features.py:85-116), nor does a
    log_fn that draws; a tilting init_dir_fn changes the flux."""
    want = _tracer("disk", fused).apply()
    t = _tracer("disk", fused)
    t.set_custom_functions(
        init_dir_fn=lambda rng, idx: torch.zeros((idx.shape[0], 3)))
    t.set_data_log_fn(lambda rng, aux, idx, valid: [rng.uniform(4)])
    np.testing.assert_array_equal(t.apply(), want)
    t = _tracer("disk", fused)
    t.set_custom_functions(init_dir_fn=lambda rng, idx: torch.tensor(
        [0.7, 0.0, -0.7]).expand(idx.shape[0], 3))
    assert not np.array_equal(t.apply(), want)


# ---- the aux rows move with their rays -----------------------------------------
def test_aux_survives_the_source_sort_and_compaction():
    """A constant aux of 5 deposits exactly 5 times the weights of a run
    whose reflection draws the same numbers (the reference's
    tests/test_stateful_particle.py:84): 8,192 rays run the source sort and
    the compaction ladder. And an aux equal to the ray's index reaches the
    first bounce beside that ray's own direction (set from the index by
    init_dir_fn), through the source sort."""
    dim = 3

    def reflect(rng, dirn, normal, prim, mat, weight, *aux):
        out = (torch.full(dirn.shape[:1], 0.5),
               reflection.diffuse(*rng.reflect_uniforms, normal, dim))
        return out + tuple(aux)

    def five(rng, idx):
        return torch.full((idx.shape[0], 1), 5.0)

    def collide(flux, ids, w, dirn, normal, mat, rng, aux):
        return _deposit(flux, ids, w * aux[:, 0:1])

    plain = _tracer("disk")
    plain.set_number_of_rays_fixed(8192)
    plain.set_custom_functions(reflection_fn=reflect)
    want = plain.apply()
    t = _tracer("disk")
    t.set_number_of_rays_fixed(8192)
    t.set_custom_functions(collision_fn=collide, reflection_fn=reflect,
                           aux_init_fn=five)
    np.testing.assert_allclose(t.apply(), 5.0 * want, rtol=1e-6)

    def direction_of(idx):
        phi = idx.to(torch.float32) * 0.01
        return torch.stack([0.3 * torch.cos(phi), 0.3 * torch.sin(phi),
                            -torch.ones_like(phi)], 1)

    seen = []

    def check(flux, ids, w, dirn, normal, mat, rng, aux):
        if rng._bounce == 0:
            want_dir = direction_of(aux[:, 0].round().long())
            want_dir = want_dir / torch.linalg.norm(want_dir, dim=1,
                                                    keepdim=True)
            seen.append(float((dirn - want_dir).abs().max()))
        return _deposit(flux, ids, w)

    t = _tracer("disk")
    t.set_number_of_rays_fixed(8192)
    t.set_custom_functions(
        collision_fn=check, aux_init_fn=lambda rng, idx: idx[:, None].float(),
        init_dir_fn=lambda rng, idx: direction_of(idx))
    t.apply()
    assert seen and max(seen) < 1e-6


# ---- which body runs -----------------------------------------------------------------
HOOK_BODIES = {
    "collision_fn": False, "reflection_fn": False, "aux_init_fn": False,
    "init_dir_fn": True, "log_fn": True, "none": True,
}


@pytest.mark.parametrize("hook", sorted(HOOK_BODIES))
def test_body_rule(hook, monkeypatch):
    """collision_fn, reflection_fn and aux_init_fn take the unfused body
    (the closest-hit search every bounce, never the bounce kernel) although
    the tracer asks for the fused one; init_dir_fn and log_fn keep the fused
    body (ref: kernel.py:959-976). Calls of the trace's wrappers, counted on
    the CPU."""
    calls = {"fused_bounce": 0, "search": 0}

    def counting(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(trace_kernel, "fused_bounce",
                        counting("fused_bounce", trace_kernel.fused_bounce))
    monkeypatch.setitem(trace_kernel._SEARCH, "disk",
                        counting("search", trace_kernel._SEARCH["disk"]))
    t = _tracer("disk", fused=True)
    t.set_number_of_rays_fixed(2000)
    hooks = {
        "collision_fn": lambda flux, ids, w, *rest: _deposit(flux, ids, w),
        "reflection_fn": lambda rng, dirn, normal, *rest: (
            torch.full(dirn.shape[:1], 0.1),
            reflection.diffuse(*rng.reflect_uniforms, normal, 3)),
        "aux_init_fn": lambda rng, idx: torch.zeros((idx.shape[0], 2)),
        "init_dir_fn": lambda rng, idx: torch.zeros((idx.shape[0], 3)),
    }
    if hook == "log_fn":
        t.set_data_log_fn(lambda rng, aux, idx, valid: [valid.sum()[None]])
    elif hook != "none":
        t.set_custom_functions(**{hook: hooks[hook]})
    assert t.apply().sum() > 0
    fused = HOOK_BODIES[hook]
    assert (calls["fused_bounce"] > 0) == fused
    assert (calls["search"] > 0) == (not fused)


# ---- what stays refused; the handle ----------------------------------------------
def test_window_flux_model_refuses_a_collision_fn():
    """As the reference (kernel.py:336-343): the window contract has no
    neighbor-id list to hand to a custom collision. The window model still
    takes a reflection_fn."""
    t = _tracer("disk")
    t.set_flux_model("window")
    t.set_number_of_rays_fixed(1000)
    t.set_custom_functions(collision_fn=lambda flux, *rest: flux)
    with pytest.raises(NotImplementedError, match="collision_fn"):
        t.apply()
    config = vrtt.TraceConfig(flux_model="window")
    with pytest.raises(NotImplementedError, match="collision_fn"):
        trace_kernel.check_supported(config, vrtt.DiffuseParticle(0.1), None,
                                     collision_fn=lambda *a: None)
    t.set_custom_functions(reflection_fn=builtin_hooks(
        vrtt.DiffuseParticle(0.1), 3)["reflection_fn"])
    assert t.apply().sum() > 0


def test_hook_handle_draws_and_refuses():
    """The handle's draws follow its RayRNG's streams; ``normal`` maps one
    draw of uniforms through the inverse error function; only a
    reflection_fn's handle carries the reflection uniforms; unknown streams
    and a collision_fn returning another shape are refused."""
    rng = rng_mod.GeneratorRNG(5, "cpu")
    rng.begin_batch(0)
    h = rng_mod.HookRNG(rng, rng_mod.HOOK_COLLISION, 0, 3)
    u = h.uniform((4096, 2))
    assert u.shape == (4096, 2) and u.dtype == torch.float32
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    z = h.normal(100000)
    assert abs(float(z.mean())) < 0.02 and abs(float(z.std()) - 1.0) < 0.02
    assert torch.isfinite(z).all()
    with pytest.raises(AttributeError):
        h.reflect_uniforms
    with pytest.raises(ValueError):
        rng_mod.HookRNG(rng, rng_mod.ROULETTE, 0)
    with pytest.raises(ValueError):
        rng.hook_uniform(rng_mod.ROULETTE, 0, 0, (3,), 0)
    t = _tracer("disk")
    t.set_number_of_rays_fixed(1000)
    t.set_custom_functions(collision_fn=lambda flux, *rest: flux[:-1])
    with pytest.raises(ValueError, match="collision_fn"):
        t.apply()
    t.set_custom_functions(aux_init_fn=lambda rng, idx: torch.zeros(3))
    with pytest.raises(ValueError, match="aux_init_fn"):
        t.apply()


def test_particle_replace_keeps_the_other_fields():
    p = vrtt.SpecularParticle(0.4, 100.0)
    q = p.replace(data_labels=("a", "b"))
    assert q.data_labels == ("a", "b") and p.data_labels == ("flux",)
    assert dataclasses.replace(q, data_labels=p.data_labels) == p
