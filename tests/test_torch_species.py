"""The two-species etch step (``fluxbench/configs/disk3d_ion_neutral.json``):
the coned-cosine ion's per-material sticking, ``apply_particles``' spans and
counters, the readers of the cell's per-layer metrics, and the cell through
the benchmark's run on the CPU. The port against the plain reference:
``test_torch_species_compare.py``."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import viennaray_tpu_torch as vrtt
from viennaray_tpu_torch.config import ReflectionKind
from viennaray_tpu_torch.ops.sampling import masked_rejection
from viennaray_tpu_torch.trace import kernel
from viennaray_tpu_torch.utils import telemetry

from fluxbench import devtrace, program_spans, spec
from fluxbench.run import Iteration, Run

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CELL = "disk3d_ion_neutral.species"
CPU = torch.device("cpu")
SPEC = spec.Spec()
SETUP = SPEC.setup("disk_species")
LIMITS = SPEC.limits(CELL)


def config(grid_delta=1.0, rays_per_point=100):
    """The cell's configuration on a coarser trench and fewer rays."""
    cfg = SPEC.config("disk3d_ion_neutral")
    cfg["geometry"]["grid_delta"] = grid_delta
    cfg["rays_per_point"] = rays_per_point
    return cfg


def tracer(cfg, seed=11, fused=True):
    """The cell's tracer on ``cfg``'s cloud with its materials; the unfused
    body where ``fused`` is false."""
    if fused:
        tr = SETUP.program(cfg, seed, CPU)
    else:
        tr = vrtt.TraceDisk(dim=3, device="cpu", fused=False)
        tr.set_boundary_conditions([vrtt.BoundaryCondition.PERIODIC] * 3)
        tr.set_number_of_rays_per_point(int(cfg["rays_per_point"]))
        tr.set_rng_seed(seed)
    SETUP.set_geometry(tr, cfg, SETUP.clouds(cfg, {})[0])
    return tr


def recorded():
    return profile(activities=[ProfilerActivity.CPU])


# ---- the coned-cosine particle's material table ------------------------


@pytest.mark.parametrize("fused", [True, False])
def test_the_coned_cosine_factory_takes_a_material_table(fused):
    cfg = config(rays_per_point=5)
    by_hand = vrtt.ConedCosineParticle(0.2, np.pi / 6, 100.0, "ionFlux")
    table = [0.1, 0.3]
    factory = vrtt.ConedCosineParticle(0.2, np.pi / 6, 100.0, "ionFlux",
                                       material_sticking=table)
    assert factory == by_hand.replace(material_sticking=table)
    assert vrtt.ConedCosineParticle(0.2, 0.5).material_sticking is None
    fluxes = []
    for particle in (factory, by_hand.replace(material_sticking=table),
                     by_hand):
        tr = tracer(cfg, fused=fused)
        tr.set_particle_type(particle)
        fluxes.append(tr.apply())
    np.testing.assert_array_equal(fluxes[0], fluxes[1])
    # the table is read: the scalar 0.2 on every material traces otherwise
    assert not np.array_equal(fluxes[0], fluxes[2])


# ---- spans and counters ------------------------------------------------


def _species_recorded(fused=True):
    cfg = config(rays_per_point=5)
    tr = tracer(cfg, fused=fused)
    telemetry.clear()
    before = dict(telemetry.COUNTS)
    with recorded():
        vrtt.apply_particles(tr, SETUP.particles(cfg))
    return telemetry.spans(), before, dict(telemetry.COUNTS)


@pytest.mark.parametrize("fused", [True, False])
def test_apply_particles_is_one_request_of_an_apply_a_species(fused):
    spans, _, _ = _species_recorded(fused)
    roots = [s for s in spans if s.parent_id == 0]
    assert [r.name for r in roots] == ["apply_particles"]
    root = roots[0]
    assert root.attrs["particles"] == 2
    applies = [s for s in spans if s.name == "apply"]
    assert [a.parent_id for a in applies] == [root.span_id] * 2
    assert [a.attrs["species"] for a in applies] == [0, 1]
    assert [a.attrs["refl_kind"] for a in applies] == [
        int(ReflectionKind.CONED_COSINE), int(ReflectionKind.DIFFUSE)]
    for s in spans:
        assert s.request_id == root.span_id


@pytest.mark.parametrize("fused", [True, False])
def test_the_cone_spans_and_counters_count_the_rejections_reads(fused):
    spans, before, after = _species_recorded(fused)
    by_id = {s.span_id: s for s in spans}
    ion, neutral = [s for s in spans if s.name == "apply"]
    cones = [s for s in spans if s.name == "cone_theta"]
    cone_reads = [s for s in spans if s.name == "read"
                  and s.attrs["what"] == kernel.READ_CONE]
    assert cones and all(by_id[s.parent_id].name == "cone_theta"
                         for s in cone_reads)
    rounds = sum(s.attrs["rounds"] for s in cones)
    assert rounds == len(cone_reads) == ion.attrs["cone_rounds"]
    assert all(s.attrs["rounds"] >= 2 for s in cones)
    assert ion.attrs["cone_calls"] == len(cones)
    assert all(s.attrs["lanes"] > 0 for s in cones)
    assert neutral.attrs["cone_rounds"] == neutral.attrs["cone_calls"] == 0
    # the rejection's reads are host reads as the ladder's are
    for apply in (ion, neutral):
        reads = [s for s in spans if s.name == "read"
                 and s.request_id == apply.request_id
                 and apply.start_ns <= s.start_ns <= apply.end_ns]
        assert apply.attrs["host_reads"] == len(reads)
    assert after["cone_rounds"] - before["cone_rounds"] == rounds
    assert after["host_reads"] - before["host_reads"] == sum(
        a.attrs["host_reads"] for a in (ion, neutral))
    # no kernel launches on the CPU, so no launch of the kFull kernel
    assert after["full_launches"] == before["full_launches"]


def test_nothing_is_recorded_without_a_profiler_but_the_counters_count():
    cfg = config(rays_per_point=5)
    tr = tracer(cfg)
    telemetry.clear()
    before = dict(telemetry.COUNTS)
    vrtt.apply_particles(tr, SETUP.particles(cfg))
    assert telemetry.spans() == []
    after = dict(telemetry.COUNTS)
    assert after["cone_rounds"] > before["cone_rounds"]
    assert after["cone_calls"] > before["cone_calls"]


def test_the_rejection_reads_once_a_round():
    reads = []
    gen = torch.Generator().manual_seed(4)

    def propose(i):
        return torch.full((64,), float(i)), torch.rand(64, generator=gen) < 0.5

    class Read:
        def __enter__(self):
            reads.append(1)

        def __exit__(self, *exc):
            return False

    value, done = masked_rejection(propose, (64,), "cpu", read=Read)
    assert bool(done.all())
    # the rounds that proposed, and the test that found every lane done
    assert len(reads) == int(value.max()) + 2


# ---- the readers of the cell's per-layer metrics -----------------------

MS = 1_000_000  # ns
FULL = "void (anonymous namespace)::bounce_kernel<DiskKind, true, 32>(vr_bounce::BounceArgs)"
PLAIN = "void (anonymous namespace)::bounce_kernel<DiskKind, false, 1>(vr_bounce::BounceArgs)"


def _trace():
    """A 100 ms window; device operations at (ms) 22-28 (the kFull kernel),
    32-34, 52-60 (the plain one): idle 0-22, 28-32, 34-52, 60-100."""
    dev = [(FULL, 22 * MS, 28 * MS),
           ("void at::native::reduce_kernel()", 32 * MS, 34 * MS),
           (PLAIN, 52 * MS, 60 * MS)]
    host = [("fluxbench.window", 0, 100 * MS),
            ("fluxbench.apply_species", 10 * MS, 90 * MS)]
    return devtrace.Trace(dev, host)


def _log():
    """One step (10-90 ms): the ion's apply 10-50 with a cone_theta span at
    12-25 holding two reads, the neutral's 50-85."""
    rows = [  # name, start, end, id, parent, request, attrs
        ("read", 13, 14, 4, 3, 1, {"what": kernel.READ_CONE}),
        ("read", 20, 24, 5, 3, 1, {"what": kernel.READ_CONE}),
        ("cone_theta", 12, 25, 3, 2, 1, {"lanes": 4096, "rounds": 2}),
        ("apply", 10, 50, 2, 1, 1, {"species": 0, "refl_kind": 2,
                                    "cone_rounds": 2, "cone_calls": 1}),
        ("apply", 50, 85, 6, 1, 1, {"species": 1, "refl_kind": 0,
                                    "cone_rounds": 0, "cone_calls": 0}),
        ("apply_particles", 10, 90, 1, 0, 1, {"particles": 2}),
    ]
    return [telemetry.Span(n, a * MS, b * MS, i, p, r, attrs)
            for n, a, b, i, p, r, attrs in rows]


def _run(trace=True):
    run = Run({"rays_per_point": 100}, {"loop": ["apply_species"]})
    run.peaks = {"hbm_bytes_per_s": 3.35e12}
    run.trace = _trace() if trace else None
    it = Iteration()
    it.coned = (5000, 2000 * 100)  # segments; 2,000 disks' rays
    run.iterations = [it]
    return run


NEW = ["species.coned_apply_ms_per_step", "species.diffuse_apply_ms_per_step",
       "cone.rounds_per_step", "cone.idle_ms_per_step",
       "bounce.coned.roofline_pct"]


@pytest.mark.parametrize("name,expected", [
    ("species.coned_apply_ms_per_step", 40.0),
    ("species.diffuse_apply_ms_per_step", 35.0),
    ("cone.rounds_per_step", 2.0),
    # idle 0-22: its midpoint 11 in the ion's apply, outside the cone span;
    # 28-32 (midpoint 30) in no cone span either; 34-52 in the ion's apply
    # after it
    ("cone.idle_ms_per_step", 0.0),
    ("bounce.coned.roofline_pct",
     100.0 * (5000 * 60 + 2000 * 28) / 3.35e12 / 0.006),
])
def test_each_species_reader_on_a_hand_made_log(monkeypatch, name, expected):
    spans = _log()
    monkeypatch.setattr(program_spans, "program_log", lambda: spans)
    assert SPEC.reader(name)(_run()) == pytest.approx(expected)


def test_the_cone_idle_is_the_gaps_inside_the_cone_spans(monkeypatch):
    spans = _log()
    # the cone span of 12-25 widened to 10-40: the midpoints of the gaps
    # 0-22 (11) and 28-32 (30) now lie in it
    spans[2] = spans[2]._replace(start_ns=10 * MS, end_ns=40 * MS)
    monkeypatch.setattr(program_spans, "program_log", lambda: spans)
    assert SPEC.reader("cone.idle_ms_per_step")(_run()) == pytest.approx(
        22.0 + 4.0)


@pytest.mark.parametrize("name", NEW)
def test_the_species_readers_read_nothing_of_an_older_program(monkeypatch,
                                                               name):
    """A program without the species' spans: applies that are their own
    requests, without ``refl_kind`` or ``cone_rounds``; or no log, or no
    trace."""
    older = [s._replace(parent_id=0, request_id=s.span_id, attrs={})
             for s in _log() if s.name == "apply"]
    monkeypatch.setattr(program_spans, "program_log", lambda: older)
    run = _run()
    if name != "bounce.coned.roofline_pct":  # the profile alone
        assert SPEC.reader(name)(run) is None
    monkeypatch.setattr(program_spans, "program_log", lambda: None)
    assert SPEC.reader(name)(_run(trace=False)) is None
    run.iterations = [Iteration()]  # no ``coned``: no bytes, no kernel time
    run.trace = devtrace.Trace([(PLAIN, 0, MS)],
                               [("fluxbench.window", 0, 100 * MS)])
    assert SPEC.reader(name)(run) is None


def test_the_metrics_are_listed_for_the_cell_alone():
    listed = {m["name"]: m for m in SPEC.data["per_layer"]}
    for name in NEW:
        assert listed[name]["workloads"] == [CELL]
        assert listed[name]["moves"] == "rays_per_s"
    names = {m["name"] for m in SPEC.metrics(CELL, True)}
    assert set(NEW) <= names and "device.idle_pct" in names


# ---- the cell through the benchmark's run ------------------------------


def test_the_cell_runs_on_the_cpu(tmp_path):
    """The cell through the benchmark's own run, on a copy of the benchmark
    at grid delta 1.0, 5 rays a point: sound, with every number it
    compares."""
    import shutil

    from fluxbench import run

    shutil.copytree(REPO / "fluxbench", tmp_path / "fluxbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    path = tmp_path / "fluxbench" / "configs" / "disk3d_ion_neutral.json"
    cfg = json.loads(path.read_text())
    cfg["geometry"]["grid_delta"] = 1.0
    cfg["rays_per_point"] = 5
    cfg["check"] = {"reference_rays_per_point": 60, "chunks": 8}
    path.write_text(json.dumps(cfg))
    s = spec.Spec(root=tmp_path, bench=tmp_path / "fluxbench")
    result, numbers = run.execute(s, CELL, 2**40 + 7, 0.5, False, CPU)
    assert result["correct"], numbers
    assert set(numbers) == set(LIMITS)
    assert {"rays_per_s", "setup_s"} <= set(result["metrics"])


def test_the_reference_side_loads_nothing_of_the_program():
    """The set-up's clouds and reference trace, both steps' reference sides
    and the comparison, in a fresh interpreter: no module of the port, JAX
    or the JAX package loaded."""
    import os
    import subprocess
    import sys

    script = (
        "import json, sys, torch\n"
        "from fluxbench import compare, spec\n"
        "from fluxbench.run import observed\n"
        "s = spec.Spec()\n"
        "config = s.config('disk3d_ion_neutral')\n"
        "config['geometry']['grid_delta'] = 1.0\n"
        "traffic = s.traffic('species')\n"
        "setup = s.setup(config['setup'])\n"
        "cloud = setup.clouds(config, traffic)[0]\n"
        "t = setup.reference(config, cloud, 10, 1, torch.device('cpu'), 2,"
        " torch.float32)\n"
        "compare.Reference(observed(s, traffic, t), t.rays, t.hits,"
        " t.hits_sq)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    p = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=""),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    names = set(json.loads(p.stdout.splitlines()[-1]))
    assert "fluxbench" in names
    assert not names & {"jax", "jaxlib", "flax", "viennaray_tpu",
                        "viennaray_tpu_torch"}
