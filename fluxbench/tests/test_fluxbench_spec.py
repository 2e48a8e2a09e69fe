"""BENCHMARK.json against the benchmark's contract, and the loaders that
find a cell's files by name: one dropped into a copy is found with no edit
to a file that is there."""

import hashlib
import json
import re
from pathlib import Path

import pytest
import torch

from fluxbench import spec

REPO = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_top_level_keys_and_sizes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(bench["command"]) <= 32
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    # a full check of 24 cells fits in 43,200 s
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


def test_names_units_and_keys(bench):
    names = [c["name"] for c in bench["configs"]]
    cells = [w["name"] for w in bench["workloads"]]
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("fluxbench/") and PATH.match(c["file"])
        assert (REPO / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["name"] in {w["config"] for w in bench["workloads"]}
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                         "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                         "layer", "moves"}
        assert m["source"] in SOURCES and 1 <= len(m["layer"]) <= 200
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    # every cell reports set-up, another end-to-end metric and a per-layer
    # metric
    for cell in cells:
        e2e = [m for m in bench["end_to_end"]
               if cell in m.get("workloads", cells)]
        assert len(e2e) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in bench["per_layer"])


def test_every_named_file_is_found():
    s = spec.Spec()
    for w in s.data["workloads"]:
        config = s.config(w["config"])
        assert callable(s.setup(config["setup"]).reference)
        for step in s.traffic(w["traffic"])["loop"]:
            assert callable(s.step(step).run)
        s.limits(w["name"])
        for trace in (False, True):
            for m in s.metrics(w["name"], trace):
                assert callable(s.reader(m["name"]))


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


PLANE_SETUP = '''"""A flat square of disks facing up, traced with a specular particle:
every ray hits the plane once and leaves, so the diffuse reference holds."""

import numpy as np

from fluxbench.reference import disks


def clouds(config, traffic):
    xs = np.arange(0.0, float(config["side"]) + 1e-9,
                   float(config["geometry"]["grid_delta"]))
    x, y = np.meshgrid(xs, xs, indexing="ij")
    p = np.stack([x.ravel(), y.ravel(), np.zeros(x.size)], 1)
    n = np.tile([0.0, 0.0, 1.0], (len(p), 1))
    return [(p.astype(np.float32), n.astype(np.float32))]


def program(config, seed, device):
    import viennaray_tpu_torch as vrt

    tr = vrt.TraceDisk(dim=3, device=device)
    tr.set_boundary_conditions([vrt.BoundaryCondition.PERIODIC] * 3)
    tr.set_particle_type(vrt.SpecularParticle(config["sticking"], 1.0))
    tr.set_number_of_rays_per_point(int(config["rays_per_point"]))
    tr.set_rng_seed(seed)
    return tr


def set_geometry(tracer, config, cloud):
    tracer.set_geometry(cloud[0], cloud[1],
                        float(config["geometry"]["grid_delta"]))


def rays_per_apply(tracer, config):
    return tracer.geometry.num_primitives * int(config["rays_per_point"])


class Traced:
    pass


def reference(config, cloud, rays_per_point, seed, device, chunks, dtype):
    t = Traced()
    rc = disks.build_cloud(cloud[0], cloud[1],
                           float(config["geometry"]["grid_delta"]))
    t.flux, hits, hits_sq, t.rays = disks.trace(
        rc, rc.num_disks * rays_per_point, sticking=config["sticking"],
        walls=("periodic", "periodic"), seed=seed, device=device,
        chunks=chunks, dtype=dtype)
    t.hits, t.hits_sq = hits.sum(), hits_sq.sum()
    return t
'''

HALVE_STEP = '''"""Half of the output, on both sides."""


def run(program, it):
    it.output = it.output / 2.0


def reference(traced, values):
    return values / 2.0
'''


def test_a_dropped_in_cell_mix_and_metric_need_no_edit(tiny_root):
    """A configuration of a new set-up (another geometry and a particle
    that no file there knows), a mix with a new step, its limits and a
    metric: found by name, run on the CPU and judged, with no file that
    was there changed."""
    from fluxbench import run

    before = _digests(tiny_root / "fluxbench")
    bench = tiny_root / "fluxbench"
    (bench / "setups" / "disk_plane.py").write_text(PLANE_SETUP)
    (bench / "steps" / "halve.py").write_text(HALVE_STEP)
    (bench / "configs" / "disk_plane.json").write_text(json.dumps(
        {"setup": "disk_plane", "dtype": "float32",
         "control_dtype": "bfloat16", "geometry": {"grid_delta": 1.0},
         "side": 10.0, "sticking": 0.5, "rays_per_point": 5,
         "check": {"reference_rays_per_point": 60, "chunks": 8}}))
    (bench / "traffic" / "apply_halved.json").write_text(json.dumps(
        {"why": "an apply, halved", "loop": ["apply", "halve"],
         "warmup_iterations": 1}))
    (bench / "limits" / "disk_plane.apply_halved.json").write_text(
        json.dumps({"flux_chi2_mean": 2.4, "hits_z": 8.5}))
    (bench / "metrics" / "steps_per_iteration.py").write_text(
        "def read(run):\n"
        "    return float(len(run.traffic['loop']))\n")
    data = json.loads((tiny_root / "BENCHMARK.json").read_text())
    data["configs"].append({"name": "disk_plane", "source": "s",
                            "file": "fluxbench/configs/disk_plane.json",
                            "reduced": [], "why": "w"})
    data["workloads"].append({"name": "disk_plane.apply_halved",
                              "config": "disk_plane",
                              "traffic": "apply_halved", "chips": 1,
                              "why": "w"})
    data["per_layer"].append({"name": "steps_per_iteration", "unit": "n",
                              "better": "lower", "source": "host_clock",
                              "layer": "entry point", "moves": "rays_per_s",
                              "workloads": ["disk_plane.apply_halved"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(data))

    s = spec.Spec(root=tiny_root, bench=bench)
    cell = s.cell("disk_plane.apply_halved")
    assert s.config(cell["config"])["setup"] == "disk_plane"
    assert s.traffic(cell["traffic"])["loop"] == ["apply", "halve"]
    names = [m["name"] for m in s.metrics(cell["name"], trace=True)]
    assert "steps_per_iteration" in names
    result, numbers = run.execute(s, cell["name"], 9, 1.0, True,
                                  torch.device("cpu"))
    assert result["correct"], numbers
    assert set(numbers) == {"flux_chi2_mean", "hits_z"}
    assert result["metrics"]["steps_per_iteration"]["value"] == 2.0
    after = _digests(bench)
    assert all(after[p] == d for p, d in before.items())


def test_an_unknown_cell_is_refused_by_name():
    with pytest.raises(KeyError, match="no workload"):
        spec.Spec().cell("no_such_cell")
