"""A run's control flow on the CPU at a tiny size, the port's plain versions
standing in for its kernels; the faults and the control that must come out
as not correct; the exits without a card."""

import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from fluxbench import control, run

REPO = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")


@pytest.mark.parametrize("workload", ["disk3d_trench.apply",
                                      "disk1m_trench.step"])
@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_on_the_cpu(tiny_spec, workload, trace):
    # seeds 2**32 and 3 draw the step cell's cloud 1 to compare, the first
    # that its window sets after the warm-up's cycle
    result, numbers = run.execute(tiny_spec, workload, 2**32, 1.0, trace,
                                  CPU)
    assert result["correct"], numbers
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "check"
    assert set(result["check"]) == set(tiny_spec.limits(workload))
    metrics = {m["name"] for m in tiny_spec.metrics(workload, trace)}
    assert set(result["metrics"]) <= metrics
    if trace:
        # no device on the CPU: nothing for the device metrics to read
        assert result["device"]["busy_s"] == 0.0
        assert result["device"]["window_s"] > 0
        assert result["breakdown"]["device_ops"] == []
    else:
        assert {"rays_per_s", "setup_s"} <= set(result["metrics"])
    json.dumps(result)


def test_the_same_seed_gives_the_same_inputs(tiny_spec):
    from fluxbench import inputs

    cell = tiny_spec.cell("disk1m_trench.step")
    config = tiny_spec.config(cell["config"])
    traffic = tiny_spec.traffic(cell["traffic"])
    progs = [run.Program(tiny_spec, config, traffic, inputs.seeds(77)[0], CPU)
             for _ in range(2)]
    assert len(progs[0].clouds) == 4
    a, b = (p.iteration() for p in progs)
    assert a.cloud == b.cloud == 1
    assert (a.output == b.output).all() and a.info == b.info
    ref_a, ref_b = (run.reference_check(tiny_spec, config, traffic,
                                        progs[0].clouds, 2,
                                        inputs.seeds(77)[1], CPU)
                    for _ in range(2))
    assert torch.equal(ref_a.mean, ref_b.mean)
    assert inputs.seeds(77) != inputs.seeds(78)


def _reversed_flux(monkeypatch):
    """An answer altered where it is produced: each batch's flux lands on
    the disks in reverse order."""
    from viennaray_tpu_torch.trace import tracer

    real = tracer.trace_batch

    def fault(*args, **kwargs):
        out = real(*args, **kwargs)
        return (out[0].flip(0),) + tuple(out[1:])

    monkeypatch.setattr(tracer, "trace_batch", fault)


def _half_batch(monkeypatch):
    """Half of each batch left out, the flux taken as twice the rest's."""
    from viennaray_tpu_torch.trace import tracer

    real = tracer.trace_batch

    def fault(geometry, source, particle, bbox, rng, b, ray_indices, valid,
              *args, **kwargs):
        valid = valid & (ray_indices % 2 == 0)
        out = real(geometry, source, particle, bbox, rng, b, ray_indices,
                   valid, *args, **kwargs)
        return (out[0] * 2.0,) + tuple(out[1:])

    monkeypatch.setattr(tracer, "trace_batch", fault)


def _geometry_unchanged(monkeypatch):
    """A step that returns its state unchanged: ``set_geometry`` keeps the
    first cloud."""
    from viennaray_tpu_torch.trace.tracer import TraceDisk

    real = TraceDisk.set_geometry

    def fault(self, *args, **kwargs):
        if self.geometry is None:
            real(self, *args, **kwargs)

    monkeypatch.setattr(TraceDisk, "set_geometry", fault)


@pytest.mark.parametrize("workload,fault", [
    ("disk3d_trench.apply", _reversed_flux),
    ("disk3d_trench.apply", _half_batch),
    ("disk1m_trench.step", _reversed_flux),
    ("disk1m_trench.step", _half_batch),
    ("disk1m_trench.step", _geometry_unchanged),
])
def test_a_broken_timed_path_is_not_correct(fault_spec, monkeypatch,
                                            workload, fault):
    fault(monkeypatch)
    result, numbers = run.execute(fault_spec, workload, 3, 1.0, False, CPU)
    assert not result["correct"], numbers
    # the window's first iteration is compared: the fault, not a window
    # with nothing to compare, fails the run
    assert min(v for v, _ in numbers.values()) < math.inf


@pytest.mark.parametrize("workload", ["disk1m_trench.apply",
                                      "disk1m_trench.step"])
def test_the_control_is_not_correct(tmp_path, workload):
    """The reference in bfloat16 in the program's place, on the cell's own
    704,250-disk cloud at one ray a point (the test's size)."""
    from conftest import make_copy

    from fluxbench import spec

    root = make_copy(tmp_path, {"disk1m_trench": {
        "rays_per_point": 1, "reference_rays_per_point": 1, "chunks": 4}})
    s = spec.Spec(root=root, bench=root / "fluxbench")
    ok, numbers = control.judge_control(s, workload, 21, 1, CPU)
    assert not ok, numbers


def _run_command(cwd, *extra):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run(
        [sys.executable, "-m", "fluxbench.run", "--workload",
         "disk3d_trench.apply", "--seed", "1", "--seconds", "1",
         "--trace", "0", *extra],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this process sees a CUDA device")
    p = _run_command(REPO)
    assert p.returncode == 2 and p.stdout == ""


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copytree(REPO / "fluxbench", tmp_path / "fluxbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = _run_command(tmp_path)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.cuda
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = _run_command(REPO)
    assert p.returncode == 0, p.stderr[-4000:]
    result = json.loads(p.stdout.splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
