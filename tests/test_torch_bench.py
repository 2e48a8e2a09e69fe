"""The port's benchmark programs (``viennaray_tpu_torch/bench``) on the CPU at
a tiny depth: every cell of the sweep, the flagship and the gradient
benchmark print JSON lines that parse and name the device they ran on, and
exit with 1 where a line's ``ok`` is false (a golden missed, as it is at
these depths) and 0 where every line's holds. The
override arguments (``--rays-per-point``, ``--grid-delta``, ``--rays``,
``--batch``) exist for these runs; on the card the programs run their own
configurations."""

import json

import pytest
import torch

from viennaray_tpu_torch.bench import flagship, grad_bench, perf_sweep

torch.set_num_threads(1)

# cell -> a coarse grid delta for the CPU (None: the cell's own)
TINY = {"disk2d": None, "disk3d": 1.0, "tri3d": 1.0, "disk18k": 1.0,
        "disk1m": 1.0, "ion": 1.0, "line2d": None}


def _lines(capsys, out):
    printed = [json.loads(line) for line in
               capsys.readouterr().out.splitlines()]
    with open(out) as f:
        written = [json.loads(line) for line in f]
    assert printed == written
    return printed


@pytest.mark.parametrize("cell", list(perf_sweep.CELLS))
def test_sweep_cell_prints_its_json_line(cell, tmp_path, capsys):
    """One line per cell with its counters and timings; a golden's rel-L2
    where the cell runs its own grid delta and has one (line2d: 1 ray per
    segment misses it, so ``ok`` is false and the exit code 1), null where
    it runs another (``ok`` then holds, exit code 0); disk1m builds without
    the neighbor records and traces."""
    out = tmp_path / "sweep.jsonl"
    argv = [cell, "--device", "cpu", "--reps", "1", "--rays-per-point", "1",
            "--out", str(out)]
    if TINY[cell] is not None:
        argv += ["--grid-delta", str(TINY[cell])]
    rc = perf_sweep.main(argv)
    (row,) = _lines(capsys, out)
    assert row["ok"] is (cell != "line2d")
    assert rc == (0 if row["ok"] else 1)
    assert row["cell"] == cell and row["device"] == {"type": "cpu"}
    assert row["num_rays"] == row["primitives"] > 0
    assert row["flux_sum"] > 0 and 0 < row["hits_per_ray"] < 10
    assert row["chunks"] >= 1 and len(row["wall_seconds"]) == 1
    assert row["peak_memory_bytes"] is None  # no device memory on the CPU
    for key in ("rays_per_s", "cpu_seconds", "fixture_seconds",
                "build_seconds", "chunks_swept",
                "tile_bounces", "counts"):
        assert key in row, key
    if cell == "line2d":
        assert set(row["rel_l2"]) == {"line2d_trench_oracle"}
    elif TINY[cell] is not None:
        assert row["rel_l2"] is None


def test_flagship_and_gradient_benchmarks_print_their_lines(tmp_path, capsys):
    """``flagship`` prints bench.py's form (metric, value, unit) with the
    device and the two goldens' rel-L2 (``ok`` False at 1 ray per point);
    ``grad_bench`` prints the flux and d / d sticking against
    ``grad3d_trench_jax`` (``ok`` False at 1,024 rays); both exit with 1
    for it; neither writes under ``benchmarks/``."""
    out = tmp_path / "bench.jsonl"
    assert flagship.main(["--device", "cpu", "--reps", "1",
                          "--rays-per-point", "1", "--out", str(out)]) == 1
    assert grad_bench.main(["--device", "cpu", "--rays", "1024", "--batch",
                            "512", "--out", str(out)]) == 1
    flag, grad = _lines(capsys, out)
    assert flag["unit"] == "rays/s" and flag["value"] > 0
    assert "cpu" in flag["metric"] and flag["device"] == {"type": "cpu"}
    assert set(flag["rel_l2"]) == {"bench_disk3d", "bench_disk3d_oracle"}
    assert flag["ok"] is False
    assert grad["config"] == "grad_1e7" and grad["device"] == {"type": "cpu"}
    assert grad["total_rays"] == 1024 and grad["d_flux_d_sticking"] < 0
    assert grad["ok"] is False
    with pytest.raises(ValueError, match="benchmarks"):
        perf_sweep.main(["line2d", "--device", "cpu", "--reps", "1",
                         "--rays-per-point", "1", "--out",
                         str(perf_sweep.common.ROOT)
                         + "/benchmarks/sweep.jsonl"])


@pytest.mark.parametrize("oks", [(True, True), (False, True), (True, False)])
def test_sweep_prints_every_cell_and_exits_1_where_one_fails(
        oks, monkeypatch, capsys):
    """The sweep prints every cell's line, also after a cell whose ``ok`` is
    false, and exits with 1 where any line's ``ok`` is false, else 0."""
    rows = iter(oks)
    monkeypatch.setattr(
        perf_sweep, "run_cell",
        lambda name, *args: {"cell": name, "ok": next(rows)})
    rc = perf_sweep.main(["disk2d", "line2d", "--device", "cpu"])
    printed = [json.loads(line)
               for line in capsys.readouterr().out.splitlines()]
    assert [r["cell"] for r in printed] == ["disk2d", "line2d"]
    assert [r["ok"] for r in printed] == list(oks)
    assert rc == (0 if all(oks) else 1)
