"""Fixtures of the benchmark's CPU tests: a copy of the benchmark in a
temporary checkout, its configurations cut to a size the CPU traces in
seconds (the port's plain versions stand in for its kernels there)."""

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]


def make_copy(root, sizes):
    """A checkout at ``root`` holding BENCHMARK.json and the benchmark's
    files; ``sizes``: config name -> {"grid_delta", "rays_per_point",
    "reference_rays_per_point", "chunks"} to set."""
    bench = root / "fluxbench"
    shutil.copytree(REPO / "fluxbench", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for name, s in sizes.items():
        path = bench / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        if "grid_delta" in s:
            cfg["geometry"]["grid_delta"] = s["grid_delta"]
        for key in ("rays_per_point",):
            if key in s:
                cfg[key] = s[key]
        for key in ("reference_rays_per_point", "chunks"):
            if key in s:
                cfg["check"][key] = s[key]
        path.write_text(json.dumps(cfg))
    return root


TINY = {"grid_delta": 1.0, "rays_per_point": 5,
        "reference_rays_per_point": 60, "chunks": 8}


@pytest.fixture
def tiny_root(tmp_path):
    """The benchmark with both configurations on the trench at grid delta
    1.0 (209 disks), 5 rays a point, the reference at 60."""
    return make_copy(tmp_path, {"disk3d_trench": TINY, "disk1m_trench": TINY})


# the faults' size: 777 disks, 15,540 rays an apply, where a fault that
# only halves the rays a front hit reads past the step cell's hits_z limit
FAULT = {"grid_delta": 0.5, "rays_per_point": 20,
         "reference_rays_per_point": 80, "chunks": 8}


@pytest.fixture
def fault_spec(tmp_path):
    from fluxbench import spec

    root = make_copy(tmp_path, {"disk3d_trench": FAULT,
                                "disk1m_trench": FAULT})
    return spec.Spec(root=root, bench=root / "fluxbench")


@pytest.fixture
def tiny_spec(tiny_root):
    from fluxbench import spec

    return spec.Spec(root=tiny_root, bench=tiny_root / "fluxbench")
