"""Finding a cell's parts by the names ``BENCHMARK.json`` gives them.

Everything that belongs to one configuration, one traffic mix, one cell's
limits or one metric is a file of its own under this folder, found by name:

- ``configs/<config>.json``: the configuration (geometry, particle, rays a
  point, walls, the sizes the reference traces) and the name of its set-up;
- ``setups/<setup>.py``: what is specific to a kind of configuration: its
  clouds, the program's tracer and particle built through the public API,
  how a cloud is set on it, and the plain reference's trace of a cloud;
- ``traffic/<mix>.json``: the loop body the window repeats, as a list of
  step names, and its parameters (its cycle of clouds, the warm-up);
- ``steps/<step>.py``: one step of a loop body, ``run(program, iteration)``
  on the program and ``reference(traced, values)``, the same step on the
  reference's estimate;
- ``limits/<cell>.json``: the limits of the numbers that decide ``correct``;
- ``metrics/<metric>.py``: a reader, ``read(run)``, that turns a run's spans,
  counters and profile into the metric, or ``None`` where it finds nothing.

So a later configuration, set-up, mix, step or metric is new files and new
entries, never an edit. Code files are loaded from this folder by path, so a
copy of the folder elsewhere runs its own files.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent  # the checkout, where BENCHMARK.json lies


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Spec:
    """``BENCHMARK.json`` and the files it names, under ``root`` (the
    checkout; the bench folder ``bench``)."""

    def __init__(self, root=ROOT, bench=HERE):
        self.root = Path(root)
        self.bench = Path(bench)
        self.data = load_json(self.root / "BENCHMARK.json")
        self._modules = {}

    def cell(self, name):
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        known = ", ".join(w["name"] for w in self.data["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({known})")

    def config(self, name):
        for c in self.data["configs"]:
            if c["name"] == name:
                return load_json(self.root / c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name):
        return load_json(self.bench / "traffic" / f"{name}.json")

    def limits(self, cell):
        return load_json(self.bench / "limits" / f"{cell}.json")

    def metrics(self, cell, trace):
        """The metrics a run of ``cell`` reports: with ``trace`` the
        per-layer ones, else the end-to-end ones; each listed for the cell
        or for every cell."""
        entries = self.data["per_layer" if trace else "end_to_end"]
        return [m for m in entries
                if "workloads" not in m or cell in m["workloads"]]

    def reader(self, metric):
        """The ``read`` function of ``metrics/<metric>.py``."""
        return self.module("metrics", metric).read

    def setup(self, name):
        """The module ``setups/<name>.py``."""
        return self.module("setups", name)

    def step(self, name):
        """The module ``steps/<name>.py``."""
        return self.module("steps", name)

    def module(self, kind, name):
        """``<kind>/<name>.py`` under the bench folder, loaded once."""
        key = (kind, name)
        if key not in self._modules:
            path = self.bench / kind / f"{name}.py"
            if not path.is_file():
                raise KeyError(f"no {kind}/{name}.py in {self.bench}")
            spec = importlib.util.spec_from_file_location(
                f"fluxbench_{kind}_{name.replace('.', '_')}_{id(self)}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            self._modules[key] = module
        return self._modules[key]
