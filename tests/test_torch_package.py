"""The port stands alone: it imports neither JAX nor the JAX package."""

import os
import re
import subprocess
import sys

import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import sys
import torch
torch.set_num_threads(1)
import viennaray_tpu_torch as vrt
from viennaray_tpu_torch.io import fixtures
pts, nrm = fixtures.create_plane_grid(1.0, 2.0, (0, 1, 2))
t = vrt.TraceDisk(dim=3, device="cpu")
t.set_geometry(pts, nrm, 1.0)
t.set_particle_type(vrt.DiffuseParticle(0.5, "flux"))
t.set_number_of_rays_fixed(600)
t.set_rng_seed(3)
assert t.apply().sum() > 0
bad = [m for m in ("jax", "flax", "viennaray_tpu") if m in sys.modules]
assert not bad, bad
print("standalone-ok")
"""


def test_import_and_trace_without_jax_in_a_fresh_process():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=ROOT, env=env, timeout=300,
        capture_output=True, text=True,
    )
    assert out.returncode == 0, out.stderr
    assert "standalone-ok" in out.stdout


def test_sources_name_neither_jax_nor_the_jax_package_as_an_import():
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "chip_diagnose.py")]
    for folder, _, names in os.walk(os.path.join(ROOT, "viennaray_tpu_torch")):
        files += [os.path.join(folder, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh"))]
    assert len(files) > 20
    # ``viennaray_tpu`` not followed by ``_torch``, outside a path-like
    # mention in prose (docstrings name their counterpart as
    # ``viennaray_tpu/<module>``)
    package = re.compile(r"viennaray_tpu(?!_torch)(?!/)")
    for path in files:
        with open(path) as f:
            text = f.read()
        for needle in ("import jax", "from jax", "import flax", "from flax"):
            assert needle not in text, (path, needle)
        assert not package.search(text), path
