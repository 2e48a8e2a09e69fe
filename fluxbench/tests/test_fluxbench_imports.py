"""The import guard: a run loads nothing whose top-level name is ``jax`` or
the JAX package's, and the reference loads nothing of the program. Each
check runs in a fresh process and compares the part of every loaded
module's name before the first dot, whole (the port's name begins with the
JAX package's)."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
JAX = {"jax", "jaxlib", "flax", "viennaray_tpu"}


def loaded_after(code):
    """The top-level names in ``sys.modules`` after ``code`` ran in a fresh
    interpreter at the repo's root."""
    script = code + (
        "\nimport sys, json\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    p = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=""),
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.splitlines()[-1]))


def test_a_run_loads_no_jax(tiny_root):
    names = loaded_after(
        "import torch\n"
        "from fluxbench import run, spec, control\n"
        f"s = spec.Spec(root={str(tiny_root)!r}, "
        f"bench={str(tiny_root / 'fluxbench')!r})\n"
        "for trace in (False, True):\n"
        "    run.execute(s, 'disk1m_trench.step', 3, 0.5, trace,"
        " torch.device('cpu'))\n"
        "for m in s.data['end_to_end'] + s.data['per_layer']:\n"
        "    s.reader(m['name'])\n"
        "assert not run.forbidden_modules()\n")
    assert "viennaray_tpu_torch" in names  # the program did run
    assert not names & JAX


def test_the_reference_loads_nothing_of_the_program():
    """The reference side of a run as the harness drives it: the set-up's
    clouds and reference trace, every step's reference side, the
    comparison."""
    names = loaded_after(
        "import torch\n"
        "from fluxbench import compare, spec\n"
        "from fluxbench.run import observed\n"
        "s = spec.Spec()\n"
        "config = s.config('disk1m_trench')\n"
        "config['geometry']['grid_delta'] = 1.0\n"
        "traffic = s.traffic('step')\n"
        "setup = s.setup(config['setup'])\n"
        "cloud = setup.clouds(config, traffic)[1]\n"
        "t = setup.reference(config, cloud, 10, 1, torch.device('cpu'), 2,"
        " torch.float32)\n"
        "compare.Reference(observed(s, traffic, t), t.rays, t.hits,"
        " t.hits_sq)\n")
    assert not names & (JAX | {"viennaray_tpu_torch"})
