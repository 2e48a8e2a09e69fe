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
from viennaray_tpu_torch.geometry import triangle_geometry
from viennaray_tpu_torch.io import make_oracle_goldens
assert triangle_geometry.TriangleGeometry.kind == "triangle"
assert "tri3d_trench_oracle" in make_oracle_goldens.CONFIGS
verts, tris = fixtures.create_trench_mesh_3d(grid_delta=1.0)
t = vrt.TraceTriangle(dim=3, device="cpu")
t.set_geometry(verts, tris, 1.0)
t.set_particle_type(vrt.DiffuseParticle(0.5, "flux"))
t.set_number_of_rays_fixed(600)
t.set_rng_seed(3)
assert t.apply().sum() > 0
from viennaray_tpu_torch.utils import materials
nodes, lines = fixtures.create_trench_line_mesh(0.5)
t = vrt.TraceLine(device="cpu")
t.set_geometry(vrt.LineMesh(nodes, lines, grid_delta=0.5),
               material_ids=materials.remap_material_ids([9] * 18 + [4] * 18)[0])
t.set_particle_type(vrt.DiffuseParticle(0.5, material_sticking=[0.5, 0.1]))
t.set_number_of_rays_fixed(600)
t.set_rng_seed(3)
assert t.apply().sum() > 0
t = vrt.TraceDisk(dim=3, device="cpu")
t.set_geometry(pts, nrm, 1.0)
t.set_particle_type(vrt.ConedCosineParticle(0.5, 0.5, 100.0))
t.set_number_of_rays_fixed(600)
assert t.apply().sum() > 0
from viennaray_tpu_torch import diff
from viennaray_tpu_torch.config import adjust_bounding_box
geo = vrt.DiskGeometry.build(pts, nrm, 1.0, device="cpu")
box = torch.tensor(adjust_bounding_box(geo.bbox.numpy(), vrt.TraceDirection.POS_Z,
                                       geo.disk_radius, 3), dtype=torch.float32)
config = vrt.TraceConfig(dim=3, ray_batch_size=256, roulette=False)
flux, grad = diff.flux_and_grad_sticking_batched(
    geo, vrt.RandomSource(bbox=box, cosine_power=1.0), vrt.DiffuseParticle(0.5),
    box, vrt.GeneratorRNG(3, "cpu"), 512, config, num_bounces=4, device="cpu")
assert flux.sum() > 0 and grad <= 0
from viennaray_tpu_torch import bench, parallel
from viennaray_tpu_torch.bench import flagship, grad_bench, perf_sweep
from viennaray_tpu_torch.examples import disk2D, sharded_trace, triangle3D
flux, totals = parallel.trace_sharded(
    geo, vrt.RandomSource(bbox=box, cosine_power=1.0), vrt.DiffuseParticle(0.5),
    box, config, vrt.GeneratorRNG(3, "cpu"), 512,
    parallel.make_ray_mesh(["cpu"] * 2))
assert flux.sum() > 0 and totals[2] > 0
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
    package = os.path.join(ROOT, "viennaray_tpu_torch")
    for module in ("geometry/triangle_geometry.py",
                   "geometry/line_geometry.py", "io/make_oracle_goldens.py",
                   "utils/materials.py", "csrc/tri_hit.cuh",
                   "csrc/line_hit.cuh", "csrc/prim_search.cuh",
                   "diff/trace_grad.py", "parallel/mesh.py",
                   "bench/perf_sweep.py", "examples/sharded_trace.py"):
        assert os.path.join(package, *module.split("/")) in files, module
    # ``viennaray_tpu`` not followed by ``_torch``, outside a path-like
    # mention in prose (docstrings name their counterpart as
    # ``viennaray_tpu/<module>``)
    jax_package = re.compile(r"viennaray_tpu(?!_torch)(?!/)")
    for path in files:
        with open(path) as f:
            text = f.read()
        for needle in ("import jax", "from jax", "import flax", "from flax"):
            assert needle not in text, (path, needle)
        assert not jax_package.search(text), path
