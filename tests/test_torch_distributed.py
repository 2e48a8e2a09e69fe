"""The port's sharded trace across processes: two gloo processes, each with
two CPU shards, against one process with one shard, bit for bit, in the
flux, the counters and the sticking gradient (the pattern of
``tests/test_distributed.py``); and, on a machine with four CUDA devices,
four NCCL processes (one card each) against one process on one card, at the
disk flagship's full width. The rendezvous is a file in the test's
temporary directory: no network.

On a GPU machine (which has no JAX, so without the repository's conftest):
``python -m pytest --noconftest -m cuda tests/test_torch_distributed.py -s``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import viennaray_tpu_torch as vrtt
from viennaray_tpu_torch.bench.common import device_record
from viennaray_tpu_torch.io import fixtures
from viennaray_tpu_torch.parallel import mesh as port_mesh

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TIMEOUT = 120

WORKER = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, {here!r})
from viennaray_tpu_torch.parallel import mesh as port_mesh
import test_torch_distributed as T

rank, world = int(sys.argv[1]), int(sys.argv[2])
port_mesh.initialize_distributed({device_type!r}, rank=rank,
                                 world_size=world, init_method={init!r})
devices = None if {device_type!r} == "cuda" else ["cpu"] * {shards}
out = T.run(port_mesh.make_ray_mesh(devices), {size!r})
np.savez({out!r} + f".{{rank}}.npz", **out)
torch.distributed.destroy_process_group()
"""

# size -> (grid delta, rays per point, batch, differentiable leg's rays)
SIZES = {"small": (1.0, 10, 512, 4 * 512),
         "flagship": (0.25, 2000, 1 << 20, 1 << 17)}


def problem(size, device):
    """The trench of disks (432 at grid delta 1.0, or the flagship's 2,993
    at 0.25), periodic walls, the random source; (geometry, source, bbox,
    config) on ``device``."""
    grid_delta, rays, batch, _ = SIZES[size]
    pts, nrm = fixtures.create_trench_grid_3d(grid_delta=grid_delta)
    geometry = vrtt.DiskGeometry.build(pts, nrm, grid_delta, dim=3,
                                       device=device)
    config = vrtt.TraceConfig(
        dim=3, num_rays_per_point=rays, ray_batch_size=batch,
        boundary_conditions=(vrtt.BoundaryCondition.PERIODIC,) * 3)
    source = vrtt.RandomSource.default(geometry, config)
    return geometry, source, source.bbox, config


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def run(mesh, size="small"):
    """The full trace (fused body, diffuse particle with sticking 0.2; a
    warm run, then a timed one) and the differentiable leg (loss =
    sum(flux^2), 4 bounces, roulette off) on ``mesh``; numpy arrays by
    name."""
    import time

    dev = mesh.devices[0]
    geometry, source, bbox, config = problem(size, dev)
    total = config.total_rays(geometry.num_primitives)
    for _ in range(2):
        sync()
        t0 = time.perf_counter()
        flux, counters = port_mesh.trace_sharded(
            geometry, source, vrtt.DiffuseParticle(0.2), bbox, config,
            vrtt.GeneratorRNG(21, dev), total, mesh)
        flux = flux.cpu().numpy()
        seconds = time.perf_counter() - t0
    sticking = torch.tensor(0.2, device=dev, requires_grad=True)
    particle = vrtt.DiffuseParticle(0.2).replace(sticking=sticking)
    grad_rays = SIZES[size][3]
    grad_config = config.__class__(**{**config.__dict__, "roulette": False,
                                      "ray_batch_size": grad_rays // 4})
    diff_flux, _ = port_mesh.trace_sharded(
        geometry, source, particle, bbox, grad_config,
        vrtt.GeneratorRNG(22, dev), grad_rays, mesh, differentiable=True,
        num_bounces=4)
    loss = (diff_flux * diff_flux).sum()
    loss.backward()
    return dict(flux=flux, counters=counters,
                diff_flux=diff_flux.detach().cpu().numpy(),
                loss=np.float64(loss.item()),
                grad=np.float32(sticking.grad.item()),
                num_rays=np.int64(total), seconds=np.float64(seconds))


def spawn(tmp_path, world, device_type, shards, size):
    """``world`` processes joined in one group, each running ``run`` on its
    mesh; their results by rank."""
    init = f"file://{tmp_path / 'rendezvous'}"
    out = str(tmp_path / "run")
    script = WORKER.format(here=HERE, init=init, out=out, shards=shards,
                           device_type=device_type, size=size)
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r),
                               str(world)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-4000:]}"
    return [dict(np.load(f"{out}.{r}.npz")) for r in range(world)]


def assert_equal_runs(got, want):
    """Every rank's results equal the one-process run's, bit for bit (the
    seconds aside)."""
    for r, result in enumerate(got):
        for key, value in want.items():
            if key != "seconds":
                np.testing.assert_array_equal(result[key], value,
                                              err_msg=f"rank {r}: {key}")


def test_two_gloo_processes_equal_one_process_bit_for_bit(tmp_path):
    """Two processes of two shards each (a 4-shard mesh over gloo) give what
    one process of one shard gives: flux, counters, the differentiable
    flux, the loss and d loss / d sticking, bit for bit, on both ranks."""
    got = spawn(tmp_path, 2, "cpu", 2, "small")
    want = run(port_mesh.make_ray_mesh(["cpu"]))
    assert want["flux"].sum() > 0 and np.isfinite(want["grad"])
    assert want["grad"] < 0
    assert_equal_runs(got, want)


FAKE_NVCC = """#!{python}
import sys, time
out = sys.argv[sys.argv.index("-o") + 1]
time.sleep(0.3)
with open(out, "w") as f:
    f.write(" ".join(sys.argv[1:]))
"""

BUILD_SCRIPT = """
import sys
from pathlib import Path
from viennaray_tpu_torch import _build
_build._build(Path(sys.argv[1]))
print("built" if _build.build_seconds else "found")
"""


def test_ranks_build_the_kernels_at_once_without_a_race(tmp_path):
    """Six processes start the kernels' first build at once into one empty
    directory, as the ranks of a sharded trace do (with a stand-in for
    ``nvcc`` that writes its ``-o`` file after a pause): one builds, the
    others wait on the lock and find the library; none fails, and no
    temporary directory is left. (Without the lock they shared one
    temporary directory, and the first to finish removed it under the
    others' link.) The build's log lies beside the library."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    target = tmp_path / "build" / "libkernels.so"
    env = dict(os.environ, PYTHONPATH=ROOT,
               PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_SCRIPT, str(target)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for _ in range(6)]
    outs = [p.communicate(timeout=TIMEOUT)[0].decode() for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert sorted(o.split()[-1] for o in outs) == ["built"] + ["found"] * 5
    assert target.exists() and "-shared" in target.read_text()
    assert sorted(p.name for p in target.parent.iterdir()) == [
        "kernels.lock", "libkernels.log", "libkernels.so"]


@pytest.mark.cuda
def test_four_nccl_processes_on_four_cards_equal_one_process(tmp_path):
    """Four processes over NCCL, one card each, on the disk flagship at full
    width (2,993 disks, 5,986,000 rays in sub-batches of 2^20; the
    differentiable leg at 2^17 rays) give what one process on one card
    gives, bit for bit, on every rank. Prints the seconds of a sharded
    apply beside the one-process apply's."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    got = spawn(tmp_path, 4, "cuda", 1, "flagship")
    want = run(port_mesh.make_ray_mesh(["cuda:0"]), "flagship")
    assert want["flux"].sum() > 0 and np.isfinite(want["grad"])
    assert_equal_runs(got, want)
    print(json.dumps({
        "nccl_processes": 4,
        "card": device_record(torch.device("cuda", 0)),
        "num_rays": int(want["num_rays"]),
        "seconds_four_processes": [float(g["seconds"]) for g in got],
        "seconds_one_process": float(want["seconds"]),
    }))
