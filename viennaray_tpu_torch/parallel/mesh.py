"""Ray sharding over devices and processes.

Counterpart of ``viennaray_tpu/parallel/mesh.py`` on ``torch.distributed``.
The JAX package lays a 1-D mesh over the ``rays`` axis, traces each device's
sub-batch under ``shard_map`` against the replicated geometry, keys each
shard's numbers by its global sub-batch index and reduces flux and counters
with ``psum``. Here:

- a ``RayMesh`` holds this process's shards, all on its one device, and,
  when one is initialised, the default process group
  (``initialize_distributed``). Shard s of the process of rank r has the
  global index r L + s, L the process's shard count; the mesh has world
  size x L shards. Several shards on one device (``["cpu"] * 8``,
  ``["cuda:0"] * 4``) mirror the JAX tests' virtual CPU devices; shards on
  several devices are several processes, one per device;
- shard g of a mega-batch that starts at global sub-batch ``start`` traces
  the port's ``trace_batch`` with batch index ``start + g`` after
  ``rng.begin_batch(start + g)``, on the g-th block of the mega-batch's ray
  indices (the JAX package's ``P("rays")`` slicing) — exactly the batch
  that the single-device tracer traces under that index;
- a process's shards run one after another; the ranks' batch fluxes and
  counters are gathered (``all_gather``) and summed in global sub-batch
  order, the fluxes into the tracer's accumulation type (float64, or
  float32 with ``accumulate_f64=False``, the tracer's
  ``set_f64_accumulation``), the counters as int64. A ring all-reduce would
  sum in another order.

So flux and counters are bit for bit the same for every shard count and
every world size, and equal to the tracer's accumulated flux wherever its
batch clamp (``trace/tracer.py:_run_trace``: the batch shrinks to the next
power of two of a small ray count) does not bind. The JAX package's
``trace_sharded`` adds its psum'd fluxes in float32; the port keeps the
tracer's float64 sum.

The differentiable trace (``differentiable=True``) sums the shards' fluxes
under autograd through ``_ShardedFlux``: a plain ``all_gather`` would drop
the gradient. Each shard traces on its own copies of the tensors that
require a gradient; the backward computes each shard's gradient from the
gradient of the summed flux (the same on every rank, as every rank holds
the same sum), gathers them and sums them in global sub-batch order. So the
gradients too are bit for bit the same for every shard count and world
size.

The tracers never import this module; it is an entry point of its own.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import TraceConfig
from ..trace.kernel import BOUNCE_SORT, trace_batch, with_deposit_tables

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def initialize_distributed(device_type: str = "cuda", **kwargs):
    """Join this process to the default process group
    (``torch.distributed.init_process_group(**kwargs)``), over NCCL for a
    CUDA mesh and gloo for a CPU mesh, and no other: a ``backend`` in
    ``kwargs`` is refused, and a CUDA mesh without NCCL raises rather than
    fall back to gloo. On a CUDA mesh the process's current device becomes
    ``cuda:<LOCAL_RANK>`` (else rank modulo the device count).

    ``rank`` and ``world_size`` default to 0 and 1. The rendezvous needs no
    network: one process alone meets in an in-memory store; several need
    ``init_method`` (``"tcp://127.0.0.1:<port>"`` or ``"file://<path>"``) or
    a ``store`` from the caller."""
    if device_type not in BACKENDS:
        raise ValueError(f"a ray mesh runs on 'cuda' or 'cpu', not "
                         f"{device_type!r}")
    if "backend" in kwargs:
        raise ValueError(f"a {device_type} mesh runs over "
                         f"{BACKENDS[device_type]}; no backend is chosen")
    backend = BACKENDS[device_type]
    rank = int(kwargs.pop("rank", 0))
    world_size = int(kwargs.pop("world_size", 1))
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh needs a CUDA device and found none")
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA mesh runs over NCCL, which this "
                               "torch build does not have")
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    if "init_method" not in kwargs and "store" not in kwargs:
        if world_size != 1:
            raise ValueError(
                "several processes need an init_method ('tcp://127.0.0.1:"
                "<port>' or 'file://<path>') or a store")
        kwargs["store"] = dist.HashStore()
    dist.init_process_group(backend, rank=rank, world_size=world_size,
                            **kwargs)


@dataclasses.dataclass(frozen=True)
class RayMesh:
    """The shards of this process (``devices``, its one device named once
    per shard) and the process group they reduce over (``None`` outside
    one)."""

    devices: Tuple[torch.device, ...]
    group: Optional[object] = None

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def world_size(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def local_size(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        """The global shard count: world size x local shards."""
        return self.world_size * self.local_size

    def shard_index(self, local: int) -> int:
        """The global index of this process's ``local``-th shard."""
        return self.rank * self.local_size + local


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_ray_mesh(devices=None) -> RayMesh:
    """The 1-D mesh over the ray axis: this process's shard ``devices``,
    one device named once per shard (``None``: one shard on
    ``cuda:<LOCAL_RANK>``, else the rank modulo the device count; without a
    CUDA device this raises), over the default process group when one is
    initialised. A process traces on one device, as it holds one copy of the
    geometry: shards on several devices are several processes. Every process
    of a group names as many shards, and the group's backend is the mesh's:
    NCCL for CUDA shards, gloo for CPU shards."""
    group = dist.group.WORLD if dist.is_initialized() else None
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_ray_mesh() shards over CUDA devices and found none; "
                "name the devices, e.g. ['cpu'] * 8")
        rank = 0 if group is None else dist.get_rank()
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        devices = [torch.device("cuda", local)]
    devices = tuple(_device(d) for d in devices)
    if len(set(devices)) != 1:
        raise ValueError(f"the shards of one process lie on one device, not "
                         f"{sorted(set(map(str, devices)))}: run a process "
                         f"per device")
    if group is not None and dist.get_backend() != BACKENDS.get(
            devices[0].type):
        raise ValueError(f"a {devices[0].type} mesh runs over "
                         f"{BACKENDS.get(devices[0].type)}, not over the "
                         f"group's {dist.get_backend()}")
    return RayMesh(devices=devices, group=group)


def _gather(t, mesh: RayMesh):
    """(world size, *t.shape): every rank's ``t`` in rank order, on ``t``'s
    device (``t[None]`` outside a process group)."""
    if mesh.group is None:
        return t[None]
    comm = (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend(mesh.group) == "nccl"
            else torch.device("cpu"))
    x = t.detach().to(comm).contiguous()
    out = [torch.empty_like(x) for _ in range(mesh.world_size)]
    dist.all_gather(out, x, group=mesh.group)
    return torch.stack(out).to(t.device)


def _grad_leaves(problem):
    """[(name, field or None, tensor)] of the problem's tensors that require
    a gradient: ``bbox`` itself, or a tensor field of the geometry, source
    or particle."""
    out = []
    for name, obj in problem.items():
        if torch.is_tensor(obj):
            if obj.requires_grad:
                out.append((name, None, obj))
        elif dataclasses.is_dataclass(obj):
            for f in dataclasses.fields(obj):
                v = getattr(obj, f.name)
                if torch.is_tensor(v) and v.requires_grad:
                    out.append((name, f.name, v))
    return out


def _with_leaves(problem, leaves, values):
    """The problem with each leaf replaced by its value."""
    problem = dict(problem)
    for (name, field, _), v in zip(leaves, values):
        problem[name] = (v if field is None
                         else dataclasses.replace(problem[name], **{field: v}))
    return problem


def _shards(mesh: RayMesh, megabatches):
    """(mega-batch position, local shard, global sub-batch, ray indices,
    valid) of every shard this process traces, mega-batch major."""
    n = mesh.size
    for b, (start, ray_indices, valid) in enumerate(megabatches):
        if ray_indices.shape[0] % n:
            raise ValueError(f"{ray_indices.shape[0]} rays do not split into "
                             f"{n} shards")
        per = ray_indices.shape[0] // n
        for s in range(mesh.local_size):
            g = mesh.shard_index(s)
            yield (b, s, start + g, ray_indices[g * per:(g + 1) * per],
                   valid[g * per:(g + 1) * per])


class _Run:
    """One sharded run on this process's device: how each shard traces, and
    how the shards' results are gathered and summed."""

    def __init__(self, problem, rng, config, mesh, megabatches, fused,
                 differentiable, num_bounces, acc_dtype, bounce_sort):
        self.problem = problem
        self.rng = rng
        self.config = config
        self.mesh = mesh
        self.megabatches = megabatches
        self.fused = fused
        self.bounce_sort = bounce_sort
        self.differentiable = differentiable
        self.num_bounces = num_bounces
        self.acc_dtype = acc_dtype
        self.home = mesh.devices[0]
        if problem["geometry"].device != self.home:
            raise ValueError(f"the geometry is on {problem['geometry'].device}"
                             f", the mesh's shards on {self.home}")

    def trace(self, problem, g, ray_indices, valid):
        """(flux, counters) of global sub-batch ``g``."""
        self.rng.begin_batch(g)
        return trace_batch(
            problem["geometry"], problem["source"], problem["particle"],
            problem["bbox"], self.rng, g, ray_indices.to(self.home),
            valid.to(self.home), self.config, fused=self.fused,
            differentiable=self.differentiable, num_bounces=self.num_bounces,
            bounce_sort=self.bounce_sort,
        )[:2]

    def reduce(self, local):
        """Gather the (n_mega, L, ...) local tensor over the ranks and return
        its rows in global sub-batch order: mega-batch, rank, shard."""
        every = _gather(local, self.mesh)  # (world, n_mega, L, ...)
        return [every[r, b, s]
                for b in range(every.shape[1])
                for r in range(every.shape[0])
                for s in range(every.shape[2])]

    def sum_flux(self, fluxes):
        """The fluxes (n_mega, L, N) summed in global order into the
        accumulation type, as the tracer sums its batches."""
        acc = None
        for f in self.reduce(fluxes):
            if acc is None:
                acc = torch.zeros(f.shape, dtype=self.acc_dtype,
                                  device=self.home)
            acc += f.to(self.acc_dtype)
        return acc

    def sum_counters(self, counters):
        return torch.stack(self.reduce(counters)).sum(dim=0).cpu().numpy()

    def stack(self, rows):
        """(n_mega, L, ...) on the home device from the shards' rows."""
        n_mega, L = len(self.megabatches), self.mesh.local_size
        out = torch.stack(rows)
        return out.reshape(n_mega, L, *out.shape[1:])


class _ShardedFlux(torch.autograd.Function):
    """The differentiable sharded flux: forward traces every shard on its
    own copies of the leaves and sums the fluxes in global order; backward
    computes each shard's leaf gradients from the summed flux's gradient,
    gathers them and sums them in global order."""

    @staticmethod
    def forward(ctx, run, leaves, *values):
        fluxes, counters, graphs = [], [], []
        with torch.enable_grad():
            for _, _, g, idx, valid in _shards(run.mesh, run.megabatches):
                own = [v.detach().requires_grad_(True) for v in values]
                problem = _with_leaves(run.problem, leaves, own)
                flux, c = run.trace(problem, g, idx, valid)
                graphs.append((flux, own))
                fluxes.append(flux.detach())
                counters.append(torch.tensor(c, dtype=torch.int64))
        ctx.run, ctx.graphs = run, graphs
        ctx.values = [(v.shape, v.dtype, v.device) for v in values]
        run.counters = run.sum_counters(run.stack(counters))
        return run.sum_flux(run.stack(fluxes))

    @staticmethod
    def backward(ctx, grad_acc):
        run = ctx.run
        rows = []
        for flux, own in ctx.graphs:
            grads = (None,) * len(own)
            if flux.requires_grad:
                grads = torch.autograd.grad(
                    flux, own, grad_acc.to(flux.device, flux.dtype),
                    allow_unused=True)
            rows.append(torch.cat([
                (torch.zeros_like(o) if gr is None else gr).reshape(-1)
                .to(run.home) for o, gr in zip(own, grads)]))
        total = None
        for row in run.reduce(run.stack(rows)):
            total = row if total is None else total + row
        out, at = [], 0
        for shape, dtype, device in ctx.values:
            size = int(np.prod(shape))
            out.append(total[at:at + size].reshape(shape).to(device, dtype))
            at += size
        ctx.graphs = None
        return (None, None, *out)


def _sharded(geometry, source, particle, bbox, rng, config, mesh,
             megabatches, fused, differentiable, num_bounces,
             accumulate_f64, bounce_sort):
    """(flux, counters as an int64 array in ``BatchCounters`` order) of the
    given mega-batches [(first global sub-batch, ray indices, valid)]."""
    acc_dtype = torch.float64 if accumulate_f64 else torch.float32
    # gathered once here, not by every shard's trace_batch
    geometry = with_deposit_tables(geometry, config)
    problem = dict(geometry=geometry, source=source, particle=particle,
                   bbox=bbox)
    run = _Run(problem, rng, config, mesh, megabatches, fused,
               differentiable, num_bounces, acc_dtype, bounce_sort)
    if differentiable:
        leaves = _grad_leaves(problem)
        flux = _ShardedFlux.apply(run, leaves, *(v for _, _, v in leaves))
        return flux, run.counters
    fluxes, counters = [], []
    for _, _, g, idx, valid in _shards(mesh, megabatches):
        flux, c = run.trace(run.problem, g, idx, valid)
        fluxes.append(flux)
        counters.append(torch.tensor(c, dtype=torch.int64))
    return run.sum_flux(run.stack(fluxes)), run.sum_counters(
        run.stack(counters))


def trace_batch_sharded(
    geometry,
    source,
    particle,
    bbox,
    rng,
    ray_indices,
    valid,
    config: TraceConfig,
    mesh: RayMesh,
    differentiable: bool = False,
    num_bounces: Optional[int] = None,
    sub_batch_start: int = 0,
    fused: bool = True,
    accumulate_f64: bool = True,
    bounce_sort: bool = BOUNCE_SORT,
):
    """Trace one global mega-batch sharded over the mesh.

    ``ray_indices`` / ``valid``: (R,) global ray indices and live lanes,
    R divisible by the mesh's shard count; every process passes the same.
    The other arguments are the port's ``trace_batch``'s (``rng`` a
    ``RayRNG`` on this process's shard device; ``fused`` and
    ``bounce_sort``, the per-bounce resort, off by default, as there).

    RNG contract (``viennaray_tpu/parallel/mesh.py:66-72``): shard g runs
    ``rng.begin_batch(sub_batch_start + g)`` and ``trace_batch`` with that
    batch index, so it reproduces exactly the numbers the single-device
    tracer draws for that batch.

    Returns (flux (N,) in float64, or float32 with ``accumulate_f64=False``,
    on the mesh's first local device, the same on every rank; counters, an
    int64 array in ``BatchCounters`` field order). With ``differentiable``
    the flux carries the gradient of every tensor of the geometry, source,
    particle or bbox that requires one (``num_bounces`` as in
    ``trace_batch``)."""
    ray_indices = torch.as_tensor(ray_indices)
    valid = torch.as_tensor(valid)
    return _sharded(geometry, source, particle, bbox, rng, config, mesh,
                    [(int(sub_batch_start), ray_indices, valid)], fused,
                    differentiable, num_bounces, accumulate_f64, bounce_sort)


def trace_sharded(
    geometry,
    source,
    particle,
    bbox,
    config: TraceConfig,
    rng,
    total_rays: int,
    mesh: RayMesh,
    differentiable: bool = False,
    num_bounces: Optional[int] = None,
    fused: bool = True,
    accumulate_f64: bool = True,
    bounce_sort: bool = BOUNCE_SORT,
):
    """The whole sharded trace: mega-batches of ``config.ray_batch_size`` x
    the mesh's shard count rays, ``valid`` masking the last one. Mega-batch
    b starts at global sub-batch b n (``trace_batch_sharded``'s contract),
    so shard g of it traces the single-device tracer's batch b n + g.

    ``rng`` takes the place of the JAX package's base key (the tracer's is
    ``GeneratorRNG(seed, device)``). ``differentiable`` / ``num_bounces``
    (not in the JAX package's ``trace_sharded``, whose differentiable leg
    is one mega-batch): every mega-batch's shards summed under one autograd
    node, so the gradient too is the same for every shard count.

    Returns (flux (N,) tensor, counters int64 array), as
    ``trace_batch_sharded``."""
    per_batch = config.ray_batch_size * mesh.size
    num_batches = max(1, -(-int(total_rays) // per_batch))
    megabatches = []
    for b in range(num_batches):
        ray_indices = torch.arange(b * per_batch, (b + 1) * per_batch,
                                   dtype=torch.int64, device=mesh.devices[0])
        megabatches.append((b * mesh.size, ray_indices,
                            ray_indices < total_rays))
    return _sharded(geometry, source, particle, bbox, rng, config, mesh,
                    megabatches, fused, differentiable, num_bounces,
                    accumulate_f64, bounce_sort)


__all__ = [
    "RayMesh",
    "initialize_distributed",
    "make_ray_mesh",
    "trace_batch_sharded",
    "trace_sharded",
]
