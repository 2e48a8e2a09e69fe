"""User-facing tracers: ``TraceDisk``, ``TraceTriangle`` and ``TraceLine``.

Counterpart of ``viennaray_tpu/trace/tracer.py``. Mirrors the reference's
``Trace`` API surface (rayTrace.hpp:15-180, rayTraceDisk.hpp,
rayTraceTriangle.hpp, gpu/raygTraceLine.hpp) — setters for
particle, geometry, boundary conditions, ray counts, seeds; ``apply()`` runs
the trace; ``normalize_flux`` / ``smooth_flux`` post-process — over a loop of
mega-batches of rays (the analog of the 2^29-ray GPU launch clamp,
gpu/raygTrace.hpp:132-160).

A tracer runs on a CUDA device unless the caller asks for the CPU, and
through the fused bounce kernel unless the caller asks for the unfused body
(``fused=False``). With ``bounce_sort=True`` it resorts its lanes before
every launch on a geometry of 8 chunks or more (the JAX package's
per-bounce coherence resort, ``trace.kernel.resort_for``); by default it
does not (``trace.kernel.BOUNCE_SORT`` says why).

``apply``, ``set_geometry``, ``normalize_flux`` and ``smooth_flux`` are the
requests of ``utils.telemetry``: under a ``torch.profiler`` session each
records its spans (an apply's carry the change of
``trace.kernel.counters``, the particle's ``refl_kind`` and, under
``apply_particles``, its ``species``).
"""

from __future__ import annotations

import functools
import os
import time
from typing import Sequence

import numpy as np
import torch

from ..config import (
    BoundaryCondition,
    NormalizationType,
    TraceConfig,
    TraceDirection,
    get_trace_settings,
)
from ..data import DataLog, TraceInfo, TracingData
from ..device import resolve_device
from ..geometry.disk_geometry import DiskGeometry
from ..geometry.line_geometry import LineGeometry
from ..geometry.mesh import DiskMesh, LineMesh, TriangleMesh
from ..geometry.neighborhood import build_neighborhood
from ..geometry.triangle_geometry import TriangleGeometry
from ..physics.source import RandomSource, check_source, source_box
from ..rng import GeneratorRNG
from ..utils import telemetry
from . import postprocess
from .kernel import (
    BOUNCE_SORT, READ_FLUX, BatchCounters, check_supported, counters,
    host_read, trace_batch, with_deposit_tables,
)


def _request(name):
    """The method as a request of ``utils.telemetry`` named ``name``."""
    def wrap(method):
        @functools.wraps(method)
        def run(self, *args, **kwargs):
            with telemetry.request(name):
                return method(self, *args, **kwargs)
        return run
    return wrap


class _TraceBase:
    """Shared setter surface (ref: rayTrace.hpp:15-180)."""

    def __init__(self, dim: int = 3, device=None, dtype=torch.float32,
                 fused: bool = True, bounce_sort: bool = BOUNCE_SORT):
        if dtype != torch.float32:
            # as the JAX package's tracers (viennaray_tpu/trace/tracer.py)
            raise NotImplementedError(
                f"the tracers run float32 only (dtype={dtype}): float64 "
                "tracing runs through trace.kernel.trace_batch(fused=False) "
                "and diff.trace_flux on a geometry widened by "
                "to(torch.float64)")
        self._dim = dim
        self._fused = bool(fused)
        self._bounce_sort = bool(bounce_sort)
        self._device = resolve_device(device)
        self._particle = None
        self._custom_source = None
        self._boundary_conditions = tuple(
            BoundaryCondition.REFLECTIVE for _ in range(3)
        )
        self._source_direction = (
            TraceDirection.POS_Z if dim == 3 else TraceDirection.POS_Y
        )
        self._num_rays_per_point = 1000
        self._num_rays_fixed = 0
        self._max_reflections = 2**30
        self._max_boundary_hits = 1000
        self._rng_seed = 0
        self._use_random_seed = True
        self._primary_direction = None
        self._run_number = 1
        # mega-batch width: larger batches amortize the per-batch fixed costs
        # (source sampling and sort, the compaction ladder's narrow tail)
        self._ray_batch_size = 2**20
        self._use_wdist = False
        self._flux_model = "neighbor"
        self._accumulate_f64 = True
        self._print_progress = False
        self._local_data = TracingData()
        self._global_data = None
        self._info = TraceInfo()
        self._data_log = DataLog()
        self._hooks = dict(collision_fn=None, reflection_fn=None,
                           aux_init_fn=None, init_dir_fn=None, log_fn=None)
        self._last_source = None
        # the index of the species ``trace.multi.apply_particles`` runs, for
        # the ``apply`` span
        self._species = None
        self.geometry = None

    # -- setters (ref: rayTrace.hpp:34-121) -------------------------------
    def set_particle_type(self, particle):
        self._particle = particle

    def set_boundary_conditions(self, conds: Sequence[BoundaryCondition]):
        conds = tuple(BoundaryCondition(c) for c in conds)
        if len(conds) < self._dim:
            raise ValueError("One boundary condition per dimension required")
        padded = conds + tuple(
            BoundaryCondition.REFLECTIVE for _ in range(3 - len(conds))
        )
        self._boundary_conditions = padded[:3]

    def set_source(self, source):
        """A source in place of the default random source (ref:
        rayTrace.hpp:46-49): a ``RandomSource``, ``GridSource`` or
        ``SurfaceSource``, or any object whose ``sample(rng, batch_index, n,
        ray_indices)`` returns (origins (n, 3), directions (n, 3), weights
        (n,)) float32 on the tracer's device (``physics.source``); an object
        that cannot be called so is refused by name."""
        check_source(source)
        self._custom_source = source

    def reset_source(self):
        self._custom_source = None

    def set_number_of_rays_per_point(self, n: int):
        self._num_rays_per_point = int(n)
        self._num_rays_fixed = 0

    def set_number_of_rays_fixed(self, n: int):
        self._num_rays_fixed = int(n)
        self._num_rays_per_point = 0

    def set_max_reflections(self, n: int):
        self._max_reflections = int(n)

    def set_max_boundary_hits(self, n: int):
        self._max_boundary_hits = int(n)

    def set_source_direction(self, direction: TraceDirection):
        self._source_direction = TraceDirection(direction)

    def set_primary_direction(self, direction):
        d = np.asarray(direction, np.float64)
        d = d / np.linalg.norm(d)
        self._primary_direction = tuple(float(x) for x in d)

    def set_use_random_seeds(self, use: bool):
        self._use_random_seed = bool(use)

    def set_rng_seed(self, seed: int):
        self._rng_seed = int(seed)
        self._use_random_seed = False

    def set_ray_batch_size(self, n: int):
        self._ray_batch_size = int(n)

    def set_use_wdist(self, use: bool):
        """1/distance weighting of the disk neighbor deposits
        (VIENNARAY_USE_WDIST, ref: rayTraceKernel.hpp:258-296). It runs the
        unfused body, whatever ``fused`` says, as the reference does."""
        self._use_wdist = bool(use)

    def set_f64_accumulation(self, use: bool):
        """Sum the batches' fluxes in float64 (True, the default: the
        reference GPU build's double precision, normKernels.cu:5-9) or in
        float32 in batch order (False). A batch's own flux is float32 either
        way."""
        self._accumulate_f64 = bool(use)

    def set_flux_model(self, model: str):
        """Disk flux deposit model: "neighbor" (CPU reference contract,
        rayTraceKernel.hpp:255-300) or "window" (GPU candidate-window
        contract, GeneralPipelineDisk.cu:51-59). Triangles and lines ignore
        it."""
        if model not in ("neighbor", "window"):
            raise ValueError(f"unknown flux model {model!r}")
        self._flux_model = model

    def enable_progress_bar(self):
        """(ref: rayTrace.hpp:69) — prints one line per mega-batch."""
        self._print_progress = True

    def disable_progress_bar(self):
        self._print_progress = False

    def set_data_log_fn(self, fn):
        """The per-ray log hook (logData, rayUtil.hpp:49-63,
        rayTraceKernel.hpp:132): ``fn(rng, aux, ray_indices, valid)`` returns
        1-D tensors, summed over batches and applies into
        ``get_data_log().data`` as float64. The contract:
        ``trace.kernel.trace_batch``. None removes it."""
        self._hooks["log_fn"] = fn

    def set_custom_functions(self, collision_fn=None, reflection_fn=None,
                             aux_init_fn=None, init_dir_fn=None):
        """A custom particle's hooks (the reference's virtual dispatch and
        GPU callable table, rayParticle.hpp:43-66); each call sets all four,
        None for a hook not wanted. Their signatures, the ``rng`` handle they
        draw from and how to deposit: the hook contract in
        ``trace.kernel.trace_batch``'s docstring. ``collision_fn``,
        ``reflection_fn`` and ``aux_init_fn`` run the unfused body."""
        self._hooks.update(collision_fn=collision_fn,
                           reflection_fn=reflection_fn,
                           aux_init_fn=aux_init_fn, init_dir_fn=init_dir_fn)

    # -- data access (ref: rayTrace.hpp:135-145) ---------------------------
    def get_local_data(self) -> TracingData:
        return self._local_data

    def set_global_data(self, data: TracingData):
        self._global_data = data

    def get_global_data(self):
        return self._global_data

    def get_ray_trace_info(self) -> TraceInfo:
        return self._info

    def get_data_log(self) -> DataLog:
        return self._data_log

    # -- shared internals ---------------------------------------------------
    def _make_config(self) -> TraceConfig:
        return TraceConfig(
            dim=self._dim,
            num_rays_per_point=self._num_rays_per_point,
            num_rays_fixed=self._num_rays_fixed,
            max_reflections=self._max_reflections,
            max_boundary_hits=self._max_boundary_hits,
            rng_seed=self._rng_seed,
            use_random_seed=self._use_random_seed,
            source_direction=self._source_direction,
            boundary_conditions=self._boundary_conditions,
            primary_direction=self._primary_direction,
            ray_batch_size=self._ray_batch_size,
            use_wdist=self._use_wdist,
            flux_model=self._flux_model,
        )

    def _base_seed(self) -> int:
        if self._use_random_seed:
            return int.from_bytes(os.urandom(4), "little")
        # (ref: rayTraceKernel.hpp:100 seed = runNumber + rngSeed)
        return (self._rng_seed + self._run_number) & 0xFFFFFFFF

    def _run_trace(self, geometry, request, before=None):
        """The apply's mega-batches; ``request``: the apply's span, which
        takes the rays, the batches, the primitives and the change of every
        counter of ``trace.kernel.counters`` as attributes, from ``before``
        (the counters at the apply's entry, where it worked before the
        trace) or from here."""
        config = self._make_config()
        n_prims = geometry.num_primitives
        total_rays = config.total_rays(n_prims)
        adjusted = source_box(geometry, config)

        if self._custom_source is not None:
            source = self._custom_source
        else:
            source = RandomSource.default(
                geometry, config, self._particle.cosine_exponent)
        check_supported(config, self._particle, source,
                        self._hooks["collision_fn"])
        self._last_source = source

        dev = self._device
        rng = GeneratorRNG(self._base_seed(), dev)
        bbox_dev = torch.tensor(adjusted, dtype=torch.float32, device=dev)

        # clamp the batch to the next power of two >= the ray count (floor
        # 512) so small runs don't trace a mostly-dead mega-batch
        batch = min(
            config.ray_batch_size,
            max(512, 1 << (max(total_rays, 2) - 1).bit_length()),
        )
        num_batches = max(1, -(-total_rays // batch))
        # Cross-batch flux accumulation in float64 by default (the reference
        # GPU build defaults to double precision, normKernels.cu:5-9): an
        # H100 adds float64 natively, so a plain float64 tensor does what the
        # JAX package's compensated (Kahan) float32 pair stood in for on the
        # TPU. set_f64_accumulation(False): float32, in batch order.
        acc_dtype = torch.float64 if self._accumulate_f64 else torch.float32
        # a collision_fn fills one channel per data label
        # (ref: tracer.py:324-330)
        n_chan = (len(self._particle.data_labels)
                  if self._hooks["collision_fn"] is not None else 1)
        flux_shape = (n_chan, n_prims) if n_chan > 1 else (n_prims,)
        flux = torch.zeros(flux_shape, dtype=acc_dtype, device=dev)
        totals = np.zeros(len(BatchCounters._fields), np.int64)
        if before is None and request.on:
            before = counters()

        t0 = time.perf_counter()
        for b in range(num_batches):
            with telemetry.span("batch", index=b, width=batch):
                ray_indices = torch.arange(
                    b * batch, (b + 1) * batch, dtype=torch.int64, device=dev
                )
                valid = ray_indices < total_rays
                rng.begin_batch(b)
                out = trace_batch(
                    geometry, source, self._particle, bbox_dev, rng, b,
                    ray_indices, valid, config, fused=self._fused,
                    bounce_sort=self._bounce_sort, **self._hooks,
                )
                batch_flux, batch_counters = out[:2]
                flux += batch_flux.to(acc_dtype)
                totals += np.asarray(batch_counters, np.int64)
                if len(out) == 3:
                    self._add_logs(out[2])
            if self._print_progress:
                print(
                    f"viennaray-tpu-torch: batch {b + 1}/{num_batches} "
                    f"({min((b + 1) * batch, total_rays)}/{total_rays} rays)",
                    flush=True,
                )
        with host_read(READ_FLUX):  # waits for the device
            out = flux.double().cpu().numpy()
        elapsed = time.perf_counter() - t0
        if request.on:
            after = counters()
            request.set(rays=total_rays, batches=num_batches, prims=n_prims,
                        run=self._run_number,
                        refl_kind=int(self._particle.reflection_kind),
                        **{k: after[k] - before[k] for k in after})
            if self._species is not None:
                request.set(species=self._species)

        c = BatchCounters(*(int(v) for v in totals))
        self._info = TraceInfo(
            num_rays=total_rays,
            total_rays_traced=c.total_traces,
            non_geometry_hits=c.non_geometry_hits,
            geometry_hits=c.geometry_hits,
            particle_hits=c.particle_hits,
            boundary_hits=c.boundary_hits,
            reflections=c.reflections,
            time=elapsed,
            chunks_swept=c.chunks_swept,
            chunks_deposited=c.chunks_deposited,
            tile_bounces=c.tile_bounces,
        )
        self._run_number += 1  # (ref: rayTraceDisk.hpp:54)
        return out

    def _add_logs(self, logs):
        """Sum one batch's log rows into the DataLog, as float64 (ref:
        tracer.py:360-369): the first rows start it, later batches and
        applies add."""
        rows = [torch.as_tensor(r).detach().cpu().numpy().astype(np.float64)
                for r in logs]
        if not self._data_log.data:
            self._data_log.data = rows
        else:
            for j, r in enumerate(rows):
                self._data_log.data[j] = self._data_log.data[j] + r

    def _store_local_data(self, flux):
        """Accumulate the flux into the particle's labelled channels;
        channels are keyed by label so runs of different particles on one
        tracer keep separate flux rows (the GPU tracer's species x label
        buffer, gpu/raygTrace.hpp:97-99). An (L, N) flux, from a
        collision_fn, gives channel i to label i (rayParticle.hpp:60-66); an
        (N,) flux fills the first label and every other label takes zeros,
        as in the reference (viennaray_tpu/trace/tracer.py:_store_local_data)."""
        labels = self._particle.data_labels
        if flux.ndim == 2:
            rows = list(flux)
        else:
            rows = [flux] + [np.zeros_like(flux) for _ in labels[1:]]
        for label, row in zip(labels, rows):
            try:
                idx = self._local_data.get_vector_data_index(label)
            except KeyError:
                idx = self._local_data.add_vector_data(len(row), label)
            self._local_data.accumulate_vector(idx, row)


class TraceDisk(_TraceBase):
    """Oriented-disk tracer (ref: rayTraceDisk.hpp)."""

    def set_geometry(self, points, normals=None, grid_delta=None,
                     disk_radius=None):
        with telemetry.request("set_geometry") as req:
            if isinstance(points, DiskMesh):
                self.geometry = DiskGeometry.from_mesh(
                    points, dim=self._dim, device=self._device
                )
            else:
                self.geometry = DiskGeometry.build(
                    points, normals, grid_delta, dim=self._dim,
                    disk_radius=disk_radius, device=self._device,
                )
            req.set(primitives=self.geometry.num_primitives)

    def set_material_ids(self, material_ids):
        self.geometry = self.geometry.replace(
            material_ids=torch.from_numpy(
                np.asarray(material_ids, np.int32)
            ).to(self._device)
        )

    def apply(self):
        """Run the trace (ref: rayTraceDisk.hpp:19-57); returns the raw flux
        per disk as a float64 numpy array, (L, N) for a ``collision_fn`` and
        a particle of L > 1 data labels."""
        with telemetry.request("apply") as req:
            self._check_settings()
            before = counters() if req.on else None
            settings = get_trace_settings(self._source_direction)
            # the areas are computed on the first apply after a change of
            # the geometry or the walls, and reused on the others
            self.geometry = self.geometry.with_areas(
                (settings[1], settings[2]), self._boundary_conditions
            )
            self.geometry = with_deposit_tables(self.geometry,
                                                self._make_config())
            flux = self._run_trace(self.geometry, req, before)
            self._store_local_data(flux)
        return flux

    @_request("normalize")
    def normalize_flux(self, flux, norm: NormalizationType = NormalizationType.SOURCE):
        """(ref: rayTraceDisk.hpp:103-142)"""
        flux = torch.as_tensor(
            np.asarray(flux, np.float32), device=self._device
        )
        areas = self.geometry.areas
        if NormalizationType(norm) == NormalizationType.MAX:
            out = postprocess.normalize_flux_max_disk(
                flux, areas, self.geometry.disk_radius
            )
        else:
            config = self._make_config()
            total = config.total_rays(self.geometry.num_primitives)
            out = postprocess.normalize_flux_source(
                flux, areas, self._last_source.source_area(), total
            )
        return out.cpu().numpy()

    @_request("smooth")
    def smooth_flux(self, flux, num_neighbors: int = 1):
        """(ref: rayTraceDisk.hpp:146-193)"""
        if num_neighbors < 1:
            return np.asarray(flux)
        if num_neighbors == 1:
            neighbors = self.geometry.neighbors
        else:
            # on the geometry's device: on the card where it is CUDA
            nbrs, _ = build_neighborhood(
                self.geometry.points,
                num_neighbors * 2.0 * self.geometry.disk_radius,
                dim=3,  # (ref: rayTraceDisk.hpp:169 always inits 3D here)
            )
            neighbors = torch.as_tensor(nbrs, device=self._device)
        out = postprocess.smooth_flux(
            torch.as_tensor(np.asarray(flux, np.float32), device=self._device),
            self.geometry.normals, neighbors,
        )
        return out.cpu().numpy()

    def _check_settings(self):
        if self._particle is None:
            self._info.error = True
            raise ValueError("No particle was specified in TraceDisk")
        if self.geometry is None:
            self._info.error = True
            raise ValueError("No geometry was passed to TraceDisk")
        if self.geometry.device != self._device:
            raise ValueError(
                f"geometry is on {self.geometry.device}, the tracer on "
                f"{self._device}"
            )
        if self.geometry.disk_radius > self.geometry.grid_delta:
            self._info.warning = True


class TraceTriangle(_TraceBase):
    """Triangle-mesh tracer (ref: rayTraceTriangle.hpp)."""

    def set_geometry(self, mesh_or_points, triangles=None, grid_delta=None):
        if isinstance(mesh_or_points, LineMesh) and self._dim != 2:
            raise ValueError("Line geometry is only supported in 2D")
        with telemetry.request("set_geometry") as req:
            if isinstance(mesh_or_points, TriangleMesh):
                self.geometry = TriangleGeometry.from_mesh(
                    mesh_or_points, dim=self._dim, device=self._device
                )
            elif isinstance(mesh_or_points, LineMesh):
                self.geometry = TriangleGeometry.from_line_mesh(
                    mesh_or_points, device=self._device
                )
            else:
                self.geometry = TriangleGeometry.build(
                    mesh_or_points, triangles, grid_delta, dim=self._dim,
                    device=self._device,
                )
            req.set(primitives=self.geometry.num_primitives)

    def set_material_ids(self, material_ids):
        self.geometry = self.geometry.replace(
            material_ids=torch.from_numpy(
                np.asarray(material_ids, np.int32)
            ).to(self._device)
        )

    def apply(self):
        """Run the trace (ref: rayTraceTriangle.hpp:19-61); returns the raw
        flux per triangle as a float64 numpy array, (L, N) for a
        ``collision_fn`` and a particle of L > 1 data labels."""
        if self._particle is None:
            self._info.error = True
            raise ValueError("No particle was specified in TraceTriangle")
        if self.geometry is None:
            self._info.error = True
            raise ValueError("No geometry was passed to TraceTriangle")
        if self.geometry.device != self._device:
            raise ValueError(
                f"geometry is on {self.geometry.device}, the tracer on "
                f"{self._device}"
            )
        with telemetry.request("apply") as req:
            flux = self._run_trace(self.geometry, req)
            self._store_local_data(flux)
        return flux

    @_request("normalize")
    def normalize_flux(self, flux, norm: NormalizationType = NormalizationType.SOURCE):
        """(ref: rayTraceTriangle.hpp:92-130)"""
        flux = torch.as_tensor(
            np.asarray(flux, np.float32), device=self._device
        )
        areas = self.geometry.areas
        if NormalizationType(norm) == NormalizationType.MAX:
            out = postprocess.normalize_flux_max_triangle(flux, areas)
        else:
            config = self._make_config()
            total = config.total_rays(self.geometry.num_primitives)
            out = postprocess.normalize_flux_source(
                flux, areas, self._last_source.source_area(), total
            )
        return out.cpu().numpy()

    @_request("smooth")
    def smooth_flux(self, flux, num_neighbors: int = 1):
        """No-op for element meshes (ref: rayTraceTriangle.hpp:134-136)."""
        return np.asarray(flux)


class TraceLine(_TraceBase):
    """Native 2D line-segment tracer — parity with the GPU-only
    ``gpu::TraceLine`` (gpu/raygTraceLine.hpp): segments are primitives (no
    triangle extrusion), flux is per segment, areas are segment lengths,
    smoothing is not implemented."""

    def __init__(self, device=None, dtype=torch.float32, fused: bool = True,
                 bounce_sort: bool = BOUNCE_SORT):
        super().__init__(dim=2, device=device, dtype=dtype, fused=fused,
                         bounce_sort=bounce_sort)

    def set_geometry(self, mesh: LineMesh, material_ids=None):
        with telemetry.request("set_geometry") as req:
            self.geometry = LineGeometry.from_mesh(
                mesh, material_ids=material_ids, device=self._device
            )
            req.set(primitives=self.geometry.num_primitives)

    def set_material_ids(self, material_ids):
        self.geometry = self.geometry.replace(
            material_ids=torch.from_numpy(
                np.asarray(material_ids, np.int32)
            ).to(self._device)
        )

    def apply(self):
        """Run the trace; returns the raw flux per segment as a float64
        numpy array, (L, N) for a ``collision_fn`` and a particle of L > 1
        data labels."""
        if self._particle is None:
            self._info.error = True
            raise ValueError("No particle was specified in TraceLine")
        if self.geometry is None:
            self._info.error = True
            raise ValueError("No geometry was passed to TraceLine")
        if self.geometry.device != self._device:
            raise ValueError(
                f"geometry is on {self.geometry.device}, the tracer on "
                f"{self._device}"
            )
        with telemetry.request("apply") as req:
            flux = self._run_trace(self.geometry, req)
            self._store_local_data(flux)
        return flux

    @_request("normalize")
    def normalize_flux(self, flux, norm: NormalizationType = NormalizationType.SOURCE):
        """flux *= sourceArea/(length * numRays)
        (ref: gpu/raygTraceLine.hpp:29-58, normKernels.cu line variant)."""
        flux = torch.as_tensor(
            np.asarray(flux, np.float32), device=self._device
        )
        areas = self.geometry.areas
        if NormalizationType(norm) == NormalizationType.MAX:
            out = postprocess.normalize_flux_max_triangle(flux, areas)
        else:
            config = self._make_config()
            total = config.total_rays(self.geometry.num_primitives)
            out = postprocess.normalize_flux_source(
                flux, areas, self._last_source.source_area(), total
            )
        return out.cpu().numpy()

    @_request("smooth")
    def smooth_flux(self, flux, num_neighbors: int = 1):
        """Not implemented for line geometry (ref: raygTraceLine.hpp:26-28)."""
        return np.asarray(flux)
