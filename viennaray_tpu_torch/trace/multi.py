"""Multi-particle (species) tracing.

Counterpart of ``viennaray_tpu/trace/multi.py``. The reference GPU tracer
launches one pipeline per particle species with a species x label flux buffer
(gpu/raygTrace.hpp:97-99, 228-248). Here each species is one ``apply()`` of
the same tracer, in order, so each keeps its own counters (the reference's
per-launch bookkeeping) and its own run number, and its labelled channels
land in the tracer's ``TracingData``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..data import TraceInfo


def apply_particles(tracer, particles: Sequence) -> Tuple[np.ndarray, List[TraceInfo]]:
    """Run ``tracer.apply()`` once per species.

    tracer: a ``TraceDisk``, ``TraceTriangle`` or ``TraceLine`` with its
    geometry and settings configured; each species runs the tracer's body
    and per-bounce resort (its ``fused`` and ``bounce_sort``). Returns
    (flux (S, N) float64, one ``TraceInfo`` per species); each species'
    labelled channels also accumulate into the tracer's ``TracingData``.
    """
    fluxes = []
    infos = []
    for particle in particles:
        tracer.set_particle_type(particle)
        fluxes.append(np.asarray(tracer.apply()))
        infos.append(tracer.get_ray_trace_info())
    return np.stack(fluxes), infos
