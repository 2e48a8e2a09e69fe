"""Tracing data containers and run statistics.

Counterpart of ``viennaray_tpu/data.py`` (host-side numpy, kept as a copy).
Ports of:
- ``TracingData``  (rayTracingData.hpp) — named scalar/vector channels with
  SUM/APPEND/AVERAGE merge semantics. This host-side container keeps the
  label/merge bookkeeping and accumulates across ``apply()`` runs.
- ``TraceInfo``    (rayUtil.hpp:65-76) — per-run counters.
- ``DataLog``      (rayUtil.hpp:49-63) — additive user log matrix.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List

import numpy as np


class MergeType(enum.IntEnum):
    """(ref: rayTracingData.hpp:10-14)"""

    SUM = 0
    APPEND = 1
    AVERAGE = 2


@dataclasses.dataclass
class TraceInfo:
    """Per-apply() statistics (ref: rayUtil.hpp:65-76)."""

    num_rays: int = 0
    total_rays_traced: int = 0
    non_geometry_hits: int = 0
    geometry_hits: int = 0
    particle_hits: int = 0
    boundary_hits: int = 0
    reflections: int = 0
    time: float = 0.0
    warning: bool = False
    error: bool = False
    # how hard the fused bounce kernel's search worked, summed over the
    # apply's launches (ops/bounce.py:COUNT_NAMES): the (search group, chunk)
    # pairs whose chunk the group walked, and the (search group, sub-bounce)
    # pairs it ran. A search group shares one chunk-skip decision: a warp of
    # 32 rays under one thread per ray, one ray under a group of threads. 0
    # on the unfused body and on the CPU (the plain version sweeps no chunks).
    # Where the trace walks the uniform grid (trace.kernel.grid_for), the
    # cells the walks visited and the searches they ran (one per live ray
    # and sub-bounce): chunks_swept / tile_bounces is then cells a search
    chunks_swept: int = 0
    # the reference's second sweep for deposits; always 0 here: the kernel
    # gathers the hit disk's neighbor or window list instead
    chunks_deposited: int = 0
    tile_bounces: int = 0


class TracingData:
    """Named scalar + vector data channels (ref: rayTracingData.hpp)."""

    def __init__(self):
        self._vector: List[np.ndarray] = []
        self._vector_labels: List[str] = []
        self._vector_merge: List[MergeType] = []
        self._scalar: List[float] = []
        self._scalar_labels: List[str] = []
        self._scalar_merge: List[MergeType] = []
        self._scalar_counts: List[int] = []

    # -- vector channels ---------------------------------------------------
    def set_number_of_vector_data(self, size: int):
        self._vector = [np.zeros(0) for _ in range(size)]
        self._vector_labels = ["vectorData"] * size
        self._vector_merge = [MergeType.SUM] * size

    def set_vector_data(self, num: int, size_or_array, value=0.0,
                        label: str = "vectorData"):
        if isinstance(size_or_array, (int, np.integer)):
            self._vector[num] = np.full(int(size_or_array), value, np.float64)
        else:
            self._vector[num] = np.asarray(size_or_array, np.float64).copy()
        self._vector_labels[num] = label

    def get_vector_data(self, key):
        if isinstance(key, str):
            key = self.get_vector_data_index(key)
        return self._vector[key]

    def get_vector_data_label(self, i: int) -> str:
        return self._vector_labels[i]

    def get_vector_data_index(self, label: str) -> int:
        try:
            return self._vector_labels.index(label)
        except ValueError:
            raise KeyError(f"No vector data labelled {label!r} in TracingData")

    def add_vector_data(self, size: int, label: str = "vectorData",
                        value: float = 0.0) -> int:
        """Append a new labelled channel; returns its index."""
        self._vector.append(np.full(int(size), value, np.float64))
        self._vector_labels.append(label)
        self._vector_merge.append(MergeType.SUM)
        return len(self._vector) - 1

    def set_vector_merge_type(self, num: int, merge: MergeType):
        self._vector_merge[num] = MergeType(merge)

    def get_vector_merge_type(self, num: int) -> MergeType:
        return self._vector_merge[num]

    @property
    def num_vector_data(self) -> int:
        return len(self._vector)

    # -- scalar channels ---------------------------------------------------
    def set_number_of_scalar_data(self, size: int):
        self._scalar = [0.0] * size
        self._scalar_labels = ["scalarData"] * size
        self._scalar_merge = [MergeType.SUM] * size
        self._scalar_counts = [0] * size

    def set_scalar_data(self, num: int, value: float, label: str = "scalarData"):
        self._scalar[num] = float(value)
        self._scalar_labels[num] = label

    def get_scalar_data(self, key):
        if isinstance(key, str):
            key = self.get_scalar_data_index(key)
        return self._scalar[key]

    def get_scalar_data_index(self, label: str) -> int:
        try:
            return self._scalar_labels.index(label)
        except ValueError:
            raise KeyError(f"No scalar data labelled {label!r} in TracingData")

    def set_scalar_merge_type(self, num: int, merge: MergeType):
        self._scalar_merge[num] = MergeType(merge)

    def get_scalar_merge_type(self, num: int) -> MergeType:
        return self._scalar_merge[num]

    @property
    def num_scalar_data(self) -> int:
        return len(self._scalar)

    # -- accumulation across apply() runs ---------------------------------
    def accumulate_vector(self, num: int, contribution: np.ndarray):
        """Fold a new per-primitive contribution into channel ``num``
        following its merge type (ref: rayTraceKernel.hpp:348-378).

        AVERAGE is not a valid merge type for vector data — the reference
        warns and skips the merge (rayTraceKernel.hpp:371-375); mirrored here.
        """
        merge = self._vector_merge[num]
        contribution = np.asarray(contribution, np.float64)
        if merge == MergeType.APPEND:
            self._vector[num] = np.concatenate([self._vector[num], contribution])
        elif merge == MergeType.AVERAGE:
            import warnings

            warnings.warn("Invalid merge type in local vector data.")
        else:  # SUM
            if self._vector[num].size == 0:
                self._vector[num] = contribution.copy()
            else:
                self._vector[num] = self._vector[num] + contribution

    def accumulate_scalar(self, num: int, contribution: float):
        """Fold one per-unit contribution (one thread/shard/batch worth) into
        scalar channel ``num``.

        SUM adds; AVERAGE keeps the running mean over all contributions —
        the incremental form of the reference's sum-then-divide-by-numThreads
        merge (rayTraceKernel.hpp:385-405).
        """
        merge = self._scalar_merge[num]
        if merge == MergeType.AVERAGE:
            c = self._scalar_counts[num]
            self._scalar[num] = (self._scalar[num] * c + float(contribution)) / (
                c + 1
            )
            self._scalar_counts[num] = c + 1
        elif merge == MergeType.SUM:
            self._scalar[num] = self._scalar[num] + float(contribution)
        else:
            import warnings

            warnings.warn("Invalid merge type in local scalar data.")


class DataLog:
    """Additive log matrix merged across shards/runs (ref: rayUtil.hpp:49-63)."""

    def __init__(self):
        self.data: List[np.ndarray] = []

    def merge(self, other: "DataLog"):
        assert len(other.data) == len(self.data), "Size mismatch when merging logs"
        for i in range(len(self.data)):
            self.data[i] = self.data[i] + other.data[i]
