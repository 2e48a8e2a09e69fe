"""Loads the port's compiled host helper, ``native/host_accel.cpp``.

Counterpart of ``viennaray_tpu/utils/native.py``. ``g++`` compiles the helper
at first use (never when a module is imported) into ``build/viennaray_tpu_torch/``
beside the package, a library whose name carries a hash of the source and the
flags, so an edit builds a new one. Several processes may load it at once
into an empty directory: each takes an exclusive ``fcntl.flock`` on a lock
file there, the first compiles into a temporary file of its own (``mkstemp``
in the same directory) and moves it into place with ``os.replace``, and the
others find it built. No environment variable is read.

Flags: ``-O3 -shared -fPIC -std=c++17 -ffp-contract=off``. Without
``-march=native``: a library built on one machine may be loaded on another
that has a copy of the checkout (its name does not say which CPU built it),
and the helper's loops gain little from the newer instructions. No fused
multiply-adds, so its squared distances are the numpy path's, operation by
operation.

Two entry points are bound: ``vr_build_neighborhood``
(``build_neighborhood_native``) and ``vr_build_grid`` (``build_grid_native``,
the cell insertion of ``geometry.grid_accel``). The neighborhood runs here
for points on the host: a numpy array or a CPU tensor handed to
``geometry.neighborhood.build_neighborhood`` (a geometry built on the CPU,
the window list). Points on a CUDA device, as ``DiskGeometry.build`` on a
CUDA device hands them, go to the card instead
(``build_neighborhood_cuda``, ``csrc/neighborhood.cu``), which gives this
helper's table bit for bit. When ``g++`` is missing or
the build fails, ``load`` logs one warning and returns None, and the callers
take their numpy paths (``geometry.neighborhood.build_neighborhood_numpy``,
``geometry.grid_accel.insert_prims_numpy``), which give the same tables.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np

from .logging import logger

SOURCE = Path(__file__).resolve().parent.parent / "native" / "host_accel.cpp"
BUILD_DIR = (Path(__file__).resolve().parent.parent.parent / "build"
             / "viennaray_tpu_torch")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")

# build directory -> the loaded library, or None after a failed build
_libraries = {}
build_seconds = 0.0  # time the last build of this process spent in g++


def library_path(build_dir=None) -> Path:
    """Where the library of the current source and flags lies (or will)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return Path(build_dir or BUILD_DIR) / f"libvr_host_accel_{h.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    global build_seconds
    target.parent.mkdir(parents=True, exist_ok=True)
    with open(target.parent / "host_accel.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if target.exists():  # another process built it while this one waited
            return
        fd, tmp = tempfile.mkstemp(dir=target.parent, suffix=".so.tmp")
        os.close(fd)
        try:
            t0 = time.perf_counter()
            subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", tmp],
                           check=True, capture_output=True, text=True,
                           timeout=300)
            os.replace(tmp, target)
            build_seconds = time.perf_counter() - t0
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)


def load(build_dir=None) -> Optional[ctypes.CDLL]:
    """The helper's library from ``build_dir`` (default ``BUILD_DIR``), built
    there first if it is missing; None, after one warning, when it cannot be
    built or loaded. The result is kept per directory."""
    key = str(build_dir or BUILD_DIR)
    if key in _libraries:
        return _libraries[key]
    target = library_path(key)
    try:
        if not target.exists():
            _build(target)
        lib = ctypes.CDLL(str(target))
    except (OSError, subprocess.SubprocessError) as err:
        detail = getattr(err, "stderr", None) or err
        logger.warning("the compiled host helper is not available (%s): "
                       "geometry neighborhoods and grids are built by numpy",
                       detail)
        lib = None
    else:
        lib.vr_build_neighborhood.restype = ctypes.c_int64
        lib.vr_build_neighborhood.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int32,
            ctypes.c_double, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.vr_build_grid.restype = ctypes.c_int64
        lib.vr_build_grid.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(ctypes.c_double),
            ctypes.c_double, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_void_p, ctypes.c_int64,
        ]
    _libraries[key] = lib
    return lib


def build_neighborhood_native(points: np.ndarray, distance: float, dim: int,
                              build_dir=None):
    """The neighborhood by the helper: (neighbors (N, K) int32 padded -1,
    counts (N,) int32), or None when the library is not available. Reads
    the first ``dim`` coordinates of ``points`` (N, >= dim)."""
    lib = load(build_dir)
    if lib is None:
        return None
    pts = np.zeros((len(points), 3), np.float64)
    pts[:, :dim] = np.asarray(points, np.float64)[:, :dim]
    n = len(pts)
    dptr = pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    counts = np.zeros(n, np.int32)
    cptr = counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    # two passes: the first counts (and returns the largest degree), the
    # second fills the padded table
    k_max = max(int(lib.vr_build_neighborhood(
        dptr, n, dim, float(distance), cptr, None, 0)), 1)
    neighbors = np.full((n, k_max), -1, np.int32)
    lib.vr_build_neighborhood(
        dptr, n, dim, float(distance), cptr,
        neighbors.ctypes.data_as(ctypes.c_void_p), k_max,
    )
    return neighbors, counts


def build_grid_native(prim_lo, prim_hi, origin, cell_size, dims, dim: int):
    """The uniform grid's cell table by the helper: (cells (C, K) int32
    padded -1, counts (C,) int32), C = nx ny nz in x-major order, or None
    when the library is not available. Every primitive goes into every cell
    its box [prim_lo, prim_hi] (N, 3) overlaps, in ascending id order; in 2D
    into z cell 0 only (the counterpart of
    ``viennaray_tpu/utils/native.py:build_grid_native``)."""
    lib = load()
    if lib is None:
        return None
    lo = np.ascontiguousarray(prim_lo, np.float64)
    hi = np.ascontiguousarray(prim_hi, np.float64)
    org = np.ascontiguousarray(origin, np.float64)
    dims_a = np.ascontiguousarray(dims, np.int64)
    n = len(lo)
    n_cells = int(dims_a.prod())
    dptr = ctypes.POINTER(ctypes.c_double)
    args = (lo.ctypes.data_as(dptr), hi.ctypes.data_as(dptr), n, dim,
            org.ctypes.data_as(dptr), float(cell_size),
            dims_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    counts = np.zeros(n_cells, np.int32)
    cptr = counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    # two passes: the first counts (and returns the fullest cell's count),
    # the second fills the padded table
    k_max = max(int(lib.vr_build_grid(*args, cptr, None, 0)), 1)
    cells = np.full((n_cells, k_max), -1, np.int32)
    lib.vr_build_grid(*args, cptr, cells.ctypes.data_as(ctypes.c_void_p),
                      k_max)
    return cells, counts
