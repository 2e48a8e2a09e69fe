"""Builds the CUDA kernels of ``csrc/`` into one shared library and loads it.

``nvcc`` compiles every ``*.cu`` for ``sm_90a`` (one process per source, all
started together; the bounce kernel's instantiations are four sources, one
per primitive kind, so that they build in parallel), links the objects into
one shared library with a plain C interface, and ``ctypes`` loads it. The build happens at first use, into
``build/`` beside the package, and again whenever a hash of the sources
changes. Nothing here runs when the module is imported. Several processes
may start at once on an empty directory (the ranks of a sharded trace): each
takes an exclusive ``fcntl.flock`` on a lock file there, the first builds in
a temporary directory of its own and moves the library into place with
``os.replace``, and the others find it built.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "viennaray_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_ptr = ctypes.c_void_p
# org dir prims chunk_bbs perm | n_rays npad pt t_near | t prim hit stream
_NEAREST_HIT = [
    _ptr, _ptr, _ptr, _ptr, _ptr, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, _ptr, _ptr, _ptr, _ptr,
]
# the float64 forms: every float pointer to doubles, t_near a double
_NEAREST_HIT_F64 = _NEAREST_HIT[:8] + [ctypes.c_double] + _NEAREST_HIT[9:]
# org dir prims perm | start lanes nx ny nz | gx gy gz cs | n_rays npad
# t_near | t prim hit walk_counts stream
_GRID_HIT = (
    [_ptr] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float] * 4
    + [ctypes.c_int] * 2 + [ctypes.c_float] + [_ptr] * 5
)
# the float64 forms: the corner, the cell size and t_near doubles
_GRID_HIT_F64 = (
    [_ptr] * 6 + [ctypes.c_int] * 3 + [ctypes.c_double] * 4
    + [ctypes.c_int] * 2 + [ctypes.c_double] + [_ptr] * 5
)
_NBR_CELLS = [_ptr, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _ptr,
              ctypes.c_double, _ptr, _ptr]
_NBR_ROWS = (
    [_ptr, ctypes.c_longlong, ctypes.c_int, ctypes.c_int] + [_ptr] * 4
    + [ctypes.c_double] * 2 + [_ptr] * 2 + [ctypes.c_int, _ptr]
)
_SIGNATURES = {
    "vr_disk_grid_nearest_hit": _GRID_HIT,
    "vr_tri_grid_nearest_hit": _GRID_HIT,
    "vr_disk_grid_nearest_hit_f64": _GRID_HIT_F64,
    "vr_tri_grid_nearest_hit_f64": _GRID_HIT_F64,
    "vr_disk_nearest_hit": _NEAREST_HIT,
    "vr_triangle_nearest_hit": _NEAREST_HIT,
    "vr_line_nearest_hit": _NEAREST_HIT,
    "vr_disk_nearest_hit_f64": _NEAREST_HIT_F64,
    "vr_triangle_nearest_hit_f64": _NEAREST_HIT_F64,
    "vr_line_nearest_hit_f64": _NEAREST_HIT_F64,
    # ids w | n_entries n_bins | out scratch scratch_words | sms branch |
    # stream
    "vr_flux_histogram": [
        _ptr, _ptr, ctypes.c_longlong, ctypes.c_int, _ptr, _ptr,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _ptr,
    ],
    # ids w | n_entries n_bins | out stream
    "vr_flux_histogram_small": [
        _ptr, _ptr, ctypes.c_int, ctypes.c_int, _ptr, _ptr,
    ],
    # grad_out ids | n_entries n_bins | grad_w | sms | stream
    "vr_flux_histogram_grad": [
        _ptr, _ptr, ctypes.c_longlong, ctypes.c_int, _ptr, ctypes.c_int, _ptr,
    ],
    # the float64 forms take the same arguments, w / out / grad_out / grad_w
    # as doubles and two words a bin in the scratch
    "vr_flux_histogram_f64": [
        _ptr, _ptr, ctypes.c_longlong, ctypes.c_int, _ptr, _ptr,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _ptr,
    ],
    "vr_flux_histogram_small_f64": [
        _ptr, _ptr, ctypes.c_int, ctypes.c_int, _ptr, _ptr,
    ],
    "vr_flux_histogram_grad_f64": [
        _ptr, _ptr, ctypes.c_longlong, ctypes.c_int, _ptr, ctypes.c_int, _ptr,
    ],
    # org dir alive bb_lo bb_ext | n dirbins | key stream
    "vr_coherence_key": [_ptr] * 5 + [ctypes.c_longlong, ctypes.c_int]
    + [_ptr] * 2,
    "vr_coherence_key_f64": [_ptr] * 5 + [ctypes.c_longlong, ctypes.c_int]
    + [_ptr] * 2,
    # take n_out n_in | org dir weight w0 alive hfb n_refl n_bdry aux n_aux |
    # the same nine outputs | stream
    "vr_permute_state": [_ptr, ctypes.c_longlong, ctypes.c_longlong]
    + [_ptr] * 9 + [ctypes.c_int] + [_ptr] * 10,
    "vr_permute_state_f64": [_ptr, ctypes.c_longlong, ctypes.c_longlong]
    + [_ptr] * 9 + [ctypes.c_int] + [_ptr] * 10,
    # pts n cols dim lo inv_cell cx stream
    "vr_neighborhood_cells": _NBR_CELLS,
    "vr_neighborhood_cells_f64": _NBR_CELLS,
    # cx n dim maxc ids grid stream
    "vr_neighborhood_ids": [_ptr, ctypes.c_longlong, ctypes.c_int]
    + [_ptr] * 4,
    # pts n cols dim cx ids order grid distance dist2 counts neighbors k
    # stream
    "vr_neighborhood_rows": _NBR_ROWS,
    "vr_neighborhood_rows_f64": _NBR_ROWS,
    # org dir weight w0 alive hfb n_refl n_bdry uniforms | prims chunk_bbs
    # perm neighbors neighbor_pack walls stick_lanes | n_rays npad pt n_prims
    # k_nbrs n_sub kind dim first_dir second_dir ray_axis bc1 bc2 refl_kind
    # max_refl max_bdry roulette deposit | t_near sticking wthresh wrenew
    # mean_free_path | group | grid start lanes, nx ny nz, gx gy gz cs | org dir
    # weight alive hfb n_refl n_bdry out | flux hit_prim wdep t_hit scratch
    # stream
    "vr_fused_bounce": (
        [_ptr] * 16 + [ctypes.c_int] * 18 + [ctypes.c_float] * 5
        + [ctypes.c_int] + [_ptr] * 2 + [ctypes.c_int] * 3
        + [ctypes.c_float] * 4 + [_ptr] * 7 + [_ptr] * 6
    ),
}

_library = None
build_seconds = 0.0  # time the last build of this process spent in nvcc
# what nvcc printed when it built the library in use: ptxas' registers and
# spills per kernel (kept beside the library, and read back from there)
build_log = ""


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of viennaray_tpu_torch cannot be "
        "built on this machine"
    )


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _run_all(commands):
    """Start every command at once; raise with the output of any that fails."""
    procs = [
        subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        for cmd in commands
    ]
    outputs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(commands, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}"
            )
    return outputs


def _log_path(target: Path) -> Path:
    return target.with_suffix(".log")


def _build(target: Path) -> None:
    global build_seconds
    nvcc = _find_nvcc()
    target.parent.mkdir(parents=True, exist_ok=True)
    with open(target.parent / "kernels.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if target.exists() and _log_path(target).exists():
            return  # another process built it while this one waited
        work = Path(tempfile.mkdtemp(dir=target.parent, suffix=".tmp"))
        try:
            sources = sorted(CSRC.glob("*.cu"))
            objects = [work / (src.stem + ".o") for src in sources]
            t0 = time.perf_counter()
            log = "\n".join(_run_all([
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                for src, obj in zip(sources, objects)
            ]))
            linked = work / target.name
            _run_all([[nvcc, "-shared", "-o", str(linked),
                       *map(str, objects)]])
            (work / "build.log").write_text(log)
            os.replace(work / "build.log", _log_path(target))
            os.replace(linked, target)
            build_seconds = time.perf_counter() - t0
        finally:
            shutil.rmtree(work, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The kernels' shared library, built first if its sources changed (or
    its build log is missing); ``build_log`` is its build's log."""
    global _library, build_log
    if _library is None:
        target = BUILD_DIR / f"libviennaray_kernels_{_source_hash()}.so"
        if not (target.exists() and _log_path(target).exists()):
            _build(target)
        build_log = _log_path(target).read_text()
        lib = ctypes.CDLL(str(target))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _library = lib
    return _library
