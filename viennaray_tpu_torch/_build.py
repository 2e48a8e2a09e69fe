"""Builds the CUDA kernels of ``csrc/`` into one shared library and loads it.

``nvcc`` compiles every ``*.cu`` for ``sm_90a`` (one process per source, all
started together; the bounce kernel's instantiations are four sources, one
per primitive kind, so that they build in parallel), links the objects into
one shared library with a plain C interface, and ``ctypes`` loads it. The build happens at first use, into
``build/`` beside the package, and again whenever a hash of the sources
changes. Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
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
_SIGNATURES = {
    "vr_disk_nearest_hit": _NEAREST_HIT,
    "vr_triangle_nearest_hit": _NEAREST_HIT,
    "vr_line_nearest_hit": _NEAREST_HIT,
    "vr_disk_nearest_hit_f64": _NEAREST_HIT_F64,
    "vr_triangle_nearest_hit_f64": _NEAREST_HIT_F64,
    "vr_line_nearest_hit_f64": _NEAREST_HIT_F64,
    # ids w | n_entries n_bins | out scratch | sms | stream
    "vr_flux_histogram": [
        _ptr, _ptr, ctypes.c_longlong, ctypes.c_int, _ptr, _ptr, ctypes.c_int,
        _ptr,
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
    # as doubles and a scratch of 2 n_bins + 1 words
    "vr_flux_histogram_f64": [
        _ptr, _ptr, ctypes.c_longlong, ctypes.c_int, _ptr, _ptr, ctypes.c_int,
        _ptr,
    ],
    "vr_flux_histogram_small_f64": [
        _ptr, _ptr, ctypes.c_int, ctypes.c_int, _ptr, _ptr,
    ],
    "vr_flux_histogram_grad_f64": [
        _ptr, _ptr, ctypes.c_longlong, ctypes.c_int, _ptr, ctypes.c_int, _ptr,
    ],
    # org dir weight w0 alive hfb n_refl n_bdry uniforms | prims chunk_bbs
    # perm neighbors neighbor_pack walls stick_lanes | n_rays npad pt n_prims
    # k_nbrs n_sub kind dim first_dir second_dir ray_axis bc1 bc2 refl_kind
    # max_refl max_bdry roulette deposit | t_near sticking wthresh wrenew
    # mean_free_path | group | org dir weight alive hfb n_refl n_bdry out |
    # flux hit_prim wdep t_hit scratch stream
    "vr_fused_bounce": (
        [_ptr] * 16 + [ctypes.c_int] * 18 + [ctypes.c_float] * 5
        + [ctypes.c_int] + [_ptr] * 7 + [_ptr] * 6
    ),
}

_library = None
build_seconds = 0.0  # time the last build of this process spent in nvcc
build_log = ""  # what nvcc printed then: ptxas' registers and spills per kernel


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


def _build(target: Path) -> None:
    global build_seconds, build_log
    nvcc = _find_nvcc()
    target.parent.mkdir(parents=True, exist_ok=True)
    work = target.parent / (target.stem + ".tmp")
    work.mkdir(exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    objects = [work / (src.stem + ".o") for src in sources]
    t0 = time.perf_counter()
    build_log = "\n".join(_run_all([
        [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        for src, obj in zip(sources, objects)
    ]))
    linked = work / target.name
    _run_all([[nvcc, "-shared", "-o", str(linked), *map(str, objects)]])
    os.replace(linked, target)
    shutil.rmtree(work, ignore_errors=True)
    build_seconds = time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The kernels' shared library, built first if its sources changed."""
    global _library
    if _library is None:
        target = BUILD_DIR / f"libviennaray_kernels_{_source_hash()}.so"
        if not target.exists():
            _build(target)
        lib = ctypes.CDLL(str(target))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _library = lib
    return _library
