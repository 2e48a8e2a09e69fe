"""Weighted histogram (flux accumulation): plain version and CUDA wrapper.

Counterpart of ``viennaray_tpu/ops/pallas_histogram.py``. ``flux_histogram``
wraps the CUDA kernel ``csrc/flux_histogram.cu`` (fixed-point integer
atomics: deterministic, float32-accurate); ``flux_histogram_ref`` is the plain
PyTorch version. On a CUDA tensor the wrapper launches the kernel or raises;
on a CPU tensor it runs the plain version.
"""

from __future__ import annotations

import torch

from .. import _build


def flux_histogram_ref(ids, w, n_prims: int):
    """sum_e w[e] into bin ids[e], summed in float64; returns (n_prims,) f32."""
    acc = torch.zeros(n_prims, dtype=torch.float64, device=w.device)
    acc.index_add_(0, ids.long(), w.double())
    return acc.float()


def flux_histogram(ids, w, n_prims: int):
    """sum_e w[e] into bin ids[e]; returns (n_prims,) f32.

    ids (E,) int32 in [0, n_prims); w (E,) f32, finite. Two calls on the same
    inputs give bitwise the same output on either device.
    """
    if ids.ndim != 1 or w.shape != ids.shape:
        raise ValueError("ids and w must both be (E,)")
    if ids.dtype != torch.int32 or w.dtype != torch.float32:
        raise TypeError("ids must be int32 and w float32")
    if ids.device != w.device:
        raise ValueError(f"ids is on {ids.device}, w on {w.device}")
    if not (ids.is_contiguous() and w.is_contiguous()):
        raise ValueError("ids and w must be contiguous")
    n_prims = int(n_prims)
    if w.device.type == "cpu":
        return flux_histogram_ref(ids, w, n_prims)
    if w.device.type != "cuda":
        raise RuntimeError(f"flux_histogram: unsupported device {w.device}")
    out = torch.empty(n_prims, dtype=torch.float32, device=w.device)
    if n_prims == 0:
        return out
    # n_prims accumulators and the largest |w|, cleared by the kernel's entry
    scratch = torch.empty(n_prims + 1, dtype=torch.int64, device=w.device)
    lib = _build.library()
    with torch.cuda.device(w.device):
        err = lib.vr_flux_histogram(
            ids.data_ptr(), w.data_ptr(), ids.shape[0], n_prims,
            out.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"vr_flux_histogram: CUDA error {err}")
    flux_histogram.launches += 1
    return out


flux_histogram.launches = 0
