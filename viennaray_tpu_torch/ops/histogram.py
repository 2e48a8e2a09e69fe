"""Weighted histogram (flux accumulation): plain version and CUDA wrapper.

Counterpart of ``viennaray_tpu/ops/pallas_histogram.py``. ``flux_histogram``
wraps the CUDA kernel ``csrc/flux_histogram.cu`` (fixed-point integer
atomics: deterministic, float32-accurate); ``flux_histogram_ref`` is the plain
PyTorch version. On a CUDA tensor the wrapper launches the kernel or raises;
on a CPU tensor it runs the plain version.

The kernel has two paths with the same bits: below ``SMALL_ENTRIES`` entries,
where the bins fit in one block's shared memory, one launch of one block
(``vr_flux_histogram_small``); else four device operations over the whole
card (``vr_flux_histogram``). ``path_for`` holds the rule.

Gradients: where ``w`` requires one, ``flux_histogram`` runs through
``FluxHistogramFn``, whose backward is the gather ``flux_histogram_grad``
(CUDA kernel ``vr_flux_histogram_grad``, plain version
``flux_histogram_grad_ref``). The kernel is called through raw pointers, so
without the Function its output would carry no graph and a gradient through
it would be silently zero.

Float64 weights (the float64 trace) take the kernels' float64 forms
(``vr_flux_histogram_f64``, ``vr_flux_histogram_small_f64``,
``vr_flux_histogram_grad_f64``; counted in ``launches_f64``). One 64-bit
fixed-point word per weight would resolve 2^-37 of the weights' range, short
of float64's 2^-53, so each weight becomes two words, each summed in a
64-bit integer bin of its own (``fixed_point_f64``): the high word the
weight scaled by 2^k and rounded, the low word the remainder scaled by a
further 2^L and rounded. A bin then resolves 2^-(k + L), about 2^-77 of the
largest weight at 2^24 entries. The plain version does the same integer sums
with ``index_add_`` on int64 tensors and the same conversion back, so kernel
and plain version give the same bits on the card and on the CPU, and so do
both paths.
"""

from __future__ import annotations

import contextlib
import functools
import math

import torch

from .. import _build

# Entries below which a call takes the one-block path: its time grows with E
# on one SM (0.0117 to 0.0133 ms at 6,144 entries, 0.0174 to 0.0179 at
# 16,384, 0.0303 to 0.0305 at 32,768), the other path's is about a fixed
# 0.023 to 0.031 ms of four device operations (H100, ``chip_diagnose.py
# --paths``; PERF.md)
SMALL_ENTRIES = 24576
# the bins of one block's shared memory: 200 KB of 64-bit integers
SMALL_MAX_BINS = 200 * 1024 // 8
# float64 weights take two 64-bit words a bin (the same threshold of
# entries: not measured apart)
SMALL_MAX_BINS_F64 = SMALL_MAX_BINS // 2
# the float64 form's largest scale exponent, so that 2^-(k + L) stays a
# normal float64 (``fixed_point_f64``); it binds only where the largest
# weight is below 2^-(898 + log2 E)
F64_MAX_SCALE_EXP = 960


def small_max_bins(dtype) -> int:
    """The most bins the one-block path takes for weights of ``dtype``."""
    return SMALL_MAX_BINS if dtype == torch.float32 else SMALL_MAX_BINS_F64


def path_for(n_entries: int, n_prims: int, dtype=torch.float32) -> str:
    """The kernel's path for a call: "small" (one launch of one block) or
    "large"."""
    if n_entries < SMALL_ENTRIES and n_prims <= small_max_bins(dtype):
        return "small"
    return "large"


def fixed_point_f64(wmax: float, n_entries: int):
    """The float64 form's two scale exponents (k, L) for weights of largest
    magnitude ``wmax`` (> 0) and ``n_entries`` entries: wmax < 2^e, E <
    2^b, k = min(62 - e - b, ``F64_MAX_SCALE_EXP``), L = 63 - b. A weight w
    becomes hi = rint(w 2^k) and lo = rint((w 2^k - hi) 2^L); |hi| E and
    |lo| E stay below 2^62, so no bin overflows even if every entry lands
    in it (``csrc/fixed_point.cuh:fixed_scale_f64``)."""
    e = math.frexp(wmax)[1]
    b = int(n_entries).bit_length()
    return min(62 - e - b, F64_MAX_SCALE_EXP), 63 - b


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def flux_histogram_ref(ids, w, n_prims: int):
    """sum_e w[e] into bin ids[e]; returns (n_prims,) of w's type. Float32
    weights: summed in float64, rounded once to float32. Float64 weights:
    the kernel's fixed-point sums (``fixed_point_f64``) on int64 tensors,
    its bits exactly."""
    if w.dtype == torch.float64:
        return _histogram_f64_ref(ids, w, n_prims)
    acc = torch.zeros(n_prims, dtype=torch.float64, device=w.device)
    acc.index_add_(0, ids.long(), w.double())
    return acc.float()


def _histogram_f64_ref(ids, w, n_prims):
    """The float64 form's arithmetic, one tensor op per operation of
    ``csrc/flux_histogram.cu``: hi = rint(w 2^k), lo = rint((w 2^k - hi)
    2^L) (round half to even, exact products by powers of two), integer
    sums per bin, out = double(hi_sum) 2^-k + double(lo_sum) 2^-(k + L)."""
    out = torch.zeros(n_prims, dtype=torch.float64, device=w.device)
    n_entries = ids.size(0)
    wmax = float(w.abs().max()) if n_entries else 0.0
    if wmax == 0.0:
        return out
    k, low = fixed_point_f64(wmax, n_entries)
    x = w * math.ldexp(1.0, k)
    hi = torch.round(x)
    lo = torch.round((x - hi) * math.ldexp(1.0, low))
    index = ids.long()
    hi_sum = torch.zeros(n_prims, dtype=torch.int64, device=w.device)
    lo_sum = torch.zeros(n_prims, dtype=torch.int64, device=w.device)
    hi_sum.index_add_(0, index, hi.long())
    lo_sum.index_add_(0, index, lo.long())
    return (hi_sum.double() * math.ldexp(1.0, -k)
            + lo_sum.double() * math.ldexp(1.0, -(k + low)))


def flux_histogram(ids, w, n_prims: int, path=None):
    """sum_e w[e] into bin ids[e]; returns (n_prims,) of w's type.

    ids (E,) int32 in [0, n_prims); w (E,) f32, finite; or w f64, finite and
    of largest magnitude below 2^900, which takes the float64 form (counted
    in ``launches_f64`` and ``launches_by_path_f64``). Two calls on the same
    inputs give bitwise the same output on either device, and so do the
    kernel's two paths. ``path`` ("small" or "large", default ``path_for``)
    forces one of them, to compare the two; the trace never sets it. Where
    ``w`` requires a gradient, the output carries one (``FluxHistogramFn``).
    """
    # the unfused body calls this once a bounce, mostly on a few thousand
    # entries, where the host's work per call is the call's time: the
    # checks below stay on cheap tensor attributes
    if ids.dim() != 1 or w.dim() != 1 or ids.size(0) != w.size(0):
        raise ValueError("ids and w must both be (E,)")
    if ids.dtype is not torch.int32 or w.dtype not in (torch.float32,
                                                        torch.float64):
        raise TypeError("ids must be int32 and w float32 or float64")
    if ids.get_device() != w.get_device():
        raise ValueError(f"ids is on {ids.device}, w on {w.device}")
    if not (ids.is_contiguous() and w.is_contiguous()):
        raise ValueError("ids and w must be contiguous")
    n_prims = int(n_prims)
    n_entries = ids.size(0)
    if path is None:
        path = path_for(n_entries, n_prims, w.dtype)
    elif path not in ("small", "large"):
        raise ValueError(f"no such path {path!r}")
    elif path == "small" and (n_prims > small_max_bins(w.dtype)
                              or n_entries >= 2**31):
        raise ValueError("the one-block path takes up to SMALL_MAX_BINS bins "
                         "(SMALL_MAX_BINS_F64 for float64 weights) and fewer "
                         "than 2^31 entries")
    if w.requires_grad and torch.is_grad_enabled():
        return FluxHistogramFn.apply(ids, w, n_prims, path)
    return _histogram(ids, w, n_prims, path)


def _histogram(ids, w, n_prims, path):
    """The checked call of ``flux_histogram``: the plain version on the CPU,
    the kernel on a CUDA device."""
    if not w.is_cuda:
        if w.device.type == "cpu":
            return flux_histogram_ref(ids, w, n_prims)
        raise RuntimeError(f"flux_histogram: unsupported device {w.device}")
    out = w.new_empty(n_prims)
    if n_prims == 0:
        return out
    lib = _build.library()
    index = w.get_device()
    n_entries = ids.size(0)
    f64 = w.dtype is torch.float64
    suffix = "_f64" if f64 else ""
    # switch devices only when the tensors are not on the current one
    switch = index != torch._C._cuda_getDevice()
    with torch.cuda.device(index) if switch else contextlib.nullcontext():
        stream = torch._C._cuda_getCurrentRawStream(index)
        if path == "small":
            err = getattr(lib, "vr_flux_histogram_small" + suffix)(
                ids.data_ptr(), w.data_ptr(), n_entries, n_prims,
                out.data_ptr(), stream,
            )
        else:
            # the accumulators (one word a bin, two for float64 weights)
            # and the largest |w|, cleared by the kernel's entry
            words = 2 * n_prims if f64 else n_prims
            scratch = torch.empty(words + 1, dtype=torch.int64,
                                  device=w.device)
            err = getattr(lib, "vr_flux_histogram" + suffix)(
                ids.data_ptr(), w.data_ptr(), n_entries, n_prims,
                out.data_ptr(), scratch.data_ptr(), _sm_count(index), stream,
            )
    if err != 0:
        raise RuntimeError(
            f"vr_flux_histogram{suffix} ({path}): CUDA error {err}")
    if f64:
        flux_histogram.launches_f64 += 1
        flux_histogram.launches_by_path_f64[path] += 1
    else:
        flux_histogram.launches += 1
        flux_histogram.launches_by_path[path] += 1
    return out


flux_histogram.launches = 0
flux_histogram.launches_by_path = {"small": 0, "large": 0}
flux_histogram.launches_f64 = 0
flux_histogram.launches_by_path_f64 = {"small": 0, "large": 0}


class FluxHistogramFn(torch.autograd.Function):
    """The histogram with a gradient for the weights: forward
    ``flux_histogram``'s kernel (or plain version on the CPU), backward
    grad_w[e] = grad_out[ids[e]] by ``flux_histogram_grad``; ``ids`` takes
    no gradient. ``flux_histogram`` applies it where ``w`` requires a
    gradient."""

    @staticmethod
    def forward(ctx, ids, w, n_prims, path):
        ctx.save_for_backward(ids)
        return _histogram(ids, w, n_prims, path)

    @staticmethod
    def backward(ctx, grad_out):
        (ids,) = ctx.saved_tensors
        return None, flux_histogram_grad(grad_out.contiguous(), ids), None, None


def flux_histogram_grad_ref(grad_out, ids):
    """grad_w[e] = grad_out[ids[e]], the histogram's backward (plain)."""
    return grad_out.index_select(0, ids)


def flux_histogram_grad(grad_out, ids):
    """The histogram's backward: (E,) grad_w[e] = grad_out[ids[e]], of
    grad_out's type.

    grad_out (n,) f32 or f64; ids (E,) int32 in [0, n). A gather: the kernel
    and the plain version give the same bits. On a CUDA tensor this launches
    ``vr_flux_histogram_grad`` (its float64 form ``vr_flux_histogram_grad_f64``
    for float64, counted in ``launches_f64``) or raises; on a CPU tensor it
    runs the plain version."""
    if grad_out.dim() != 1 or ids.dim() != 1:
        raise ValueError("grad_out must be (n,) and ids (E,)")
    if ids.dtype is not torch.int32 or grad_out.dtype not in (torch.float32,
                                                              torch.float64):
        raise TypeError("ids must be int32 and grad_out float32 or float64")
    index = grad_out.get_device()
    if ids.get_device() != index:
        raise ValueError(f"ids is on {ids.device}, grad_out on "
                         f"{grad_out.device}")
    if not (ids.is_contiguous() and grad_out.is_contiguous()):
        raise ValueError("grad_out and ids must be contiguous")
    if not grad_out.is_cuda:
        if grad_out.device.type == "cpu":
            return flux_histogram_grad_ref(grad_out, ids)
        raise RuntimeError(
            f"flux_histogram_grad: unsupported device {grad_out.device}")
    n_entries = ids.size(0)
    out = grad_out.new_empty(n_entries)
    if n_entries == 0:
        return out
    lib = _build.library()
    f64 = grad_out.dtype is torch.float64
    entry = "vr_flux_histogram_grad" + ("_f64" if f64 else "")
    switch = index != torch._C._cuda_getDevice()
    with torch.cuda.device(index) if switch else contextlib.nullcontext():
        err = getattr(lib, entry)(
            grad_out.data_ptr(), ids.data_ptr(), n_entries, grad_out.size(0),
            out.data_ptr(), _sm_count(index),
            torch._C._cuda_getCurrentRawStream(index),
        )
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}")
    if f64:
        flux_histogram_grad.launches_f64 += 1
    else:
        flux_histogram_grad.launches += 1
    return out


flux_histogram_grad.launches = 0
flux_histogram_grad.launches_f64 = 0
