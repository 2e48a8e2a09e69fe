"""Weighted histogram (flux accumulation): plain version and CUDA wrapper.

Counterpart of ``viennaray_tpu/ops/pallas_histogram.py``. ``flux_histogram``
wraps the CUDA kernel ``csrc/flux_histogram.cu`` (fixed-point integer
atomics: deterministic, float32-accurate); ``flux_histogram_ref`` is the plain
PyTorch version. On a CUDA tensor the wrapper launches the kernel or raises;
on a CPU tensor it runs the plain version.

The kernel has two paths with the same bits: below ``SMALL_ENTRIES`` entries,
where the bins fit in the shared memory of a thread-block cluster, one launch
of one cluster of ``small_cluster_for`` blocks (``vr_flux_histogram_small``);
else two launches over the whole card (``vr_flux_histogram``). ``path_for``
holds the rule. The large path has two
branches with the same bits: each block of a thread-block cluster of
``cluster_for`` blocks holds a slice of the bins in shared memory (the
cluster branch), or the entries go to global bins (the global branch).
``branch_for`` picks one: the cluster branch where the bins fit and the
entries are many beside the slices the blocks flush. ``branch`` asks for
either, to compare the two.

Gradients: where ``w`` requires one, ``flux_histogram`` runs through
``FluxHistogramFn``, whose backward is the gather ``flux_histogram_grad``
(CUDA kernel ``vr_flux_histogram_grad``, plain version
``flux_histogram_grad_ref``). The kernel is called through raw pointers, so
without the Function its output would carry no graph and a gradient through
it would be silently zero.

Float64 weights (the float64 trace) take the kernels' float64 forms
(``vr_flux_histogram_f64``, ``vr_flux_histogram_small_f64``,
``vr_flux_histogram_grad_f64``; counted in ``histogram_launches_f64`` and
``flux_histogram_grad.launches_f64``). One 64-bit fixed-point word per
weight would resolve 2^-37 of the weights' range, short of float64's 2^-53,
so each weight becomes two words, each summed in a
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
from ..utils import telemetry
from ..utils.telemetry import COUNTS

# Entries below which a call takes the small path (one launch of one
# cluster): it beats the large path's two launches on the device alone up
# to 98,304 entries on 2,993 bins (0.01058 ms against 0.0118) and loses from
# 114,688 (0.01246 against 0.01169); as the host issues them it wins at
# every E measured up to 196,608 (0.0216 against 0.0369) (H100,
# ``chip_diagnose.py --paths --launch-times``; PERF.md). The one-block path
# before it stopped at 24,576
SMALL_ENTRIES = 114688
# the large path (csrc/histogram_cluster.cuh): a block's slice of bins in
# shared memory, the largest cluster C = 2^s, and the words of a slice that
# C keeps to where it can (each block flushes its slice's words)
SLICE_BYTES = 200 * 1024
MAX_CLUSTER_SHIFT = 4
FLUSH_WORDS = 4096
# the float32 bins the small path takes: what the slices of the largest
# cluster hold (half as many float64 bins, two words each)
SMALL_MAX_BINS = (SLICE_BYTES // 8) << MAX_CLUSTER_SHIFT
# the cluster branch where the entries are at least this many times the
# words the blocks flush (an SM's block a slice): below it the global
# branch is faster (2,993 bins, ms global against cluster: 0.01205 against
# 0.01347 at 393,216 entries, 0.0160 against 0.0151 at 2^20; H100,
# ``chip_diagnose.py --paths --launch-times``; PERF.md)
FLUSH_ENTRIES = 2
# its first launch's blocks an SM at most, each writing one partial maximum
# into the scratch (csrc/flux_histogram.cu:kPrepBlocksPerSm)
PREP_BLOCKS_PER_SM = 4
# the large path's branches as the kernel's entry takes them
BRANCHES = {"cluster": 1, "global": 2}
# the float64 form's largest scale exponent, so that 2^-(k + L) stays a
# normal float64 (``fixed_point_f64``); it binds only where the largest
# weight is below 2^-(898 + log2 E)
F64_MAX_SCALE_EXP = 960


def small_max_bins(dtype) -> int:
    """The most bins the small path takes for weights of ``dtype``: what
    the slices of a cluster of 2^``MAX_CLUSTER_SHIFT`` blocks hold."""
    return SMALL_MAX_BINS if dtype == torch.float32 else SMALL_MAX_BINS // 2


def small_cluster_for(n_prims: int, dtype=torch.float32) -> int:
    """The small path's cluster size C for ``n_prims`` bins: the largest,
    2^``MAX_CLUSTER_SHIFT`` blocks, as fast as any smaller C at every shape
    measured (``chip_diagnose.py --small-sweep``; PERF.md), where its slices
    hold the bins (``small_max_bins``), else 0 (the large path then)
    (``csrc/histogram_cluster.cuh:small_cluster_shift``)."""
    return 1 << MAX_CLUSTER_SHIFT if n_prims <= small_max_bins(dtype) else 0


def path_for(n_entries: int, n_prims: int, dtype=torch.float32) -> str:
    """The kernel's path for a call: "small" (one launch of one cluster) or
    "large"."""
    if n_entries < SMALL_ENTRIES and n_prims <= small_max_bins(dtype):
        return "small"
    return "large"


def cluster_for(n_prims: int, dtype=torch.float32) -> int:
    """The large path's cluster size C for ``n_prims`` bins: the smallest C
    = 2^s whose slices of ceil(n / C) bins (one 64-bit word a bin, two for
    float64 weights) hold at most ``FLUSH_WORDS`` words, else
    2^``MAX_CLUSTER_SHIFT``; 0 where that slice passes ``SLICE_BYTES`` (the
    global branch). Bin b lives in block b mod C of a cluster, at word
    b // C of its slice (``csrc/histogram_cluster.cuh:cluster_shift``)."""
    words = 1 if dtype == torch.float32 else 2
    s = 0
    while s < MAX_CLUSTER_SHIFT and -(-n_prims >> s) * words > FLUSH_WORDS:
        s += 1
    return 1 << s if -(-n_prims >> s) * words * 8 <= SLICE_BYTES else 0


def branch_for(n_entries: int, n_prims: int, dtype=torch.float32,
               sms: int = 132) -> str:
    """The large path's branch for a call on a card of ``sms`` SMs:
    "cluster" where ``cluster_for`` finds a C and the entries number at
    least ``FLUSH_ENTRIES`` times the words the flush adds (sms blocks, a
    slice of ceil(n / C) bins each), else "global"."""
    cluster = cluster_for(n_prims, dtype)
    if not cluster:
        return "global"
    words = (1 if dtype == torch.float32 else 2) * -(-n_prims // cluster)
    return "cluster" if n_entries >= FLUSH_ENTRIES * sms * words else "global"


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


def flux_histogram(ids, w, n_prims: int, path=None, branch=None):
    """sum_e w[e] into bin ids[e]; returns (n_prims,) of w's type.

    ids (E,) int32 in [0, n_prims); w (E,) f32, finite; or w f64, finite and
    of largest magnitude below 2^900, which takes the float64 form (counted
    in ``histogram_launches_f64`` and
    ``flux_histogram.launches_by_path_f64.<path>``). Two calls on the same
    inputs give bitwise the same output on either device, and so do the
    kernel's two paths and the large path's two branches. ``path`` ("small"
    or "large", default ``path_for``) forces one of the paths, ``branch``
    ("cluster" or "global", default ``branch_for``) one of the large path's
    branches, to compare them; the trace sets neither. Where ``w`` requires
    a gradient, the output carries one (``FluxHistogramFn``).
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
        raise ValueError("the small path takes up to SMALL_MAX_BINS bins "
                         "(half as many for float64 weights) and fewer than "
                         "2^31 entries")
    if branch is not None and branch not in BRANCHES:
        raise ValueError(f"no such branch {branch!r}")
    if branch is not None and path != "large":
        raise ValueError("branch picks a branch of the large path")
    if branch == "cluster" and not cluster_for(n_prims, w.dtype):
        raise ValueError(f"{n_prims} bins do not fit in a cluster's shared "
                         "memory: the large path takes the global branch")
    if w.requires_grad and torch.is_grad_enabled():
        return FluxHistogramFn.apply(ids, w, n_prims, path, branch)
    return _histogram(ids, w, n_prims, path, branch)


def _histogram(ids, w, n_prims, path, branch=None):
    """The checked call of ``flux_histogram``: the plain version on the CPU,
    the kernel on a CUDA device."""
    # the entries handed in, on either device
    COUNTS["histogram_entries_f64" if w.dtype is torch.float64
           else "histogram_entries"] += ids.size(0)
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
            # the bins (one word each, two for float64 weights), the ticket
            # and the first launch's partial maxima, all written by the
            # kernels before they are read: per call, never shared
            sms = _sm_count(index)
            if branch is None:
                branch = branch_for(n_entries, n_prims, w.dtype, sms)
            words = ((2 if f64 else 1) * n_prims + 1
                     + PREP_BLOCKS_PER_SM * sms)
            scratch = torch.empty(words, dtype=torch.int64, device=w.device)
            err = getattr(lib, "vr_flux_histogram" + suffix)(
                ids.data_ptr(), w.data_ptr(), n_entries, n_prims,
                out.data_ptr(), scratch.data_ptr(), words, sms,
                BRANCHES[branch], stream,
            )
    if err != 0:
        raise RuntimeError(
            f"vr_flux_histogram{suffix} ({path}): CUDA error {err}")
    COUNTS["histogram_launches" + suffix] += 1
    COUNTS[f"flux_histogram.launches_by_path{suffix}.{path}"] += 1
    if path == "large":
        COUNTS[f"flux_histogram.launches_by_branch{suffix}.{branch}"] += 1
    return out


# the launches, by path and the large path's by branch, and the entries of
# every call, on the CPU too (kernel 2's roofline counts each entry's id and
# weight read once); float64 weights' under the same names ending in _f64
telemetry.declare(*(name for suffix in ("", "_f64") for name in (
    "histogram_launches" + suffix, "histogram_entries" + suffix,
    *(f"flux_histogram.launches_by_path{suffix}.{path}"
      for path in ("small", "large")),
    *(f"flux_histogram.launches_by_branch{suffix}.{branch}"
      for branch in BRANCHES))))


class FluxHistogramFn(torch.autograd.Function):
    """The histogram with a gradient for the weights: forward
    ``flux_histogram``'s kernel (or plain version on the CPU), backward
    grad_w[e] = grad_out[ids[e]] by ``flux_histogram_grad``; ``ids`` takes
    no gradient. ``flux_histogram`` applies it where ``w`` requires a
    gradient."""

    @staticmethod
    def forward(ctx, ids, w, n_prims, path, branch):
        ctx.save_for_backward(ids)
        return _histogram(ids, w, n_prims, path, branch)

    @staticmethod
    def backward(ctx, grad_out):
        (ids,) = ctx.saved_tensors
        return (None, flux_histogram_grad(grad_out.contiguous(), ids), None,
                None, None)


def flux_histogram_grad_ref(grad_out, ids):
    """grad_w[e] = grad_out[ids[e]], the histogram's backward (plain)."""
    return grad_out.index_select(0, ids)


def flux_histogram_grad(grad_out, ids):
    """The histogram's backward: (E,) grad_w[e] = grad_out[ids[e]], of
    grad_out's type.

    grad_out (n,) f32 or f64; ids (E,) int32 in [0, n). A gather: the kernel
    and the plain version give the same bits. On a CUDA tensor this launches
    ``vr_flux_histogram_grad`` (its float64 form ``vr_flux_histogram_grad_f64``
    for float64, counted in ``flux_histogram_grad.launches_f64``) or raises;
    on a CPU tensor it runs the plain version."""
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
    COUNTS["flux_histogram_grad.launches_f64" if f64
           else "flux_histogram_grad.launches"] += 1
    return out


telemetry.declare("flux_histogram_grad.launches",
                  "flux_histogram_grad.launches_f64")
