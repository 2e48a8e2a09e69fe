"""The per-bounce coherence resort's key and the permutation of the per-ray
state: plain versions and CUDA wrappers.

Counterpart of the JAX package's ``_coherence_key``, ``_permute_state`` and
``_sorted_state`` (viennaray_tpu/trace/kernel.py:397-479). The resort
(``trace/kernel.py:resort``) orders a batch's lanes by ``coherence_key``
with ``torch.sort(key, stable=True)`` and moves the state with
``permute_state``; the compaction orders them by the same key at the 8 sign
octants (the JAX package's compaction key), and it and the source sort move
the state with ``permute_state`` too.

- ``coherence_key`` (CUDA kernel ``vr_coherence_key``, plain version
  ``coherence_key_ref``): the lane's position cell (16^3 cells of the
  bounding box) and direction bin as one int32, dead lanes last.
- ``permute_state`` (CUDA kernel ``vr_permute_state``, plain version
  ``permute_state_ref``): every per-ray array, and the hooks' ``aux``,
  gathered at ``take`` in one launch. A stable sort by the key followed by
  this gather gives the lanes of the JAX package's one multi-operand
  ``lax.sort`` (``_sorted_state``) and of its stable argsort plus packed
  gather (``_permute_state``).

Why kernels, where the JAX package has none: the sort itself is a library
sort there too (``jnp.argsort``, ``lax.sort`` in XLA), and stays one here.
But a permutation by tensor ops is one indexing op per state array, eight or
nine launches, and the key about fifteen; the resort runs both before every
launch of the trace, and every trace runs them at each compaction, on paths
where the host already holds about half of the wall time (``PERF.md`` §5). The JAX package packed its nine gathers into
one for the same reason (kernel.py:431-441). Here the key and the
permutation are one launch each (``csrc/permute.cu``, which says what
bounds them).

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor it
runs the plain version. Float64 states launch the float64 forms, counted in
``<wrapper>.launches_f64``. The plain versions repeat the kernels' operations
one tensor op each, so kernel and plain version give the same bits.
"""

from __future__ import annotations

import torch

from .. import _build
from ..utils import telemetry
from ..utils.telemetry import COUNTS
from .bounce import RayState

# a dead lane's key: after every live lane's (at most 16^3 64 bins)
DEAD_KEY = 1 << 30


def _direction_bin(dirn, dirbins):
    """(bin (R,) int32, number of bins): the sign octant below 32 bins;
    from 32 on the xy octant and ``nb_pol`` polar bands of z (4, or 8 from
    64 bins on)."""
    x, y, z = dirn[:, 0], dirn[:, 1], dirn[:, 2]
    xy = (x > 0).to(torch.int32) + 2 * (y > 0).to(torch.int32)
    if dirbins < 32:
        return xy + 4 * (z > 0).to(torch.int32), 8
    nb_pol = 8 if dirbins >= 64 else 4
    band = torch.clamp(((z + 1.0) * (nb_pol / 2.0)).to(torch.int32), 0,
                       nb_pol - 1)
    return (xy + 4 * (x.abs() > y.abs()).to(torch.int32) + 8 * band,
            8 * nb_pol)


def coherence_key_ref(org, dirn, alive, bb_lo, bb_ext, dirbins: int):
    """The resort's key (plain): ((cx 16 + cy) 16 + cz) nb_d + dbin with
    c = clamp(trunc((org - bb_lo) / bb_ext * 16), 0, 15) per axis; dead
    lanes ``DEAD_KEY``. (R,) int32. The JAX package's ``_coherence_key``
    (viennaray_tpu/trace/kernel.py:397-426) operation for operation."""
    cell = torch.clamp(((org - bb_lo) / bb_ext * 16.0).to(torch.int32), 0, 15)
    dbin, nb_d = _direction_bin(dirn, dirbins)
    key = ((cell[:, 0] * 16 + cell[:, 1]) * 16 + cell[:, 2]) * nb_d + dbin
    return torch.where(alive, key, torch.full_like(key, DEAD_KEY))


def _check_key_inputs(org, dirn, alive, bb_lo, bb_ext):
    if org.ndim != 2 or org.shape[1] != 3 or dirn.shape != org.shape:
        raise ValueError("org and dirn must both be (R, 3)")
    if alive.shape != org.shape[:1]:
        raise ValueError("alive must be (R,)")
    if bb_lo.shape != (3,) or bb_ext.shape != (3,):
        raise ValueError("bb_lo and bb_ext must be (3,)")
    if org.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"org must be float32 or float64, got {org.dtype}")
    for name, x, dt in (("dirn", dirn, org.dtype), ("alive", alive, torch.bool),
                        ("bb_lo", bb_lo, org.dtype),
                        ("bb_ext", bb_ext, org.dtype)):
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")
    for name, x in (("org", org), ("dirn", dirn), ("alive", alive),
                    ("bb_lo", bb_lo), ("bb_ext", bb_ext)):
        if x.device != org.device:
            raise ValueError(f"{name} is on {x.device}, org on {org.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def coherence_key(org, dirn, alive, bb_lo, bb_ext, dirbins: int):
    """The resort's key: (R,) int32, ``coherence_key_ref``'s bit for bit.

    org/dirn (R, 3) float32 or float64 (the float64 form, counted in
    ``coherence_key.launches_f64``), alive (R,) bool, bb_lo and bb_ext (3,)
    of org's type: the box's low corner and extent (the extent at least
    1e-6). ``dirbins``: the direction bins, 8, 32 or 64
    (``trace/kernel.py:dirbins_for``). On CUDA tensors launches
    ``vr_coherence_key`` or raises; on CPU tensors runs
    the plain version."""
    _check_key_inputs(org, dirn, alive, bb_lo, bb_ext)
    dirbins = int(dirbins)
    if org.device.type == "cpu":
        return coherence_key_ref(org, dirn, alive, bb_lo, bb_ext, dirbins)
    if org.device.type != "cuda":
        raise RuntimeError(f"coherence_key: unsupported device {org.device}")
    f64 = org.dtype == torch.float64
    entry = "vr_coherence_key" + ("_f64" if f64 else "")
    n = org.shape[0]
    key = torch.empty(n, dtype=torch.int32, device=org.device)
    if n == 0:
        return key
    lib = _build.library()
    with torch.cuda.device(org.device):
        err = getattr(lib, entry)(
            org.data_ptr(), dirn.data_ptr(), alive.data_ptr(),
            bb_lo.data_ptr(), bb_ext.data_ptr(), n, dirbins, key.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}")
    COUNTS["coherence_key.launches_f64" if f64
           else "coherence_key.launches"] += 1
    return key


def permute_state_ref(take, state: RayState, aux=None):
    """(RayState, aux) with every array at ``take`` (plain): one indexing op
    per array, the JAX package's ``_permute_state`` for a state of any
    type (viennaray_tpu/trace/kernel.py:442-447)."""
    return (RayState(*(x[take] for x in state)),
            None if aux is None else aux[take])


def _check_state(take, state, aux):
    org = state.org
    if take.ndim != 1 or take.dtype != torch.int64:
        raise TypeError("take must be (n,) int64")
    R = org.shape[0]
    if take.shape[0] > R:
        raise ValueError(f"take has {take.shape[0]} lanes, the state {R}")
    if org.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"org must be float32 or float64, got {org.dtype}")
    fdt = org.dtype
    want = {
        "org": ((R, 3), fdt), "dirn": ((R, 3), fdt), "weight": ((R,), fdt),
        "w0": ((R,), fdt), "alive": ((R,), torch.bool),
        "hfb": ((R,), torch.bool), "n_refl": ((R,), torch.int32),
        "n_bdry": ((R,), torch.int32),
    }
    arrays = list(zip(RayState._fields, state)) + [("take", take)]
    if aux is not None:
        if aux.ndim != 2 or aux.shape[0] != R or aux.dtype != fdt:
            raise ValueError(f"aux must be (R, A) {fdt} with R = {R}")
        arrays.append(("aux", aux))
    for name, x in arrays:
        if name in want and (tuple(x.shape), x.dtype) != want[name]:
            raise ValueError(f"{name} must be {want[name][0]} "
                             f"{want[name][1]}, got {tuple(x.shape)} "
                             f"{x.dtype}")
        if x.device != org.device:
            raise ValueError(f"{name} is on {x.device}, org on {org.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def permute_state(take, state: RayState, aux=None):
    """Every per-ray array of ``state`` (and ``aux``) at ``take``: returns
    (RayState, aux) of len(take) lanes, contiguous, ``permute_state_ref``'s
    bit for bit.

    take (n,) int64 with entries in [0, R), n <= R (a compaction keeps the
    first n of its order); state a ``RayState`` of R lanes, float32 or
    float64 (the float64 form, counted in ``permute_state.launches_f64``);
    aux None or (R, A) of the state's type. On CUDA tensors launches
    ``vr_permute_state`` once or raises; on CPU tensors runs the plain
    version."""
    _check_state(take, state, aux)
    org = state.org
    if org.device.type == "cpu":
        return permute_state_ref(take, state, aux)
    if org.device.type != "cuda":
        raise RuntimeError(f"permute_state: unsupported device {org.device}")
    n = take.shape[0]
    out = RayState(*(x.new_empty((n,) + tuple(x.shape[1:])) for x in state))
    aux_out = None if aux is None else aux.new_empty((n, aux.shape[1]))
    n_aux = 0 if aux is None else aux.shape[1]
    if n == 0:
        return out, aux_out
    f64 = org.dtype == torch.float64
    entry = "vr_permute_state" + ("_f64" if f64 else "")
    lib = _build.library()
    with torch.cuda.device(org.device):
        err = getattr(lib, entry)(
            take.data_ptr(), n, org.shape[0],
            *(x.data_ptr() for x in state),
            0 if aux is None else aux.data_ptr(), n_aux,
            *(x.data_ptr() for x in out),
            0 if aux_out is None else aux_out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}")
    COUNTS["permute_state.launches_f64" if f64
           else "permute_state.launches"] += 1
    return out, aux_out


telemetry.declare(*(f"{name}.{what}"
                    for name in ("coherence_key", "permute_state")
                    for what in ("launches", "launches_f64")))
