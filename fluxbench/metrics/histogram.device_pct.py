"""Kernel 2's share of the device's busy time in the traced window, in %:
the union of the intervals of its kernels (``prepare_kernel``,
``cluster_histogram_kernel``, ``small_cluster_histogram_kernel``; not the
backward's ``gather_grad*``) over the union of all device operations'."""

from fluxbench.readers import traced

PATTERN = r"\b(prepare_kernel|small_cluster_histogram_kernel|cluster_histogram_kernel)\b"


def read(run):
    t = traced(run)
    if t is None:
        return None
    mine = t.busy_s(PATTERN)
    if mine <= 0:
        return None
    return 100.0 * mine / t.busy_s()
