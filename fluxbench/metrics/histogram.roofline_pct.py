"""Kernel 2's bytes bound over its device time, in %: each entry's id and
weight read once at the types the histogram receives and each call's bins
written once (``program_spans.histogram_bytes``, from the counters the
program's ``apply`` spans carry), at the card's HBM peak, over the union of
the intervals of the kernels ``histogram.device_pct`` reads."""

from fluxbench.program_spans import histogram_roofline_pct


def read(run):
    return histogram_roofline_pct(run)
