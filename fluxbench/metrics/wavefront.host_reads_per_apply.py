"""Blocking reads from the device to the host per apply, as the program
counts them (``trace.kernel.trace_batch.host_reads``: the survivor count
before each batch's ladder and after each launch, each batch's counters,
the apply's flux), carried by its ``apply`` span; mean over the traced
window's applies."""

from fluxbench.program_spans import counter_per_apply


def read(run):
    return counter_per_apply(run, "host_reads")
