"""The stream's ms of the program's ``deposit`` spans per apply (each
span's ``device_ns``, from CUDA events at its ends: the deposit entries'
tensor work and kernel 2's call on the hand-out path), mean over the traced
window's applies."""

from fluxbench.program_spans import device_ms_per_apply


def read(run):
    return device_ms_per_apply(run, "deposit")
