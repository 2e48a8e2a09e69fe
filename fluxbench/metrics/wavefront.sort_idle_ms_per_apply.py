"""The device's idle ms per apply while the host was inside the program's
``source`` (source sampling and its sort), ``compact`` (a ladder step's
compaction or cut) and ``resort`` spans. Each idle gap of the traced window
goes to the innermost program span at its midpoint; mean over the window's
applies."""

from fluxbench.program_spans import SORT, idle_ms_per_apply


def read(run):
    return idle_ms_per_apply(run, SORT)
