"""The device's idle ms per apply while the host was inside the program's
``launch`` spans (a launch's uniforms, the bounce kernel's call, the
deposits handed out and their ``deposit`` spans): the bounce loop's glue.
Each idle gap of the traced window goes to the innermost program span at
its midpoint; mean over the window's applies."""

from fluxbench.program_spans import LAUNCH, idle_ms_per_apply


def read(run):
    return idle_ms_per_apply(run, LAUNCH)
