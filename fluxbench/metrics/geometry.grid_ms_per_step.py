"""Host ms of the program's ``geometry.grid`` spans per ``set_geometry``: the
grid DDA's tables (``GridData.build``), mean over the traced window's
steps."""

from fluxbench.program_spans import span_ms_per_request


def read(run):
    return span_ms_per_request(run, "geometry.grid", "set_geometry")
