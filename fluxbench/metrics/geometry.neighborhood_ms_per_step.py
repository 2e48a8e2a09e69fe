"""Host ms of the program's ``geometry.neighborhood`` spans per
``set_geometry``: the neighbor lists (``neighborhood.build_neighborhood``),
mean over the traced window's steps."""

from fluxbench.program_spans import span_ms_per_request


def read(run):
    return span_ms_per_request(run, "geometry.neighborhood", "set_geometry")
