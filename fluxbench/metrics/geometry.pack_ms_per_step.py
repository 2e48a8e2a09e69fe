"""Host ms of the program's ``geometry.pack`` spans per ``set_geometry``: the
SoA packing, the tables' copies to the card and the neighbor records, mean
over the traced window's steps."""

from fluxbench.program_spans import span_ms_per_request


def read(run):
    return span_ms_per_request(run, "geometry.pack", "set_geometry")
