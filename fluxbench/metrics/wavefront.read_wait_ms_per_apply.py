"""Host ms inside the program's ``read`` spans per apply: the host waiting
for the card at each blocking read (the survivor counts, the counters, the
flux), mean over the traced window's applies."""

from fluxbench.program_spans import span_ms_per_request


def read(run):
    return span_ms_per_request(run, "read", "apply")
