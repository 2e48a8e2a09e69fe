"""Device kernels (the port's and torch's alike; copies and fills left out)
that start inside the benchmark's ``apply`` spans, per apply
(``torch.profiler``): each one a launch the host issued."""

import numpy as np

from fluxbench.readers import traced


def read(run):
    t = traced(run)
    if t is None:
        return None
    spans = t.spans("apply")
    if len(spans) == 0:
        return None
    starts = t.kernel_starts()
    inside = (np.searchsorted(starts, spans[:, 1], side="right")
              - np.searchsorted(starts, spans[:, 0], side="left"))
    return float(inside.sum()) / len(spans)
