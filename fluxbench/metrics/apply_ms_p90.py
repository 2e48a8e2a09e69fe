"""The 90th percentile of the window's apply wall times (host clock, each
ending in the copy of the flux to the host that ``apply`` makes), in ms;
``statistics.quantiles(..., n=10, method="inclusive")``."""

import statistics

from fluxbench.readers import spans_s


def read(run):
    ms = [1e3 * s for s in spans_s(run, "apply")]
    if len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=10, method="inclusive")[-1]
