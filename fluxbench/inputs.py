"""The seeds of a run, made from ``--seed`` alone: ``seeds`` splits it into
the program's seed, the reference's and a draw for the sample to compare.
A cell's clouds come from its set-up module (``setups/``)."""

from __future__ import annotations

import numpy as np


def seeds(seed):
    """(program seed, reference seed, sample draw) from ``--seed``: three
    independent 63-bit numbers."""
    ss = np.random.SeedSequence(int(seed))
    a, b, c = (int(s.generate_state(1, np.uint64)[0] >> np.uint64(1))
               for s in ss.spawn(3))
    return a, b, c
