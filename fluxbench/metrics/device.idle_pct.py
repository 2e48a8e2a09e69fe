"""100 x (1 - the union of the device operations' intervals over the traced
window's length): the share of the window in which nothing ran on the card
(``torch.profiler``; kernels, copies and fills alike)."""

from fluxbench.readers import traced


def read(run):
    t = traced(run)
    if t is None:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
