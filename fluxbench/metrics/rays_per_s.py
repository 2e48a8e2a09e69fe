"""Rays launched by every iteration the window completed, over the host
clock's seconds from the window's start to the last iteration's end: what a
process simulation waits for at a fixed Monte Carlo accuracy. Everything in
the loop body counts (in a step: the geometry rebuild, the normalization and
the smoothing)."""


def read(run):
    its = run.iterations
    if not its:
        return None
    return sum(it.rays for it in its) / (its[-1].end - run.window_start)
