"""Seconds from the start of the process (the top of ``fluxbench.run``) to
the window's start: imports, the library's load (its build on the first run
in a checkout), the clouds, the geometry build and the warm-up iterations."""


def read(run):
    return run.setup_s
