"""``set_geometry`` of the next cloud of the mix's cycle, ending in a
synchronise. The reference traces the compared cloud itself, so its side
of the step does nothing."""


def run(program, it):
    program.set_geometry()
    program.sync()


def reference(traced, values):
    return values
