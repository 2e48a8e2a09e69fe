"""``normalize_flux(flux)`` (SOURCE): per source ray and unit area."""


def run(program, it):
    it.output = program.tracer.normalize_flux(it.output)
    it.divisor = 1.0


def reference(traced, values):
    return traced.normalize(values)
