"""``apply()``: the flux of every disk, summed over the apply's rays; the
reference's is its deposits per ray."""


def run(program, it):
    it.output = program.tracer.apply()
    info = program.tracer.get_ray_trace_info()
    rays = program.setup.rays_per_apply(program.tracer, program.config)
    it.add_apply((info.geometry_hits, info.num_rays, info.total_rays_traced),
                 rays)
    it.divisor = rays  # the output over its rays is the reference's units


def reference(traced, values):
    return traced.flux / traced.rays.double()[:, None]
