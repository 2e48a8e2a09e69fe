"""Kernel 4 on the grid walk (``bounce_grid_kernel``): its bytes bound
(``readers.bounce_bytes``: segments from ``TraceInfo.total_rays_traced``,
disks read once an apply; no walk table counted) at the card's HBM peak,
over the device time of the kernels named ``bounce_grid_kernel``, in %."""

from fluxbench.readers import bounce_bytes, bytes_bound_roofline_pct

PATTERN = r"\bbounce_grid_kernel\b"


def read(run):
    rpp = int(run.config["rays_per_point"])
    return bytes_bound_roofline_pct(
        run, PATTERN, lambda it: bounce_bytes(it, rpp))
