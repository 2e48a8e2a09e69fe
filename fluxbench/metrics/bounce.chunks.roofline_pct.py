"""Kernel 4 on the chunk search (``bounce_kernel``): its bytes bound
(``readers.bounce_bytes``: segments from ``TraceInfo.total_rays_traced``,
disks read once an apply) at the card's HBM peak, over the device time of
the kernels named ``bounce_kernel``, in %. The same work whatever
implements the search."""

from fluxbench.readers import bounce_bytes, bytes_bound_roofline_pct

PATTERN = r"\bbounce_kernel\b"


def read(run):
    rpp = int(run.config["rays_per_point"])
    return bytes_bound_roofline_pct(
        run, PATTERN, lambda it: bounce_bytes(it, rpp))
