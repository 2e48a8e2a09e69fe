"""The host clock around ``set_geometry`` (ending in a synchronise), mean
over the window's steps, in ms: the host geometry build (neighborhood,
packing, grid tables) of a step's new cloud."""

from fluxbench.readers import spans_s


def read(run):
    ms = [1e3 * s for s in spans_s(run, "set_geometry")]
    if not ms:
        return None
    return sum(ms) / len(ms)
