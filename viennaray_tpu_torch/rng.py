"""Random numbers for the trace, asked for by purpose.

The trace never holds a generator of its own. It asks a ``RayRNG`` for
uniforms in [0, 1) by purpose: ``uniform(stream, batch_index, bounce, n)``.
The streams are the two draws of the source origin, the two of the source
direction, the two of the lobe of a source that draws no origin (grid and
surface sources), the two of the diffuse reflection, the azimuth of the coned-cosine
reflection, the roulette draw, and the three of gas scattering: the
probability draw, which is also the scatter point's distance, and the two of
the new direction (``STREAMS``). A launch of several bounces asks for all its
uniforms at once: ``uniform_block(batch_index, bounce, n, n_cols)``. The
polar angle of the coned-cosine reflection is an accept-reject of several
rounds and has a method of its own, ``cone_theta``.

Why an interface: the JAX package keys its uniforms with threefry
(``fold_in(base, batch) -> fold_in(batch, bounce) -> split``). The port holds
no threefry; its default implementation is one ``torch.Generator``. A test
can still supply an implementation that returns the JAX package's own
uniforms for each (stream, batch, bounce) and so compare the two traces lane
by lane.

Contract kept by every implementation: a fixed seed and a fixed batch size
give the same numbers on the same device, and a batch's numbers depend on its
global index only, not on which batches ran before it.
"""

from __future__ import annotations

import hashlib

import torch

from .ops import sampling

SOURCE_ORIGIN_1 = "source_origin_1"
SOURCE_ORIGIN_2 = "source_origin_2"
SOURCE_DIR_1 = "source_dir_1"
SOURCE_DIR_2 = "source_dir_2"
SOURCE_LOBE_1 = "source_lobe_1"
SOURCE_LOBE_2 = "source_lobe_2"
REFLECT_1 = "reflect_1"
REFLECT_2 = "reflect_2"
CONE_PHI = "cone_phi"
ROULETTE = "roulette"
SCATTER = "scatter"
SCATTER_Z = "scatter_z"
SCATTER_PHI = "scatter_phi"
STREAMS = (
    SOURCE_ORIGIN_1, SOURCE_ORIGIN_2, SOURCE_DIR_1, SOURCE_DIR_2,
    SOURCE_LOBE_1, SOURCE_LOBE_2, REFLECT_1, REFLECT_2, CONE_PHI, ROULETTE, SCATTER, SCATTER_Z,
    SCATTER_PHI,
)


class RayRNG:
    """Interface: uniforms by purpose.

    ``begin_batch(batch_index)`` is called once before a mega-batch's first
    draw. ``uniform`` returns ``n`` float32 uniforms in [0, 1) on the trace's
    device. ``bounce`` is the wavefront iteration for the reflection,
    roulette and scattering streams; for the source-direction streams it
    counts the rounds of the tilted source's accept-reject loop (0 for the
    plain lobe, -1 for the lobe that lanes fall back to when no round
    accepted). ``uniform_block`` returns an (n, n_cols) block for the launch
    that starts at iteration ``bounce`` and runs ``n_cols / n_uni`` bounces,
    ``n_uni`` = 3, or 6 with gas scattering: per bounce the columns
    [reflection 1 (the coned-cosine launch overwrites it with theta),
    reflection 2, roulette, then scatter, scatter z, scatter phi].
    ``cone_theta`` returns the coned-cosine lobe's polar angles for the launch
    that starts at ``bounce``: ``shape`` is (n,) for a launch of one bounce
    and (n, n_sub) for one of several.
    """

    def begin_batch(self, batch_index: int) -> None:
        raise NotImplementedError

    def uniform(self, stream: str, batch_index: int, bounce: int,
                n: int) -> torch.Tensor:
        raise NotImplementedError

    def uniform_block(self, batch_index: int, bounce: int, n: int,
                      n_cols: int) -> torch.Tensor:
        raise NotImplementedError

    def cone_theta(self, batch_index: int, bounce: int, shape,
                   cone_angle: float) -> torch.Tensor:
        raise NotImplementedError


class GeneratorRNG(RayRNG):
    """Default implementation: one ``torch.Generator`` on the trace's device,
    re-seeded for each mega-batch from (base seed, global batch index). The
    numbers then follow from the order of the draws, which the trace keeps
    fixed, so ``stream`` and ``bounce`` only document the call."""

    def __init__(self, seed: int, device):
        self._seed = int(seed)
        self._device = torch.device(device)
        self._generator = torch.Generator(device=self._device)
        self._batch = None

    def begin_batch(self, batch_index: int) -> None:
        digest = hashlib.sha256(
            f"{self._seed}:{int(batch_index)}".encode()
        ).digest()
        self._generator.manual_seed(
            int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)
        )
        self._batch = int(batch_index)

    def _rand(self, batch_index, shape):
        if batch_index != self._batch:
            raise RuntimeError(
                f"draw for batch {batch_index} but batch {self._batch} is "
                "open: call begin_batch first"
            )
        return torch.rand(
            shape, generator=self._generator, device=self._device,
            dtype=torch.float32,
        )

    def uniform(self, stream, batch_index, bounce, n):
        if stream not in STREAMS:
            raise ValueError(f"unknown stream {stream!r}")
        return self._rand(batch_index, n)

    def uniform_block(self, batch_index, bounce, n, n_cols):
        return self._rand(batch_index, (n, n_cols))

    def cone_theta(self, batch_index, bounce, shape, cone_angle):
        """The rejection runs here, each round drawing two uniforms for every
        lane, until every lane has accepted (at most 64 rounds)."""
        return sampling.coned_cosine_theta(
            lambda i: (self._rand(batch_index, shape),
                       self._rand(batch_index, shape)),
            shape, cone_angle, self._device,
        )
