"""Random numbers for the trace, asked for by purpose.

The trace never holds a generator of its own. It asks a ``RayRNG`` for
uniforms in [0, 1) by purpose: ``uniform(stream, batch_index, bounce, n)``.
The streams are the two draws of the source origin, the two of the source
direction, the two of the reflection, and the roulette draw (``STREAMS``).
A launch of several bounces asks for all its reflection and roulette
uniforms at once: ``uniform_block(batch_index, bounce, n, n_cols)``.

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

SOURCE_ORIGIN_1 = "source_origin_1"
SOURCE_ORIGIN_2 = "source_origin_2"
SOURCE_DIR_1 = "source_dir_1"
SOURCE_DIR_2 = "source_dir_2"
REFLECT_1 = "reflect_1"
REFLECT_2 = "reflect_2"
ROULETTE = "roulette"
STREAMS = (
    SOURCE_ORIGIN_1, SOURCE_ORIGIN_2, SOURCE_DIR_1, SOURCE_DIR_2,
    REFLECT_1, REFLECT_2, ROULETTE,
)


class RayRNG:
    """Interface: uniforms by purpose.

    ``begin_batch(batch_index)`` is called once before a mega-batch's first
    draw. ``uniform`` returns ``n`` float32 uniforms in [0, 1) on the trace's
    device. ``bounce`` is the wavefront iteration for the reflection and
    roulette streams; for the source-direction streams it counts the rounds
    of the tilted source's accept-reject loop (0 for the plain lobe, -1 for
    the lobe that lanes fall back to when no round accepted).
    ``uniform_block`` returns an (n, n_cols) block for the launch that starts
    at iteration ``bounce`` and runs ``n_cols / 3`` bounces: per bounce the
    columns [reflection 1, reflection 2, roulette].
    """

    def begin_batch(self, batch_index: int) -> None:
        raise NotImplementedError

    def uniform(self, stream: str, batch_index: int, bounce: int,
                n: int) -> torch.Tensor:
        raise NotImplementedError

    def uniform_block(self, batch_index: int, bounce: int, n: int,
                      n_cols: int) -> torch.Tensor:
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
