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
rounds and has a method of its own, ``cone_theta``. A custom particle's hooks
draw through a ``HookRNG`` handle from streams of their own
(``HOOK_STREAMS``), which never move the trace's own draws.

Why an interface: the JAX package keys its uniforms with threefry
(``fold_in(base, batch) -> fold_in(batch, bounce) -> split``). The port holds
no threefry; its default implementation is one ``torch.Generator``. A test
can still supply an implementation that returns the JAX package's own
uniforms for each (stream, batch, bounce) and so compare the two traces lane
by lane.

Contract kept by every implementation: a fixed seed and a fixed batch size
give the same numbers on the same device, and a batch's numbers depend on its
global index only, not on which batches ran before it.

Float type: an implementation draws in its ``dtype`` attribute, float32 by
default (an implementation without one draws float32). The float64 trace
(a geometry widened by ``to(torch.float64)``) asks for a float64 one, as the
JAX package under ``jax_enable_x64`` draws its uniforms in the geometry's
type: ``GeneratorRNG(seed, device, dtype=torch.float64)``.
"""

from __future__ import annotations

import hashlib
import math

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
# the streams of a custom particle's hooks (``HookRNG``)
HOOK_INIT_DIR = "hook_init_dir"
HOOK_AUX_INIT = "hook_aux_init"
HOOK_LOG = "hook_log"
HOOK_REFLECTION = "hook_reflection"
HOOK_COLLISION = "hook_collision"
HOOK_STREAMS = (
    HOOK_INIT_DIR, HOOK_AUX_INIT, HOOK_LOG, HOOK_REFLECTION, HOOK_COLLISION,
)
STREAMS = (
    SOURCE_ORIGIN_1, SOURCE_ORIGIN_2, SOURCE_DIR_1, SOURCE_DIR_2,
    SOURCE_LOBE_1, SOURCE_LOBE_2, REFLECT_1, REFLECT_2, CONE_PHI, ROULETTE, SCATTER, SCATTER_Z,
    SCATTER_PHI,
) + HOOK_STREAMS


class RayRNG:
    """Interface: uniforms by purpose.

    ``begin_batch(batch_index)`` is called once before a mega-batch's first
    draw. ``uniform`` returns ``n`` uniforms in [0, 1) of ``dtype`` on the
    trace's device. ``bounce`` is the wavefront iteration for the reflection,
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
    and (n, n_sub) for one of several. ``hook_uniform`` returns uniforms of
    any ``shape`` for a hook's ``call``-th draw (0, 1, ...) from one of
    ``HOOK_STREAMS`` at ``bounce`` (0 for the hooks that run once a batch).
    """

    dtype = torch.float32

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

    def hook_uniform(self, stream: str, batch_index: int, bounce: int, shape,
                     call: int) -> torch.Tensor:
        raise NotImplementedError


class HookRNG:
    """The ``rng`` a custom particle's hook receives, in place of the JAX
    package's key: bound to one (batch, bounce, hook), it draws uniforms of
    the trace's ``RayRNG``'s type under the hook's own stream, keyed
    by (batch, bounce, stream, call), so they never move the trace's own
    draws. Each call draws fresh numbers; the same trace makes the same
    calls, so a fixed seed gives the same numbers.

    The handle of a ``reflection_fn`` also carries ``reflect_uniforms``: the
    two uniforms of each lane that the particle's built-in reflection would
    have used at this bounce (diffuse: the sphere point's pair; coned-cosine:
    theta and the azimuth's uniform; specular: zeros). With them
    ``physics.reflection.diffuse(u1, u2, normal, dim)`` gives the built-in
    diffuse reflection bit for bit.
    """

    def __init__(self, rng: RayRNG, stream: str, batch_index: int,
                 bounce: int = 0, reflect_uniforms=None):
        if stream not in HOOK_STREAMS:
            raise ValueError(f"unknown hook stream {stream!r}")
        self._rng = rng
        self._stream = stream
        self._batch = int(batch_index)
        self._bounce = int(bounce)
        self._calls = 0
        self._reflect = reflect_uniforms

    @property
    def reflect_uniforms(self):
        if self._reflect is None:
            raise AttributeError(
                f"only a reflection_fn's handle carries reflect_uniforms, "
                f"not {self._stream}'s"
            )
        return self._reflect

    def uniform(self, shape) -> torch.Tensor:
        """Uniforms in [0, 1) of ``shape`` (an int or a tuple)."""
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        u = self._rng.hook_uniform(self._stream, self._batch, self._bounce,
                                   shape, self._calls)
        self._calls += 1
        return u

    def normal(self, shape) -> torch.Tensor:
        """Standard normal numbers of ``shape`` from one draw of uniforms, by
        the inverse error function (as ``jax.random.normal`` maps its own
        uniforms)."""
        u = self.uniform(shape)
        lo = torch.nextafter(torch.tensor(-1.0, dtype=u.dtype),
                             torch.tensor(0.0, dtype=u.dtype)).item()
        v = torch.clamp(u * (1.0 - lo) + lo, min=lo)
        return torch.erfinv(v) * math.sqrt(2.0)


class GeneratorRNG(RayRNG):
    """Default implementation: one ``torch.Generator`` on the trace's device,
    re-seeded for each mega-batch from (base seed, global batch index). The
    numbers then follow from the order of the draws, which the trace keeps
    fixed, so ``stream`` and ``bounce`` only document the call. The hooks
    draw from a second generator (``hook_uniform``). ``dtype``: float32 (the
    default), or float64 for the float64 trace; ``torch.rand`` draws in
    it."""

    def __init__(self, seed: int, device, dtype=torch.float32):
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"GeneratorRNG draws float32 or float64, not "
                             f"{dtype}")
        self.dtype = dtype
        self._seed = int(seed)
        self._device = torch.device(device)
        self._generator = torch.Generator(device=self._device)
        self._hook_generator = torch.Generator(device=self._device)
        self._batch = None

    @staticmethod
    def _seed_of(*parts) -> int:
        digest = hashlib.sha256(":".join(map(str, parts)).encode()).digest()
        return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)

    def begin_batch(self, batch_index: int) -> None:
        self._generator.manual_seed(self._seed_of(self._seed, int(batch_index)))
        self._batch = int(batch_index)

    def _rand(self, batch_index, shape):
        if batch_index != self._batch:
            raise RuntimeError(
                f"draw for batch {batch_index} but batch {self._batch} is "
                "open: call begin_batch first"
            )
        return torch.rand(
            shape, generator=self._generator, device=self._device,
            dtype=self.dtype,
        )

    def uniform(self, stream, batch_index, bounce, n):
        if stream not in STREAMS:
            raise ValueError(f"unknown stream {stream!r}")
        return self._rand(batch_index, n)

    def uniform_block(self, batch_index, bounce, n, n_cols):
        return self._rand(batch_index, (n, n_cols))

    def hook_uniform(self, stream, batch_index, bounce, shape, call):
        """A generator of its own, seeded for each call from (base seed,
        batch, stream, bounce, call): a hook's draws never move the trace's
        own."""
        if stream not in HOOK_STREAMS:
            raise ValueError(f"unknown hook stream {stream!r}")
        if batch_index != self._batch:
            raise RuntimeError(
                f"draw for batch {batch_index} but batch {self._batch} is "
                "open: call begin_batch first"
            )
        self._hook_generator.manual_seed(self._seed_of(
            self._seed, int(batch_index), stream, int(bounce), int(call)))
        return torch.rand(tuple(shape), generator=self._hook_generator,
                          device=self._device, dtype=self.dtype)

    def cone_theta(self, batch_index, bounce, shape, cone_angle):
        """The rejection runs here, each round drawing two uniforms for every
        lane, until every lane has accepted (at most 64 rounds)."""
        return sampling.coned_cosine_theta(
            lambda i: (self._rand(batch_index, shape),
                       self._rand(batch_index, shape)),
            shape, cone_angle, self._device, self.dtype,
        )
