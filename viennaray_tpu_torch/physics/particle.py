"""Particle models.

Counterpart of ``viennaray_tpu/physics/particle.py``: the reference's CRTP
particles (rayParticle.hpp:21-124) as one dataclass of parameters plus a
reflection-model selector (``ops/bounce.py:bounce_step`` applies the model).
``DiffuseParticle``, ``SpecularParticle`` and ``ConedCosineParticle`` are
ported, with per-material sticking and gas scattering (``mean_free_path``).
Several data labels give a custom ``collision_fn`` that many flux channels
(``trace.kernel.trace_batch``); without one the first label takes the flux.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..config import ReflectionKind
from . import reflection


@dataclasses.dataclass(frozen=True)
class Particle:
    """A particle species' parameters.

    Attributes:
      sticking: default sticking probability: a float, or a 0-d float32
        tensor whose graph the differentiable trace keeps (``diff``).
      cosine_exponent: power of the source cosine lobe
        (ref: getSourceDistributionPower, rayParticle.hpp:69).
      cone_angle: max cone angle for CONED_COSINE reflection.
      material_sticking: optional (num_materials,) sticking lookup by material
        id (ref GPU per-material sticking map, rayParticle.hpp:213): a
        sequence of floats, or a float32 tensor whose graph the
        differentiable trace keeps.
      direction: optional fixed initial direction (3,) overriding the
        source's sampled direction for every ray (rayParticle.hpp:31,92);
        normalized (and z-flattened in 2D) by the trace.
      mean_free_path: gas-phase scattering mean free path; <= 0 disables
        (ref: getMeanFreePath, rayParticle.hpp:73).
      reflection_kind: reflection model selector.
      data_labels: names of the flux channels this particle fills
        (ref: getLocalDataLabels, rayParticle.hpp:78).
      name: species name.
    """

    sticking: object  # float, or a 0-d float tensor
    cosine_exponent: float = 1.0
    cone_angle: float = 0.0
    material_sticking: Optional[object] = None  # floats, or a tensor
    direction: Optional[Tuple[float, float, float]] = None
    mean_free_path: float = -1.0
    reflection_kind: int = int(ReflectionKind.DIFFUSE)
    data_labels: Tuple[str, ...] = ("flux",)
    name: str = "particle"

    def replace(self, **changes) -> "Particle":
        """A copy with ``changes`` (the JAX package's ``struct`` method)."""
        return dataclasses.replace(self, **changes)

    def reflect(self, rng, ray_dir, normal, dim: int) -> torch.Tensor:
        """New unit directions (R, 3) of rays ``ray_dir`` (R, 3) reflected
        off ``normal`` (R, 3) by the particle's model: the JAX package's
        ``reflect(key, ray_dir, normal, dim)``
        (viennaray_tpu/physics/particle.py:72-78), for a ``reflection_fn``
        hook. ``rng`` is the hook's ``rng.HookRNG``: its ``reflect_uniforms``
        are the numbers the built-in reflection draws at this bounce, so a
        hook that reflects with this reflects as the built-in body does, bit
        for bit. A coned-cosine particle at a cone angle <= 0 or >= pi/2
        reflects with the specular or the diffuse model, as that body does
        (``reflection.cone_limit_kind``)."""
        kind = ReflectionKind(self.reflection_kind)
        if kind == ReflectionKind.CONED_COSINE:
            limit = reflection.cone_limit_kind(self.cone_angle)
            kind = kind if limit is None else limit
        u1, u2 = rng.reflect_uniforms
        if kind == ReflectionKind.DIFFUSE:
            return reflection.diffuse(u1, u2, normal, dim)
        if kind == ReflectionKind.SPECULAR:
            return reflection.specular(ray_dir, normal, dim)
        # coned-cosine: the polar angle arrives where diffuse's u1 does
        return reflection.coned_cosine(u1, u2, ray_dir, normal, dim)

    def sticking_for(self, material_ids: torch.Tensor,
                     dtype=torch.float32) -> torch.Tensor:
        """Per-hit sticking of ``dtype`` (float32, or float64 for the float64
        trace) on the ids' device: the material table where one is set (ids
        below 0 read entry 0), else the scalar. A sticking value or table
        given as a tensor keeps its graph."""
        dev = material_ids.device
        if self.material_sticking is None:
            return torch.as_tensor(self.sticking, dtype=dtype,
                                   device=dev).expand(material_ids.shape)
        table = torch.as_tensor(self.material_sticking, dtype=dtype,
                                device=dev)
        return table[torch.clamp(material_ids, min=0).long()]


def DiffuseParticle(
    sticking_probability: float,
    data_label: str = "flux",
    material_sticking=None,
) -> Particle:
    """Constant-sticking diffuse particle (ref: rayParticle.hpp:126-163)."""
    return Particle(
        sticking=float(sticking_probability),
        cosine_exponent=1.0,
        material_sticking=material_sticking,
        reflection_kind=int(ReflectionKind.DIFFUSE),
        data_labels=(data_label,),
        name="DiffuseParticle",
    )


def SpecularParticle(
    sticking_probability: float,
    source_power: float,
    data_label: str = "flux",
    material_sticking=None,
    direction=None,
) -> Particle:
    """Constant-sticking specular particle (ref: rayParticle.hpp:165-204).

    ``direction``: optional fixed initial direction (the GPU particle
    struct's ``direction`` field, rayParticle.hpp:217)."""
    return Particle(
        sticking=float(sticking_probability),
        cosine_exponent=float(source_power),
        material_sticking=material_sticking,
        direction=None if direction is None else tuple(
            float(x) for x in direction
        ),
        reflection_kind=int(ReflectionKind.SPECULAR),
        data_labels=(data_label,),
        name="SpecularParticle",
    )


def ConedCosineParticle(
    sticking_probability: float,
    cone_angle: float,
    source_power: float = 1.0,
    data_label: str = "flux",
) -> Particle:
    """Coned-cosine reflecting particle (reflection: rayReflection.hpp:52-120)."""
    return Particle(
        sticking=float(sticking_probability),
        cosine_exponent=float(source_power),
        cone_angle=float(cone_angle),
        reflection_kind=int(ReflectionKind.CONED_COSINE),
        data_labels=(data_label,),
        name="ConedCosineParticle",
    )
