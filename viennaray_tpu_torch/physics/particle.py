"""Particle models.

Counterpart of ``viennaray_tpu/physics/particle.py``: the reference's CRTP
particles (rayParticle.hpp:21-124) as one dataclass of parameters plus a
reflection-model selector (``ops/bounce.py:bounce_step`` applies the model).
``DiffuseParticle`` and ``SpecularParticle`` are ported. The dataclass keeps the fields of the settings that are not ported yet
(per-material sticking, cone angle, mean free path, several data labels) so
that the trace can refuse them by name instead of ignoring them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from ..config import ReflectionKind


@dataclasses.dataclass(frozen=True)
class Particle:
    """A particle species' parameters.

    Attributes:
      sticking: default sticking probability.
      cosine_exponent: power of the source cosine lobe
        (ref: getSourceDistributionPower, rayParticle.hpp:69).
      cone_angle: max cone angle for CONED_COSINE reflection (not ported).
      material_sticking: per-material sticking table (not ported).
      direction: optional fixed initial direction (3,) overriding the
        source's sampled direction for every ray (rayParticle.hpp:31,92);
        normalized (and z-flattened in 2D) by the trace.
      mean_free_path: gas-phase scattering mean free path; <= 0 disables
        (scattering is not ported).
      reflection_kind: reflection model selector.
      data_labels: names of the flux channels this particle fills
        (ref: getLocalDataLabels, rayParticle.hpp:78).
      name: species name.
    """

    sticking: float
    cosine_exponent: float = 1.0
    cone_angle: float = 0.0
    material_sticking: Optional[Sequence[float]] = None
    direction: Optional[Tuple[float, float, float]] = None
    mean_free_path: float = -1.0
    reflection_kind: int = int(ReflectionKind.DIFFUSE)
    data_labels: Tuple[str, ...] = ("flux",)
    name: str = "particle"


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
