"""Material-id utilities.

Counterpart of ``viennaray_tpu/utils/materials.py`` (kept as a copy): the GPU
tracer's consecutive material remapping (gpu/raygTrace.hpp:299-345). User
material ids can be arbitrary ints; the per-material sticking table wants
dense 0..M-1 indices."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def remap_material_ids(material_ids) -> Tuple[np.ndarray, Dict[int, int]]:
    """Map arbitrary material ids to consecutive 0..M-1.

    Returns (dense_ids (N,) int32, mapping original->dense), with dense ids
    assigned in order of first appearance (matching the reference's pass over
    the array)."""
    material_ids = np.asarray(material_ids)
    mapping: Dict[int, int] = {}
    out = np.zeros(len(material_ids), np.int32)
    for i, m in enumerate(material_ids.tolist()):
        if m not in mapping:
            mapping[m] = len(mapping)
        out[i] = mapping[m]
    return out, mapping


def sticking_table_from_map(mapping: Dict[int, int], sticking_map,
                            default: float = 1.0) -> np.ndarray:
    """Dense (M,) sticking table from {original_material_id: sticking}
    (ref: per-material sticking maps, rayParticle.hpp:213)."""
    table = np.full(len(mapping), default, np.float32)
    for orig, dense in mapping.items():
        if orig in sticking_map:
            table[dense] = sticking_map[orig]
    return table
