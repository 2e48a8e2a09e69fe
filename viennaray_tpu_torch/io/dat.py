"""Readers for the reference's plain-text geometry formats.

A copy of ``viennaray_tpu/io/dat.py`` (numpy only).

- ``read_grid_from_file``: point/normal grids (ref: rayUtil.hpp:353-372);
  format: numPoints, gridDelta, then points, then normals.
- ``read_mesh_from_file``: node/element meshes (ref: rayUtil.hpp:374-411);
  format: 'grid_delta' v, 'n_nodes' n, 'n_elements' m, 'n' x y z ..., 'e' i j [k] ...
"""

from __future__ import annotations

import numpy as np


def read_grid_from_file(path: str):
    """Returns (grid_delta, points (N,3), normals (N,3))."""
    with open(path) as f:
        tokens = f.read().split()
    it = iter(tokens)
    num_points = int(next(it))
    grid_delta = float(next(it))
    vals = np.array([float(next(it)) for _ in range(num_points * 6)], np.float32)
    points = vals[: num_points * 3].reshape(num_points, 3)
    normals = vals[num_points * 3:].reshape(num_points, 3)
    return grid_delta, points, normals


def read_mesh_from_file(path: str, dim: int):
    """Returns (grid_delta, nodes (V,3), elements (N,dim))."""
    with open(path) as f:
        tokens = f.read().split()
    it = iter(tokens)
    assert next(it) == "grid_delta"
    grid_delta = float(next(it))
    assert next(it) == "n_nodes"
    num_nodes = int(next(it))
    assert next(it) == "n_elements"
    num_elements = int(next(it))
    nodes = np.zeros((num_nodes, 3), np.float32)
    for i in range(num_nodes):
        assert next(it) == "n"
        nodes[i] = [float(next(it)), float(next(it)), float(next(it))]
    # Tolerate headers that overstate the element count (the reference's own
    # lineMesh.dat says 130 but contains 129; the reference reader's asserts
    # compile out in Release and the stream just stops, rayUtil.hpp:404-409)
    elements = np.zeros((num_elements, dim), np.uint32)
    count = num_elements
    for i in range(num_elements):
        try:
            tok = next(it)
        except StopIteration:
            count = i
            break
        assert tok == "e"
        elements[i] = [int(next(it)) for _ in range(dim)]
    if count != num_elements:
        import warnings

        warnings.warn(
            f"{path}: header declares {num_elements} elements, file has "
            f"{count}; truncating"
        )
        elements = elements[:count]
    return grid_delta, nodes, elements
