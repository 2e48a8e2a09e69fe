"""VTK / VTP result writers (ports of rayUtil.hpp:413-560).

A copy of ``viennaray_tpu/io/vtk.py`` (numpy only): the same arrays give the
same bytes.

Results are validated against ViennaRay visually/numerically through these
files, so the formats match the reference byte-layout-wise (ASCII):
- ``write_vtk``: legacy VTK point cloud with per-cell flux.
- ``write_vtp``: XML PolyData with lines (2D) or polys (3D) and point-vs-cell
  flux auto-detection.
"""

from __future__ import annotations

import numpy as np


def _clean(flux):
    flux = np.asarray(flux, np.float64)
    return np.where(np.abs(flux) < 1e-6, 0.0, flux)


def write_vtk(filename: str, points, flux, dim: int = 3):
    """Legacy VTK unstructured point cloud (ref: rayUtil.hpp:413-449)."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    flux = _clean(flux)
    n = len(points)
    with open(filename, "w") as f:
        f.write("# vtk DataFile Version 2.0\n")
        f.write(f"{dim}D Surface\n")
        f.write("ASCII\n")
        f.write("DATASET UNSTRUCTURED_GRID\n")
        f.write(f"POINTS {n} float\n")
        for p in points:
            f.write(f"{p[0]} {p[1]} {p[2]} \n")
        f.write(f"CELLS {n} {n * 2}\n")
        for i in range(n):
            f.write(f"1 {i}\n")
        f.write(f"CELL_TYPES {n}\n")
        for _ in range(n):
            f.write("1\n")
        f.write(f"CELL_DATA {len(flux)}\n")
        f.write("SCALARS flux float\n")
        f.write("LOOKUP_TABLE default\n")
        for v in flux:
            f.write(f"{v}\n")


def write_vtp(filename: str, points, elements, flux, dim: int = 3):
    """XML PolyData writer (ref: rayUtil.hpp:451-555)."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    elements = np.asarray(elements, np.int64).reshape(-1, dim)
    flux = _clean(flux)
    n_points = len(points)
    n_elements = len(elements)
    with open(filename, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write(
            '<VTKFile type="PolyData" version="0.1" byte_order="LittleEndian">\n'
        )
        f.write("  <PolyData>\n")
        if dim == 2:
            f.write(
                f'    <Piece NumberOfPoints="{n_points}" NumberOfVerts="0" '
                f'NumberOfLines="{n_elements}" NumberOfStrips="0" '
                f'NumberOfPolys="0">\n'
            )
        else:
            f.write(
                f'    <Piece NumberOfPoints="{n_points}" NumberOfVerts="0" '
                f'NumberOfLines="0" NumberOfStrips="0" '
                f'NumberOfPolys="{n_elements}">\n'
            )
        f.write("      <Points>\n")
        f.write(
            '        <DataArray type="Float32" NumberOfComponents="3" '
            'format="ascii">\n'
        )
        for p in points:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")
        f.write("        </DataArray>\n")
        f.write("      </Points>\n")
        tag = "Lines" if dim == 2 else "Polys"
        f.write(f"      <{tag}>\n")
        f.write(
            '        <DataArray type="Int32" Name="connectivity" format="ascii">\n'
        )
        for e in elements:
            f.write(" ".join(str(int(v)) for v in e) + " \n")
        f.write("        </DataArray>\n")
        f.write('        <DataArray type="Int32" Name="offsets" format="ascii">\n')
        for i in range(n_elements):
            f.write(f"{(i + 1) * dim}\n")
        f.write("        </DataArray>\n")
        f.write(f"      </{tag}>\n")
        if len(flux) == n_points:
            f.write('      <PointData Scalars="flux">\n')
            f.write(
                '        <DataArray type="Float32" Name="flux" format="ascii">\n'
            )
            for v in flux:
                f.write(f"{np.float32(v)}\n")
            f.write("        </DataArray>\n")
            f.write("      </PointData>\n")
        elif len(flux) == n_elements:
            f.write('      <CellData Scalars="flux">\n')
            f.write(
                '        <DataArray type="Float32" Name="flux" format="ascii">\n'
            )
            for v in flux:
                f.write(f"{np.float32(v)}\n")
            f.write("        </DataArray>\n")
            f.write("      </CellData>\n")
        elif len(flux) > 0:
            import sys

            print(
                "write_vtp: flux size does not match points or polys; "
                "skipping data",
                file=sys.stderr,
            )
        f.write("    </Piece>\n")
        f.write("  </PolyData>\n")
        f.write("</VTKFile>\n")
