"""IO modules: dat readers, VTK/VTP writers, fixtures."""

from . import dat, fixtures, vtk

__all__ = ["dat", "fixtures", "vtk"]
