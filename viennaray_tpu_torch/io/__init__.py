"""Geometry fixtures (readers and writers are not ported yet)."""

from . import fixtures

__all__ = ["fixtures"]
