"""Typed containers and numpy interop."""

from .interop import from_numpy, to_numpy
from .typing import DescentParameters, SinkhornPotentials

__all__ = ["DescentParameters", "SinkhornPotentials", "from_numpy", "to_numpy"]
