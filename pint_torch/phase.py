"""Exact pulse phase as an (integer, fractional) pair of float64 tensors.

Port of :mod:`pint_tpu.phase`: the integer part is an integral-valued
float64 and the fraction is kept in [-0.5, 0.5) with carry arithmetic, so
residuals never cancel against ~1e11-cycle absolute phases.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pint_torch.dd import DD, dd_round_split

__all__ = ["Phase", "phase_from_dd"]


def _split(value):
    """Normalize a float64 phase into (int, frac) with frac in [-0.5, 0.5)."""
    k = torch.round(value)
    return k, value - k


class Phase(NamedTuple):
    """Pulse phase split as ``int_ + frac``."""

    int_: torch.Tensor
    frac: torch.Tensor

    @classmethod
    def from_float(cls, value) -> "Phase":
        k, f = _split(value)
        return cls(k, f)

    @classmethod
    def make(cls, int_, frac) -> "Phase":
        """Build from separate parts, re-normalizing the carry."""
        k, f = _split(frac)
        return cls(int_ + k, f)

    @property
    def value(self) -> torch.Tensor:
        return self.int_ + self.frac

    def __add__(self, other: "Phase") -> "Phase":
        if not isinstance(other, Phase):
            other = Phase.from_float(other)
        return Phase.make(self.int_ + other.int_, self.frac + other.frac)

    __radd__ = __add__

    def __sub__(self, other: "Phase") -> "Phase":
        if not isinstance(other, Phase):
            other = Phase.from_float(other)
        return Phase.make(self.int_ - other.int_, self.frac - other.frac)

    def __neg__(self) -> "Phase":
        return Phase(-self.int_, -self.frac)

    def to_float(self) -> torch.Tensor:
        return self.int_ + self.frac


def phase_from_dd(x: DD) -> Phase:
    """Exact split of a double-double cycle count into a Phase."""
    k, f = dd_round_split(x)
    return Phase(k, f)

