"""Forward-mode dual numbers on tensors: the plain twin of ``csrc/dual.cuh``.

A :class:`Dual` holds a value tensor ``v`` and its partials ``d`` with one
trailing axis of length K (the kernel's own inputs).  Every rule here is
the one ``dual.cuh`` applies, with the same operands in the same order, so
a kernel and its plain PyTorch twin agree to rounding.  The elementary
functions accept plain tensors too, so one body of arithmetic serves both
the primal-only and the partials form of a twin.
"""

from __future__ import annotations

import torch

__all__ = ["Dual", "val", "sin", "cos", "sqrt", "log", "atan2", "clip",
           "seed"]


def _e(x):
    """Value tensor with a trailing unit axis, to scale partials."""
    return x.unsqueeze(-1) if torch.is_tensor(x) else x


class Dual:
    __slots__ = ("v", "d")

    def __init__(self, v, d):
        self.v = v
        self.d = d

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, b):
        if isinstance(b, Dual):
            return Dual(self.v + b.v, self.d + b.d)
        return Dual(self.v + b, self.d)

    def __radd__(self, a):
        return Dual(a + self.v, self.d)

    def __neg__(self):
        return Dual(-self.v, -self.d)

    def __sub__(self, b):
        if isinstance(b, Dual):
            return Dual(self.v - b.v, self.d - b.d)
        return Dual(self.v - b, self.d)

    def __rsub__(self, a):
        return Dual(a - self.v, -self.d)

    def __mul__(self, b):
        if isinstance(b, Dual):
            return Dual(self.v * b.v, self.d * _e(b.v) + _e(self.v) * b.d)
        return Dual(self.v * b, self.d * _e(b))

    def __rmul__(self, a):
        return Dual(a * self.v, _e(a) * self.d)

    def __truediv__(self, b):
        if isinstance(b, Dual):
            v = self.v / b.v
            return Dual(v, (self.d - _e(v) * b.d) / _e(b.v))
        return Dual(self.v / b, self.d / _e(b))

    def __rtruediv__(self, a):
        v = a / self.v
        return Dual(v, (-(_e(v) * self.d)) / _e(self.v))


def val(x):
    """The value part of a Dual, or the tensor itself."""
    return x.v if isinstance(x, Dual) else x


def seed(v, index: int, k: int) -> Dual:
    """``v`` as the ``index``-th of ``k`` independent variables."""
    d = torch.zeros(v.shape + (k,), dtype=v.dtype, device=v.device)
    d[..., index] = 1.0
    return Dual(v, d)


def sin(x):
    if isinstance(x, Dual):
        return Dual(torch.sin(x.v), x.d * _e(torch.cos(x.v)))
    return torch.sin(x)


def cos(x):
    if isinstance(x, Dual):
        return Dual(torch.cos(x.v), x.d * _e(-torch.sin(x.v)))
    return torch.cos(x)


def sqrt(x):
    if isinstance(x, Dual):
        v = torch.sqrt(x.v)
        return Dual(v, x.d * _e(0.5 / v))
    return torch.sqrt(x)


def log(x):
    if isinstance(x, Dual):
        return Dual(torch.log(x.v), x.d / _e(x.v))
    return torch.log(x)


def atan2(y, x):
    if isinstance(y, Dual):
        v = torch.atan2(y.v, x.v)
        den = x.v * x.v + y.v * y.v
        return Dual(v, (_e(x.v) * y.d - _e(y.v) * x.d) / _e(den))
    return torch.atan2(y, x)


def clip(x, lo: float, hi: float):
    """Clip that keeps NaN (a NaN fails both comparisons and passes through
    with its tangent); a clipped element's tangent is zero."""
    v = val(x)
    below, above = v < lo, v > hi
    out = torch.where(below, lo, torch.where(above, hi, v))
    if isinstance(x, Dual):
        return Dual(out, torch.where(_e(below | above), 0.0, x.d))
    return out
