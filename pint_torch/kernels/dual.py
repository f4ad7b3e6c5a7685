"""Forward-mode dual numbers on tensors: the plain twin of ``csrc/dual.cuh``.

A :class:`Dual` holds a value tensor ``v`` and its partials ``d`` with one
trailing axis of length K (the kernel's own inputs).  Every rule here is
the one ``dual.cuh`` applies, with the same operands in the same order, so
a kernel and its plain PyTorch twin agree to rounding.  K1
(``spin_phase``) uses them; K2 computes its partials by a reverse sweep
instead (``models/binary/engines.py``).
"""

from __future__ import annotations

import torch

__all__ = ["Dual", "val", "seed"]


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
