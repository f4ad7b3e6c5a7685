"""Forward-mode dual numbers on tensors: the plain twin of ``csrc/dual.cuh``.

A :class:`Dual` holds a value tensor ``v`` and its partials ``d`` with one
trailing axis of length K (the kernel's own inputs).  Every rule here is
the one ``dual.cuh`` applies, with the same operands in the same order, so
a kernel and its plain PyTorch twin agree to rounding.  K1
(``spin_phase``) uses them; K2 computes its partials by a reverse sweep
instead (``models/binary/engines.py``).

The kernels' ``backward`` shares :func:`row_cotangent` and
:func:`toa_cotangent`: with the local partials P (B, N, K) saved at the
forward, an input's cotangent is the output cotangent contracted with
its columns of P, mapped as each ``jvp`` maps tangents to columns, and
summed over the axes the input was broadcast along.
"""

from __future__ import annotations

import torch

__all__ = ["Dual", "val", "seed", "sum_to", "row_cotangent",
           "toa_cotangent"]


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


# ---------------------------------------------------------------------------
# reverse mode through the partials
# ---------------------------------------------------------------------------
def sum_to(g, shape):
    """``g`` summed over its leading axes and the unit axes of ``shape``
    (the input's own shape, before the kernel broadcast it); None stays
    None."""
    if g is None or shape is None:
        return None
    while g.ndim > len(shape):
        g = g.sum(0)
    dims = [i for i, (a, b) in enumerate(zip(g.shape, shape))
            if b == 1 and a != 1]
    return g.sum(dims, keepdim=True) if dims else g


def row_cotangent(grad, cols, shape):
    """Cotangent of a per-row input (B, K) whose K entries have the
    partials ``cols`` (B, N, K): the sum over the TOAs of ``grad`` (B, N)
    times each column, summed to ``shape``."""
    return sum_to((grad.unsqueeze(-2) @ cols).squeeze(-2), shape)


def toa_cotangent(grad, col, shape):
    """Cotangent of a per-TOA input (B, N) whose partial is ``col`` (B,
    N), summed to ``shape``."""
    return sum_to(grad * col, shape)
