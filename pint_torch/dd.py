"""Double-double ("two-float") arithmetic on float64 tensors.

Port of :mod:`pint_tpu.dd` (reference ``dd.py:48-433``).  A value is the
unevaluated sum ``hi + lo`` of two float64 tensors.  The error-free
transforms are written FMA-free (Dekker split, ``_SPLITTER = 2**27 + 1``):
PyTorch runs every elementwise operation as its own kernel, so no compiler
sees ``a * b - p`` as one contractible expression, and nothing here relies on
fused multiply-add.  CUDA kernels that inline this arithmetic compile with
``-fmad=false`` for the same reason (:mod:`pint_torch.kernels`).

``mul_mod1`` and ``day2sec_exact`` are :class:`torch.autograd.Function`\\ s
whose ``jvp`` mirrors the reference's custom JVPs (``dd.py:385-390`` and
``:410-414``): the folded product's derivative goes into the fractional
part, the exact day->second split's into its high component.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

__all__ = [
    "DD", "two_sum", "quick_two_sum", "two_prod", "dd_from_float",
    "dd_add", "dd_sub", "dd_neg", "dd_mul", "dd_div", "dd_abs", "dd_sum",
    "dd_round_split", "mul_mod1", "day2sec_exact", "taylor_horner_dd",
]

# 2**27 + 1, the Dekker/Veltkamp splitter for float64
_SPLITTER = 134217729.0


def two_sum(a, b):
    """Error-free transform: a + b = s + e exactly (Knuth, branch-free)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Error-free a + b = s + e, requiring |a| >= |b| (Dekker)."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a):
    t = _SPLITTER * a
    hi = t - (t - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """Error-free transform: a * b = p + e exactly (Dekker, FMA-free)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


class DD(NamedTuple):
    """A double-double value: the unevaluated sum ``hi + lo``.  Parts are
    float64 tensors or Python floats (scalar epochs)."""

    hi: object
    lo: object

    def __add__(self, other):
        return dd_add(self, other)

    __radd__ = __add__

    def __sub__(self, other):
        return dd_sub(self, other)

    def __rsub__(self, other):
        return dd_add(dd_neg(self), other)

    def __mul__(self, other):
        return dd_mul(self, other)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return dd_div(self, other)

    def __neg__(self):
        return dd_neg(self)

    def to_float(self):
        """Collapse to float64 (loses the low word)."""
        return self.hi + self.lo

    def __getitem__(self, idx):
        return DD(self.hi[idx], self.lo[idx])


def _as_dd(x) -> DD:
    if isinstance(x, DD):
        return x
    return DD(x, x * 0.0 if torch.is_tensor(x) else 0.0)


def dd_from_float(x) -> DD:
    """Promote a float64 tensor (or float) to DD with a zero low word."""
    return DD(x, torch.zeros_like(x) if torch.is_tensor(x) else 0.0)


def dd_add(x, y) -> DD:
    """DD + (DD | float). Accurate (Bailey) two-term renormalized sum."""
    x = _as_dd(x)
    if isinstance(y, DD):
        s1, s2 = two_sum(x.hi, y.hi)
        t1, t2 = two_sum(x.lo, y.lo)
        s2 = s2 + t1
        s1, s2 = quick_two_sum(s1, s2)
        s2 = s2 + t2
        hi, lo = quick_two_sum(s1, s2)
        return DD(hi, lo)
    s1, s2 = two_sum(x.hi, y)
    s2 = s2 + x.lo
    hi, lo = quick_two_sum(s1, s2)
    return DD(hi, lo)


def dd_neg(x: DD) -> DD:
    return DD(-x.hi, -x.lo)


def dd_sub(x, y) -> DD:
    if isinstance(y, DD):
        return dd_add(_as_dd(x), dd_neg(y))
    return dd_add(_as_dd(x), -y)


def dd_mul(x, y) -> DD:
    """DD * (DD | float)."""
    x = _as_dd(x)
    if isinstance(y, DD):
        p1, p2 = two_prod(x.hi, y.hi)
        p2 = p2 + x.hi * y.lo + x.lo * y.hi
        hi, lo = quick_two_sum(p1, p2)
        return DD(hi, lo)
    p1, p2 = two_prod(x.hi, y)
    p2 = p2 + x.lo * y
    hi, lo = quick_two_sum(p1, p2)
    return DD(hi, lo)


def dd_div(x, y) -> DD:
    """DD / (DD | float), three-step long division (Bailey)."""
    x = _as_dd(x)
    y = _as_dd(y)
    q1 = x.hi / y.hi
    r = dd_sub(x, dd_mul(y, q1))
    q2 = r.hi / y.hi
    r = dd_sub(r, dd_mul(y, q2))
    q3 = r.hi / y.hi
    s1, s2 = quick_two_sum(q1, q2)
    s2 = s2 + q3
    hi, lo = quick_two_sum(s1, s2)
    return DD(hi, lo)


def dd_abs(x: DD) -> DD:
    sgn = torch.where(x.hi < 0, -1.0, 1.0)
    return DD(x.hi * sgn, x.lo * sgn)


def dd_sum(x: DD, dim=None) -> DD:
    """Sum of a DD tensor keeping dd precision (compensated sequential fold).
    ``dim=None`` sums over all elements."""
    hi, lo = x.hi, x.lo
    if not hi.ndim:
        return x
    if dim is None:
        hs, ls = hi.reshape(-1), lo.reshape(-1)
    else:
        hs, ls = hi.movedim(dim, 0), lo.movedim(dim, 0)
    acc = DD(hs[0], ls[0])
    for i in range(1, hs.shape[0]):
        acc = dd_add(acc, DD(hs[i], ls[i]))
    return acc


def dd_round_split(x: DD):
    """(nearest integer, fraction in [-0.5, 0.5]) with ``x = k + f`` to dd
    accuracy.  ``torch.round`` rounds half to even, like ``jnp.round``."""
    k = torch.round(x.hi)
    f = (x.hi - k) + x.lo
    extra = torch.round(f)
    return k + extra, f - extra


# ---------------------------------------------------------------------------
# Exact-by-construction folded products (reference dd.py:311-414).  The
# static bounds make the dominant partial product exactly representable:
# |F0| < 2**12 Hz, |t| < 2**35 s, |d| < 2**15 days.
# ---------------------------------------------------------------------------
_C_POW = 12
_T_POW = 35
_D_POW = 15
_SPLIT_BITS = 25
DAY_S_F = 86400.0


def _scaled_split(x, pow_bound, bits=_SPLIT_BITS):
    """``x = hi + lo`` with ``hi`` a multiple of 2**(pow_bound-bits)."""
    s = 2.0 ** (pow_bound - bits)
    hi = torch.round(x * (1.0 / s)) * s
    return hi, x - hi


def _fold(k, f, p):
    """Accumulate p into the (integer, fraction) accumulator pair."""
    kp = torch.round(p)
    return k + kp, f + (p - kp)


def _mul_mod1_impl(c, t):
    """(k, f) with ``c * t = k + f``, |error| <~ 2**-31 cycles, k integral."""
    ch, cl = _scaled_split(c, _C_POW)
    th, tl = _scaled_split(t, _T_POW)
    k = torch.zeros_like(t)
    f = torch.zeros_like(t)
    k, f = _fold(k, f, ch * th)
    k, f = _fold(k, f, ch * tl)
    k, f = _fold(k, f, cl * th)
    f = f + cl * tl
    kp = torch.round(f)
    return k + kp, f - kp


def _day2sec_impl(d):
    """``d`` days -> two float64 second-components summing to d*86400."""
    dh, dl = _scaled_split(d, _D_POW)
    return dh * DAY_S_F, dl * DAY_S_F


class _MulMod1(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(c, t):
        return _mul_mod1_impl(c, t)

    @staticmethod
    def setup_context(ctx, inputs, output):
        c, t = inputs
        ctx.mark_non_differentiable(output[0])
        ctx.save_for_forward(c, t)

    @staticmethod
    def jvp(ctx, dc, dt):
        c, t = ctx.saved_tensors
        df = 0.0
        if dc is not None:
            df = t * dc
        if dt is not None:
            df = df + c * dt
        if not torch.is_tensor(df):
            df = torch.zeros_like(t)
        return None, df


def mul_mod1(c, t):
    """Folded product ``c * t = k + f`` (k integral float64, f in
    [-0.5, 0.5]); the JVP routes the full derivative into ``f``."""
    c = torch.as_tensor(c, dtype=t.dtype, device=t.device)
    return _MulMod1.apply(c, t)


class _Day2Sec(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(d):
        return _day2sec_impl(d)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def jvp(ctx, dd_):
        return dd_ * DAY_S_F, torch.zeros_like(dd_)


def day2sec_exact(d):
    """Day->second conversion as an unevaluated two-term sum."""
    return _Day2Sec.apply(d)


def taylor_horner_dd(x: DD, coeffs: Sequence) -> DD:
    """sum_i coeffs[i] * x**i / i! in double-double (Horner form)."""
    n = len(coeffs)
    acc = dd_from_float(torch.zeros_like(x.hi))
    if n == 0:
        return acc
    for i in range(n - 1, -1, -1):
        c = coeffs[i] / math.factorial(i)
        acc = dd_add(dd_mul(acc, x), c)
    return acc
