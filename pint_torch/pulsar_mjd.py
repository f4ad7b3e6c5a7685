"""Precision MJD utilities (port of ``pint_tpu/pulsar_mjd.py``).

The device-side precision lives in :mod:`pint_torch.dd` (double-double
pairs); this module is the host-side boundary: exact string <-> (int, frac)
MJD splits (``str_to_mjds``, ``mjds_to_str``), the error-free transforms
and ``day_frac``, the JD <-> MJD conversions in the "pulsar_mjd"
leap-second convention (every day is 86400 s; a leap second is
unrepresentable), the numpy-longdouble helpers, and the ``TimeFormat*``
classes' ``set_jds``/``to_value`` conversions without astropy (which is no
dependency: ``TOAs.utc_mjd`` carries the same longdouble information
directly).
"""

from __future__ import annotations

import numpy as np

from pint_torch.timescales import _LEAP_TABLE, tai_minus_utc

__all__ = [
    "two_sum", "two_product", "split", "day_frac",
    "str_to_mjds", "mjds_to_str", "jds_to_mjds", "mjds_to_jds",
    "jds_to_mjds_pulsar", "mjds_to_jds_pulsar",
    "data2longdouble", "longdouble2str", "str2longdouble",
    "quantity2longdouble_withunit", "safe_kind_conversion",
    "time_to_longdouble", "time_from_longdouble",
    "time_to_mjd_string", "time_from_mjd_string",
    "TimeFormatMJD", "PulsarMJD", "MJDLong", "PulsarMJDLong",
    "MJDString", "PulsarMJDString",
]

DJM0 = 2400000.5  # JD of MJD epoch (erfa.DJM0)


# ---------------------------------------------------------------------------
# error-free transforms (reference pulsar_mjd.py:586,609,638; host numpy —
# IEEE-correct on the CPU)
# ---------------------------------------------------------------------------

def two_sum(a, b):
    """Exact a + b = s + e as two float64s (Knuth two-sum)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


# 2**27 + 1, Dekker splitter: host-side numpy float64 always (this module
# never runs on device)
_SPLITTER = 134217729.0


def split(a):
    """Dekker split: a = hi + lo with both halves 26-bit."""
    a = np.asarray(a, np.float64)
    t = _SPLITTER * a
    hi = t - (t - a)
    return hi, a - hi


def two_product(a, b):
    """Exact a * b = p + e as two float64s (Dekker product)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def day_frac(val1, val2, factor=None, divisor=None):
    """Sum (optionally scaled) as exact (integer day, frac) float64 pair,
    frac in [-0.5, 0.5] (reference ``pulsar_mjd.py:529``)."""
    sum12, err12 = two_sum(val1, val2)
    if factor is not None:
        sum12, carry = two_product(sum12, factor)
        carry += err12 * factor
        sum12, err12 = two_sum(sum12, carry)
    if divisor is not None:
        q1 = sum12 / divisor
        p1, p2 = two_product(q1, divisor)
        d1, d2 = two_sum(sum12, -p1)
        d2 += err12
        d2 -= p2
        q2 = (d1 + d2) / divisor
        sum12, err12 = two_sum(q1, q2)
    day = np.round(sum12)
    extra, frac = two_sum(sum12, -day)
    frac += extra + err12
    # the carry can push frac past +-0.5; renormalize once
    excess = np.round(frac)
    day = day + excess
    extra, frac = two_sum(sum12, -day)
    frac += extra + err12
    return day, frac


# ---------------------------------------------------------------------------
# string <-> (imjd, fmjd)
# ---------------------------------------------------------------------------

def _str_to_mjds_one(s) -> tuple:
    if isinstance(s, bytes):
        s = s.decode()
    from fractions import Fraction

    v = Fraction(s.strip().translate(str.maketrans("DdE", "eee")))
    i = int(v) if v >= 0 else -int(-v) - (1 if v != int(v) else 0)
    return i, float(v - i)


def str_to_mjds(s):
    """Exact decimal MJD string -> (int MJD, frac) with no rounding loss
    (reference ``pulsar_mjd.py:488``; arrays of strings accepted)."""
    if isinstance(s, (str, bytes)):
        return _str_to_mjds_one(s)
    arr = np.asarray(s)
    imjd = np.empty(arr.shape, dtype=np.int64)
    fmjd = np.empty(arr.shape, dtype=np.float64)
    for idx in np.ndindex(arr.shape):
        imjd[idx], fmjd[idx] = _str_to_mjds_one(str(arr[idx]))
    return imjd, fmjd


def _mjds_to_str_one(mjd1, mjd2) -> str:
    imjd, fmjd = day_frac(mjd1, mjd2)
    imjd = int(imjd)
    fmjd = float(fmjd)
    while fmjd < 0.0:
        imjd -= 1
        fmjd += 1.0
    return str(imjd) + f"{fmjd:.16f}"[1:]


def mjds_to_str(mjd1, mjd2):
    """(int, frac) MJD pair -> decimal string (reference
    ``pulsar_mjd.py:521``)."""
    m1 = np.asarray(mjd1)
    m2 = np.asarray(mjd2)
    if m1.shape == ():
        return _mjds_to_str_one(float(m1), float(m2))
    out = np.empty(m1.shape, dtype="U30")
    for idx in np.ndindex(m1.shape):
        out[idx] = _mjds_to_str_one(float(m1[idx]), float(m2[idx]))
    return out


# ---------------------------------------------------------------------------
# JD <-> MJD, plain and pulsar_mjd-convention
# ---------------------------------------------------------------------------

def jds_to_mjds(jd1, jd2):
    return day_frac(np.asarray(jd1) - DJM0, jd2)


def mjds_to_jds(mjd1, mjd2):
    return day_frac(np.asarray(mjd1) + DJM0, mjd2)


def _leap_at_end_of_day(imjd):
    """Seconds inserted at the end of UTC day ``imjd`` (0 or 1)."""
    return (tai_minus_utc(np.asarray(imjd, np.float64) + 1.0)
            - tai_minus_utc(np.asarray(imjd, np.float64))).astype(np.float64)


def _to_day_floor(day, frac):
    """(day, frac in [-0.5, 0.5]) -> (floor day, frac in [0, 1))."""
    shift = np.floor(frac)
    return day + shift, frac - shift


def mjds_to_jds_pulsar(mjd1, mjd2):
    """pulsar_mjd (every day 86400 s) -> true UTC JD pair.

    On a leap-second day the pulsar-MJD fraction advances 86400 s while the
    real day holds 86401, so the true UTC fraction is rescaled
    (reference ``pulsar_mjd.py:430 mjds_to_jds_pulsar`` semantics via erfa).
    """
    day, frac = _to_day_floor(*day_frac(mjd1, mjd2))
    day_len = 86400.0 + _leap_at_end_of_day(day)
    return day + DJM0, frac * 86400.0 / day_len


def jds_to_mjds_pulsar(jd1, jd2):
    """True UTC JD pair -> pulsar_mjd convention; raises during a leap
    second, which pulsar_mjd cannot represent (reference
    ``pulsar_mjd.py:400``)."""
    day, frac = _to_day_floor(*day_frac(np.asarray(jd1) - DJM0, jd2))
    day_len = 86400.0 + _leap_at_end_of_day(day)
    sec = frac * day_len
    if np.any(sec > 86400.0):
        raise ValueError(
            "UTC times during a leap second cannot be represented in "
            "pulsar_mjd format")
    return day, sec / 86400.0


# ---------------------------------------------------------------------------
# longdouble interop (reference pulsar_mjd.py:314-365)
# ---------------------------------------------------------------------------

def str2longdouble(str_data):
    """String (Fortran 1.0d2 exponents allowed) -> numpy longdouble."""
    if not isinstance(str_data, (str, bytes)):
        raise TypeError(f"Need a string: {str_data!r}")
    if isinstance(str_data, bytes):
        str_data = str_data.decode()
    return np.longdouble(str_data.translate(str.maketrans("Dd", "ee")))


def data2longdouble(data):
    """Anything -> numpy longdouble (strings via :func:`str2longdouble`)."""
    return str2longdouble(data) if type(data) is str else np.longdouble(data)


def longdouble2str(x):
    """numpy longdouble -> string."""
    return str(x)


def quantity2longdouble_withunit(data):
    """Quantity-like -> same unit at longdouble precision.  Without astropy
    in this stack a bare number is returned as longdouble; an object with
    ``.unit``/``.to_value`` round-trips through its unit like the
    reference."""
    unit = getattr(data, "unit", None)
    if unit is None:
        return np.longdouble(data)
    return np.longdouble(data.to_value(unit)) * unit


def safe_kind_conversion(values, dtype):
    """Sequence -> array of ``dtype`` guarding object-kind surprises
    (reference ``pulsar_mjd.py`` helper)."""
    from collections.abc import Sequence

    if isinstance(values, Sequence):
        return np.asarray(values, dtype=dtype)
    return dtype(values)


# ---------------------------------------------------------------------------
# Time-object interop: duck-typed on (jd1, jd2) so astropy Time works when
# installed, and any pair-carrying object works without it
# ---------------------------------------------------------------------------

def time_to_longdouble(t):
    """Time-like (``.jd1``/``.jd2``, e.g. astropy Time) -> longdouble MJD."""
    jd1 = getattr(t, "jd1", None)
    if jd1 is None:
        return np.longdouble(t)
    return (np.longdouble(jd1) - np.longdouble(DJM0)) + np.longdouble(t.jd2)


def time_from_longdouble(t, scale="utc", format="pulsar_mjd"):
    """longdouble MJD -> (jd1, jd2) pair; feeds astropy Time(*pair) when
    available."""
    t = np.longdouble(t)
    i = np.floor(t)
    return np.float64(i) + DJM0, np.float64(t - i)


def time_to_mjd_string(t):
    """Time-like -> exact decimal MJD string.  Bare longdouble input is
    split at longdouble precision BEFORE entering float64 pair arithmetic
    (a direct float64 cast would round ~90 ns off a typical MJD)."""
    jd1 = getattr(t, "jd1", None)
    if jd1 is None:
        t = np.longdouble(t)
        i = np.floor(t)
        return mjds_to_str(np.float64(i), np.float64(t - i))
    mjd1, mjd2 = jds_to_mjds(jd1, t.jd2)
    return mjds_to_str(mjd1, mjd2)


def time_from_mjd_string(s, scale="utc", format="pulsar_mjd"):
    """Decimal MJD string -> exact (jd1, jd2) pair."""
    i, f = str_to_mjds(s)
    return np.float64(i) + DJM0, np.float64(f)


# ---------------------------------------------------------------------------
# time-format classes (reference pulsar_mjd.py TimeFormat subclasses).
# There is no astropy Time here — the formats are plain conversion
# namespaces between the user-facing value (float / longdouble / string
# MJD) and the internal (jd1, jd2) pair, which is exactly the computation
# the reference's astropy formats perform.  ``pulsar_mjd`` variants apply
# the leap-second-smearing UTC convention (mjds_to_jds_pulsar).
# ---------------------------------------------------------------------------

class TimeFormatMJD:
    """Base: float-MJD <-> (jd1, jd2).  Reference ``pulsar_mjd.py:150``
    family; scale handling is the caller's concern (like ``Time(...,
    scale=)`` in the reference)."""

    name = "mjd"
    _to_jds = staticmethod(mjds_to_jds)
    _from_jds = staticmethod(jds_to_mjds)

    @classmethod
    def set_jds(cls, val1, val2=0.0):
        """User value pair -> (jd1, jd2)."""
        return cls._to_jds(*day_frac(val1, val2))

    @classmethod
    def to_value(cls, jd1, jd2):
        """(jd1, jd2) -> float MJD (lossy by design, like the reference's
        plain ``.mjd``)."""
        m1, m2 = cls._from_jds(jd1, jd2)
        out = np.asarray(m1) + np.asarray(m2)
        return out.reshape(())[()] if out.size == 1 else out


class PulsarMJD(TimeFormatMJD):
    """Pulsar-convention UTC MJD: each day has exactly 86400 equal-length
    seconds, leap seconds smeared (reference ``pulsar_mjd.py:68``)."""

    name = "pulsar_mjd"
    _to_jds = staticmethod(mjds_to_jds_pulsar)
    _from_jds = staticmethod(jds_to_mjds_pulsar)


class MJDLong(TimeFormatMJD):
    """MJD carried as numpy longdouble (reference ``pulsar_mjd.py:150``):
    full 80-bit precision in and out."""

    name = "mjd_long"

    @classmethod
    def set_jds(cls, val1, val2=0.0):
        v = np.asarray(val1, dtype=np.longdouble) \
            + np.asarray(val2, dtype=np.longdouble)
        hi = np.asarray(v, dtype=np.float64)
        lo = np.asarray(v - hi.astype(np.longdouble), dtype=np.float64)
        return cls._to_jds(*day_frac(hi, lo))

    @classmethod
    def to_value(cls, jd1, jd2):
        m1, m2 = cls._from_jds(jd1, jd2)
        out = np.asarray(m1, dtype=np.longdouble) \
            + np.asarray(m2, dtype=np.longdouble)
        return out.reshape(())[()] if out.size == 1 else out


class PulsarMJDLong(MJDLong):
    """Longdouble MJD under the pulsar-UTC convention (reference
    ``pulsar_mjd.py:231``)."""

    name = "pulsar_mjd_long"
    _to_jds = staticmethod(mjds_to_jds_pulsar)
    _from_jds = staticmethod(jds_to_mjds_pulsar)


class MJDString(TimeFormatMJD):
    """MJD as exact decimal strings (reference ``pulsar_mjd.py:288``)."""

    name = "mjd_string"

    @classmethod
    def set_jds(cls, val1, val2=None):
        return cls._to_jds(*str_to_mjds(val1))

    @classmethod
    def to_value(cls, jd1, jd2):
        m1, m2 = (np.asarray(v) for v in cls._from_jds(jd1, jd2))
        if m1.size == 1:  # scalar in -> plain str out
            return mjds_to_str(m1.reshape(()), m2.reshape(()))
        return mjds_to_str(m1, m2)


class PulsarMJDString(MJDString):
    """String MJD under the pulsar-UTC convention (reference
    ``pulsar_mjd.py:330``)."""

    name = "pulsar_mjd_string"
    _to_jds = staticmethod(mjds_to_jds_pulsar)
    _from_jds = staticmethod(jds_to_mjds_pulsar)
