"""Time-scale conversions: UTC -> TAI -> TT -> TDB, without astropy/ERFA.

The reference delegates UTC->TT->TDB to astropy ``Time`` (ERFA C inside,
``toa.py:2251``, ``observatory/__init__.py:443``).  In this framework the
conversions are implemented natively so ingestion has zero astronomy-library
dependencies:

* leap seconds from a built-in IERS table (UTC is only defined since 1972),
* TT = TAI + 32.184 s,
* TDB - TT from a truncated Fairhead-Bretagnon-style analytic series
  (geocentric terms; ~10 us accuracy — pluggable, see :class:`TDBProvider`,
  so a full FB90 table or ephemeris-integrated TE405 can be dropped in).

MJDs follow the "pulsar_mjd" convention of the reference
(``pulsar_mjd.py:86``): the fractional day is seconds-since-midnight/86400,
i.e. leap seconds never make a day longer than 86400 s.  All host math is in
numpy longdouble and converts losslessly to DD pairs for the device.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "tai_minus_utc",
    "tt_minus_utc",
    "utc_to_tt_mjd",
    "tdb_minus_tt",
    "tdb_minus_tt_series",
    "set_tdb_provider",
    "utc_to_tdb_mjd",
    "gps_to_utc_seconds",
]

# (MJD of UTC start, TAI-UTC seconds) — IERS leap-second history since 1972.
_LEAP_TABLE = np.array(
    [
        (41317.0, 10.0), (41499.0, 11.0), (41683.0, 12.0), (42048.0, 13.0),
        (42413.0, 14.0), (42778.0, 15.0), (43144.0, 16.0), (43509.0, 17.0),
        (43874.0, 18.0), (44239.0, 19.0), (44786.0, 20.0), (45151.0, 21.0),
        (45516.0, 22.0), (46247.0, 23.0), (47161.0, 24.0), (47892.0, 25.0),
        (48257.0, 26.0), (48804.0, 27.0), (49169.0, 28.0), (49534.0, 29.0),
        (50083.0, 30.0), (50630.0, 31.0), (51179.0, 32.0), (53736.0, 33.0),
        (54832.0, 34.0), (56109.0, 35.0), (57204.0, 36.0), (57754.0, 37.0),
    ]
)

TT_MINUS_TAI = 32.184  # seconds, by definition
GPS_MINUS_TAI = -19.0  # TAI - GPS = 19 s, constant since GPS epoch


def tai_minus_utc(utc_mjd) -> np.ndarray:
    """TAI-UTC in seconds at the given UTC MJD(s)."""
    utc_mjd = np.atleast_1d(np.asarray(utc_mjd, dtype=np.float64))
    idx = np.searchsorted(_LEAP_TABLE[:, 0], utc_mjd, side="right") - 1
    if np.any(idx < 0):
        raise ValueError("UTC is undefined before MJD 41317 (1972-01-01)")
    return _LEAP_TABLE[idx, 1]


def tt_minus_utc(utc_mjd) -> np.ndarray:
    """TT-UTC in seconds."""
    return tai_minus_utc(utc_mjd) + TT_MINUS_TAI


def gps_to_utc_seconds(utc_mjd) -> np.ndarray:
    """UTC - UTC(GPS) offset in seconds: -(TAI-UTC) + 19."""
    return -(tai_minus_utc(utc_mjd) - 19.0)


def utc_to_tt_mjd(utc_mjd):
    """UTC MJD (pulsar_mjd convention) -> TT MJD, longdouble in/out."""
    utc_mjd = np.asarray(utc_mjd, dtype=np.longdouble)
    dt = tt_minus_utc(np.asarray(utc_mjd, dtype=np.float64)).reshape(utc_mjd.shape)
    return utc_mjd + np.asarray(dt, dtype=np.longdouble) / np.longdouble(86400.0)


def utc_to_tdb_offset_seconds(utc_mjd, ephem: "str | None" = None) -> np.ndarray:
    """(TDB - UTC) in seconds at the given UTC epochs, float64.

    Computed without forming absolute-MJD sums, so degraded-longdouble
    platforms can apply the offset to a (hi, lo) pair with an error-free
    transform instead of rounding at ulp(MJD) ~ 0.3 us.
    """
    utc64 = np.asarray(utc_mjd, dtype=np.float64)
    dt = tt_minus_utc(utc64)
    tt64 = utc64 + dt / 86400.0
    return dt + tdb_minus_tt(tt64, ephem=ephem)


def tt_to_utc_mjd(tt_mjd):
    """TT MJD -> UTC MJD (inverse of utc_to_tt_mjd; TT-UTC evaluated at the
    TT epoch is exact away from a leap-second boundary, where the offset is
    constant over the ~69 s difference anyway)."""
    tt_mjd = np.asarray(tt_mjd, dtype=np.longdouble)
    dt = tt_minus_utc(np.asarray(tt_mjd, dtype=np.float64)).reshape(tt_mjd.shape)
    return tt_mjd - np.asarray(dt, dtype=np.longdouble) / np.longdouble(86400.0)


# Truncated analytic TDB-TT series (geocentric).  Terms: (amplitude_s,
# frequency_rad_per_julian_century, phase_rad); the classic leading terms of
# the Fairhead & Bretagnon (1990) series as tabulated in the Astronomical
# Almanac.  Accuracy ~10 us 1980-2050; the full 1.7 ms annual term dominates.
_TDB_TERMS = np.array(
    [
        (1.656674e-3, 628.3075850, 6.240054),
        (2.2418e-5, 575.3384885, 4.296977),
        (1.3840e-5, 1256.6151700, 6.196905),
        (4.770e-6, 52.9690965, 0.444401),
        (4.677e-6, 606.9776754, 4.021195),
        (2.257e-6, 21.3299095, 5.543113),
        (1.694e-6, -0.3523118, 5.025133),
        (1.554e-6, 628.6598968, 5.198467),
        (1.276e-6, 1203.6460735, 4.444888),
        (1.193e-6, 1150.6769770, 2.322313),
        (1.115e-6, 7.4781599, 5.154724),
        (0.794e-6, 786.0419392, 3.910456),
        (0.600e-6, 575.3384885, 2.435898),
        (0.496e-6, 1097.7078805, 5.171764),
    ]
)
# secular mixed term: +1.02e-8 * T * sin(628.3076 T + 4.249) s
_TDB_SECULAR = (1.02e-8, 628.3075850, 4.249032)


def tdb_minus_tt_series(tt_mjd) -> np.ndarray:
    """TDB-TT in seconds from the truncated analytic series (geocentric,
    ~10 us accuracy 1980-2050)."""
    tt_mjd = np.asarray(tt_mjd, dtype=np.float64)
    T = ((tt_mjd - 51544.5) / 36525.0).reshape(-1)
    amp = _TDB_TERMS[:, 0][:, None]
    freq = _TDB_TERMS[:, 1][:, None]
    ph = _TDB_TERMS[:, 2][:, None]
    out = np.sum(amp * np.sin(freq * T[None, :] + ph), axis=0)
    a, f, p = _TDB_SECULAR
    out = out + a * T * np.sin(f * T + p)
    return out.reshape(tt_mjd.shape)


from pint_torch.exceptions import EphemCoverageError as _EphemCoverageError

_tdb_provider = None  # explicit user override via set_tdb_provider
_warned_tdb_fallback = False


def tdb_minus_tt(tt_mjd, ephem: "str | None" = None) -> np.ndarray:
    """TDB-TT in seconds (geocentric), float64.

    Source priority: (1) an explicitly installed provider
    (:func:`set_tdb_provider`); (2) the loaded kernel's own time-ephemeris
    segment when present (DE430t/DE440t 't' kernels — ns-exact, better than
    the reference's ERFA analytic series); (3) direct integration of the
    defining rate equation with the loaded ephemeris
    (:mod:`pint_torch.tdb_integrated` — timing-relevant variation exact to
    ephemeris quality); (4) the truncated analytic series (~10 us).
    """
    global _warned_tdb_fallback
    if _tdb_provider is not None:
        return _tdb_provider(np.asarray(tt_mjd, dtype=np.float64))
    try:
        from pint_torch.ephemeris import load_ephemeris

        eph = load_ephemeris(ephem or "DE440")
        if getattr(eph, "has_tdb_tt", lambda: False)():
            return eph.tdb_minus_tt(tt_mjd)
        from pint_torch.tdb_integrated import integrated_tdb_minus_tt

        return integrated_tdb_minus_tt(tt_mjd, ephem=ephem)
    except (FileNotFoundError, ImportError, KeyError,
            _EphemCoverageError) as e:
        # expected degradations only (missing kernel/scipy, epochs outside
        # kernel coverage); programming errors must surface, not silently
        # downgrade precision by 4 orders of magnitude
        if not _warned_tdb_fallback:
            _warned_tdb_fallback = True
            from pint_torch.logging import log

            log.warning(f"Integrated TDB-TT unavailable ({e}); using the "
                        "truncated analytic series (~10 us)")
        return tdb_minus_tt_series(np.asarray(tt_mjd, dtype=np.float64))


def set_tdb_provider(fn) -> None:
    """Install an alternative TDB-TT provider (signature: tt_mjd -> seconds);
    pass None to restore the kernel/series default."""
    global _tdb_provider
    _tdb_provider = fn


def utc_to_tdb_mjd(utc_mjd, ephem: "str | None" = None):
    """UTC MJD -> TDB MJD, longdouble precision end to end."""
    tt = utc_to_tt_mjd(utc_mjd)
    dt = tdb_minus_tt(np.asarray(tt, dtype=np.float64),
                      ephem=ephem).reshape(np.shape(tt))
    return tt + np.asarray(dt, dtype=np.longdouble) / np.longdouble(86400.0)
