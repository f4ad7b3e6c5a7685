"""TDB-TT by direct integration of the IAU defining rate equation.

The reference reaches ~ns TDB-TT through ERFA's 787-term Fairhead-Bretagnon
series (``observatory/__init__.py:443``).  Here the conversion is computed
from the same physics the series encodes, using whatever solar-system
ephemeris is loaded:

    d(TDB-TT)/dt = (v_E^2 / 2 + U_ext(geocenter)) / c^2  -  <mean rate>

integrated cumulatively over a window covering the requested epochs, spline-
interpolated, and anchored to the analytic series by an offset+rate fit.
The anchor fixes only the constant and linear pieces — which pulse-phase
fitting cannot see (they are absorbed by the phase offset and F0) — so the
*timing-relevant variation* of TDB-TT is exact to the ephemeris quality:
~ns with a real JPL kernel (even a non-'t' kernel), ~0.1 us with the
built-in analytic ephemeris.  Quadrature error at the 0.125 d step is < ns
for every physical period (>= 27 d).

Priority in :func:`pint_torch.timescales.tdb_minus_tt`: explicit provider >
kernel time-ephemeris segment ('t' kernels) > this integrator > bare series.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from pint_torch.logging import log

__all__ = ["IntegratedTDB", "integrated_tdb_minus_tt"]

from pint_torch import c as _C_M_S

C_KM_S = _C_M_S / 1e3
DAY_S = 86400.0
#: GM [km^3/s^2] (IAU/DE nominal values); Earth excluded (external potential)
GM = {
    "sun": 1.32712440018e11,
    "mercury": 2.2031868551e4,
    "venus": 3.24858592e5,
    "mars": 4.282837362e4,
    "jupiter": 1.26712764e8,
    "saturn": 3.7940585e7,
    "uranus": 5.794556e6,
    "neptune": 6.836527e6,
    "moon": 4.9028001e3,
}


def _rate(eph, mjd: np.ndarray) -> np.ndarray:
    """(v_E^2/2 + U_ext)/c^2 [s/s] at the geocenter."""
    epos, evel = eph.posvel_ssb("earth", mjd)
    v2 = np.sum(evel**2, axis=1)
    u = np.zeros(len(mjd))
    for body, gm in GM.items():
        try:
            bpos, _ = eph.posvel_ssb(body, mjd)
        except KeyError:  # kernel without this body: skip its ~small term
            continue
        r = np.linalg.norm(bpos - epos, axis=1)
        u += gm / r
    return (0.5 * v2 + u) / C_KM_S**2


class IntegratedTDB:
    """Cumulative integral of the TDB-TT rate for one ephemeris.

    DETERMINISM CONTRACT: the value served for a given epoch depends only
    on (ephemeris, epoch) — never on the process's query history.  The
    sample grid is aligned to absolute multiples of ``STEP`` from
    ``ANCHOR_EPOCH``, the window always includes the fixed anchor range,
    and the offset+rate anchor against the analytic series is fit over
    that same fixed range — so rebuilding a wider window reproduces every
    previously served value exactly (same samples, same anchor), and two
    different processes computing the same epochs agree bit-for-bit.
    Without this, absolute products (polycos, TZR phases, pulse numbers)
    written by one process disagree with another at the tens-of-us level.
    The anchor fixes only the constant and linear pieces, which pulse-
    phase fitting cannot see (absorbed by the phase offset and F0).
    """

    #: margin around the requested span [days]
    PAD = 40.0
    STEP = 0.125  # days
    #: fixed anchor range (J2000 + two Julian years): the series datum
    ANCHOR_EPOCH = 51544.5
    ANCHOR_SPAN = 730.5

    def __init__(self, ephem: Optional[str] = None):
        self.ephem = ephem
        self._spline = None
        self._range: Optional[Tuple[float, float]] = None

    def _build(self, lo: float, hi: float) -> None:
        from scipy.interpolate import CubicSpline

        from pint_torch.ephemeris import load_ephemeris
        from pint_torch.timescales import tdb_minus_tt_series

        eph = load_ephemeris(self.ephem or "DE440")
        # the anchor range is a deterministic function of the KERNEL alone:
        # the fixed J2000 range when covered, else the first ANCHOR_SPAN
        # days of the kernel's coverage — query history can never influence
        # the anchor (even for exotic kernels not covering J2000)
        a_lo, a_hi = self._anchor_range(eph)
        # the window always covers the anchor range
        lo = min(lo, a_lo)
        hi = max(hi, a_hi)
        # never sample outside a kernel's coverage: the padding is a
        # convenience, not worth losing the kernel path at the span edges
        lo, hi = self._clamp(lo, hi)
        if hi - lo < 2 * self.STEP:
            from pint_torch.exceptions import EphemCoverageError

            raise EphemCoverageError(
                f"requested TDB-TT window lies outside the kernel coverage "
                f"of {self.ephem or 'DE440'}")
        # absolute grid alignment: sample points are exact multiples of
        # STEP from ANCHOR_EPOCH regardless of the window
        k_lo = int(np.floor((lo - self.ANCHOR_EPOCH) / self.STEP))
        k_hi = int(np.ceil((hi - self.ANCHOR_EPOCH) / self.STEP))
        grid = self.ANCHOR_EPOCH + np.arange(k_lo, k_hi + 1) * self.STEP
        rate = _rate(eph, grid)
        # accumulate OUTWARD from the anchor origin in both directions, so
        # each P[i] is a fixed partial sum independent of how far the
        # window happens to extend — bit-exact under any rebuild
        k0 = int(np.round((a_lo - self.ANCHOR_EPOCH) / self.STEP))
        i0 = min(max(k0 - k_lo, 0), len(grid) - 1)
        traps = (rate[1:] + rate[:-1]) * 0.5 * self.STEP * DAY_S
        P = np.zeros(len(grid))
        P[i0 + 1:] = np.cumsum(traps[i0:])
        if i0 > 0:
            P[:i0] = -np.cumsum(traps[:i0][::-1])[::-1]
        # anchor offset+rate to the analytic series over the fixed range
        m = (grid >= a_lo) & (grid <= a_hi)
        d = P[m] - tdb_minus_tt_series(grid[m])
        A = np.stack([np.ones(int(m.sum())), grid[m] - a_lo], axis=1)
        c, *_ = np.linalg.lstsq(A, d, rcond=None)
        P = P - (c[0] + c[1] * (grid - a_lo))
        self._spline = CubicSpline(grid, P)
        self._range = (float(grid[0]), float(grid[-1]))
        log.info(f"Integrated TDB-TT over MJD {grid[0]:.1f}..{grid[-1]:.1f} "
                 f"({len(grid)} samples, ephem={self.ephem or 'DE440'})")

    def _anchor_range(self, eph) -> Tuple[float, float]:
        """Deterministic per-kernel anchor range, snapped to the absolute
        STEP grid: J2000+ANCHOR_SPAN when covered, else the first
        ANCHOR_SPAN days of the kernel coverage."""
        a_lo, a_hi = self.ANCHOR_EPOCH, self.ANCHOR_EPOCH + self.ANCHOR_SPAN
        cov = getattr(eph, "coverage_mjd", None)
        if cov is not None:
            clo, chi = cov()
            if a_lo < clo + self.STEP or a_hi > chi - self.STEP:
                k = int(np.ceil((clo + self.STEP - self.ANCHOR_EPOCH)
                                / self.STEP))
                a_lo = self.ANCHOR_EPOCH + k * self.STEP
                a_hi = min(a_lo + self.ANCHOR_SPAN, chi - self.STEP)
        return a_lo, a_hi

    def __call__(self, tt_mjd) -> np.ndarray:
        from pint_torch.exceptions import EphemCoverageError

        tt = np.atleast_1d(np.asarray(tt_mjd, dtype=np.float64))
        lo, hi = float(tt.min()) - self.PAD, float(tt.max()) + self.PAD
        if self._range is None:
            self._build(lo, hi)
        elif lo < self._range[0] or hi > self._range[1]:
            # skip the rebuild when the built window already covers the
            # clamped want range (e.g. pinned at a kernel coverage edge
            # that is not STEP-aligned — rebuilding would re-integrate the
            # whole grid on every call and change nothing)
            want_lo = min(lo, self._range[0])
            want_hi = max(hi, self._range[1])
            want_lo, want_hi = self._clamp(want_lo, want_hi)
            if want_lo < self._range[0] or want_hi > self._range[1]:
                self._build(want_lo, want_hi)
        # never silently cubic-extrapolate beyond the integration grid: the
        # requested epochs are outside the kernel's coverage
        if tt.min() < self._range[0] or tt.max() > self._range[1]:
            bad = tt[(tt < self._range[0]) | (tt > self._range[1])]
            raise EphemCoverageError(
                f"TDB-TT integration window MJD {self._range[0]:.1f}.."
                f"{self._range[1]:.1f} (kernel coverage) does not include "
                f"MJD {bad.min():.1f}..{bad.max():.1f}")
        return np.asarray(self._spline(tt)).reshape(np.shape(tt_mjd))

    def _clamp(self, lo: float, hi: float) -> Tuple[float, float]:
        from pint_torch.ephemeris import load_ephemeris

        eph = load_ephemeris(self.ephem or "DE440")
        cov = getattr(eph, "coverage_mjd", None)
        if cov is None:
            return lo, hi
        clo, chi = cov()
        return max(lo, clo + self.STEP), min(hi, chi - self.STEP)


_integrators: Dict[str, IntegratedTDB] = {}


def integrated_tdb_minus_tt(tt_mjd, ephem: Optional[str] = None) -> np.ndarray:
    key = (ephem or "DE440").lower()
    if key not in _integrators:
        _integrators[key] = IntegratedTDB(ephem)
    return _integrators[key](tt_mjd)
