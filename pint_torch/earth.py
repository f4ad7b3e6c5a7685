"""Earth orientation: ITRF <-> GCRS rotation without ERFA.

Replaces the reference's ``erfautils.py:26 gcrs_posvel_from_itrf`` (pyerfa C)
with a native implementation: IAU 1976 precession + IAU 1980 nutation
(leading terms) + GMST/equation-of-equinoxes Earth rotation.  Polar motion
and UT1-UTC default to zero (no IERS feed in a zero-egress environment) but
are pluggable via :func:`set_eop_provider`; their omission contributes
< ~1.5 us of topocentric delay error, far below the analytic-ephemeris floor.

Truncation error of the nutation series is ~0.01 arcsec -> ~0.3 m at the
geocenter distance -> ~1 ns of timing, i.e. negligible.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "itrf_to_gcrs_matrix",
    "gcrs_posvel_from_itrf",
    "set_eop_provider",
]

_ARCSEC = np.pi / (180.0 * 3600.0)
_DEG = np.pi / 180.0
#: Earth rotation rate [rad/s] (IERS conventional)
OMEGA_EARTH = 7.292115146706979e-5


def _eop_zero(utc_mjd):
    """Default Earth-orientation parameters: (ut1_minus_utc_s, xp_rad, yp_rad)."""
    z = np.zeros_like(np.asarray(utc_mjd, dtype=np.float64))
    return z, z, z


_eop_provider = _eop_zero


def set_eop_provider(fn) -> None:
    """Install an IERS EOP provider: utc_mjd -> (UT1-UTC s, xp rad, yp rad)."""
    global _eop_provider
    _eop_provider = fn


def _R1(a):
    c, s = np.cos(a), np.sin(a)
    z, o = np.zeros_like(c), np.ones_like(c)
    return np.stack(
        [np.stack([o, z, z], -1), np.stack([z, c, s], -1), np.stack([z, -s, c], -1)], -2
    )


def _R2(a):
    c, s = np.cos(a), np.sin(a)
    z, o = np.zeros_like(c), np.ones_like(c)
    return np.stack(
        [np.stack([c, z, -s], -1), np.stack([z, o, z], -1), np.stack([s, z, c], -1)], -2
    )


def _R3(a):
    c, s = np.cos(a), np.sin(a)
    z, o = np.zeros_like(c), np.ones_like(c)
    return np.stack(
        [np.stack([c, s, z], -1), np.stack([-s, c, z], -1), np.stack([z, z, o], -1)], -2
    )


def _precession_matrix(T):
    """IAU 1976 precession: mean-of-date -> J2000 (T = TT Julian centuries)."""
    zeta = (2306.2181 * T + 0.30188 * T**2 + 0.017998 * T**3) * _ARCSEC
    z = (2306.2181 * T + 1.09468 * T**2 + 0.018203 * T**3) * _ARCSEC
    theta = (2004.3109 * T - 0.42665 * T**2 - 0.041833 * T**3) * _ARCSEC
    # P(J2000->date) = R3(-z) R2(theta) R3(-zeta); we need its inverse,
    # taking mean-of-date vectors to J2000: R3(zeta) R2(-theta) R3(z)
    return _R3(zeta) @ _R2(-theta) @ _R3(z)


# IAU 1980 nutation, leading terms.  Columns: multipliers of (l, l', F, D, Om),
# dpsi sin-coefficient [arcsec], deps cos-coefficient [arcsec].
_NUT_TERMS = np.array(
    [
        [0, 0, 0, 0, 1, -17.1996, 9.2025],
        [0, 0, 2, -2, 2, -1.3187, 0.5736],
        [0, 0, 2, 0, 2, -0.2274, 0.0977],
        [0, 0, 0, 0, 2, 0.2062, -0.0895],
        [0, 1, 0, 0, 0, 0.1426, 0.0054],
        [1, 0, 0, 0, 0, 0.0712, -0.0007],
        [0, 1, 2, -2, 2, -0.0517, 0.0224],
        [0, 0, 2, 0, 1, -0.0386, 0.0200],
        [1, 0, 2, 0, 2, -0.0301, 0.0129],
        [0, -1, 2, -2, 2, 0.0217, -0.0095],
        [1, 0, 0, -2, 0, -0.0158, -0.0001],
        [0, 0, 2, -2, 1, 0.0129, -0.0070],
        [-1, 0, 2, 0, 2, 0.0123, -0.0053],
        [0, 0, 0, 2, 0, 0.0063, -0.0002],
        [1, 0, 0, 0, 1, 0.0063, -0.0033],
        [-1, 0, 0, 0, 1, -0.0058, 0.0032],
        [-1, 0, 2, 2, 2, -0.0059, 0.0026],
        [1, 0, 2, 0, 1, -0.0051, 0.0027],
    ]
)


def _fundamental_args(T):
    """Delaunay arguments in radians (T = TT Julian centuries since J2000)."""
    l = (134.96298139 + 477198.8673981 * T) * _DEG  # noqa: E741
    lp = (357.52772333 + 35999.0503400 * T) * _DEG
    F = (93.27191028 + 483202.0175381 * T) * _DEG
    D = (297.85036306 + 445267.1114800 * T) * _DEG
    Om = (125.04452222 - 1934.1362608 * T) * _DEG
    return l, lp, F, D, Om


def _nutation_angles(T):
    """Return (dpsi, deps, eps0) in radians."""
    l, lp, F, D, Om = _fundamental_args(np.asarray(T))
    args = np.stack([l, lp, F, D, Om], axis=-1)  # (..., 5)
    mult = _NUT_TERMS[:, :5]  # (n, 5)
    phase = args @ mult.T  # (..., n)
    dpsi = np.sum(_NUT_TERMS[:, 5] * np.sin(phase), axis=-1) * _ARCSEC
    deps = np.sum(_NUT_TERMS[:, 6] * np.cos(phase), axis=-1) * _ARCSEC
    eps0 = (84381.448 - 46.8150 * T - 0.00059 * T**2 + 0.001813 * T**3) * _ARCSEC
    return dpsi, deps, eps0


def _gmst_rad(ut1_mjd):
    """Greenwich mean sidereal time (IAU 1982), radians."""
    ut1_mjd = np.asarray(ut1_mjd, dtype=np.float64)
    d0 = np.floor(ut1_mjd)
    frac = ut1_mjd - d0
    Tu = (d0 - 51544.5) / 36525.0
    gmst0 = 24110.54841 + 8640184.812866 * Tu + 0.093104 * Tu**2 - 6.2e-6 * Tu**3
    gmst_sec = gmst0 + frac * 86400.0 * 1.00273790934
    return (gmst_sec % 86400.0) / 86400.0 * 2.0 * np.pi


def itrf_to_gcrs_matrix(utc_mjd, tt_mjd=None):
    """Rotation matrix/matrices taking ITRF vectors to GCRS (J2000) frame."""
    utc_mjd = np.asarray(utc_mjd, dtype=np.float64)
    if tt_mjd is None:
        from pint_torch.timescales import utc_to_tt_mjd

        tt_mjd = np.asarray(utc_to_tt_mjd(utc_mjd), dtype=np.float64)
    T = (np.asarray(tt_mjd, dtype=np.float64) - 51544.5) / 36525.0
    dut1, xp, yp = _eop_provider(utc_mjd)
    ut1_mjd = utc_mjd + dut1 / 86400.0
    dpsi, deps, eps0 = _nutation_angles(T)
    gast = _gmst_rad(ut1_mjd) + dpsi * np.cos(eps0)
    # nutation matrix: true-of-date -> mean-of-date
    N = _R1(-eps0) @ _R3(dpsi) @ _R1(eps0 + deps)
    P = _precession_matrix(T)
    # polar motion (xp, yp ~ 0 by default)
    W = _R2(xp) @ _R1(yp) if np.any(xp) or np.any(yp) else None
    R_earth = _R3(-gast)  # true-of-date <- pseudo-earth-fixed
    M = P @ N @ R_earth
    if W is not None:
        M = M @ W
    return M


def gcrs_posvel_from_itrf(itrf_xyz_m, utc_mjd, tt_mjd=None):
    """Observatory GCRS position [m] and velocity [m/s] from ITRF coordinates.

    The native stand-in for reference ``erfautils.py:26``.  Velocity is the
    Earth-rotation term (omega x r) rotated into GCRS; higher-order terms
    (precession/nutation rates) are < 1 mm/s and ignored.
    """
    itrf_xyz_m = np.asarray(itrf_xyz_m, dtype=np.float64)
    M = itrf_to_gcrs_matrix(utc_mjd, tt_mjd)  # (..., 3, 3)
    pos = (M @ itrf_xyz_m.reshape((3, 1))).reshape(M.shape[:-2] + (3,))
    omega = np.array([0.0, 0.0, OMEGA_EARTH])
    v_itrf_like = np.cross(omega, itrf_xyz_m)  # in the rotating sense
    vel = (M @ v_itrf_like.reshape((3, 1))).reshape(M.shape[:-2] + (3,))
    return pos, vel
