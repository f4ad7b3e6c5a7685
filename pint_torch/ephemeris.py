"""Solar-system ephemerides: body positions/velocities wrt the SSB.

Replaces the reference's jplephem+astropy pipeline
(``solar_system_ephemerides.py:123,201``) with two native providers:

* :class:`SPKEphemeris` — a from-scratch reader for JPL SPK/DAF ``.bsp``
  kernels (Chebyshev types 2 and 3), used whenever a kernel file for the
  requested ``EPHEM`` (DE405/DE421/DE440...) can be found on disk.
* :class:`AnalyticEphemeris` — a built-in closed-form ephemeris: truncated
  VSOP87D series for the Earth (~1 arcsec ~ 700 km ~ 2 ms of Roemer delay;
  1 arcsec at 1 AU is 499 s x 4.85e-6 rad), Standish mean Keplerian
  elements for the planets, truncated lunar theory for the Moon,
  mass-weighted Sun-SSB offset.  Sufficient for internally consistent
  simulation/fit cycles and order-ms absolute work.  Microsecond-level
  absolute timing of real data fundamentally requires a numerical JPL
  kernel on disk (the reference downloads one at runtime for the same
  reason); golden-parity tests are gated on kernel availability.

All outputs are barycentric ICRS/J2000-equatorial, km and km/s, matching the
units of the reference's TOA table columns (``toa.py:2323``).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Tuple

import numpy as np

from pint_torch.logging import log

__all__ = [
    "Ephemeris",
    "AnalyticEphemeris",
    "SPKEphemeris",
    "load_ephemeris",
    "BODY_IDS",
]

_DEG = np.pi / 180.0
#: J2000 mean obliquity used for ecliptic->equatorial rotation [rad]
_EPS_J2000 = 84381.448 * np.pi / (180.0 * 3600.0)
AU_KM = 1.495978707e8
DAY_S = 86400.0

#: NAIF ids of the time-ephemeris (TDB-TT) segment in 't' kernels
TDB_TT_TARGET = 1000000001
TDB_TT_CENTER = 1000000000

#: NAIF integer codes used by SPK kernels
BODY_IDS = {
    "ssb": 0, "mercury_bary": 1, "venus_bary": 2, "emb": 3, "mars_bary": 4,
    "jupiter_bary": 5, "saturn_bary": 6, "uranus_bary": 7, "neptune_bary": 8,
    "pluto_bary": 9, "sun": 10, "moon": 301, "earth": 399,
    "mercury": 199, "venus": 299,
    # for the barycenter-only bodies PINT also uses the planet name directly
    "mars": 4, "jupiter": 5, "saturn": 6, "uranus": 7, "neptune": 8, "pluto": 9,
}


class Ephemeris:
    """Interface: barycentric posvel of a named body at TDB MJD epoch(s)."""

    name = "base"

    def posvel_ssb(self, body: str, tdb_mjd) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError


def _rot_x(v, angle):
    c, s = np.cos(angle), np.sin(angle)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return np.stack([x, c * y - s * z, s * y + c * z], axis=-1)


# ---------------------------------------------------------------------------
# Analytic ephemeris
# ---------------------------------------------------------------------------

# Standish (JPL approximate positions, 1800-2050 fit) mean Keplerian elements
# in the J2000 ecliptic: a [AU], e, I [deg], L [deg], varpi [deg], Omega [deg]
# and their per-Julian-century rates.
_ELEMENTS = {
    "mercury": ((0.38709927, 0.20563593, 7.00497902, 252.25032350, 77.45779628, 48.33076593),
                (0.00000037, 0.00001906, -0.00594749, 149472.67411175, 0.16047689, -0.12534081)),
    "venus": ((0.72333566, 0.00677672, 3.39467605, 181.97909950, 131.60246718, 76.67984255),
              (0.00000390, -0.00004107, -0.00078890, 58517.81538729, 0.00268329, -0.27769418)),
    "emb": ((1.00000261, 0.01671123, -0.00001531, 100.46457166, 102.93768193, 0.0),
            (0.00000562, -0.00004392, -0.01294668, 35999.37244981, 0.32327364, 0.0)),
    "mars": ((1.52371034, 0.09339410, 1.84969142, -4.55343205, -23.94362959, 49.55953891),
             (0.00001847, 0.00007882, -0.00813131, 19140.30268499, 0.44441088, -0.29257343)),
    "jupiter": ((5.20288700, 0.04838624, 1.30439695, 34.39644051, 14.72847983, 100.47390909),
                (-0.00011607, -0.00013253, -0.00183714, 3034.74612775, 0.21252668, 0.20469106)),
    "saturn": ((9.53667594, 0.05386179, 2.48599187, 49.95424423, 92.59887831, 113.66242448),
               (-0.00125060, -0.00050991, 0.00193609, 1222.49362201, -0.41897216, -0.28867794)),
    "uranus": ((19.18916464, 0.04725744, 0.77263783, 313.23810451, 170.95427630, 74.01692503),
               (-0.00196176, -0.00004397, -0.00242939, 428.48202785, 0.40805281, 0.04240589)),
    "neptune": ((30.06992276, 0.00859048, 1.77004347, -55.12002969, 44.96476227, 131.78422574),
                (0.00026291, 0.00005105, 0.00035372, 218.45945325, -0.32241464, -0.00508664)),
}

#: inverse mass ratios m_sun/m_planet (DE-series conventional)
_INV_MASS = {
    "mercury": 6023600.0, "venus": 408523.71, "emb": 328900.56, "mars": 3098708.0,
    "jupiter": 1047.3486, "saturn": 3497.898, "uranus": 22902.98, "neptune": 19412.24,
}

#: m_moon / (m_earth + m_moon)
_MOON_FRAC = 0.0123000371 / (1.0 + 0.0123000371)

# Truncated lunar theory (Meeus-style principal terms).
# Longitude terms: (coeff_deg, mult of D, M, M', F) applied as sin.
_MOON_LON = [
    (6.288774, 0, 0, 1, 0), (1.274027, 2, 0, -1, 0), (0.658314, 2, 0, 0, 0),
    (0.213618, 0, 0, 2, 0), (-0.185116, 0, 1, 0, 0), (-0.114332, 0, 0, 0, 2),
    (0.058793, 2, 0, -2, 0), (0.057066, 2, -1, -1, 0), (0.053322, 2, 0, 1, 0),
    (0.045758, 2, -1, 0, 0), (-0.040923, 0, 1, -1, 0), (-0.034720, 1, 0, 0, 0),
    (-0.030383, 0, 1, 1, 0), (0.015327, 2, 0, 0, -2), (-0.012528, 0, 0, 1, 2),
    (0.010980, 0, 0, 1, -2),
]
# Latitude terms: (coeff_deg, D, M, M', F) applied as sin.
_MOON_LAT = [
    (5.128122, 0, 0, 0, 1), (0.280602, 0, 0, 1, 1), (0.277693, 0, 0, 1, -1),
    (0.173237, 2, 0, 0, -1), (0.055413, 2, 0, -1, 1), (0.046271, 2, 0, -1, -1),
    (0.032573, 2, 0, 0, 1), (0.017198, 0, 0, 2, 1),
]
# Distance terms: (coeff_km, D, M, M', F) applied as cos.
_MOON_DIST = [
    (-20905.355, 0, 0, 1, 0), (-3699.111, 2, 0, -1, 0), (-2955.968, 2, 0, 0, 0),
    (-569.925, 0, 0, 2, 0), (48.888, 0, 1, 0, 0), (-3.149, 0, 0, 0, 2),
    (246.158, 2, 0, -2, 0), (-152.138, 2, -1, -1, 0), (-170.733, 2, 0, 1, 0),
    (-204.586, 2, -1, 0, 0), (-129.620, 0, 1, -1, 0), (108.743, 1, 0, 0, 0),
    (104.755, 0, 1, 1, 0), (10.321, 2, 0, 0, -2),
]

# ---------------------------------------------------------------------------
# Truncated VSOP87D Earth series (heliocentric, mean ecliptic+equinox of
# date).  Terms A*cos(B + C*tau), tau = Julian millennia TDB from J2000.0;
# A in 1e-8 rad (L, B) / 1e-8 AU (R).  This is the standard ~"1 arcsecond"
# abridgement of VSOP87 (Bretagnon & Francou 1988); it replaces the mean
# Keplerian EMB orbit (error up to ~1e-4 rad, tens of ms of Roemer delay)
# with a ~5e-6 rad / ~2e-6 AU model (~2 ms worst-case Roemer error).
_VSOP_EARTH_L = [
    # L0
    [(175347046.0, 0.0, 0.0),
     (3341656.0, 4.6692568, 6283.0758500),
     (34894.0, 4.6261024, 12566.1517000),
     (3497.0, 2.7441, 5753.3849), (3418.0, 2.8289, 3.5231),
     (3136.0, 3.6277, 77713.7715), (2676.0, 4.4181, 7860.4194),
     (2343.0, 6.1352, 3930.2097), (1324.0, 0.7425, 11506.7698),
     (1273.0, 2.0371, 529.6910), (1199.0, 1.1096, 1577.3435),
     (990.0, 5.233, 5884.927), (902.0, 2.045, 26.298),
     (857.0, 3.508, 398.149), (780.0, 1.179, 5223.694),
     (753.0, 2.533, 5507.553), (505.0, 4.583, 18849.228),
     (492.0, 4.205, 775.523), (357.0, 2.920, 0.067),
     (317.0, 5.849, 11790.629), (284.0, 1.899, 796.298),
     (271.0, 0.315, 10977.079), (243.0, 0.345, 5486.778),
     (206.0, 4.806, 2544.314), (205.0, 1.869, 5573.143),
     (202.0, 2.458, 6069.777), (156.0, 0.833, 213.299),
     (132.0, 3.411, 2942.463), (126.0, 1.083, 20.775),
     (115.0, 0.645, 0.980), (103.0, 0.636, 4694.003),
     (102.0, 0.976, 15720.839), (102.0, 4.267, 7.114),
     (99.0, 6.21, 2146.17), (98.0, 0.68, 155.42),
     (86.0, 5.98, 161000.69), (85.0, 1.30, 6275.96),
     (85.0, 3.67, 71430.70), (80.0, 1.81, 17260.15),
     (79.0, 3.04, 12036.46), (75.0, 1.76, 5088.63),
     (74.0, 3.50, 3154.69), (74.0, 4.68, 801.82),
     (70.0, 0.83, 9437.76), (62.0, 3.98, 8827.39),
     (61.0, 1.82, 7084.90), (57.0, 2.78, 6286.60),
     (56.0, 4.39, 14143.50), (56.0, 3.47, 6279.55),
     (52.0, 0.19, 12139.55), (52.0, 1.33, 1748.02),
     (51.0, 0.28, 5856.48), (49.0, 0.49, 1194.45),
     (41.0, 5.37, 8429.24), (41.0, 2.40, 19651.05),
     (39.0, 6.17, 10447.39), (37.0, 6.04, 10213.29),
     (37.0, 2.57, 1059.38), (36.0, 1.71, 2352.87),
     (36.0, 1.78, 6812.77), (33.0, 0.59, 17789.85),
     (30.0, 0.44, 83996.85), (30.0, 2.74, 1349.87),
     (25.0, 3.16, 4690.48)],
    # L1
    [(628331966747.0, 0.0, 0.0),
     (206059.0, 2.678235, 6283.0758500),
     (4303.0, 2.6351, 12566.1517), (425.0, 1.590, 3.523),
     (119.0, 5.796, 26.298), (109.0, 2.966, 1577.344),
     (93.0, 2.59, 18849.23), (72.0, 1.14, 529.69),
     (68.0, 1.87, 398.15), (67.0, 4.41, 5507.55),
     (59.0, 2.89, 5223.69), (56.0, 2.17, 155.42),
     (45.0, 0.40, 796.30), (36.0, 0.47, 775.52),
     (29.0, 2.65, 7.11), (21.0, 5.34, 0.98),
     (19.0, 1.85, 5486.78), (19.0, 4.97, 213.30),
     (17.0, 2.99, 6275.96), (16.0, 0.03, 2544.31),
     (16.0, 1.43, 2146.17), (15.0, 1.21, 10977.08),
     (12.0, 2.83, 1748.02), (12.0, 3.26, 5088.63),
     (12.0, 5.27, 1194.45), (12.0, 2.08, 4694.00),
     (11.0, 0.77, 553.57), (10.0, 1.30, 6286.60),
     (10.0, 4.24, 1349.87), (9.0, 2.70, 242.73),
     (9.0, 5.64, 951.72), (8.0, 5.30, 2352.87)],
    # L2
    [(52919.0, 0.0, 0.0), (8720.0, 1.0721, 6283.0758),
     (309.0, 0.867, 12566.152), (27.0, 0.05, 3.52),
     (16.0, 5.19, 26.30), (16.0, 3.68, 155.42),
     (10.0, 0.76, 18849.23), (9.0, 2.06, 77713.77),
     (7.0, 0.83, 775.52), (5.0, 4.66, 1577.34),
     (4.0, 1.03, 7.11), (4.0, 3.44, 5573.14),
     (3.0, 5.14, 796.30), (3.0, 6.05, 5507.55),
     (3.0, 1.19, 242.73), (3.0, 6.12, 529.69),
     (3.0, 0.31, 398.15), (3.0, 2.28, 553.57),
     (2.0, 4.38, 5223.69), (2.0, 3.75, 0.98)],
    # L3
    [(289.0, 5.844, 6283.076), (35.0, 0.0, 0.0),
     (17.0, 5.49, 12566.15), (3.0, 5.20, 155.42),
     (1.0, 4.72, 3.52), (1.0, 5.30, 18849.23), (1.0, 5.97, 242.73)],
    # L4
    [(114.0, 3.142, 0.0), (8.0, 4.13, 6283.08), (1.0, 3.84, 12566.15)],
    # L5
    [(1.0, 3.14, 0.0)],
]

_VSOP_EARTH_B = [
    # B0
    [(280.0, 3.199, 84334.662), (102.0, 5.422, 5507.553),
     (80.0, 3.88, 5223.69), (44.0, 3.70, 2352.87), (32.0, 4.00, 1577.34)],
    # B1
    [(9.0, 3.90, 5507.55), (6.0, 1.73, 5223.69)],
]

_VSOP_EARTH_R = [
    # R0
    [(100013989.0, 0.0, 0.0),
     (1670700.0, 3.0984635, 6283.0758500),
     (13956.0, 3.05525, 12566.15170),
     (3084.0, 5.1985, 77713.7715), (1628.0, 1.1739, 5753.3849),
     (1576.0, 2.8469, 7860.4194), (925.0, 5.453, 11506.770),
     (542.0, 4.564, 3930.210), (472.0, 3.661, 5884.927),
     (346.0, 0.964, 5507.553), (329.0, 5.900, 5223.694),
     (307.0, 0.299, 5573.143), (243.0, 4.273, 11790.629),
     (212.0, 5.847, 1577.344), (186.0, 5.022, 10977.079),
     (175.0, 3.012, 18849.228), (110.0, 5.055, 5486.778),
     (98.0, 0.89, 6069.78), (86.0, 5.69, 15720.84),
     (86.0, 1.27, 161000.69), (65.0, 0.27, 17260.15),
     (63.0, 0.92, 529.69), (57.0, 2.01, 83996.85),
     (56.0, 5.24, 71430.70), (49.0, 3.25, 2544.31),
     (47.0, 2.58, 775.52), (45.0, 5.54, 9437.76),
     (43.0, 6.01, 6275.96), (39.0, 5.36, 4694.00),
     (38.0, 2.39, 8827.39), (37.0, 0.83, 19651.05),
     (37.0, 4.90, 12139.55), (36.0, 1.67, 12036.46),
     (35.0, 1.84, 2942.46), (33.0, 0.24, 7084.90),
     (32.0, 0.18, 5088.63), (32.0, 1.78, 398.15),
     (28.0, 1.21, 6286.60), (28.0, 1.90, 6279.55),
     (26.0, 4.59, 10447.39)],
    # R1
    [(103019.0, 1.107490, 6283.075850),
     (1721.0, 1.0644, 12566.1517), (702.0, 3.142, 0.0),
     (32.0, 1.02, 18849.23), (31.0, 2.84, 5507.55),
     (25.0, 1.32, 5223.69), (18.0, 1.42, 1577.34),
     (10.0, 5.91, 10977.08), (9.0, 1.42, 6275.96),
     (9.0, 0.27, 5486.78)],
    # R2
    [(4359.0, 5.7846, 6283.0758), (124.0, 5.579, 12566.152),
     (12.0, 3.14, 0.0), (9.0, 3.63, 77713.77),
     (6.0, 1.87, 5573.14), (3.0, 5.47, 18849.23)],
    # R3
    [(145.0, 4.273, 6283.076), (7.0, 3.92, 12566.15)],
    # R4
    [(4.0, 2.56, 6283.08)],
]


def _vsop_series(tables, tau):
    """Sum_k tau^k * sum_i A cos(B + C*tau) for one coordinate [1e-8 units]."""
    total = np.zeros_like(tau)
    for k, table in enumerate(tables):
        arr = np.asarray(table)  # (n, 3)
        s = np.sum(arr[:, 0] * np.cos(arr[:, 1] + arr[:, 2] * tau[..., None]),
                   axis=-1)
        total = total + s * tau**k
    return total * 1e-8


def _rotz_vec(v, a):
    """Rotate vectors (..., 3) about +z by angle(s) a."""
    c, s = np.cos(a), np.sin(a)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return np.stack([c * x - s * y, s * x + c * y, z], axis=-1)


def _roty_vec(v, a):
    c, s = np.cos(a), np.sin(a)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return np.stack([c * x + s * z, y, -s * x + c * z], axis=-1)


def _kepler_E(M, e, iters=10):
    """Solve Kepler's equation by Newton iteration (vectorized)."""
    E = M + e * np.sin(M)
    for _ in range(iters):
        E = E - (E - e * np.sin(E) - M) / (1.0 - e * np.cos(E))
    return E


class AnalyticEphemeris(Ephemeris):
    """Built-in closed-form solar-system ephemeris (no data files needed)."""

    name = "builtin_analytic"

    def _helio_ecl(self, planet: str, T):
        """Heliocentric J2000-ecliptic posvel of a planet/EMB [AU, AU/day]."""
        el0, rate = _ELEMENTS[planet]
        a, e, inc, L, varpi, Om = (np.float64(el0[i]) + np.float64(rate[i]) * T for i in range(6))
        inc, L, varpi, Om = inc * _DEG, L * _DEG, varpi * _DEG, Om * _DEG
        w = varpi - Om
        M = np.remainder(L - varpi + np.pi, 2 * np.pi) - np.pi
        E = _kepler_E(M, e)
        cosE, sinE = np.cos(E), np.sin(E)
        b = a * np.sqrt(1.0 - e * e)
        xp = a * (cosE - e)
        yp = b * sinE
        # mean motion [rad/day] from the L rate
        n = np.float64(_ELEMENTS[planet][1][3]) * _DEG / 36525.0
        Edot = n / (1.0 - e * cosE)
        vxp = -a * sinE * Edot
        vyp = b * cosE * Edot
        cw, sw = np.cos(w), np.sin(w)
        cO, sO = np.cos(Om), np.sin(Om)
        ci, si = np.cos(inc), np.sin(inc)
        r11 = cw * cO - sw * sO * ci
        r12 = -sw * cO - cw * sO * ci
        r21 = cw * sO + sw * cO * ci
        r22 = -sw * sO + cw * cO * ci
        r31 = sw * si
        r32 = cw * si
        pos = np.stack([r11 * xp + r12 * yp, r21 * xp + r22 * yp, r31 * xp + r32 * yp], -1)
        vel = np.stack([r11 * vxp + r12 * vyp, r21 * vxp + r22 * vyp, r31 * vxp + r32 * vyp], -1)
        return pos, vel

    def _moon_geo_ecl(self, T):
        """Geocentric J2000-ecliptic posvel of the Moon [km, km/day]."""
        # Fundamental arguments (degrees; of-date angles)
        Lp = 218.3164477 + 481267.88123421 * T
        D = (297.8501921 + 445267.1114034 * T) * _DEG
        M = (357.5291092 + 35999.0502909 * T) * _DEG
        Mp = (134.9633964 + 477198.8675055 * T) * _DEG
        F = (93.2720950 + 483202.0175233 * T) * _DEG
        lon = np.asarray(Lp, dtype=np.float64).copy()
        lat = np.zeros_like(lon)
        dist = np.full_like(lon, 385000.56)
        for c, d, m, mp, f in _MOON_LON:
            lon = lon + c * np.sin(d * D + m * M + mp * Mp + f * F)
        for c, d, m, mp, f in _MOON_LAT:
            lat = lat + c * np.sin(d * D + m * M + mp * Mp + f * F)
        for c, d, m, mp, f in _MOON_DIST:
            dist = dist + c * np.cos(d * D + m * M + mp * Mp + f * F)
        # refer longitude to the J2000 equinox (subtract accumulated general
        # precession, 5029.0966 arcsec/Julian century)
        lon = lon - 1.3969713 * T
        lon, lat = lon * _DEG, lat * _DEG
        cl, sl = np.cos(lon), np.sin(lon)
        cb, sb = np.cos(lat), np.sin(lat)
        pos = np.stack([dist * cb * cl, dist * cb * sl, dist * sb], -1)
        return pos

    def _moon_geo_ecl_posvel(self, T):
        pos = self._moon_geo_ecl(T)
        dT = 0.5 / 36525.0  # half a day, centered difference for velocity
        v = (self._moon_geo_ecl(T + dT) - self._moon_geo_ecl(T - dT)) / 1.0  # km/day
        return pos, v

    @staticmethod
    def _earth_helio_ecl_j2000(T):
        """Heliocentric J2000-ecliptic position of the Earth [AU] from the
        truncated VSOP87D series (includes the ~4700 km lunar wobble, so this
        is the Earth itself, not the EMB).

        The series give (lon, lat, R) in the mean ecliptic/equinox of date;
        the result is rotated of-date ecliptic -> of-date equatorial
        (mean obliquity) -> J2000 equatorial (IAU1976 precession) -> J2000
        ecliptic, all per-epoch.
        """
        tau = np.asarray(T, dtype=np.float64) / 10.0  # Julian millennia
        lon = _vsop_series(_VSOP_EARTH_L, tau)
        lat = _vsop_series(_VSOP_EARTH_B, tau)
        R = _vsop_series(_VSOP_EARTH_R, tau)
        cl, sl = np.cos(lon), np.sin(lon)
        cb, sb = np.cos(lat), np.sin(lat)
        v = np.stack([R * cb * cl, R * cb * sl, R * sb], axis=-1)
        # mean obliquity of date (IAU 1980), arcsec
        eps = (84381.448 - 46.8150 * T - 0.00059 * T**2 + 0.001813 * T**3) \
            * np.pi / (180.0 * 3600.0)
        v = _rot_x(v, eps)  # ecliptic of date -> equatorial of date
        # IAU1976 precession, mean-of-date -> J2000: in passive notation
        # R3(zeta) R2(-theta) R3(z); _rot*_vec are ACTIVE rotations, i.e.
        # R3(a) == _rotz_vec(., -a), R2(a) == _roty_vec(., -a)
        asec = np.pi / (180.0 * 3600.0)
        zeta = (2306.2181 * T + 0.30188 * T**2 + 0.017998 * T**3) * asec
        z = (2306.2181 * T + 1.09468 * T**2 + 0.018203 * T**3) * asec
        theta = (2004.3109 * T - 0.42665 * T**2 - 0.041833 * T**3) * asec
        v = _rotz_vec(_roty_vec(_rotz_vec(v, -z), theta), -zeta)
        return _rot_x(v, -_EPS_J2000)  # equatorial J2000 -> ecliptic J2000

    def _earth_helio_posvel(self, T):
        """Heliocentric J2000-ecliptic posvel of the Earth [AU, AU/day]."""
        pos = self._earth_helio_ecl_j2000(T)
        dT = 0.5 / 36525.0
        vel = self._earth_helio_ecl_j2000(T + dT) - self._earth_helio_ecl_j2000(T - dT)
        return pos, vel

    def posvel_ssb(self, body: str, tdb_mjd) -> Tuple[np.ndarray, np.ndarray]:
        body = body.lower()
        tdb_mjd = np.atleast_1d(np.asarray(tdb_mjd, dtype=np.float64))
        T = (tdb_mjd - 51544.5) / 36525.0
        # heliocentric positions of all massive bodies for the SSB offset
        helio: Dict[str, Tuple[np.ndarray, np.ndarray]] = {
            p: self._helio_ecl(p, T) for p in _ELEMENTS
        }
        denom = 1.0 + sum(1.0 / im for im in _INV_MASS.values())
        sun_pos = -sum(helio[p][0] / _INV_MASS[p] for p in _ELEMENTS) / denom
        sun_vel = -sum(helio[p][1] / _INV_MASS[p] for p in _ELEMENTS) / denom

        if body == "sun":
            pos_au, vel_aud = sun_pos, sun_vel
        elif body in ("earth", "moon", "emb"):
            # VSOP87-truncated Earth (~arcsec, ~2 ms Roemer accuracy);
            # moon/EMB are derived from it via the geocentric lunar theory
            epos, evel = self._earth_helio_posvel(T)
            pos_au = sun_pos + epos
            vel_aud = sun_vel + evel
            if body != "earth":
                mpos_km, mvel_kmd = self._moon_geo_ecl_posvel(T)
                frac = 1.0 if body == "moon" else _MOON_FRAC
                pos_au = pos_au + frac * mpos_km / AU_KM
                vel_aud = vel_aud + frac * mvel_kmd / AU_KM
        elif body in _ELEMENTS:
            pos_au = sun_pos + helio[body][0]
            vel_aud = sun_vel + helio[body][1]
        else:
            raise KeyError(f"Unknown body for analytic ephemeris: {body}")
        # ecliptic J2000 -> equatorial ICRS, AU -> km, AU/day -> km/s
        pos = _rot_x(pos_au, _EPS_J2000) * AU_KM
        vel = _rot_x(vel_aud, _EPS_J2000) * AU_KM / DAY_S
        return pos, vel


# ---------------------------------------------------------------------------
# SPK (.bsp) kernel reader — DAF file format, segment types 2 and 3
# ---------------------------------------------------------------------------

class _Segment:
    __slots__ = ("target", "center", "frame", "dtype", "start", "end", "et0", "et1",
                 "init", "intlen", "rsize", "n", "_coeffs")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)
        self._coeffs = None


class SPKEphemeris(Ephemeris):
    """Reader/evaluator for JPL SPK .bsp kernels (Chebyshev types 2 & 3).

    The DAF container layout (1024-byte records, summary/name record chain)
    and the type-2/3 segment layout are implemented from the public SPK
    specification.  Evaluation vectorizes the Chebyshev recurrence with numpy.
    """

    def __init__(self, path: str):
        self.path = path
        self.name = os.path.splitext(os.path.basename(path))[0]
        with open(path, "rb") as f:
            self._data = f.read()
        try:
            self._parse()
        except (struct.error, ValueError, IndexError) as e:
            # a half-downloaded kernel must fail as a typed file error,
            # not an opaque struct/buffer exception deep in the parser
            from pint_torch.exceptions import PintFileError

            raise PintFileError(
                f"{path}: truncated or corrupt SPK kernel ({e})") from e

    def _parse(self):
        d = self._data
        locidw = d[0:8].decode("ascii", "replace")
        if not locidw.startswith("DAF/SPK"):
            raise ValueError(f"{self.path}: not an SPK kernel ({locidw!r})")
        locfmt = d[88:96].decode("ascii", "replace")
        self._le = "LTL" in locfmt
        endian = "<" if self._le else ">"
        self._endian = endian
        nd, ni = struct.unpack_from(endian + "ii", d, 8)
        fward, bward, free = struct.unpack_from(endian + "iii", d, 76)
        if (nd, ni) != (2, 6):
            raise ValueError(f"{self.path}: unexpected DAF ND/NI = {nd}/{ni}")
        ss = nd + (ni + 1) // 2  # summary size in doubles
        self.segments = []
        rec = fward
        while rec > 0:
            base = (rec - 1) * 1024
            nxt, prv, nsum = struct.unpack_from(endian + "ddd", d, base)
            for i in range(int(nsum)):
                off = base + 24 + i * ss * 8
                et0, et1 = struct.unpack_from(endian + "dd", d, off)
                ints = struct.unpack_from(endian + "6i", d, off + nd * 8)
                target, center, frame, dtype, start, end = ints
                if dtype not in (2, 3):
                    continue
                trailer = struct.unpack_from(endian + "4d", d, (end - 4) * 8)
                init, intlen, rsize, n = trailer
                self.segments.append(
                    _Segment(target=target, center=center, frame=frame, dtype=dtype,
                             start=start, end=end, et0=et0, et1=et1, init=init,
                             intlen=intlen, rsize=int(rsize), n=int(n))
                )
            rec = int(nxt)
        # index segments by (target, center)
        self._by_pair: Dict[Tuple[int, int], _Segment] = {}
        for s in self.segments:
            self._by_pair.setdefault((s.target, s.center), s)

    def _seg_coeffs(self, s: _Segment) -> np.ndarray:
        if s._coeffs is None:
            endian = "<f8" if self._le else ">f8"
            nwords = s.rsize * s.n
            try:
                arr = np.frombuffer(self._data, dtype=endian,
                                    count=nwords, offset=(s.start - 1) * 8)
            except ValueError as e:
                # the summary chain parsed but the coefficient block is
                # missing: a kernel cut mid-file
                from pint_torch.exceptions import PintFileError

                raise PintFileError(
                    f"{self.path}: truncated SPK kernel — segment "
                    f"{s.target}/{s.center} coefficients extend past end "
                    f"of file ({e})") from e
            s._coeffs = arr.reshape(s.n, s.rsize).astype(np.float64)
        return s._coeffs

    def _eval_pair(self, target: int, center: int, et: np.ndarray):
        s = self._by_pair[(target, center)]
        recs = self._seg_coeffs(s)
        # refuse to extrapolate outside the segment's coverage (1 s tolerance)
        if np.any(et < s.et0 - 1.0) or np.any(et > s.et1 + 1.0):
            from pint_torch.exceptions import EphemCoverageError

            bad = et[(et < s.et0 - 1.0) | (et > s.et1 + 1.0)]
            raise EphemCoverageError(
                f"{self.path}: epoch(s) MJD "
                f"{bad.min() / DAY_S + 51544.5:.1f}..{bad.max() / DAY_S + 51544.5:.1f} "
                f"outside kernel coverage for segment {target}/{center} "
                f"(MJD {s.et0 / DAY_S + 51544.5:.1f}..{s.et1 / DAY_S + 51544.5:.1f})"
            )
        idx = np.clip(((et - s.init) / s.intlen).astype(int), 0, s.n - 1)
        rec = recs[idx]  # (..., rsize)
        # (note: the out-of-coverage check above raises EphemCoverageError)
        mid, radius = rec[..., 0], rec[..., 1]
        x = (et - mid) / radius  # in [-1, 1]
        if (s.target, s.center) == (TDB_TT_TARGET, TDB_TT_CENTER):
            ncomp = 1  # time-ephemeris segment: scalar TDB-TT [s]
        else:
            ncomp = 3 if s.dtype == 2 else 6
        ncoef = (s.rsize - 2) // ncomp
        coeffs = rec[..., 2:2 + ncoef * ncomp].reshape(rec.shape[:-1] + (ncomp, ncoef))
        # Chebyshev recurrence; the derivative recurrence is only needed for
        # type 2, which stores positions and differentiates for velocity.
        need_deriv = s.dtype == 2
        pos_terms = [coeffs[..., :, 0], coeffs[..., :, 1] * x[..., None]]
        dpos_terms = [np.zeros_like(coeffs[..., :, 0]), coeffs[..., :, 1]]
        Tkm1, Tk = np.ones_like(x), x
        dTkm1, dTk = np.zeros_like(x), np.ones_like(x)
        for k in range(2, ncoef):
            Tkp1 = 2 * x * Tk - Tkm1
            pos_terms.append(coeffs[..., :, k] * Tkp1[..., None])
            if need_deriv:
                dTkp1 = 2 * Tk + 2 * x * dTk - dTkm1
                dpos_terms.append(coeffs[..., :, k] * dTkp1[..., None])
                dTkm1, dTk = dTk, dTkp1
            Tkm1, Tk = Tk, Tkp1
        val = np.sum(np.stack(pos_terms, -1), axis=-1)  # (..., ncomp)
        if s.dtype == 2:
            dval = np.sum(np.stack(dpos_terms, -1), axis=-1) / radius[..., None]
            return val, dval  # km, km/s
        return val[..., :3], val[..., 3:]

    def _chain(self, body_id: int):
        """Path of (target, center, sign) hops from SSB (0) to body."""
        # BFS over available pairs
        from collections import deque

        start = 0
        goal = body_id
        adj: Dict[int, list] = {}
        for (t, c) in self._by_pair:
            adj.setdefault(c, []).append((t, (t, c), +1))
            adj.setdefault(t, []).append((c, (t, c), -1))
        q = deque([(start, [])])
        seen = {start}
        while q:
            node, path = q.popleft()
            if node == goal:
                return path
            for nxt, pair, sign in adj.get(node, []):
                if nxt not in seen:
                    seen.add(nxt)
                    q.append((nxt, path + [(pair, sign)]))
        raise KeyError(f"No SPK path from SSB to body {body_id} in {self.path}")

    def posvel_ssb(self, body: str, tdb_mjd) -> Tuple[np.ndarray, np.ndarray]:
        body_id = BODY_IDS[body.lower()] if isinstance(body, str) else int(body)
        tdb_mjd = np.atleast_1d(np.asarray(tdb_mjd, dtype=np.float64))
        et = (tdb_mjd - 51544.5) * DAY_S  # TDB seconds past J2000
        pos = np.zeros(tdb_mjd.shape + (3,))
        vel = np.zeros(tdb_mjd.shape + (3,))
        for pair, sign in self._chain(body_id):
            p, v = self._eval_pair(pair[0], pair[1], et)
            pos = pos + sign * p
            vel = vel + sign * v
        return pos, vel

    def has_tdb_tt(self) -> bool:
        """True when the kernel carries a time-ephemeris segment (the 't'
        kernels DE430t/DE440t; target 1000000001 wrt 1000000000)."""
        return (TDB_TT_TARGET, TDB_TT_CENTER) in self._by_pair

    def tdb_minus_tt(self, tt_mjd) -> np.ndarray:
        """TDB-TT [s] from the kernel's integrated time ephemeris — the
        ns-exact source the reference reaches via ERFA's analytic series
        (``observatory/__init__.py:443``); a 't' kernel beats the series.

        Kernel conventions differ on whether the segment stores TDB-TT or
        TT-TDB; the sign is self-calibrated once per kernel by correlating
        against the analytic series' 1.7 ms annual term (any real kernel
        agrees with the series at the ~10 us level, so the correlation sign
        is unambiguous).

        The argument difference (evaluating at TT vs TDB epochs, ~1.7 ms)
        changes the result by < d(TDB-TT)/dt * 1.7 ms ~ 3e-14 s: ignorable.
        """
        if not self.has_tdb_tt():
            raise KeyError(f"{self.path} has no TDB-TT time-ephemeris segment")
        shape = np.shape(tt_mjd)
        tt = np.atleast_1d(np.asarray(tt_mjd, dtype=np.float64))
        et = (tt - 51544.5) * DAY_S
        val, _ = self._eval_pair(TDB_TT_TARGET, TDB_TT_CENTER, et)
        return self._tdbtt_sign() * val[..., 0].reshape(shape)

    def _tdbtt_sign(self) -> float:
        if getattr(self, "_tdbtt_sign_cached", None) is None:
            from pint_torch.timescales import tdb_minus_tt_series

            s = self._by_pair[(TDB_TT_TARGET, TDB_TT_CENTER)]
            et = np.linspace(s.et0, min(s.et1, s.et0 + 366 * DAY_S), 73)
            raw, _ = self._eval_pair(TDB_TT_TARGET, TDB_TT_CENTER, et)
            raw = raw[..., 0] - raw[..., 0].mean()
            ref = tdb_minus_tt_series(et / DAY_S + 51544.5)
            ref = ref - ref.mean()
            corr = float(np.sum(raw * ref))
            self._tdbtt_sign_cached = 1.0 if corr >= 0 else -1.0
            if corr < 0:
                log.info(f"{self.path}: time-ephemeris segment stores TT-TDB"
                         " (sign flipped to the TDB-TT convention)")
        return self._tdbtt_sign_cached

    def coverage_mjd(self) -> Tuple[float, float]:
        """(lo, hi) MJD range covered by every segment simultaneously."""
        lo = max(s.et0 for s in self.segments) / DAY_S + 51544.5
        hi = min(s.et1 for s in self.segments) / DAY_S + 51544.5
        return lo, hi


# ---------------------------------------------------------------------------
# Loader
# ---------------------------------------------------------------------------

_loaded: Dict[str, Ephemeris] = {}


def _search_paths():
    paths = []
    if os.environ.get("PINT_EPHEM_DIR"):
        paths.append(os.environ["PINT_EPHEM_DIR"])
    paths += [
        os.path.join(os.path.dirname(__file__), "data", "ephemeris"),
        os.path.expanduser("~/.pint_torch/ephemeris"),
        os.getcwd(),
    ]
    return paths


def load_ephemeris(name: str = "DE440") -> Ephemeris:
    """Load the named ephemeris (e.g. 'DE421'), falling back to analytic.

    Mirrors reference ``solar_system_ephemerides.py:123 load_kernel`` search
    semantics (local paths, env override) minus the network download, which a
    zero-egress deployment cannot perform.
    """
    name = name or "DE440"
    key = name.lower()
    if key in _loaded:
        return _loaded[key]
    if name.lower().endswith(".bsp"):
        # explicit path: use as given (case preserved), never fall back silently
        if not os.path.exists(name):
            raise FileNotFoundError(f"Ephemeris kernel not found: {name}")
        eph: Ephemeris = SPKEphemeris(name)
    else:
        eph = None  # type: ignore[assignment]
        for d in _search_paths():
            for cand_name in (name + ".bsp", name.lower() + ".bsp", name.upper() + ".bsp"):
                cand = os.path.join(d, cand_name)
                if os.path.exists(cand):
                    eph = SPKEphemeris(cand)
                    break
            if eph is not None:
                break
        if eph is None:
            log.info(
                f"Using built-in analytic solar-system ephemeris (no {name}.bsp found; "
                "Earth position approximate at the ~1e-5 AU level)"
            )
            eph = AnalyticEphemeris()
    _loaded[key] = eph
    return eph


def objPosVel_wrt_SSB(objname: str, tdb_mjd, ephem: str = "DE440"):
    """Reference-parity helper (``solar_system_ephemerides.py:201``)."""
    from pint_torch.utils import PosVel

    eph = load_ephemeris(ephem)
    pos, vel = eph.posvel_ssb(objname, tdb_mjd)
    return PosVel(pos, vel, obj=objname, origin="ssb")


def sun_ecliptic_longitude_deg(mjd, precision: str = "low"):
    """Geocentric ecliptic (J2000) longitude of the Sun [deg].

    ``"low"``: the classical mean-Sun expression (~0.01 deg), matching the
    reference's analytic branch (``utils.py:2668 get_conjunction``).
    ``"high"``: -Earth heliocentric position from the VSOP87 series.
    """
    mjd = np.asarray(mjd, dtype=np.float64)
    if precision == "low":
        n = mjd - 51544.5
        L = 280.460 + 0.9856474 * n
        g = np.deg2rad(357.528 + 0.9856003 * n)
        lam = L + 1.915 * np.sin(g) + 0.020 * np.sin(2.0 * g)
        return np.asarray(lam % 360.0)[()]
    T = (mjd - 51544.5) / 36525.0
    pos = AnalyticEphemeris._earth_helio_ecl_j2000(T)
    # geocentric Sun = -heliocentric Earth
    lam = np.arctan2(-pos[..., 1], -pos[..., 0])
    return np.asarray(np.rad2deg(lam) % 360.0)[()]


# ---------------------------------------------------------------------------
# reference-spelled entry points (solar_system_ephemerides.py:123,201,240,289)
# ---------------------------------------------------------------------------

def load_kernel(ephem: str, path: "str | None" = None, link: str = None):
    """Reference ``solar_system_ephemerides.py:123``: load the named kernel
    (or an explicit ``path``); ``link`` (a download URL) is accepted for
    signature parity but unusable in a zero-egress deployment."""
    if link:
        log.warning("load_kernel: remote links are not supported in this "
                    "zero-egress build; using local search paths")
    if path:
        # an explicit path must load THAT kernel or fail loudly — the
        # name-based analytic fallback would silently degrade accuracy
        key = str(path).lower()
        if key not in _loaded:
            if not os.path.exists(str(path)):
                raise FileNotFoundError(f"Ephemeris kernel not found: {path}")
            _loaded[key] = SPKEphemeris(str(path))
        return _loaded[key]
    return load_ephemeris(ephem)


def clear_loaded_ephem() -> None:
    """Drop every cached kernel (reference
    ``solar_system_ephemerides.py clear_loaded_ephem``)."""
    _loaded.clear()


def objPosVel(obj1: str, obj2: str, t, ephem: str = "DE440",
              path=None, link=None):
    """Position/velocity of ``obj2`` relative to ``obj1`` (reference
    ``solar_system_ephemerides.py:240``); ``t`` is TDB MJD."""
    # an explicit path IS the kernel to use — name-based lookup would
    # silently fall back to the analytic ephemeris when the named kernel
    # is not on the search path
    key = str(path) if path else ephem
    if link:
        load_kernel(ephem, path=path, link=link)
    pv1 = objPosVel_wrt_SSB(obj1, t, key)
    pv2 = objPosVel_wrt_SSB(obj2, t, key)
    return pv2 - pv1


def get_tdb_tt_ephem_geocenter(tt_mjd, ephem: str = "DE440",
                               path=None, link=None) -> np.ndarray:
    """Geocentric TDB-TT [s] read from a 't' kernel's time-ephemeris
    segment (reference ``solar_system_ephemerides.py:289``); raises when the
    loaded kernel carries none (e.g. the analytic fallback)."""
    eph = load_kernel(ephem, path=path, link=link)
    if not getattr(eph, "has_tdb_tt", lambda: False)():
        raise ValueError(
            f"Ephemeris {ephem!r} has no TDB-TT time-ephemeris segment "
            "(use a 't' kernel such as DE440t)")
    return eph.tdb_minus_tt(tt_mjd)
