"""Derived astrophysical quantities from timing parameters (a copy of
``pint_tpu/derived_quantities.py``, numpy and ``scipy.optimize.brentq`` on
the host): spin period/frequency conversions with error propagation,
characteristic age, spin-down luminosity, magnetic fields, binary mass
functions and mass solutions, GR post-Keplerian predictions (OMDOT, GAMMA,
PBDOT, SINI, DR, DTH), Shklovskii correction, dispersion slope.

Unit convention: plain floats in the units stated per function -- periods
in s, frequencies in Hz, masses in Msun, PB in days, X (a sini) in
light-seconds, angles in deg, distances in kpc.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy.optimize import brentq

__all__ = [
    "p_to_f", "pferrs", "pulsar_age", "pulsar_edot", "pulsar_B",
    "pulsar_B_lightcyl", "mass_funct", "mass_funct2", "pulsar_mass",
    "companion_mass", "pbdot", "gamma", "omdot", "sini", "dr", "dth",
    "omdot_to_mtot", "a1sini", "shklovskii_factor", "dispersion_slope",
]

#: GM_sun / c^3 [s] (IAU nominal; pint.Tsun)
TSUN_S = 4.925490947641267e-06
C_KM_S = 299792.458
SECPERDAY = 86400.0
SECPERJULYR = 365.25 * SECPERDAY
#: dispersion constant [s MHz^2 cm^3 / pc]
DMCONST = 1.0 / 2.41e-4
KPC_KM = 3.0856775814913673e16


def p_to_f(p, pd, pdd: Optional[float] = None):
    """(P, Pdot[, Pddot]) -> (F, Fdot[, Fddot]); the transform is its own
    inverse (reference ``derived_quantities.py:38``)."""
    f = 1.0 / p
    fd = -pd / (p * p)
    if pdd is None:
        return f, fd
    fdd = 0.0 if pdd == 0 else 2.0 * pd * pd / p**3 - pdd / (p * p)
    return f, fd, fdd


def pferrs(porf, porferr, pdorfd=None, pdorfderr=None):
    """Period/frequency conversions WITH uncertainties
    (reference ``derived_quantities.py:89``)."""
    if pdorfd is None:
        return 1.0 / porf, porferr / porf**2
    forp = 1.0 / porf
    fdorpd = -pdorfd / porf**2
    forperr = porferr / porf**2
    fdorpderr = np.sqrt((4.0 * pdorfd**2 * porferr**2) / porf**6
                        + pdorfderr**2 / porf**4)
    return forp, forperr, fdorpd, fdorpderr


def pulsar_age(f: float, fdot: float, n: int = 3, fo: float = 1e-9) -> float:
    """Characteristic age [yr] with braking index n
    (reference ``derived_quantities.py:149``)."""
    return float(-f / ((n - 1) * fdot) * (1.0 - (fo / f) ** (n - 1))
                 / SECPERJULYR)


def pulsar_edot(f: float, fdot: float, I: float = 1e45) -> float:
    """Spin-down luminosity [erg/s], I in g cm^2
    (reference ``derived_quantities.py:194``)."""
    return float(-4.0 * np.pi**2 * I * f * fdot)


def pulsar_B(f: float, fdot: float) -> float:
    """Surface dipole field estimate [G] (reference
    ``derived_quantities.py:232``): 3.2e19 sqrt(P Pdot) = 3.2e19
    sqrt(-fdot/f^3)."""
    return float(3.2e19 * np.sqrt(-fdot / f**3))


def pulsar_B_lightcyl(f: float, fdot: float) -> float:
    """Light-cylinder field [G] (reference ``derived_quantities.py:274``)."""
    p = 1.0 / f
    pd = -fdot / f**2
    return float(2.9e8 * p ** (-5.0 / 2.0) * np.sqrt(pd))


def mass_funct(pb_d: float, x_ls: float) -> float:
    """Binary mass function [Msun] (reference ``derived_quantities.py:318``):
    4 pi^2 x^3 / (G Pb^2)."""
    pb = pb_d * SECPERDAY
    return float(4.0 * np.pi**2 * x_ls**3 / (TSUN_S * pb**2))


def mass_funct2(mp: float, mc: float, i_deg: float) -> float:
    """(Mc sin i)^3 / (Mp + Mc)^2 [Msun]
    (reference ``derived_quantities.py:359``)."""
    return float((mc * np.sin(np.radians(i_deg))) ** 3 / (mp + mc) ** 2)


def pulsar_mass(pb_d: float, x_ls: float, mc: float, i_deg: float) -> float:
    """Solve for the pulsar mass [Msun]
    (reference ``derived_quantities.py:404``)."""
    mf = mass_funct(pb_d, x_ls)
    sini_ = np.sin(np.radians(i_deg))
    # (mc sini)^3/(mp+mc)^2 = mf -> mp = sqrt((mc sini)^3/mf) - mc
    return float(np.sqrt((mc * sini_) ** 3 / mf) - mc)


def companion_mass(pb_d: float, x_ls: float, i_deg: float = 90.0,
                   mp: float = 1.4) -> float:
    """Solve the cubic for the companion mass [Msun]
    (reference ``derived_quantities.py:471``)."""
    mf = mass_funct(pb_d, x_ls)
    s = np.sin(np.radians(i_deg))

    def g(mc):
        return (mc * s) ** 3 / (mp + mc) ** 2 - mf

    return float(brentq(g, 1e-6, 1e4))


def pbdot(mp: float, mc: float, pb_d: float, e: float) -> float:
    """GR orbital decay [s/s] (reference ``derived_quantities.py:575``)."""
    pb = pb_d * SECPERDAY
    fe = (1 + 73.0 / 24 * e**2 + 37.0 / 96 * e**4) / (1 - e**2) ** 3.5
    return float(-192.0 * np.pi / 5 * (pb / (2 * np.pi)) ** (-5.0 / 3.0)
                 * fe * TSUN_S ** (5.0 / 3.0) * mp * mc / (mp + mc) ** (1.0 / 3.0))


def gamma(mp: float, mc: float, pb_d: float, e: float) -> float:
    """GR Einstein delay amplitude [s]
    (reference ``derived_quantities.py:640``)."""
    pb = pb_d * SECPERDAY
    return float(e * (pb / (2 * np.pi)) ** (1.0 / 3.0) * TSUN_S ** (2.0 / 3.0)
                 * (mp + mc) ** (-4.0 / 3.0) * mc * (mp + 2 * mc))


def omdot(mp: float, mc: float, pb_d: float, e: float) -> float:
    """GR periastron advance [deg/yr]
    (reference ``derived_quantities.py:701``)."""
    pb = pb_d * SECPERDAY
    rate = (3 * (pb / (2 * np.pi)) ** (-5.0 / 3.0)
            * TSUN_S ** (2.0 / 3.0) * (mp + mc) ** (2.0 / 3.0) / (1 - e**2))
    return float(np.degrees(rate) * SECPERJULYR)


def sini(mp: float, mc: float, pb_d: float, x_ls: float) -> float:
    """GR-consistent sin(i) (reference ``derived_quantities.py:761``)."""
    pb = pb_d * SECPERDAY
    return float(TSUN_S ** (-1.0 / 3.0) * (pb / (2 * np.pi)) ** (-2.0 / 3.0)
                 * x_ls * (mp + mc) ** (2.0 / 3.0) / mc)


def dr(mp: float, mc: float, pb_d: float) -> float:
    """GR Roemer-delay shape correction (reference
    ``derived_quantities.py:817``)."""
    pb = pb_d * SECPERDAY
    return float((2 * np.pi / pb) ** (2.0 / 3.0) * TSUN_S ** (2.0 / 3.0)
                 * (3 * mp**2 + 6 * mp * mc + 2 * mc**2)
                 / ((mp + mc) ** (4.0 / 3.0)))


def dth(mp: float, mc: float, pb_d: float) -> float:
    """GR dtheta correction (reference ``derived_quantities.py:867``)."""
    pb = pb_d * SECPERDAY
    return float((2 * np.pi / pb) ** (2.0 / 3.0) * TSUN_S ** (2.0 / 3.0)
                 * (3.5 * mp**2 + 6 * mp * mc + 2 * mc**2)
                 / ((mp + mc) ** (4.0 / 3.0)))


def omdot_to_mtot(omdot_deg_yr: float, pb_d: float, e: float) -> float:
    """Total mass [Msun] from the observed periastron advance
    (reference ``derived_quantities.py:917``)."""
    pb = pb_d * SECPERDAY
    rate = np.radians(omdot_deg_yr) / SECPERJULYR
    return float((rate * (1 - e**2) / 3.0
                  * (pb / (2 * np.pi)) ** (5.0 / 3.0)) ** 1.5 / TSUN_S)


def a1sini(mp: float, mc: float, pb_d: float, i_deg: float = 90.0) -> float:
    """Projected semimajor axis [ls]
    (reference ``derived_quantities.py:981``)."""
    pb = pb_d * SECPERDAY
    return float((mc * np.sin(np.radians(i_deg)))
                 * (TSUN_S ** (1.0 / 3.0)
                    * (pb / (2 * np.pi)) ** (2.0 / 3.0))
                 / (mp + mc) ** (2.0 / 3.0))


def shklovskii_factor(pmtot_mas_yr: float, D_kpc: float) -> float:
    """Shklovskii acceleration a_s [1/s]: Pdot_shk = a_s * P
    (reference ``derived_quantities.py:1035``)."""
    mu = np.radians(pmtot_mas_yr / 3600.0e3) / SECPERJULYR  # rad/s
    d_km = D_kpc * KPC_KM  # 1 kpc = 3.0857e16 km
    return float(mu**2 * d_km / C_KM_S)


def dispersion_slope(dm: float) -> float:
    """Dispersion slope K*DM [s MHz^2 -> 1/s convention of the reference]
    (reference ``derived_quantities.py:1073``)."""
    return float(DMCONST * 1e12 * dm)
