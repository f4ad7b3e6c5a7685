"""Binary-orbit delay engines (port of
``pint_tpu/models/binary/engines.py:29-226``, the DD path).

Pure functions of a parameter mapping ``p`` (PB, PBDOT, ... as in
:data:`DD_PARAMS`) and ``tt0`` (seconds since T0), written once for plain
tensors and for :class:`~pint_torch.kernels.dual.Dual` numbers.  They are
the arithmetic of kernel K2 (``pint_torch/kernels/csrc/dd_binary.cu``),
operation for operation: the kernel's plain twin
(:func:`pint_torch.kernels.dd_binary.dd_binary_reference`) is
:func:`dd_delay` on these, so kernel and twin round alike.  On the main
path the binary component calls the kernel wrapper instead.
"""

from __future__ import annotations

import math

import torch

from pint_torch.kernels.dual import atan2, clip, cos, log, sin, sqrt, val

__all__ = ["DD_PARAMS", "TSUN", "orbits_pb", "mean_anomaly", "ecc_at",
           "a1_at", "solve_kepler", "dd_state", "dd_delay_core", "dd_delay"]

#: the DD parameter row, in the reference's units (PB days, OM deg,
#: OMDOT deg/yr, M2 Msun)
DD_PARAMS = ("PB", "PBDOT", "XPBDOT", "A1", "A1DOT", "ECC", "EDOT", "OM",
             "OMDOT", "M2", "SINI", "GAMMA", "DR", "DTH", "A0", "B0")

#: G * Msun / c^3 [s]
TSUN = 4.925490947000518e-6
SEC_PER_YEAR = 365.25 * 86400.0
DEG = math.pi / 180.0
TWO_PI = 2.0 * math.pi


def orbits_pb(p, tt0):
    """(orbits, instantaneous period) from PB/PBDOT/XPBDOT."""
    pb_s = p["PB"] * 86400.0
    pbdot = p["PBDOT"] + p["XPBDOT"]
    frac = tt0 / pb_s
    orbits = frac - 0.5 * pbdot * frac * frac
    pbprime = pb_s + p["PBDOT"] * tt0
    return orbits, pbprime


def mean_anomaly(orbits):
    """Orbital phase in [0, 2 pi)."""
    return (orbits - torch.floor(val(orbits))) * TWO_PI


def ecc_at(p, tt0):
    return p["ECC"] + tt0 * p["EDOT"]


def a1_at(p, tt0):
    return p["A1"] + tt0 * p["A1DOT"]


def solve_kepler(M, e, niter: int = 15):
    """E - e sin E = M by a fixed count of Newton steps clamped to
    |dE| <= 1; the clamp keeps NaN."""
    E = M + e * sin(M)
    for _ in range(niter):
        dE = (E - e * sin(E) - M) / (1.0 - e * cos(E))
        E = E - clip(dE, -1.0, 1.0)
    return E


def dd_state(p, tt0):
    """E, the true anomaly nu and the advanced periastron omega."""
    orbits, pbprime = orbits_pb(p, tt0)
    M = mean_anomaly(orbits)
    e = ecc_at(p, tt0)
    E = solve_kepler(M, e)
    nu = 2.0 * atan2(sqrt(1.0 + e) * sin(E / 2.0),
                     sqrt(1.0 - e) * cos(E / 2.0))
    k = p["OMDOT"] * DEG / SEC_PER_YEAR / (TWO_PI / pbprime)
    nu_cont = nu + TWO_PI * torch.floor(val(orbits)) \
        + torch.where(val(nu) < 0, TWO_PI, 0.0)
    omega = p["OM"] * DEG + k * nu_cont
    return dict(pbprime=pbprime, e=e, sinE=sin(E), cosE=cos(E), nu=nu,
                omega=omega)


def dd_delay_core(st, a1, e, gamma, sini, m2_tsun, dr, dth, a0, b0):
    """Inverse-timing Roemer + Einstein, Shapiro and aberration delays."""
    sinE, cosE = st["sinE"], st["cosE"]
    er = e * (1.0 + dr)
    eth = e * (1.0 + dth)
    sin_om, cos_om = sin(st["omega"]), cos(st["omega"])
    alpha = a1 * sin_om
    beta = a1 * sqrt(1.0 - eth * eth) * cos_om
    Dre = alpha * (cosE - er) + beta * sinE + gamma * sinE
    Drep = -alpha * sinE + (beta + gamma) * cosE
    Drepp = -alpha * cosE - (beta + gamma) * sinE
    nhat = TWO_PI / st["pbprime"] / (1.0 - e * cosE)
    nD = nhat * Drep
    nhat2 = nhat * nhat
    delayI = Dre * (1.0 - nhat * Drep + nD * nD + 0.5 * nhat2 * Dre * Drepp
                    - 0.5 * e * sinE / (1.0 - e * cosE) * nhat2 * Dre * Drep)
    brace = (1.0 - e * cosE
             - sini * (sin_om * (cosE - e) + sqrt(1.0 - e * e) * cos_om * sinE))
    delayS = -2.0 * m2_tsun * log(brace)
    om_plus_nu = st["omega"] + st["nu"]
    delayA = (a0 * (sin(om_plus_nu) + e * sin_om)
              + b0 * (cos(om_plus_nu) + e * cos_om))
    return delayI + delayS + delayA


def dd_delay(p, tt0):
    """Plain DD: SINI/M2 Shapiro, DR/DTH deformations."""
    st = dd_state(p, tt0)
    return dd_delay_core(st, a1_at(p, tt0), st["e"], p["GAMMA"], p["SINI"],
                         p["M2"] * TSUN, p["DR"], p["DTH"], p["A0"], p["B0"])
