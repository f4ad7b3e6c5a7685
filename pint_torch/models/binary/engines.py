"""Binary-orbit delay engines (port of
``pint_tpu/models/binary/engines.py:29-226``, the DD path).

Plain PyTorch functions of a parameter mapping ``p`` (PB, PBDOT, ... as in
:data:`DD_PARAMS`) and ``tt0`` (seconds since T0).  They are the arithmetic
of kernel K2 (``pint_torch/kernels/csrc/dd_binary.cu``), operation for
operation: :func:`dd_forward` is its ``dd_forward`` and :func:`dd_partials`
its ``dd_reverse``, so kernel and plain twin
(:func:`pint_torch.kernels.dd_binary.dd_binary_reference`) round alike.
The forward pass is the reference's own eager arithmetic; the partials
come from a hand-derived reverse sweep, with Kepler's equation
differentiated at its root.  On the main path the binary component calls
the kernel wrapper instead.
"""

from __future__ import annotations

import math

import torch

__all__ = ["DD_PARAMS", "TSUN", "solve_kepler", "kepler_inputs",
           "dd_forward", "dd_delay", "dd_partials"]

#: the DD parameter row, in the reference's units (PB days, OM deg,
#: OMDOT deg/yr, M2 Msun)
DD_PARAMS = ("PB", "PBDOT", "XPBDOT", "A1", "A1DOT", "ECC", "EDOT", "OM",
             "OMDOT", "M2", "SINI", "GAMMA", "DR", "DTH", "A0", "B0")

#: G * Msun / c^3 [s]
TSUN = 4.925490947000518e-6
SEC_PER_YEAR = 365.25 * 86400.0
DEG = math.pi / 180.0
TWO_PI = 2.0 * math.pi


def _div(a, b):
    """``a / b`` rounded once, as the kernel and the reference divide.
    Torch evaluates ``float / tensor`` as the float times the tensor's
    reciprocal, and on CUDA ``tensor / float`` as the tensor times the
    float's reciprocal: two roundings each."""
    if not torch.is_tensor(a):
        a = torch.full_like(b, a)
    elif not torch.is_tensor(b):
        b = torch.full_like(a, b)
    return a / b


def solve_kepler(M, e, niter: int = 15):
    """E - e sin E = M by a fixed count of Newton steps clamped to
    |dE| <= 1; the clamp keeps NaN."""
    E = M + e * torch.sin(M)
    for _ in range(niter):
        dE = (E - e * torch.sin(E) - M) / (1.0 - e * torch.cos(E))
        E = E - torch.where(dE < -1.0, -1.0, torch.where(dE > 1.0, 1.0, dE))
    return E


def kepler_inputs(p, tt0, f: dict):
    """orbits_pb, mean_anomaly and ecc_at: ``(fl, M, e)``, the whole orbits
    since T0, the mean anomaly and the eccentricity at ``tt0``; the
    intermediates :func:`dd_partials` reads go into ``f``."""
    f["pb_s"] = pb_s = p["PB"] * 86400.0
    f["pbdot"] = pbdot = p["PBDOT"] + p["XPBDOT"]
    f["frac"] = frac = tt0 / pb_s
    orbits = frac - 0.5 * pbdot * frac * frac
    f["pbprime"] = pb_s + p["PBDOT"] * tt0
    fl = torch.floor(orbits)
    M = (orbits - fl) * TWO_PI
    f["e"] = e = p["ECC"] + tt0 * p["EDOT"]
    return fl, M, e


def dd_forward(p, tt0) -> dict:
    """The DD delay (SINI/M2 Shapiro, DR/DTH deformations) under ``delay``,
    with the intermediates :func:`dd_partials` reads."""
    f = {}
    fl, M, e = kepler_inputs(p, tt0, f)
    pbprime = f["pbprime"]
    E = solve_kepler(M, e)
    f["sinE"] = sinE = torch.sin(E)
    f["cosE"] = cosE = torch.cos(E)
    # dd_state: true anomaly and periastron advance
    f["sE2"] = torch.sin(E / 2.0)
    f["cE2"] = torch.cos(E / 2.0)
    f["sq1p"] = torch.sqrt(1.0 + e)
    f["sq1m"] = torch.sqrt(1.0 - e)
    f["yv"] = f["sq1p"] * f["sE2"]
    f["xv"] = f["sq1m"] * f["cE2"]
    f["nu"] = nu = 2.0 * torch.atan2(f["yv"], f["xv"])
    f["k"] = k = _div(_div(p["OMDOT"] * DEG, SEC_PER_YEAR),
                      _div(TWO_PI, pbprime))
    f["nu_cont"] = nu_cont = nu + TWO_PI * fl + (nu < 0.0).to(nu.dtype) \
        * TWO_PI
    f["omega"] = omega = p["OM"] * DEG + k * nu_cont
    # a1_at, dd_delay_core
    f["a1"] = a1 = p["A1"] + tt0 * p["A1DOT"]
    f["m2_tsun"] = p["M2"] * TSUN
    f["er"] = e * (1.0 + p["DR"])
    f["eth"] = eth = e * (1.0 + p["DTH"])
    f["so"] = so = torch.sin(omega)
    f["co"] = co = torch.cos(omega)
    f["alpha"] = alpha = a1 * so
    f["q"] = torch.sqrt(1.0 - eth * eth)
    f["beta"] = beta = a1 * f["q"] * co
    f["bg"] = bg = beta + p["GAMMA"]
    f["Dre"] = Dre = alpha * (cosE - f["er"]) + beta * sinE \
        + p["GAMMA"] * sinE
    f["Drep"] = Drep = -alpha * sinE + bg * cosE
    f["Drepp"] = Drepp = -alpha * cosE - bg * sinE
    f["den"] = den = 1.0 - e * cosE
    f["nhat"] = nhat = _div(TWO_PI, pbprime) / den
    f["nD"] = nD = nhat * Drep
    f["nhat2"] = nhat2 = nhat * nhat
    f["T"] = T = 0.5 * e * sinE / den
    f["brI"] = brI = (1.0 - nhat * Drep + nD * nD
                      + 0.5 * nhat2 * Dre * Drepp - T * nhat2 * Dre * Drep)
    delayI = Dre * brI
    f["r1"] = torch.sqrt(1.0 - e * e)
    f["inner"] = so * (cosE - e) + f["r1"] * co * sinE
    f["brace"] = den - p["SINI"] * f["inner"]
    delayS = -2.0 * f["m2_tsun"] * torch.log(f["brace"])
    opn = omega + nu
    f["sopn"] = torch.sin(opn)
    f["copn"] = torch.cos(opn)
    delayA = p["A0"] * (f["sopn"] + e * so) + p["B0"] * (f["copn"] + e * co)
    f["delay"] = delayI + delayS + delayA
    return f


def dd_delay(p, tt0):
    """Plain DD delay."""
    return dd_forward(p, tt0)["delay"]


def dd_partials(p, tt0, f):
    """The reverse sweep of :func:`dd_forward`: partials (..., 17) of the
    delay with respect to tt0 and the 16 parameters of :data:`DD_PARAMS`,
    all NaN where the delay is not finite."""
    e = f["e"]
    P = [None] * (len(DD_PARAMS) + 1)
    gd = torch.where(torch.isfinite(f["delay"]), 1.0, math.nan).to(e.dtype)
    A0, B0, SINI = p["A0"], p["B0"], p["SINI"]
    sinE, cosE, so, co = f["sinE"], f["cosE"], f["so"], f["co"]
    # delayA = A0 (sin(omega+nu) + e so) + B0 (cos(omega+nu) + e co)
    P[15] = gd * (f["sopn"] + e * so)
    P[16] = gd * (f["copn"] + e * co)
    g_opn = gd * (A0 * f["copn"] - B0 * f["sopn"])
    g_e = gd * (A0 * so + B0 * co)
    g_so = gd * (A0 * e)
    g_co = gd * (B0 * e)
    g_omega = g_opn
    g_nu = g_opn
    # delayS = -2 m2_tsun log(brace); brace = den - SINI inner
    P[10] = gd * (-2.0 * torch.log(f["brace"])) * TSUN
    g_brace = gd * (-2.0 * f["m2_tsun"] / f["brace"])
    g_den = g_brace
    P[11] = -g_brace * f["inner"]
    g_inner = -g_brace * SINI
    # inner = so (cosE - e) + r1 co sinE; r1 = sqrt(1 - e^2)
    g_so = g_so + g_inner * (cosE - e)
    g_c = g_inner * so
    g_e = g_e - g_inner * so
    g_r1 = g_inner * co * sinE
    g_co = g_co + g_inner * f["r1"] * sinE
    g_s = g_inner * f["r1"] * co
    g_e = g_e - g_r1 * e / f["r1"]
    # delayI = Dre brI
    Dre, Drep, Drepp = f["Dre"], f["Drep"], f["Drepp"]
    nhat, nhat2, T = f["nhat"], f["nhat2"], f["T"]
    g_Dre = gd * f["brI"]
    g_brI = gd * Dre
    g_nhat = -g_brI * Drep
    g_Drep = -g_brI * nhat
    g_nD = g_brI * 2.0 * f["nD"]
    g_nhat2 = g_brI * (0.5 * Dre * Drepp - T * Dre * Drep)
    g_Dre = g_Dre + g_brI * (0.5 * nhat2 * Drepp - T * nhat2 * Drep)
    g_Drepp = g_brI * 0.5 * nhat2 * Dre
    g_T = -g_brI * nhat2 * Dre * Drep
    g_Drep = g_Drep - g_brI * T * nhat2 * Dre
    # T = 0.5 e sinE / den; nhat2 = nhat^2; nD = nhat Drep
    den = f["den"]
    g_e = g_e + g_T * 0.5 * sinE / den
    g_s = g_s + g_T * 0.5 * e / den
    g_den = g_den - g_T * T / den
    g_nhat = g_nhat + g_nhat2 * 2.0 * nhat + g_nD * Drep
    g_Drep = g_Drep + g_nD * nhat
    # nhat = 2 pi / pbprime / den; den = 1 - e cosE
    pbprime = f["pbprime"]
    g_pbprime = -g_nhat * nhat / pbprime
    g_den = g_den - g_nhat * nhat / den
    g_e = g_e - g_den * cosE
    g_c = g_c - g_den * e
    # Drepp = -alpha cosE - bg sinE; Drep = -alpha sinE + bg cosE
    alpha, bg = f["alpha"], f["bg"]
    g_alpha = -g_Drepp * cosE
    g_c = g_c - g_Drepp * alpha
    g_bg = -g_Drepp * sinE
    g_s = g_s - g_Drepp * bg
    g_alpha = g_alpha - g_Drep * sinE
    g_s = g_s - g_Drep * alpha
    g_bg = g_bg + g_Drep * cosE
    g_c = g_c + g_Drep * bg
    # Dre = alpha (cosE - er) + beta sinE + GAMMA sinE; bg = beta + GAMMA
    g_alpha = g_alpha + g_Dre * (cosE - f["er"])
    g_c = g_c + g_Dre * alpha
    g_er = -g_Dre * alpha
    g_beta = g_Dre * sinE + g_bg
    P[12] = g_beta
    g_s = g_s + g_Dre * bg
    # beta = a1 q co; q = sqrt(1 - eth^2); alpha = a1 so
    a1, q = f["a1"], f["q"]
    g_a1 = g_beta * q * co
    g_q = g_beta * a1 * co
    g_co = g_co + g_beta * a1 * q
    g_eth = -g_q * f["eth"] / q
    g_a1 = g_a1 + g_alpha * so
    g_so = g_so + g_alpha * a1
    g_omega = g_omega + g_so * co - g_co * so
    # eth = e (1 + DTH); er = e (1 + DR)
    g_e = g_e + g_eth * (1.0 + p["DTH"]) + g_er * (1.0 + p["DR"])
    P[14] = g_eth * e
    P[13] = g_er * e
    # omega = OM DEG + k nu_cont; k = OMDOT DEG / SEC_PER_YEAR / (2 pi / pb')
    P[8] = g_omega * DEG
    g_k = g_omega * f["nu_cont"]
    g_nu = g_nu + g_omega * f["k"]
    P[9] = g_k * _div(DEG / SEC_PER_YEAR, _div(TWO_PI, pbprime))
    g_pbprime = g_pbprime + g_k * f["k"] / pbprime
    # nu = 2 atan2(yv, xv); yv = sq1p sin(E/2); xv = sq1m cos(E/2)
    xv, yv = f["xv"], f["yv"]
    rr = xv * xv + yv * yv
    g_yv = g_nu * 2.0 * xv / rr
    g_xv = -g_nu * 2.0 * yv / rr
    g_E = g_s * cosE - g_c * sinE \
        + 0.5 * (g_yv * f["sq1p"] * f["cE2"] - g_xv * f["sq1m"] * f["sE2"])
    g_e = g_e + 0.5 * (g_yv * f["sE2"] / f["sq1p"]
                       - g_xv * f["cE2"] / f["sq1m"])
    # Kepler at its root: dE = (dM + sinE de) / den
    g_M = g_E / den
    g_e = g_e + g_M * sinE
    # e = ECC + t EDOT; a1 = A1 + t A1DOT
    P[6] = g_e
    P[7] = g_e * tt0
    P[4] = g_a1
    P[5] = g_a1 * tt0
    # M = (orbits - floor) 2 pi; orbits = frac - 0.5 pbdot frac^2;
    # frac = t / pb_s; pbprime = pb_s + PBDOT t; pb_s = PB 86400
    frac, pb_s = f["frac"], f["pb_s"]
    g_orb = g_M * TWO_PI
    g_frac = g_orb * (1.0 - f["pbdot"] * frac)
    g_pbdot = -g_orb * 0.5 * frac * frac
    g_pbs = g_pbprime - g_frac * frac / pb_s
    P[1] = g_pbs * 86400.0
    P[2] = g_pbdot + g_pbprime * tt0
    P[3] = g_pbdot
    P[0] = g_frac / pb_s + g_pbprime * p["PBDOT"] + g_e * p["EDOT"] \
        + g_a1 * p["A1DOT"]
    shape = torch.broadcast_shapes(*(x.shape for x in P))
    return torch.stack([x.expand(shape) for x in P], dim=-1)
