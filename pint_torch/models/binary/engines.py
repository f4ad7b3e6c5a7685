"""Binary-orbit delay engines (port of
``pint_tpu/models/binary/engines.py:29-352,355-495``: the DD family --
BT, DD, DDS, DDH, DDGR and DDK -- and the ELL1 family with ELL1H's
orthometric Shapiro delay; ``:68-108``: the FBX and ORBWAVES orbits,
kernel K6's arithmetic, :func:`binary_orbits_forward` and
:func:`binary_orbits_partials`, whose orbits and pbprime K2 and K4 take
in place of PB/PBDOT/XPBDOT's in every mode).

Plain PyTorch functions of a parameter mapping ``p`` (PB, PBDOT, ... as in
:data:`DD_PARAMS`, :data:`ELL1_PARAMS` or :data:`ELL1H_PARAMS`) and the
time since T0 or TASC in seconds.  They are the arithmetic of kernels K2
(``pint_torch/kernels/csrc/dd_binary.cu``) and K4
(``csrc/ell1_binary.cu``), operation for operation: :func:`dd_forward` is
K2's ``dd_forward`` and :func:`dd_partials` its ``dd_reverse``;
:func:`ell1_forward` and :func:`ell1_partials` are K4's ``ell1_forward``
and ``ell1_reverse``.  So kernel and plain twin round alike.  The forward
passes are the reference's own eager arithmetic; the partials come from
hand-derived reverse sweeps (Kepler's equation differentiated at its root
in DD and BT).  :func:`bt_forward` and :func:`bt_partials` are K2's
``bt_forward`` and ``bt_reverse``; K2's DDGR and DDK modes are
:func:`dd_forward`'s, their rows and per-TOA inputs made here in torch
(:func:`ddgr_row`, :func:`ddk_corrections`; DDS's and DDH's rows by
:func:`dds_sini`, :func:`ddh_sini_m2`).  On the main path the binary
components call the kernel wrappers instead.
"""

from __future__ import annotations

import math

import torch

__all__ = ["DD_PARAMS", "DDGR_PARAMS", "DDK_TOA_INPUTS", "DD", "BT", "DDGR",
           "DDK", "BTX", "toa_inputs", "FBX", "WAVES_PB", "WAVES_FBX",
           "orbit_coefficients",
           "binary_orbits_forward", "binary_orbits_partials", "ELL1_PARAMS", "ELL1H_PARAMS", "ELL1", "ELL1K",
           "ELL1H_EXACT", "ELL1H_HARMONIC", "TSUN", "KPC_LS", "solve_kepler",
           "kepler_inputs", "dd_forward", "dd_delay", "dd_partials",
           "bt_forward", "bt_delay", "bt_partials", "row_params",
           "partial_columns", "npartial", "dds_sini",
           "ddh_sini_m2", "ddgr_arr", "ddgr_row", "ddk_corrections",
           "ecliptic_pm_to_equatorial",
           "ell1_eps", "ell1_roemer_terms", "ell1_inverse_delay",
           "ell1_forward", "ell1_delay", "ell1k_delay", "ell1h_delay",
           "ell1_partials", "ell1_params", "ell1_columns"]

#: the DD parameter row, in the reference's units (PB days, OM deg,
#: OMDOT deg/yr, M2 Msun)
DD_PARAMS = ("PB", "PBDOT", "XPBDOT", "A1", "A1DOT", "ECC", "EDOT", "OM",
             "OMDOT", "M2", "SINI", "GAMMA", "DR", "DTH", "A0", "B0")

#: DDGR's row: DD's with the GR-derived periastron advance k (in place of
#: OMDOT), the companion mass in seconds (M2S, G M2 / c^3, in place of M2)
#: and the relativistic semi-major axis ar [s] (in place of SINI: sini =
#: a1 / ar per TOA); PBDOT holds PBDOT plus the GR orbital decay
DDGR_PARAMS = DD_PARAMS[:8] + ("K", "M2S", "AR") + DD_PARAMS[11:]

#: DDK's per-TOA inputs, (B, N) each: Kopeikin's corrections to a1 [ls]
#: and omega [rad], and sin(kin)
DDK_TOA_INPUTS = ("d_a1", "d_om", "sini")

#: the DD family's forms, as K2 takes them: DD (also DDS and DDH, whose
#: rows are reparameterized), BT, DDGR, DDK and BTX (BT with a per-TOA
#: a1: the piecewise BT)
DD, BT, DDGR, DDK, BTX = range(5)

#: the ELL1/ELL1k parameter row (PB days, EPS1DOT/EPS2DOT 1/s, OMDOT
#: deg/yr, LNEDOT 1/yr, M2 Msun); ELL1 reads EPS1DOT/EPS2DOT and ELL1k
#: OMDOT/LNEDOT in their place
ELL1_PARAMS = ("PB", "PBDOT", "XPBDOT", "A1", "A1DOT", "EPS1", "EPS2",
               "EPS1DOT", "EPS2DOT", "OMDOT", "LNEDOT", "M2", "SINI")

#: the ELL1H parameter row: ELL1's with the orthometric H3 [s], H4 [s]
#: and STIGMA in place of M2/SINI
ELL1H_PARAMS = ELL1_PARAMS[:11] + ("H3", "H4", "STIGMA")

#: the ELL1 family's forms, as K4 takes them: ELL1 and ELL1k (M2/SINI
#: Shapiro delay), ELL1H with the exact orthometric form and with its
#: harmonic sum (False and True stand for ELL1 and ELL1k)
ELL1, ELL1K, ELL1H_EXACT, ELL1H_HARMONIC = range(4)

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


def kepler_inputs(p, tt0, f: dict, orb=None):
    """orbits_pb, mean_anomaly and ecc_at: ``(fl, M, e)``, the whole orbits
    since T0, the mean anomaly and the eccentricity at ``tt0``; the
    intermediates :func:`dd_partials` reads go into ``f``.  ``orb``, where
    given, is the orbit input ``(orbits, pbprime)`` (K6's FBX or ORBWAVES
    orbits) in place of PB/PBDOT/XPBDOT's."""
    if orb is not None:
        orbits, f["pbprime"] = orb
    else:
        f["pb_s"] = pb_s = p["PB"] * 86400.0
        f["pbdot"] = pbdot = p["PBDOT"] + p["XPBDOT"]
        f["frac"] = frac = tt0 / pb_s
        orbits = frac - 0.5 * pbdot * frac * frac
        f["pbprime"] = pb_s + p["PBDOT"] * tt0
    fl = torch.floor(orbits)
    M = (orbits - fl) * TWO_PI
    f["e"] = e = p["ECC"] + tt0 * p["EDOT"]
    return fl, M, e


def dd_forward(p, tt0, mode=DD, x=None, orb=None) -> dict:
    """The DD delay (SINI/M2 Shapiro, DR/DTH deformations) under ``delay``,
    with the intermediates :func:`dd_partials` reads.  ``mode`` DDGR reads
    the row of :data:`DDGR_PARAMS` (k, m2 in seconds and the semi-major
    axis ar in place of OMDOT, M2, SINI; sini = a1 / ar per TOA, as
    ``ddgr_delay`` divides); DDK adds the per-TOA ``x["d_a1"]`` to a1 and
    ``x["d_om"]`` to omega (after k nu, as ``ddk_delay`` adds it to the
    state's omega) and takes sini from ``x["sini"]``.  ``orb`` is the
    orbit input of :func:`kepler_inputs`."""
    f = {}
    fl, M, e = kepler_inputs(p, tt0, f, orb)
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
    if mode == DDGR:
        f["k"] = k = p["K"]
    else:
        f["k"] = k = _div(_div(p["OMDOT"] * DEG, SEC_PER_YEAR),
                          _div(TWO_PI, pbprime))
    f["nu_cont"] = nu_cont = nu + TWO_PI * fl + (nu < 0.0).to(nu.dtype) \
        * TWO_PI
    f["omega"] = omega = p["OM"] * DEG + k * nu_cont
    # a1_at, dd_delay_core
    f["a1"] = a1 = p["A1"] + tt0 * p["A1DOT"]
    if mode == DDK:
        f["omega"] = omega = omega + x["d_om"]
        f["a1"] = a1 = a1 + x["d_a1"]
    if mode == DDGR:
        f["m2_tsun"] = p["M2S"]
        f["sini"] = a1 / p["AR"]
    else:
        f["m2_tsun"] = p["M2"] * TSUN
        f["sini"] = x["sini"] if mode == DDK else p["SINI"]
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
    f["brace"] = den - f["sini"] * f["inner"]
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


def dd_partials(p, tt0, f, mode=DD, orbit: bool = False):
    """The reverse sweep of :func:`dd_forward`: partials (...,
    :func:`npartial`) of the delay with respect to tt0 and the row's
    entries that the mode reads (:func:`partial_columns`: DD and DDGR all
    16; DDK all but SINI, then d_a1, d_om and sini), all NaN where the
    delay is not finite.  With an ``orbit`` input the partials with
    respect to orbits and pbprime take PB's and PBDOT's places and
    XPBDOT's is not written."""
    e = f["e"]
    P = [None] * (len(DD_PARAMS) + 1 + len(DDK_TOA_INPUTS))
    gd = torch.where(torch.isfinite(f["delay"]), 1.0, math.nan).to(e.dtype)
    A0, B0 = p["A0"], p["B0"]
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
    # delayS = -2 m2_tsun log(brace); brace = den - sini inner
    P[10] = gd * (-2.0 * torch.log(f["brace"]))
    if mode != DDGR:
        P[10] = P[10] * TSUN
    g_brace = gd * (-2.0 * f["m2_tsun"] / f["brace"])
    g_den = g_brace
    g_sini = -g_brace * f["inner"]
    g_inner = -g_brace * f["sini"]
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
    # sini: SINI (DD), a1 / ar (DDGR), per TOA (DDK)
    if mode == DDGR:
        g_a1 = g_a1 + g_sini / p["AR"]
        P[11] = -g_sini * f["sini"] / p["AR"]
    elif mode == DDK:
        P[17] = g_a1
        P[18] = g_omega
        P[19] = g_sini
    else:
        P[11] = g_sini
    # eth = e (1 + DTH); er = e (1 + DR)
    g_e = g_e + g_eth * (1.0 + p["DTH"]) + g_er * (1.0 + p["DR"])
    P[14] = g_eth * e
    P[13] = g_er * e
    # omega = OM DEG + k nu_cont; k = OMDOT DEG / SEC_PER_YEAR / (2 pi / pb')
    # or, in DDGR, the row's k
    P[8] = g_omega * DEG
    g_k = g_omega * f["nu_cont"]
    g_nu = g_nu + g_omega * f["k"]
    if mode == DDGR:
        P[9] = g_k
    else:
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
    g_orb = g_M * TWO_PI
    if orbit:
        P[1] = g_orb
        P[2] = g_pbprime
        P[0] = g_e * p["EDOT"] + g_a1 * p["A1DOT"]
        return _stack([P[i] for i in partial_columns(mode, True)])
    frac, pb_s = f["frac"], f["pb_s"]
    g_frac = g_orb * (1.0 - f["pbdot"] * frac)
    g_pbdot = -g_orb * 0.5 * frac * frac
    g_pbs = g_pbprime - g_frac * frac / pb_s
    P[1] = g_pbs * 86400.0
    P[2] = g_pbdot + g_pbprime * tt0
    P[3] = g_pbdot
    P[0] = g_frac / pb_s + g_pbprime * p["PBDOT"] + g_e * p["EDOT"] \
        + g_a1 * p["A1DOT"]
    return _stack([P[i] for i in partial_columns(mode)])


def _stack(P):
    shape = torch.broadcast_shapes(*(x.shape for x in P))
    return torch.stack([x.expand(shape) for x in P], dim=-1)


# ----------------------------------------------------------------------
# BT (Blandford & Teukolsky 1976; reference engines.py:127-159)
# ----------------------------------------------------------------------
def bt_forward(p, tt0, a1_toa=None, orb=None) -> dict:
    """The BT delay (L1 + L2) R on Kepler's E, R with the constant PB
    (reference ``bt_delay`` with ``use_pb``), under ``delay``, with the
    intermediates :func:`bt_partials` reads.  ``p`` is a
    :data:`DD_PARAMS` row, of which BT reads PB, PBDOT, XPBDOT, A1,
    A1DOT, ECC, EDOT, OM, OMDOT and GAMMA.  ``a1_toa`` (BTX, the
    piecewise BT) is a per-TOA A1 in place of the row's; with an orbit
    input ``orb`` = (orbits, pbprime) R reads that pbprime (the caller
    hands it PB 86400 where the reference keeps ``use_pb``)."""
    f = {}
    _, M, e = kepler_inputs(p, tt0, f, orb)
    if orb is not None:
        f["pb_s"] = orb[1]
    E = solve_kepler(M, e)
    f["a1"] = a1 = (p["A1"] if a1_toa is None else a1_toa) \
        + tt0 * p["A1DOT"]
    # omega_bt = OM DEG + ((OMDOT DEG) / SEC_PER_YEAR) tt0
    f["omdot"] = omdot = _div(p["OMDOT"] * DEG, SEC_PER_YEAR)
    om = p["OM"] * DEG + omdot * tt0
    f["so"] = so = torch.sin(om)
    f["co"] = co = torch.cos(om)
    f["sinE"] = sinE = torch.sin(E)
    f["cosE"] = cosE = torch.cos(E)
    f["alpha"] = alpha = a1 * so
    f["sq"] = sq = torch.sqrt(1.0 - e * e)
    f["beta"] = beta = a1 * co * sq
    f["bg"] = bg = beta + p["GAMMA"]
    f["L"] = L = alpha * (cosE - e) + bg * sinE
    f["num"] = num = beta * cosE - alpha * sinE
    f["den"] = den = 1.0 - e * cosE
    f["w"] = w = den * f["pb_s"]
    f["q"] = q = TWO_PI * num / w
    f["R"] = R = 1.0 - q
    f["delay"] = L * R
    return f


def bt_delay(p, tt0):
    """Plain BT delay."""
    return bt_forward(p, tt0)["delay"]


def bt_partials(p, tt0, f, mode=BT, orbit: bool = False):
    """The reverse sweep of :func:`bt_forward`: partials (..., 11) with
    respect to tt0 and the 10 entries of :data:`DD_PARAMS` that BT reads
    (:func:`partial_columns`; BTX's per-TOA a1 last, in A1's place), all
    NaN where the delay is not finite; with an ``orbit`` input, those of
    orbits and of R's pbprime in PB's and PBDOT's places."""
    e = f["e"]
    gd = torch.where(torch.isfinite(f["delay"]), 1.0, math.nan).to(e.dtype)
    P = [None] * (len(DD_PARAMS) + 1)
    sinE, cosE, so, co = f["sinE"], f["cosE"], f["so"], f["co"]
    alpha, beta, bg, den = f["alpha"], f["beta"], f["bg"], f["den"]
    # delay = L R; R = 1 - q; q = 2 pi num / w; w = den pb_s
    g_L = gd * f["R"]
    g_q = -(gd * f["L"])
    w = f["w"]
    g_num = g_q * TWO_PI / w
    g_w = -g_q * f["q"] / w
    g_den = g_w * f["pb_s"]
    g_pbs = g_w * den
    # den = 1 - e cosE
    g_e = -g_den * cosE
    g_c = -g_den * e
    # num = beta cosE - alpha sinE
    g_beta = g_num * cosE
    g_c = g_c + g_num * beta
    g_alpha = -g_num * sinE
    g_s = -g_num * alpha
    # L = alpha (cosE - e) + bg sinE; bg = beta + GAMMA
    g_alpha = g_alpha + g_L * (cosE - e)
    g_c = g_c + g_L * alpha
    g_e = g_e - g_L * alpha
    g_bg = g_L * sinE
    g_s = g_s + g_L * bg
    g_beta = g_beta + g_bg
    P[12] = g_bg
    # beta = a1 co sq; sq = sqrt(1 - e^2); alpha = a1 so
    a1, sq = f["a1"], f["sq"]
    g_a1 = g_beta * co * sq
    g_co = g_beta * a1 * sq
    g_sq = g_beta * a1 * co
    g_e = g_e - g_sq * e / sq
    g_a1 = g_a1 + g_alpha * so
    g_so = g_alpha * a1
    # om = OM DEG + omdot t
    g_om = g_so * co - g_co * so
    P[8] = g_om * DEG
    P[9] = g_om * (DEG / SEC_PER_YEAR) * tt0
    # Kepler at its root: dE = (dM + sinE de) / den
    g_E = g_s * cosE - g_c * sinE
    g_M = g_E / den
    g_e = g_e + g_M * sinE
    P[6] = g_e
    P[7] = g_e * tt0
    P[4] = g_a1
    P[5] = g_a1 * tt0
    # M = (orbits - floor) 2 pi; orbits = frac - 0.5 pbdot frac^2;
    # frac = t / pb_s; pb_s = PB 86400 (R's constant PB too)
    g_orb = g_M * TWO_PI
    if orbit:
        P[1] = g_orb
        P[2] = g_pbs
        P[0] = g_e * p["EDOT"] + g_a1 * p["A1DOT"] + g_om * f["omdot"]
        return _stack([P[i] for i in partial_columns(mode, True)])
    frac, pb_s = f["frac"], f["pb_s"]
    g_frac = g_orb * (1.0 - f["pbdot"] * frac)
    g_pbdot = -g_orb * 0.5 * frac * frac
    g_pbs = g_pbs - g_frac * frac / pb_s
    P[1] = g_pbs * 86400.0
    P[2] = g_pbdot
    P[3] = g_pbdot
    P[0] = g_frac / pb_s + g_e * p["EDOT"] + g_a1 * p["A1DOT"] \
        + g_om * f["omdot"]
    return _stack([P[i] for i in partial_columns(mode)])


def row_params(mode):
    """The parameter row of a K2 ``mode``."""
    return DDGR_PARAMS if mode == DDGR else DD_PARAMS


#: the row entries each K2 mode reads, by their index in the row: BT
#: has no Shapiro delay, DR, DTH or aberration, DDK reads its sini per
#: TOA in place of the row's SINI, and BTX its a1 per TOA in place of A1
_ROW_READ = {DD: tuple(range(16)), DDGR: tuple(range(16)),
             BT: tuple(range(9)) + (11,),
             DDK: tuple(i for i in range(16) if i != 10),
             BTX: tuple(i for i in range(9) if i != 3) + (11,)}


def partial_columns(mode, orbit: bool = False) -> tuple:
    """The partials a K2 ``mode`` writes, by their index among tt0 (0),
    the 16 row entries (1-16) and DDK's per-TOA d_a1, d_om and sini
    (17-19): tt0, the row entries the mode reads and, in DDK, the per-TOA
    inputs; BTX's per-TOA a1 is A1's sweep index (4), last.  An entry the
    mode does not read has no column.  With an ``orbit`` input, indices 1
    and 2 are the partials with respect to orbits and pbprime and PB,
    PBDOT and XPBDOT (row entries 0-2) are not read."""
    extra = tuple(range(17, 17 + len(DDK_TOA_INPUTS))) if mode == DDK \
        else (4,) if mode == BTX else ()
    rows = tuple(1 + i for i in _ROW_READ[mode] if not orbit or i > 2)
    return (0,) + ((1, 2) if orbit else ()) + rows + extra


def npartial(mode, orbit: bool = False) -> int:
    """Partials per element of a K2 ``mode``: 17 in DD and DDGR, 11 in BT
    and BTX, 19 in DDK (:func:`partial_columns`); one fewer with an
    orbit input."""
    return len(partial_columns(mode, orbit))


def toa_inputs(mode) -> tuple:
    """The per-TOA inputs of a K2 ``mode``: DDK's d_a1, d_om and sini,
    BTX's a1."""
    return DDK_TOA_INPUTS if mode == DDK else ("a1",) if mode == BTX \
        else ()


# ----------------------------------------------------------------------
# DDS, DDH, DDGR, DDK: per-row (and for DDK per-TOA) inputs of K2
# (reference engines.py:227-352)
# ----------------------------------------------------------------------
def _tensor(v, like):
    """``v`` as a float64 tensor on ``like``'s device (a (B, 1) tensor
    stays as it is).  A number is filled on the device, not copied from
    the host: an evaluation may be captured in a CUDA graph (the fused
    grid sweep)."""
    return v if torch.is_tensor(v) else torch.full(
        (1, 1), float(v), dtype=like.dtype, device=like.device)


def dds_sini(pv, like):
    """DDS: sini = 1 - exp(-SHAPMAX) (reference ``dds_delay``), (B, 1) or
    (1, 1) on ``like``'s device."""
    return 1.0 - torch.exp(-_tensor(pv.get("SHAPMAX", 0.0), like))


def ddh_sini_m2(pv, like):
    """DDH: (sini, M2 [Msun]) from the orthometric H3 [s] and STIGMA
    (Freire & Wex 2010 eq 20, 22; reference ``ddh_delay``): sini =
    2 stig / (1 + stig^2), m2 = H3 / max(stig, 1e-30)^3 in seconds, handed
    to K2's DD row as m2 / TSUN (K2 multiplies by TSUN again: at most an
    ulp of the Shapiro amplitude from the reference's m2)."""
    h3 = _tensor(pv.get("H3", 0.0), like)
    stig = _tensor(pv.get("STIGMA", 0.0), like)
    sini = 2.0 * stig / (1.0 + stig * stig)
    m2_tsun = h3 / _ipow(torch.clamp(stig, min=1e-30), 3)
    return sini, _div(m2_tsun, TSUN)


def ddgr_arr(mtot, m1, m2, n, niter: int = 20):
    """The relativistic semi-major axis (Taylor & Weisberg 1989; reference
    ``_ddgr_arr``), fixed-point iterated, masses in seconds: (arr0, arr)."""
    arr0 = torch.pow(mtot / (n * n), 1.0 / 3.0)
    arr = arr0
    for _ in range(niter):
        arr = arr0 * torch.pow(
            1.0 + (m1 * m2 / (mtot * mtot) - 9.0) * (mtot / (2.0 * arr)),
            2.0 / 3.0)
    return arr0, arr


def ddgr_row(pv, like) -> dict:
    """DDGR's K2 row (:data:`DDGR_PARAMS`) from MTOT and M2 (Taylor &
    Weisberg 1989 eq 15-25; reference ``ddgr_delay``): PBDOT plus the GR
    orbital decay, k with XOMDOT, m2 in seconds, ar, gamma, dr and dth,
    each (B, 1) or (1, 1), in the reference's order of operations."""
    def g(name):
        return _tensor(pv.get(name, 0.0), like)

    mtot = g("MTOT") * TSUN
    m2 = g("M2") * TSUN
    m1 = mtot - m2
    pb_s = g("PB") * 86400.0
    n = _div(TWO_PI, pb_s)
    e0 = g("ECC")
    e2 = e0 * e0
    arr0, arr = ddgr_arr(mtot, m1, m2, n)
    fe = (1.0 + (73.0 / 24.0) * e2 + (37.0 / 96.0) * (e2 * e2)) \
        * torch.pow(1.0 - e2, -3.5)
    pbdot_gr = (-192.0 * math.pi / 5.0) * torch.pow(n, 5.0 / 3.0) \
        * m1 * m2 * torch.pow(mtot, -1.0 / 3.0) * fe
    k = 3.0 * mtot / (arr0 * (1.0 - e2)) \
        + _div(g("XOMDOT") * DEG, SEC_PER_YEAR) / n
    row = {name: g(name) for name in DD_PARAMS}
    row.update(
        PBDOT=g("PBDOT") + pbdot_gr, K=k, M2S=m2, AR=arr * (m2 / mtot),
        GAMMA=e0 * m2 * (m1 + 2.0 * m2) / (n * arr0 * mtot),
        DR=(m1 * (3.0 * m1 + 6.0 * m2) + 2.0 * (m2 * m2)) / (mtot * arr),
        DTH=(3.5 * (m1 * m1) + 6.0 * m1 * m2 + 2.0 * (m2 * m2))
        / (mtot * arr))
    return row


#: mas/yr -> rad/s
_MAS_YR = DEG / 3600.0e3 / SEC_PER_YEAR
#: 1 kpc in light-seconds
KPC_LS = 3.0856775814913673e19 / 299792458.0


def ddk_corrections(pv, tt0, psr_pos, obs_pos_ls, k96: float):
    """Kopeikin's annual-parallax and secular proper-motion corrections
    (Kopeikin 1995 eq 15-19, 1996 eq 8-10; reference ``ddk_corrections``),
    elementwise: ``(d_a1, d_om [rad], kin [rad])`` at ``tt0`` (B, N) from
    the unit vector to the pulsar ``psr_pos`` (..., N, 3) and the
    observatory's position ``obs_pos_ls`` (N, 3) [ls], both equatorial;
    PMRA/PMDEC [mas/yr] are the proper motion in that frame."""
    def g(name, default=0.0):
        return pv.get(name, default)

    kom = g("KOM") * DEG
    kin0 = g("KIN") * DEG
    sin_kom, cos_kom = torch.sin(_tensor(kom, tt0)), torch.cos(
        _tensor(kom, tt0))
    sin_lat = psr_pos[..., 2]
    cos_lat = torch.sqrt(torch.clamp(1.0 - sin_lat * sin_lat, min=1e-30))
    sin_long = psr_pos[..., 1] / cos_lat
    cos_long = psr_pos[..., 0] / cos_lat
    ox, oy, oz = obs_pos_ls[..., 0], obs_pos_ls[..., 1], obs_pos_ls[..., 2]
    delta_I0 = -ox * sin_long + oy * cos_long
    delta_J0 = -ox * sin_lat * cos_long - oy * sin_lat * sin_long \
        + oz * cos_lat
    pm_long = g("PMRA") * _MAS_YR
    pm_lat = g("PMDEC") * _MAS_YR
    d_kin_pm = (-pm_long * sin_kom + pm_lat * cos_kom) * tt0 * k96
    kin = kin0 + d_kin_pm
    tan_kin = torch.tan(kin)
    sin_kin = torch.sin(kin)
    a1_0 = g("A1") + tt0 * g("A1DOT")
    d_a1_pm = a1_0 * d_kin_pm / tan_kin
    d_om_pm = (pm_long * cos_kom + pm_lat * sin_kom) / sin_kin * tt0 * k96
    px = g("PX", 1e-30)
    d_ls = _div(KPC_LS, torch.clamp(px, min=1e-30) if torch.is_tensor(px)
                else _tensor(max(px, 1e-30), tt0))
    kom_proj = delta_I0 * sin_kom - delta_J0 * cos_kom
    d_a1_px = (a1_0 + d_a1_pm * k96) / tan_kin / d_ls * kom_proj
    d_om_px = -(delta_I0 * cos_kom + delta_J0 * sin_kom) / sin_kin / d_ls
    return d_a1_pm * k96 + d_a1_px, d_om_pm * k96 + d_om_px, kin


def ecliptic_pm_to_equatorial(elong, elat, pm_elong, pm_elat, obliquity,
                              like):
    """Proper motion (PMELONG, PMELAT) at ecliptic (ELONG, ELAT) [rad]
    rotated to equatorial (alpha*, delta) components, both in the
    cos(lat)-scaled longitude convention (reference
    ``components.py:46 _ecliptic_pm_to_equatorial``).  Each argument a
    float or a (B, 1) tensor (floats become tensors on ``like``'s
    device); 3-vectors are tuples, their dot products summed in index
    order."""
    ce, se = math.cos(obliquity), math.sin(obliquity)
    elong, elat = _tensor(elong, like), _tensor(elat, like)
    cb, sb = torch.cos(elat), torch.sin(elat)
    cl, sl = torch.cos(elong), torch.sin(elong)

    def to_eq(v):
        return (v[0], ce * v[1] - se * v[2], se * v[1] + ce * v[2])

    n = to_eq((cb * cl, cb * sl, sb))
    e_lon = to_eq((-sl, cl, 0.0))
    e_lat = to_eq((-sb * cl, -sb * sl, cb))
    pm = tuple(pm_elong * a + pm_elat * b for a, b in zip(e_lon, e_lat))
    ra = torch.atan2(n[1], n[0])
    dec = torch.asin(torch.clamp(n[2], -1.0, 1.0))
    e_ra = (-torch.sin(ra), torch.cos(ra), 0.0)
    e_dec = (-torch.sin(dec) * torch.cos(ra), -torch.sin(dec) * torch.sin(ra),
             torch.cos(dec))

    def dot(a, b):
        return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]

    return dot(pm, e_ra), dot(pm, e_dec)


# ----------------------------------------------------------------------
# ELL1 family (Lange et al. 2001; reference engines.py:355-453)
# ----------------------------------------------------------------------
def ell1_eps(p, ttasc, ell1k: bool = False, f: dict = None):
    """(eps1, eps2) at each epoch: linear EPS1DOT/EPS2DOT evolution, or
    ELL1k's exponential/rotating form (OMDOT, LNEDOT).  The intermediates
    :func:`ell1_partials` reads go into ``f``."""
    f = {} if f is None else f
    if ell1k:
        f["omdot"] = omdot = _div(p["OMDOT"] * DEG, SEC_PER_YEAR)
        f["lnedot"] = lnedot = _div(p["LNEDOT"], SEC_PER_YEAR)
        f["scale"] = scale = 1.0 + lnedot * ttasc
        th = omdot * ttasc
        f["cw"] = c = torch.cos(th)
        f["sw"] = s = torch.sin(th)
        eps1 = scale * (p["EPS1"] * c + p["EPS2"] * s)
        eps2 = scale * (p["EPS2"] * c - p["EPS1"] * s)
        return eps1, eps2
    return (p["EPS1"] + ttasc * p["EPS1DOT"],
            p["EPS2"] + ttasc * p["EPS2DOT"])


def _harmonics(phi):
    """sin and cos of phi, 2 phi, 3 phi and 4 phi, each taken of its own
    rounded argument as the reference takes them."""
    return [(torch.sin(k * phi), torch.cos(k * phi)) if k > 1
            else (torch.sin(phi), torch.cos(phi)) for k in (1, 2, 3, 4)]


def ell1_roemer_terms(phi, eps1, eps2, first_order_dre: bool = False,
                      sc=None):
    """(Dre, Drep, Drepp)/a1: the third-order-in-e ELL1 Roemer delay and
    its Phi-derivatives (reference ``engines.py:372``), in the reference's
    order of operations; ``first_order_dre`` takes ELL1k's first-order Dre
    with its -3/2 eps1 term.  ``sc`` is :func:`_harmonics` of ``phi``."""
    (s1, c1), (s2, c2), (s3, c3), (s4, c4) = _harmonics(phi) if sc is None \
        else sc
    e1, e2 = eps1, eps2
    e1sq, e2sq = e1 * e1, e2 * e2
    e1cu, e2cu = e1 * e1sq, e2 * e2sq
    if first_order_dre:
        dre = s1 + 0.5 * (e2 * s2 - e1 * (c2 + 3.0))
    else:
        dre = (s1 + 0.5 * (e2 * s2 - e1 * c2)
               - (1.0 / 8.0) * (5 * e2sq * s1 - 3 * e2sq * s3
                                - 2 * e2 * e1 * c1 + 6 * e2 * e1 * c3
                                + 3 * e1sq * s1 + 3 * e1sq * s3)
               - (1.0 / 12.0) * (5 * e2cu * s2 + 3 * e1sq * e2 * s2
                                 - 6 * e1 * e2sq * c2 - 4 * e1cu * c2
                                 - 4 * e2cu * s4 + 12 * e1sq * e2 * s4
                                 + 12 * e1 * e2sq * c4 - 4 * e1cu * c4))
    drep = (c1 + e1 * s2 + e2 * c2
            - (1.0 / 8.0) * (5 * e2sq * c1 - 9 * e2sq * c3
                             + 2 * e1 * e2 * s1 - 18 * e1 * e2 * s3
                             + 3 * e1sq * c1 + 9 * e1sq * c3)
            - (1.0 / 12.0) * (10 * e2cu * c2 + 6 * e1sq * e2 * c2
                              + 12 * e1 * e2sq * s2 + 8 * e1cu * s2
                              - 16 * e2cu * c4 + 48 * e1sq * e2 * c4
                              - 48 * e1 * e2sq * s4 + 16 * e1cu * s4))
    drepp = (-s1 + 2 * e1 * c2 - 2 * e2 * s2
             - (1.0 / 8.0) * (-5 * e2sq * s1 + 27 * e2sq * s3
                              + 2 * e1 * e2 * c1 - 54 * e1 * e2 * c3
                              - 3 * e1sq * s1 - 27 * e1sq * s3)
             - (1.0 / 12.0) * (-20 * e2cu * s2 - 12 * e1sq * e2 * s2
                               + 24 * e1 * e2sq * c2 + 16 * e1cu * c2
                               + 64 * e2cu * s4 - 192 * e1sq * e2 * s4
                               - 192 * e1 * e2sq * c4 + 64 * e1cu * c4))
    return dre, drep, drepp


def ell1_forward(p, ttasc, mode=ELL1, nharms: int = 7,
                 use_h4: bool = False, orb=None) -> dict:
    """The delay of the ELL1 family's ``mode`` under ``delay``: the
    inverse-timing Roemer part (ELL1k's eccentricity and first-order Dre
    for ``ELL1K``) and the M2/SINI Shapiro delay, or ELL1H's orthometric
    one -- exact, or harmonics 3..``nharms`` of stigma = STIGMA or H4/H3
    (``use_h4``) -- (reference ``ell1_inverse_delay``, ``ell1_delay`` and
    ``ell1h_delay``, ``engines.py:416-495``), with the intermediates
    :func:`ell1_partials` reads.  ``orb``, where given, is the orbit
    input ``(orbits, pbprime)`` (K6's FBX or ORBWAVES orbits) in place of
    PB/PBDOT/XPBDOT's."""
    ell1k = mode == ELL1K
    f = {}
    if orb is not None:
        orbits, pbprime = orb
        f["pbprime"] = pbprime
    else:
        f["pb_s"] = pb_s = p["PB"] * 86400.0
        f["pbdot"] = pbdot = p["PBDOT"] + p["XPBDOT"]
        f["frac"] = frac = _div(ttasc, pb_s)
        orbits = frac - 0.5 * pbdot * frac * frac
        f["pbprime"] = pbprime = pb_s + p["PBDOT"] * ttasc
    f["phi"] = phi = (orbits - torch.floor(orbits)) * TWO_PI
    f["eps1"], f["eps2"] = eps1, eps2 = ell1_eps(p, ttasc, ell1k, f)
    f["a1"] = a1 = p["A1"] + ttasc * p["A1DOT"]
    f["sc"] = sc = _harmonics(phi)
    f["dre"], f["drep"], f["drepp"] = dre, drep, drepp = ell1_roemer_terms(
        phi, eps1, eps2, first_order_dre=ell1k, sc=sc)
    f["Dre"] = Dre = a1 * dre
    f["Drep"] = Drep = a1 * drep
    f["Drepp"] = Drepp = a1 * drepp
    f["nhat"] = nhat = _div(TWO_PI, pbprime)
    f["nD"] = nD = nhat * Drep
    f["nhat2"] = nhat2 = nhat * nhat
    f["brI"] = brI = 1.0 - nD + nD * nD + 0.5 * nhat2 * Dre * Drepp
    delayI = Dre * brI
    if mode == ELL1H_EXACT:
        delayS = _ell1h_exact(p, sc, f)
    elif mode == ELL1H_HARMONIC:
        delayS = _ell1h_harmonic(p, phi, sc, f, nharms, use_h4)
    else:
        f["m2"] = m2 = p["M2"] * TSUN
        f["brace"] = brace = 1.0 - p["SINI"] * sc[0][0]
        delayS = -2.0 * m2 * torch.log(brace)
    f["delay"] = delayI + delayS
    return f


def _ipow(x, y: int):
    """``x ** y`` for an integer ``y`` >= 0 by the reference's products
    (``lax.integer_pow``: binary powering, x^3 = x x^2, x^4 = (x^2)^2)."""
    if y == 0:
        return torch.ones_like(x)
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def _harmonic_coefficient(k: int) -> float:
    """(-1)^pwr 2 / k of harmonic ``k`` (reference
    ``_h3_fourier_harms``), folded in doubles as the reference folds it."""
    pwr = (k + 1) // 2 if k % 2 == 1 else (k + 2) // 2
    return ((-1.0) ** pwr) * 2.0 / k


def _ell1h_exact(p, sc, f):
    """The exact orthometric Shapiro delay (Freire & Wex 2010 eq 28;
    reference ``ell1h_delay`` with ``exact``)."""
    s1, c2 = sc[0][0], sc[1][1]
    f["h3"] = h3 = p["H3"]
    f["sig"] = sig = p["STIGMA"]
    f["sig2"] = sig2 = sig * sig
    f["sig3"] = sig3 = sig2 * sig
    f["lognum"] = lognum = 1.0 + sig2 - 2.0 * sig * s1
    f["Q"] = Q = torch.log(lognum) + 2.0 * sig * s1 - sig2 * c2
    f["A"] = A = _div(-2.0 * h3, sig3)
    return A * Q


def _ell1h_harmonic(p, phi, sc, f, nharms: int, use_h4: bool):
    """-2 H3 times the Shapiro harmonics 3..``nharms`` with stigma^3
    factored out (Freire & Wex 2010 eq 10, 13; reference
    ``_h3_fourier_harms``); stigma is STIGMA or, with ``use_h4``, H4/H3
    (0 where H3 is 0)."""
    f["h3"] = h3 = p["H3"]
    if use_h4:
        sig = torch.where(h3 == 0.0, 0.0,
                          p["H4"] / torch.where(h3 == 0.0, 1.0, h3))
    else:
        sig = p["STIGMA"]
    f["sig"] = sig
    total = 0.0
    for k in range(3, int(nharms) + 1):
        basis = _harmonic_basis(phi, sc, k)[0]
        total = total + _harmonic_coefficient(k) * _ipow(sig, k - 3) * basis
    f["T"] = total
    return -2.0 * h3 * total


def _harmonic_basis(phi, sc, k: int):
    """(trig(k phi), its phase derivative / k) of harmonic ``k``: (sin,
    cos) for odd k, (cos, -sin) for even; sin 3 phi and cos 4 phi are the
    Roemer terms' own."""
    if k == 3:
        return sc[2][0], sc[2][1]
    if k == 4:
        return sc[3][1], -sc[3][0]
    if k % 2 == 1:
        return torch.sin(k * phi), torch.cos(k * phi)
    return torch.cos(k * phi), -torch.sin(k * phi)


def ell1_inverse_delay(p, ttasc, ell1k: bool = False):
    """``(delayI, phi, pbprime)`` (reference ``engines.py:416``)."""
    f = ell1_forward(p, ttasc, int(ell1k))
    return f["Dre"] * f["brI"], f["phi"], f["pbprime"]


def ell1_delay(p, ttasc, ell1k: bool = False):
    """Plain ELL1 delay (reference ``engines.py:439``)."""
    return ell1_forward(p, ttasc, int(ell1k))["delay"]


def ell1k_delay(p, ttasc):
    """Plain ELL1k delay (reference ``engines.py:448``)."""
    return ell1_forward(p, ttasc, ELL1K)["delay"]


def ell1h_delay(p, ttasc, nharms: int = 7, exact: bool = False,
                use_h4: bool = False):
    """Plain ELL1H delay (reference ``engines.py:474``)."""
    return ell1_forward(p, ttasc, ELL1H_EXACT if exact else ELL1H_HARMONIC,
                        nharms, use_h4)["delay"]


def ell1_params(mode):
    """The parameter row of ``mode``."""
    return ELL1H_PARAMS if mode >= ELL1H_EXACT else ELL1_PARAMS


def ell1_columns(mode, orbit: bool = False) -> tuple:
    """The partials K4 writes, by their index among ttasc (0) and the
    mode's row (1-n): all of them, or with an ``orbit`` input 0, the
    partials with respect to orbits (1) and pbprime (2), and the row past
    XPBDOT (4-n)."""
    n = len(ell1_params(mode)) + 1
    return tuple(range(n)) if not orbit else (0, 1, 2) + tuple(range(4, n))


def _ell1_coefficients(e1, e2):
    """The third-order Dre/a1 as sum_k S_k sin(k phi) + C_k cos(k phi):
    ``[(S_k, C_k, dS_k/de1, dC_k/de1, dS_k/de2, dC_k/de2)]`` for k = 1..4.
    Drep and Drepp are its Phi-derivatives (k S_k cos - k C_k sin, and
    -k^2 times Dre's terms), which :func:`ell1_partials` uses."""
    e1sq, e2sq, e1e2 = e1 * e1, e2 * e2, e1 * e2
    return [
        (1.0 - 0.125 * (5.0 * e2sq + 3.0 * e1sq), 0.25 * e1e2,
         -0.75 * e1, 0.25 * e2, -1.25 * e2, 0.25 * e1),
        (0.5 * e2 - _div((5.0 * e2sq + 3.0 * e1sq) * e2, 12.0),
         -0.5 * e1 + _div((6.0 * e2sq + 4.0 * e1sq) * e1, 12.0),
         -0.5 * e1e2, -0.5 + 0.5 * e2sq + e1sq,
         0.5 - _div(15.0 * e2sq + 3.0 * e1sq, 12.0), e1e2),
        (0.375 * (e2sq - e1sq), -0.75 * e1e2,
         -0.75 * e1, -0.75 * e2, 0.75 * e2, -0.75 * e1),
        ((_div(e2sq, 3.0) - e1sq) * e2, (_div(e1sq, 3.0) - e2sq) * e1,
         -2.0 * e1e2, e1sq - e2sq, e2sq - e1sq, -2.0 * e1e2),
    ]


def ell1_partials(p, ttasc, f, mode=ELL1, nharms: int = 7,
                  use_h4: bool = False, orbit: bool = False):
    """The reverse sweep of :func:`ell1_forward`: partials (..., 1 + n) of
    the delay with respect to ttasc and the n parameters of the mode's
    row (:data:`ELL1_PARAMS`, :data:`ELL1H_PARAMS`), all NaN where the
    delay is not finite.  The parameters the form does not read (ELL1 and
    ELL1H: OMDOT, LNEDOT; ELL1k: EPS1DOT, EPS2DOT; ELL1H: H4 or STIGMA)
    get zeros.  With an ``orbit`` input (:func:`ell1_columns`) the partials
    with respect to orbits and pbprime take PB's and PBDOT's places and
    XPBDOT's is not written."""
    ell1k = mode == ELL1K
    P = [None] * (len(ell1_params(mode)) + 1)
    gd = torch.where(torch.isfinite(f["delay"]), 1.0, math.nan).to(
        f["delay"].dtype)
    sc = f["sc"]
    s1, c1 = sc[0]
    if mode == ELL1H_EXACT:
        g_phi = _ell1h_exact_reverse(p, f, gd, P)
    elif mode == ELL1H_HARMONIC:
        g_phi = _ell1h_harmonic_reverse(p, f, gd, P, nharms, use_h4)
    else:
        # delayS = -2 m2 log(brace); brace = 1 - SINI sin(phi)
        P[12] = gd * (-2.0 * torch.log(f["brace"])) * TSUN
        g_brace = gd * (-2.0 * f["m2"] / f["brace"])
        P[13] = -g_brace * s1
        g_phi = -g_brace * p["SINI"] * c1
    # delayI = Dre brI; brI = 1 - nD + nD^2 + 0.5 nhat2 Dre Drepp
    Dre, Drep, Drepp = f["Dre"], f["Drep"], f["Drepp"]
    nhat, nhat2, nD = f["nhat"], f["nhat2"], f["nD"]
    g_brI = gd * Dre
    g_Dre = gd * f["brI"] + g_brI * 0.5 * nhat2 * Drepp
    g_Drepp = g_brI * 0.5 * nhat2 * Dre
    g_nD = g_brI * (2.0 * nD - 1.0)
    g_nhat = g_nD * Drep + g_brI * 0.5 * Dre * Drepp * 2.0 * nhat
    g_Drep = g_nD * nhat
    # nhat = 2 pi / pbprime; D* = a1 d*
    g_pbprime = -g_nhat * nhat / f["pbprime"]
    a1 = f["a1"]
    g_a1 = g_Dre * f["dre"] + g_Drep * f["drep"] + g_Drepp * f["drepp"]
    g_re, g_rep, g_repp = g_Dre * a1, g_Drep * a1, g_Drepp * a1
    # the Roemer terms: G = g_re dre + g_rep drep + g_repp drepp as a sum
    # of harmonics, differentiated in phi, eps1 and eps2
    e1, e2 = f["eps1"], f["eps2"]
    g_e1 = g_e2 = 0.0
    for k, (coef, (sk, ck)) in enumerate(zip(_ell1_coefficients(e1, e2), sc),
                                         start=1):
        S, C, dS1, dC1, dS2, dC2 = coef
        al = (-(k * k) * g_repp) if ell1k else g_re - (k * k) * g_repp
        be = k * g_rep
        a = al * S - be * C
        b = al * C + be * S
        g_phi = g_phi + k * (a * ck - b * sk)
        g_e1 = g_e1 + sk * (al * dS1 - be * dC1) + ck * (al * dC1 + be * dS1)
        g_e2 = g_e2 + sk * (al * dS2 - be * dC2) + ck * (al * dC2 + be * dS2)
    if ell1k:
        # first-order Dre = s1 + 0.5 (e2 s2 - e1 (c2 + 3))
        s2, c2 = sc[1]
        g_phi = g_phi + g_re * (c1 + e2 * c2 + e1 * s2)
        g_e1 = g_e1 + g_re * (-0.5 * c2 - 1.5)
        g_e2 = g_e2 + g_re * (0.5 * s2)
    # eps1, eps2; a1 = A1 + t A1DOT
    zero = gd * 0.0
    g_t = g_a1 * p["A1DOT"]
    if ell1k:
        cw, sw, scale = f["cw"], f["sw"], f["scale"]
        E1, E2 = p["EPS1"], p["EPS2"]
        g_scale = g_e1 * (E1 * cw + E2 * sw) + g_e2 * (E2 * cw - E1 * sw)
        P[6] = scale * (g_e1 * cw - g_e2 * sw)
        P[7] = scale * (g_e1 * sw + g_e2 * cw)
        g_c = scale * (g_e1 * E1 + g_e2 * E2)
        g_s = scale * (g_e1 * E2 - g_e2 * E1)
        g_th = g_s * cw - g_c * sw
        P[8] = P[9] = zero
        P[10] = g_th * ttasc * (DEG / SEC_PER_YEAR)
        P[11] = _div(g_scale * ttasc, SEC_PER_YEAR)
        g_t = g_t + g_th * f["omdot"] + g_scale * f["lnedot"]
    else:
        P[6] = g_e1
        P[7] = g_e2
        P[8] = g_e1 * ttasc
        P[9] = g_e2 * ttasc
        P[10] = P[11] = zero
        g_t = g_t + g_e1 * p["EPS1DOT"] + g_e2 * p["EPS2DOT"]
    P[4] = g_a1
    P[5] = g_a1 * ttasc
    # phi = (orbits - floor) 2 pi; orbits = frac - 0.5 pbdot frac^2;
    # frac = t / pb_s; pbprime = pb_s + PBDOT t; pb_s = PB 86400
    g_orb = g_phi * TWO_PI
    if orbit:
        P[1] = g_orb
        P[2] = g_pbprime
        P[0] = g_t
    else:
        frac, pb_s = f["frac"], f["pb_s"]
        g_frac = g_orb * (1.0 - f["pbdot"] * frac)
        g_pbdot = -g_orb * 0.5 * frac * frac
        g_pbs = g_pbprime - g_frac * frac / pb_s
        P[1] = g_pbs * 86400.0
        P[2] = g_pbdot + g_pbprime * ttasc
        P[3] = g_pbdot
        P[0] = g_frac / pb_s + g_pbprime * p["PBDOT"] + g_t
    return _stack([P[i] for i in ell1_columns(mode, orbit)])


def _ell1h_exact_reverse(p, f, gd, P):
    """Partials of the exact form A Q, A = -2 H3 / stigma^3, Q = log(L) +
    2 stigma sin(phi) - stigma^2 cos(2 phi), L = 1 + stigma^2 - 2 stigma
    sin(phi), into P[12] (H3), P[13] (H4: 0) and P[14] (STIGMA); returns
    the adjoint of phi."""
    sc = f["sc"]
    s1, c1 = sc[0]
    s2, c2 = sc[1]
    sig, sig3, L, Q, A = f["sig"], f["sig3"], f["lognum"], f["Q"], f["A"]
    P[12] = gd * Q * _div(-2.0, sig3)
    P[13] = gd * 0.0
    g_Q = gd * A
    dQ_dsig = (2.0 * sig - 2.0 * s1) / L + 2.0 * s1 - 2.0 * sig * c2
    P[14] = gd * Q * (-3.0 * A / sig) + g_Q * dQ_dsig
    return g_Q * (-2.0 * sig * c1 / L + 2.0 * sig * c1
                  + 2.0 * f["sig2"] * s2)


def _ell1h_harmonic_reverse(p, f, gd, P, nharms: int, use_h4: bool):
    """Partials of -2 H3 T, T = sum_k c_k stigma^(k-3) trig(k phi), into
    P[12] (H3), P[13] (H4) and P[14] (STIGMA), stigma = STIGMA or H4/H3
    (``use_h4``; partials 0 in H4 and from stigma where H3 is 0); returns
    the adjoint of phi."""
    phi, sc, sig, h3 = f["phi"], f["sc"], f["sig"], f["h3"]
    g_T = gd * (-2.0 * h3)
    g_phi = 0.0
    dT_dsig = 0.0
    for k in range(3, int(nharms) + 1):
        ck = _harmonic_coefficient(k)
        basis, dbasis = _harmonic_basis(phi, sc, k)
        g_phi = g_phi + (ck * k) * _ipow(sig, k - 3) * dbasis
        if k > 3:
            dT_dsig = dT_dsig + (ck * (k - 3)) * _ipow(sig, k - 4) * basis
    g_sig = g_T * dT_dsig
    P[12] = gd * f["T"] * -2.0
    zero = gd * 0.0
    if use_h4:
        nz = h3 != 0.0
        h3s = torch.where(nz, h3, 1.0)
        P[12] = P[12] + torch.where(nz, -g_sig * sig / h3s, zero)
        P[13] = torch.where(nz, g_sig / h3s, zero)
        P[14] = zero
    else:
        P[13] = zero
        P[14] = g_sig + zero
    return g_T * g_phi


# ----------------------------------------------------------------------
# FBX and ORBWAVES orbits (reference engines.py:68-108): kernel K6's
# arithmetic, operation for operation (csrc/binary_orbits.cu)
# ----------------------------------------------------------------------
#: K6's forms: the FB0..FBn Taylor series (reference ``orbits_fbx``),
#: ORBWAVES on a PB base (which ignores PBDOT/XPBDOT) and ORBWAVES on an
#: FBX base (reference ``orbits_waves``)
FBX, WAVES_PB, WAVES_FBX = range(3)


def orbit_coefficients(form, nfb: int, nwaves: int) -> tuple:
    """The names of K6's coefficient row in ``form``: FB0..FB(nfb-1), or
    PB for the ORBWAVES PB base; then, with waves, ORBWAVEC_k and
    ORBWAVES_k interleaved and ORBWAVE_OM last."""
    base = ("PB",) if form == WAVES_PB else tuple(
        f"FB{i}" for i in range(nfb))
    if form == FBX:
        return base
    waves = tuple(n for k in range(nwaves)
                  for n in (f"ORBWAVEC{k}", f"ORBWAVES{k}"))
    return base + waves + ("ORBWAVE_OM",)


def _horner_fbx(fb, tt0):
    """orbits = sum FBn t^(n+1)/(n+1)! and freq = sum FBn t^n/n! by the
    reference's Horner ladder, multiplying by the rounded reciprocals
    1/(n+2) and 1/(n+1)."""
    orbits = torch.zeros_like(tt0)
    freq = torch.zeros_like(tt0)
    for n in range(len(fb) - 1, -1, -1):
        f = fb[n]
        orbits = (orbits * tt0) * (1.0 / (n + 2)) + f
        freq = (freq * tt0) * (1.0 / (n + 1)) + f
    return orbits * tt0, freq


def _waves(c_s, om, tw):
    """The wave sum dphi and its rate, term by term in the reference's
    order."""
    dphi = torch.zeros_like(tw)
    dphi_dot = torch.zeros_like(tw)
    for k, (c, s) in enumerate(c_s):
        w = (k + 1) * om
        ph = w * tw
        cp, sp = torch.cos(ph), torch.sin(ph)
        dphi = dphi + c * cp + s * sp
        dphi_dot = dphi_dot + w * (s * cp - c * sp)
    return dphi, dphi_dot


def binary_orbits_forward(tt0, coef, form, nfb: int, nwaves: int,
                          tw_off: float = 0.0) -> dict:
    """K6's forward pass: ``orbits`` and ``pbprime`` (B, N) from ``tt0``
    and the coefficient row ``coef`` (B, :func:`orbit_coefficients`), with
    ``tw = tt0 + tw_off`` for the waves; the intermediates
    :func:`binary_orbits_partials` reads."""
    cols = [coef[:, i:i + 1] for i in range(coef.shape[1])]
    f = {}
    if form == WAVES_PB:
        f["pb_s"] = pb_s = cols[0] * 86400.0
        orbits = _div(tt0, pb_s)
        inv = _div(1.0, pb_s)
        first = 1
    else:
        orbits, f["freq"] = _horner_fbx(cols[:nfb], tt0)
        pbp0 = _div(1.0, f["freq"])
        if form == FBX:
            f["orbits"], f["pbprime"] = orbits, pbp0
            return f
        inv = _div(1.0, pbp0)
        first = nfb
    tw = tt0 + tw_off
    c_s = [(cols[first + 2 * k], cols[first + 2 * k + 1])
           for k in range(nwaves)]
    dphi, dphi_dot = _waves(c_s, cols[-1], tw)
    f["orbits"] = orbits + dphi
    f["pbprime"] = _div(1.0, inv + dphi_dot)
    return f


def binary_orbits_partials(tt0, coef, form, nfb: int, nwaves: int,
                           tw_off: float, f: dict):
    """K6's partials (B, N, 2, 1 + ncoef): of orbits ([..., 0, :]) and of
    pbprime ([..., 1, :]) with respect to tt0 (column 0) and the
    coefficients, in closed form (pbprime = 1 / g, dpbprime = -pbprime^2
    dg, g the orbital frequency)."""
    B = max(tt0.shape[0], coef.shape[0])
    cols = [coef[:, i:i + 1] for i in range(coef.shape[1])]
    nc = len(cols)
    zero = torch.zeros_like(f["orbits"])
    Po = [zero] * (1 + nc)
    Pg = [zero] * (1 + nc)
    if form == WAVES_PB:
        pb_s = f["pb_s"]
        Po[0] = zero + _div(1.0, pb_s)
        Po[1] = -(_div(tt0, pb_s) / pb_s) * 86400.0
        Pg[1] = zero - _div(86400.0, pb_s * pb_s)
        first = 1
    else:
        fb = cols[:nfb]
        c = torch.ones_like(tt0)
        for n in range(nfb):
            nxt = (c * tt0) * (1.0 / (n + 1))
            Po[1 + n] = zero + nxt
            Pg[1 + n] = zero + c
            c = nxt
        dfreq = torch.zeros_like(tt0)
        for n in range(nfb - 1, 0, -1):
            dfreq = (dfreq * tt0) * (1.0 / n) + fb[n]
        Po[0] = zero + f["freq"]
        Pg[0] = zero + dfreq
        first = nfb
    if form != FBX:
        om = cols[-1]
        tw = tt0 + tw_off
        g_om_o = zero
        g_om_g = zero
        for k in range(nwaves):
            cc, ss = cols[first + 2 * k], cols[first + 2 * k + 1]
            w = (k + 1) * om
            ph = w * tw
            cp, sp = torch.cos(ph), torch.sin(ph)
            rate = ss * cp - cc * sp
            curv = ss * sp + cc * cp
            Po[1 + first + 2 * k] = zero + cp
            Po[1 + first + 2 * k + 1] = zero + sp
            Pg[1 + first + 2 * k] = -(w * sp)
            Pg[1 + first + 2 * k + 1] = w * cp
            Po[0] = Po[0] + w * rate
            Pg[0] = Pg[0] - (w * w) * curv
            g_om_o = g_om_o + ((k + 1) * tw) * rate
            g_om_g = g_om_g + (k + 1) * rate - (w * ((k + 1) * tw)) * curv
        Po[nc] = g_om_o
        Pg[nc] = g_om_g
    m = -(f["pbprime"] * f["pbprime"])
    Pp = [m * g for g in Pg]
    N = f["orbits"].shape[-1]
    return torch.stack([torch.stack([x.expand(B, N) for x in Po], dim=-1),
                        torch.stack([x.expand(B, N) for x in Pp], dim=-1)],
                       dim=-2)
