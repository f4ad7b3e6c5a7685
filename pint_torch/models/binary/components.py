"""Par-facing binary components (port of
``pint_tpu/models/binary/components.py:46-205,447-627,672-790``): the
barycentric time since the epoch, (TDB - T0|TASC) * 86400 - acc_delay in
double-double, handed as float64 to an engine kernel -- K2
(:mod:`pint_torch.kernels.dd_binary`) for the DD family (BT, DD, DDS,
DDH, DDGR, DDK and the piecewise BT), K4
(:mod:`pint_torch.kernels.ell1_binary`) for ELL1, ELL1k and ELL1H --
whose arithmetic is :mod:`pint_torch.models.binary.engines`.  DDS, DDH and
DDGR hand K2 a row reparameterized in torch (differentiable through
``torch.func`` like the reference's jacfwd), DDK its per-TOA Kopeikin
corrections, the piecewise BT its per-TOA a1.  FBX and ORBWAVES orbits
come from K6 (:mod:`pint_torch.kernels.binary_orbits`) and enter K2 or K4
as their orbit inputs, under any binary, as the reference's generic
``_orbits_fn``."""

from __future__ import annotations

import math

import numpy as np
import torch

from pint_torch.dd import dd_mul, dd_sub
from pint_torch.kernels import binary_orbits as K6
from pint_torch.kernels import dd_binary as K2
from pint_torch.kernels import ell1_binary as K4
from pint_torch.models.binary.engines import (BT, BTX, DD_PARAMS, DDGR,
                                              DDGR_PARAMS, DDK, ELL1,
                                              ELL1_PARAMS, ELL1H_EXACT,
                                              ELL1H_HARMONIC, ELL1H_PARAMS,
                                              ELL1K, FBX, WAVES_FBX, WAVES_PB,
                                              dds_sini, ddgr_row,
                                              ddh_sini_m2, ddk_corrections,
                                              ecliptic_pm_to_equatorial,
                                              orbit_coefficients)
from pint_torch.models.timing_model import DelayComponent, stack_params
from pint_torch.pulsar_ecliptic import OBL_IERS2010_RAD
from pint_torch.utils import taylor_horner

__all__ = ["PulsarBinary", "BinaryBT", "BinaryBT_piecewise", "BinaryDD",
           "BinaryDDS", "BinaryDDH", "BinaryDDGR", "BinaryDDK", "BinaryELL1",
           "BinaryELL1k", "BinaryELL1H"]

DAY_S = 86400.0


class MissingParameter(ValueError):
    """A component lacks a parameter its model needs (the reference's
    ``MissingParameter``)."""


class TimingModelError(ValueError):
    """A parameter value the model cannot use (the reference's
    ``TimingModelError``)."""


class PulsarBinary(DelayComponent):
    """Config: ``nfb`` and ``nwaves``, the FBX and ORBWAVES orbits'
    counts (0 and 0: PB/PBDOT orbits)."""

    category = "pulsar_system"
    epoch_param = "T0"

    def _value(self, name):
        p = self._parent.params_table.get(name)
        return None if p is None else p.value

    def validate(self):
        """The reference's ``PulsarBinary.validate`` (``components.py:
        146-166``): PB (or FB0), ORBWAVE_OM and ORBWAVE_EPOCH with waves,
        the epoch, A1, SINI and ECC."""
        name = type(self).__name__
        if not self.config.get("nfb", 0) and self._value("PB") is None:
            raise MissingParameter(f"{name}: PB (or FB0) is required")
        if self.config.get("nwaves", 0):
            for p in ("ORBWAVE_OM", "ORBWAVE_EPOCH"):
                if self._value(p) is None:
                    raise MissingParameter(f"{name}: {p} is required")
        if self._value(self.epoch_param) is None:
            raise MissingParameter(f"{name}: {self.epoch_param} is required")
        if self._value("A1") is None:
            raise MissingParameter(f"{name}: A1 is required")
        sini = self._value("SINI")
        if sini is not None and not -1.0 <= sini <= 1.0:
            raise TimingModelError(f"SINI = {sini} must be within [-1, 1]")
        ecc = self._value("ECC")
        if ecc is not None and not 0 <= ecc < 1:
            raise TimingModelError(f"ECC = {ecc} must be within [0, 1)")

    def pb(self, t=None):
        """Orbital period [d] and its 1-sigma uncertainty (None where no
        source parameter carries one) at MJD(s) ``t``, the epoch by
        default, from PB/PBDOT(+XPBDOT) or the FB ladder -- days on both
        paths (reference ``components.py:262``); host numpy."""
        table = self._parent.params_table
        ep = self._parent.epoch_value(self.epoch_param)
        t_mjd = ep if t is None else t
        dt_d = np.asarray(t_mjd, dtype=np.float64) - ep
        if self._value("PB") is not None:
            pb_d = float(self._value("PB"))
            unc = table["PB"].uncertainty
            err2 = float(unc) ** 2 if unc is not None else 0.0
            pbdot = 0.0
            for name in ("PBDOT", "XPBDOT"):
                p = table.get(name)
                if p is not None and p.value is not None:
                    pbdot += float(p.value)
                    if p.uncertainty is not None:
                        err2 += (float(p.uncertainty) * dt_d) ** 2
            val = pb_d + pbdot * dt_d
            err = np.sqrt(err2) if np.any(err2) else None
            return val, err
        nfb = int(self.config.get("nfb", 0))
        if nfb:
            dt_s = dt_d * DAY_S
            coeffs = [float(table[f"FB{i}"].value or 0.0) for i in range(nfb)]
            f = np.asarray(taylor_horner(dt_s, coeffs), dtype=np.float64)
            val = 1.0 / f / DAY_S
            # d(1/f)/dFB_i = -(dt^i / i!) / f^2
            err2 = np.zeros_like(np.asarray(dt_s, dtype=np.float64))
            any_err = False
            for i in range(nfb):
                u_i = table[f"FB{i}"].uncertainty
                if u_i is not None:
                    any_err = True
                    err2 = err2 + (dt_s**i / math.factorial(i) / f**2
                                   * float(u_i)) ** 2
            err = np.sqrt(err2) / DAY_S if any_err else None
            return val, err
        raise AttributeError(
            "Neither PB nor FB0 is present in the timing model")

    def pbdot_pair(self):
        """(PBDOT, sigma): -FB1/FB0^2 where the FB ladder drives the orbit,
        else PBDOT itself; None when neither is set (reference
        ``components.py:309``)."""
        table = self._parent.params_table
        fb1 = table.get("FB1")
        if fb1 is not None and fb1.value:
            fb0 = table["FB0"]
            f0v, f1v = float(fb0.value), float(fb1.value)
            val = -f1v / f0v**2
            err = float(np.hypot((fb1.uncertainty or 0.0) / f0v**2,
                                 2.0 * f1v * (fb0.uncertainty or 0.0)
                                 / f0v**3))
            return val, err
        p = table.get("PBDOT")
        if p is not None and p.value:
            return float(p.value), float(p.uncertainty or 0.0)
        return None

    def _tt0(self, pv, batch, acc_delay):
        epoch = pv[self.epoch_param]
        d = dd_mul(dd_sub(batch.tdb, epoch), DAY_S)
        return (d.hi + d.lo) - acc_delay

    def _orbits(self, pv, tt0):
        """The orbit inputs (orbits, pbprime), (B, N) each, of FBX or
        ORBWAVES orbits from K6 -- ORBWAVES (on a PB or FBX base) when wave
        amplitudes are set, else FBX when any FBn is set -- or None for
        PB/PBDOT orbits (reference ``_orbits_fn``, ``components.py:
        168-193``); the waves' tw = tt0 + (epoch - ORBWAVE_EPOCH) 86400 in
        double-double."""
        nfb = int(self.config.get("nfb", 0))
        nw = int(self.config.get("nwaves", 0))
        if not nfb and not nw:
            return None
        form = FBX if not nw else WAVES_FBX if nfb else WAVES_PB
        off = 0.0
        if nw:
            d = dd_mul(dd_sub(pv[self.epoch_param], pv["ORBWAVE_EPOCH"]),
                       DAY_S)
            off = d.hi + d.lo
        coef = stack_params(pv, orbit_coefficients(form, nfb, nw),
                            tt0.device)
        return K6.binary_orbits(tt0, coef, form, nfb, nw, off)

    def binary_delay(self, pv, tt0):
        raise NotImplementedError

    def delay_func(self, pv, batch, ctx, acc_delay):
        tt0 = self._tt0(pv, batch, acc_delay)
        if tt0.ndim == 1:
            tt0 = tt0.unsqueeze(0)
        return self.binary_delay(pv, tt0)


class BinaryBT(PulsarBinary):
    """Blandford & Teukolsky model (reference ``components.py:447``), on
    K2's BT instantiation: R with the constant PB, as the reference's
    ``use_pb`` without FBn (on FBX orbits R reads pbprime)."""

    register = True

    def _orbits_bt(self, pv, tt0):
        """K2's BT orbit inputs: K6's orbits, and as pbprime what R reads
        -- K6's on FBX orbits, PB 86400 on a PB base (``use_pb``)."""
        orb = self._orbits(pv, tt0)
        if orb is None or self.config.get("nfb", 0):
            return orb
        pb_s = pv["PB"] * 86400.0
        pb_s = pb_s.expand_as(orb[0]) if torch.is_tensor(pb_s) \
            else torch.full_like(orb[0], pb_s)
        return orb[0], pb_s

    def binary_delay(self, pv, tt0, a1=None):
        row = stack_params(pv, DD_PARAMS, tt0.device)
        if a1 is None:
            return K2.dd_binary(tt0, row, BT, orb=self._orbits_bt(pv, tt0))
        return K2.dd_binary(tt0, row, BTX, (a1,), self._orbits_bt(pv, tt0))


class BinaryBT_piecewise(BinaryBT):
    """BT with piecewise T0X_xxxx/A1X_xxxx overrides in [XR1_xxxx,
    XR2_xxxx) MJD windows (reference ``components.py:721-790``): per
    piece, tt0 shifted by m (T0 - T0X) 86400 and a per-TOA a1 = A1 + m
    (A1X - A1), formed as the reference forms them, on K2's BTX
    instantiation.  Config: ``piece_indices``; context: ``masks`` (n, N)
    of 0/1."""

    register = True

    def validate(self):
        super().validate()
        for i in self.config.get("piece_indices", []):
            for pre in ("XR1_", "XR2_"):
                if self._value(f"{pre}{i:04d}") is None:
                    raise MissingParameter(
                        f"BinaryBT_piecewise: {pre}{i:04d} is required")

    def delay_func(self, pv, batch, ctx, acc_delay):
        tt0 = self._tt0(pv, batch, acc_delay)
        if tt0.ndim == 1:
            tt0 = tt0.unsqueeze(0)
        masks = ctx.get("masks")
        if masks is None or not self.config.get("piece_indices"):
            return self.binary_delay(pv, tt0)
        t0 = pv["T0"]
        A1 = pv.get("A1", 0.0)
        a1 = A1 * torch.ones_like(tt0)
        for k, i in enumerate(self.config["piece_indices"]):
            m = masks[k]
            dt_days = (t0.hi - pv.get(f"T0X_{i:04d}", 0.0)) + t0.lo
            tt0 = tt0 + m * dt_days * DAY_S
            a1 = a1 + m * (pv.get(f"A1X_{i:04d}", 0.0) - A1)
        B = max(tt0.shape[0], a1.shape[0])
        return self.binary_delay(pv, tt0.expand(B, -1), a1.expand(B, -1))


class BinaryDD(PulsarBinary):
    """Damour & Deruelle model (reference ``components.py:458``)."""

    register = True

    def _row(self, pv, tt0):
        """The DD row's values by name; DDS and DDH reparameterize it."""
        return pv

    def binary_delay(self, pv, tt0):
        return K2.dd_binary(tt0, stack_params(self._row(pv, tt0), DD_PARAMS,
                                              tt0.device),
                            orb=self._orbits(pv, tt0))


class BinaryDDS(BinaryDD):
    """DD with SHAPMAX = -log(1 - SINI) (reference ``components.py:479``):
    K2's DD instantiation on the row with sini = 1 - exp(-SHAPMAX)."""

    register = True

    def validate(self):
        super().validate()
        sm = self._value("SHAPMAX")
        if sm is not None and sm < -math.log(2):
            raise TimingModelError(f"SHAPMAX = {sm} must be > -log(2)")

    def _row(self, pv, tt0):
        return dict(pv, SINI=dds_sini(pv, tt0))


class BinaryDDH(BinaryDD):
    """DD with the orthometric H3/STIGMA Shapiro parameters (reference
    ``components.py:501``): K2's DD instantiation on the row with sini =
    2 stig / (1 + stig^2) and M2 = H3 / stig^3 / TSUN."""

    register = True

    def validate(self):
        super().validate()
        if self._value("H3") is None or self._value("STIGMA") is None:
            raise MissingParameter("BinaryDDH: H3/STIGMA are required")

    def _row(self, pv, tt0):
        sini, m2 = ddh_sini_m2(pv, tt0)
        return dict(pv, SINI=sini, M2=m2)


class BinaryDDGR(BinaryDD):
    """GR-constrained DD (reference ``components.py:527``): SINI, GAMMA, k,
    DR, DTH and the GR orbital decay from MTOT and M2 per row in torch
    (:func:`~pint_torch.models.binary.engines.ddgr_row`), then K2's DDGR
    instantiation."""

    register = True

    def validate(self):
        super().validate()
        if self._value("MTOT") is None or self._value("M2") is None:
            raise MissingParameter("BinaryDDGR: MTOT/M2 are required")

    def binary_delay(self, pv, tt0):
        return K2.dd_binary(tt0, stack_params(ddgr_row(pv, tt0), DDGR_PARAMS,
                                              tt0.device), DDGR,
                            orb=self._orbits(pv, tt0))


class BinaryDDK(BinaryDD):
    """DD with Kopeikin's annual-parallax and secular proper-motion
    corrections (reference ``components.py:552-587``): the corrections per
    (point, TOA) in torch
    (:func:`~pint_torch.models.binary.engines.ddk_corrections`), from the
    astrometry's unit vector to the pulsar and the observatory's position,
    then K2's DDK instantiation, which adds d_a1 and d_om and takes sin(kin)
    as sini.  An ecliptic proper motion is rotated to equatorial first, as
    the reference rotates it; K96 (a bool parameter) enters as 1.0 or
    0.0."""

    register = True

    def validate(self):
        super().validate()
        if self._value("KIN") is None or self._value("KOM") is None:
            raise MissingParameter("BinaryDDK: KIN/KOM are required")
        if self._value("PX") in (None, 0.0):
            raise TimingModelError(
                "DDK needs a non-zero PX (Kopeikin parallax terms)")
        if self._value("SINI") is not None:
            raise TimingModelError(
                "DDK uses KIN; remove SINI from the par file")

    def delay_func(self, pv, batch, ctx, acc_delay):
        tt0 = self._tt0(pv, batch, acc_delay)
        if tt0.ndim == 1:
            tt0 = tt0.unsqueeze(0)
        astro = next((c for c in self._parent.components.values()
                      if hasattr(c, "ssb_to_psb_xyz")), None)
        if astro is None:
            raise TimingModelError("DDK requires an astrometry component")
        psr_pos = astro.ssb_to_psb_xyz(pv, batch.tdb.hi)
        pv2 = dict(pv)
        if "PMELONG" in pv and "PMRA" not in pv:
            # the unit vector (and Kopeikin's I0/J0 basis from it) is
            # equatorial: the proper motion goes to that frame too
            pv2["PMRA"], pv2["PMDEC"] = ecliptic_pm_to_equatorial(
                pv["ELONG"], pv["ELAT"], pv.get("PMELONG", 0.0),
                pv.get("PMELAT", 0.0), OBL_IERS2010_RAD, tt0)
        k96 = 1.0 if self._value("K96") in (None, True) else 0.0
        d_a1, d_om, kin = ddk_corrections(pv2, tt0, psr_pos,
                                          batch.ssb_obs_pos, k96)
        return K2.dd_binary(tt0, stack_params(pv2, DD_PARAMS, tt0.device),
                            DDK, (d_a1, d_om, torch.sin(kin)),
                            self._orbits(pv, tt0))


class BinaryELL1(PulsarBinary):
    """Low-eccentricity Lange et al. (2001) model, epoch TASC (reference
    ``components.py:589``)."""

    register = True
    epoch_param = "TASC"
    mode = ELL1

    def binary_delay(self, pv, tt0):
        return K4.ell1_binary(tt0, stack_params(pv, ELL1_PARAMS,
                                                tt0.device), self.mode,
                              orb=self._orbits(pv, tt0))


class BinaryELL1k(BinaryELL1):
    """ELL1 with exponential eccentricity evolution and periastron advance
    (Susobhanan+ 2018; reference ``components.py:705``)."""

    register = True
    mode = ELL1K


class BinaryELL1H(BinaryELL1):
    """ELL1 with the orthometric Shapiro delay H3 with STIGMA, or H3 with
    H4 (Freire & Wex 2010; reference ``components.py:672-700``).  The form
    is chosen as the reference chooses it: exact when STIGMA is set and not
    0, else the harmonics 3..NHARMS of stigma = STIGMA, or H4/H3 when H4
    is set and STIGMA is not."""

    register = True

    def validate(self):
        if self._value("H3") is None:
            raise ValueError("BinaryELL1H: H3 is required")
        if self._value("H4") is not None \
                and self._value("STIGMA") is not None:
            raise ValueError("BinaryELL1H: provide H4 or STIGMA, not both")

    def binary_delay(self, pv, tt0):
        stigma, h4 = self._value("STIGMA"), self._value("H4")
        exact = stigma is not None and stigma != 0.0
        mode = ELL1H_EXACT if exact else ELL1H_HARMONIC
        return K4.ell1_binary(
            tt0, stack_params(pv, ELL1H_PARAMS, tt0.device), mode,
            nharms=int(self._value("NHARMS") or 7),
            use_h4=h4 is not None and stigma is None,
            orb=self._orbits(pv, tt0))
