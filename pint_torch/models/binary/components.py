"""Par-facing binary components (port of
``pint_tpu/models/binary/components.py:46-205,447-627,672-719``): the
barycentric time since the epoch, (TDB - T0|TASC) * 86400 - acc_delay in
double-double, handed as float64 to an engine kernel -- K2
(:mod:`pint_torch.kernels.dd_binary`) for the DD family (BT, DD, DDS,
DDH, DDGR, DDK), K4 (:mod:`pint_torch.kernels.ell1_binary`) for ELL1,
ELL1k and ELL1H -- whose arithmetic is
:mod:`pint_torch.models.binary.engines`.  DDS, DDH and DDGR hand K2 a
row reparameterized in torch (differentiable through ``torch.func`` like
the reference's jacfwd), DDK its per-TOA Kopeikin corrections."""

from __future__ import annotations

import math

import torch

from pint_torch.dd import dd_mul, dd_sub
from pint_torch.kernels import dd_binary as K2
from pint_torch.kernels import ell1_binary as K4
from pint_torch.models.binary.engines import (BT, DD_PARAMS, DDGR,
                                              DDGR_PARAMS, DDK, ELL1,
                                              ELL1_PARAMS, ELL1H_EXACT,
                                              ELL1H_HARMONIC, ELL1H_PARAMS,
                                              ELL1K, dds_sini, ddgr_row,
                                              ddh_sini_m2, ddk_corrections,
                                              ecliptic_pm_to_equatorial)
from pint_torch.models.timing_model import DelayComponent, stack_params
from pint_torch.pulsar_ecliptic import OBL_IERS2010_RAD

__all__ = ["PulsarBinary", "BinaryBT", "BinaryBT_piecewise", "BinaryDD",
           "BinaryDDS", "BinaryDDH", "BinaryDDGR", "BinaryDDK", "BinaryELL1",
           "BinaryELL1k", "BinaryELL1H", "QUEUED"]

DAY_S = 86400.0

#: where ROADMAP.md queues what the port refuses in this package's binaries
QUEUED = ("ROADMAP.md queue A item 5 (FBX/ORBWAVES orbits and "
          "BinaryBT_piecewise, with orbital/kepler.py)")


class MissingParameter(ValueError):
    """A component lacks a parameter its model needs (the reference's
    ``MissingParameter``)."""


class TimingModelError(ValueError):
    """A parameter value the model cannot use (the reference's
    ``TimingModelError``)."""


class PulsarBinary(DelayComponent):
    """Config: ``nfb`` and ``nwaves`` (FBX / ORBWAVES orbits; this slice
    runs the PB parameterization only)."""

    category = "pulsar_system"
    epoch_param = "T0"

    def _check_orbits(self):
        if self.config.get("nfb", 0) or self.config.get("nwaves", 0):
            raise NotImplementedError(
                f"{type(self).__name__}: FBX/ORBWAVES orbits are not ported "
                f"yet ({QUEUED}); the port evaluates PB/PBDOT orbits")

    def _value(self, name):
        p = self._parent.params_table.get(name)
        return None if p is None else p.value

    def validate(self):
        """The reference's ``PulsarBinary.validate`` checks of PB, the
        epoch, A1, SINI and ECC, with PB/PBDOT orbits (FBX and ORBWAVES
        are refused)."""
        self._check_orbits()
        name = type(self).__name__
        if self._value("PB") is None:
            raise MissingParameter(f"{name}: PB (or FB0) is required")
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

    def _tt0(self, pv, batch, acc_delay):
        epoch = pv[self.epoch_param]
        d = dd_mul(dd_sub(batch.tdb, epoch), DAY_S)
        return (d.hi + d.lo) - acc_delay

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
    ``use_pb`` on PB orbits."""

    register = True

    def binary_delay(self, pv, tt0):
        self._check_orbits()
        return K2.dd_binary(tt0, stack_params(pv, DD_PARAMS, tt0.device), BT)


class BinaryBT_piecewise(BinaryBT):
    """Piecewise BT (reference ``components.py:721``): queued, not ported;
    a snapshot that holds it is refused with the ROADMAP item that ports
    it."""

    register = True

    def __init__(self, config=None, context=None):
        raise NotImplementedError(
            f"component {type(self).__name__} is not ported yet ({QUEUED})")


class BinaryDD(PulsarBinary):
    """Damour & Deruelle model (reference ``components.py:458``)."""

    register = True

    def _row(self, pv, tt0):
        """The DD row's values by name; DDS and DDH reparameterize it."""
        return pv

    def binary_delay(self, pv, tt0):
        self._check_orbits()
        return K2.dd_binary(tt0, stack_params(self._row(pv, tt0), DD_PARAMS,
                                              tt0.device))


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
        self._check_orbits()
        return K2.dd_binary(tt0, stack_params(ddgr_row(pv, tt0), DDGR_PARAMS,
                                              tt0.device), DDGR)


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
        self._check_orbits()
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
                            DDK, (d_a1, d_om, torch.sin(kin)))


class BinaryELL1(PulsarBinary):
    """Low-eccentricity Lange et al. (2001) model, epoch TASC (reference
    ``components.py:589``)."""

    register = True
    epoch_param = "TASC"
    mode = ELL1

    def binary_delay(self, pv, tt0):
        self._check_orbits()
        return K4.ell1_binary(tt0, stack_params(pv, ELL1_PARAMS,
                                                tt0.device), self.mode)


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
        self._check_orbits()
        stigma, h4 = self._value("STIGMA"), self._value("H4")
        exact = stigma is not None and stigma != 0.0
        mode = ELL1H_EXACT if exact else ELL1H_HARMONIC
        return K4.ell1_binary(
            tt0, stack_params(pv, ELL1H_PARAMS, tt0.device), mode,
            nharms=int(self._value("NHARMS") or 7),
            use_h4=h4 is not None and stigma is None)
