"""Astrometry: sky position, proper motion and parallax (port of
``pint_tpu/models/astrometry.py:30-67,147-278``, equatorial and ecliptic
frames), and the pulsar's elongation from the Sun that the solar-wind
components read.

delay = -r_obs . n_psr + the parallax term [s], positions in light-seconds.
Free parameters are (B, 1) tensors, so the unit vector is (B, N, 3) on a
grid and (N, 3) when no astrometric parameter is free.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pint_torch.exceptions import MissingParameter
from pint_torch.models.parameter import (AngleParameter, MJDParameter,
                                         floatParameter, strParameter)
from pint_torch.models.timing_model import DelayComponent
from pint_torch.pulsar_ecliptic import OBL_IERS2010_RAD

__all__ = ["AstrometryEquatorial", "AstrometryEcliptic"]

#: mas/yr -> rad/day
_MASYR_TO_RADDAY = (math.pi / 180.0 / 3600.0 / 1000.0) / 365.25
#: kpc in light-seconds
_KPC_LS = 3.0856775814913673e19 / 299792458.0


def _cos(x):
    return torch.cos(x) if torch.is_tensor(x) else math.cos(x)


#: rotation ecliptic (IERS2010) -> equatorial, about x
_COS_OBL = float(np.cos(OBL_IERS2010_RAD))
_SIN_OBL = float(np.sin(OBL_IERS2010_RAD))


def _rowsum(x):
    """Sum over the trailing xyz axis in index order (x + y) + z."""
    return (x[..., 0] + x[..., 1]) + x[..., 2]


def _change_posepoch(comp, new_epoch, lat: str, lon: str, pmlat: str,
                     pmlon: str) -> None:
    """Move POSEPOCH to ``new_epoch``, advancing the latitude and longitude
    along the proper-motion linearization the delay evaluates (reference
    ``astrometry.py:205-225,280-293``)."""
    from pint_torch.dd import dd_from_longdouble

    table = comp._parent.params_table
    pe = table["POSEPOCH"].value
    if pe is None:
        raise ValueError("POSEPOCH is not currently set")
    dt_day = float(np.longdouble(new_epoch)
                   - (np.longdouble(pe[0]) + np.longdouble(pe[1])))
    lat0 = float(table[lat].value)
    table[lat].value = lat0 + float(table[pmlat].value or 0.0) \
        * _MASYR_TO_RADDAY * dt_day
    table[lon].value = float(table[lon].value) \
        + float(table[pmlon].value or 0.0) * _MASYR_TO_RADDAY * dt_day \
        / np.cos(lat0)
    d = dd_from_longdouble(np.longdouble(new_epoch))
    table["POSEPOCH"].value = (float(d.hi), float(d.lo))
    comp.finish_config()


class Astrometry(DelayComponent):
    category = "astrometry"

    def finish_config(self):
        self._finish_epoch("has_posepoch", "POSEPOCH")

    def _posepoch_from_pepoch(self, pm):
        """POSEPOCH falls back to PEPOCH where a proper motion is set
        (reference ``astrometry.py:212-217``)."""
        if self.POSEPOCH.value is None and any(self._value(p) for p in pm):
            pep = self._parent_param("PEPOCH")
            if pep is not None and pep.value is not None:
                self.POSEPOCH.value = pep.value

    def ssb_to_psb_xyz(self, pv, epoch_mjd):
        raise NotImplementedError

    def _dt_day(self, pv, epoch_mjd):
        """Days from POSEPOCH (zero without one)."""
        if self.config.get("has_posepoch", False) and "POSEPOCH" in pv:
            pe = pv["POSEPOCH"]
            return epoch_mjd - (pe.hi + pe.lo)
        return torch.zeros_like(epoch_mjd)

    def sun_angle(self, pv, batch):
        """The pulsar-Sun elongation [rad] at each TOA, (N,) or (B, N)
        (reference ``sun_angle_traced``, ``astrometry.py:37-45``)."""
        L_hat = self.ssb_to_psb_xyz(pv, batch.tdb.hi)
        sun = batch.obs_sun_pos
        sun_hat = sun / torch.sqrt(_rowsum(sun * sun))[:, None]
        return torch.arccos(torch.clamp(_rowsum(sun_hat * L_hat), -1.0, 1.0))

    def barycentric_radio_freq(self, pv, batch):
        """Observed frequency corrected for observatory motion (MHz)."""
        L_hat = self.ssb_to_psb_xyz(pv, batch.tdb.hi)
        v_dot_L = _rowsum(batch.ssb_obs_vel * L_hat)
        return batch.freq * (1.0 - v_dot_L)

    def _geometric_delay(self, pv, batch, L_hat, px_mas):
        r = batch.ssb_obs_pos
        re_dot_L = _rowsum(r * L_hat)
        delay = -re_dot_L
        re_sqr = _rowsum(r * r)
        px_delay = (0.5 * re_sqr * (px_mas / _KPC_LS)
                    * (1.0 - re_dot_L * re_dot_L
                       / torch.clamp(re_sqr, min=1e-30)))
        return delay + px_delay

    def delay_func(self, pv, batch, ctx, acc_delay):
        L_hat = self.ssb_to_psb_xyz(pv, batch.tdb.hi)
        return self._geometric_delay(pv, batch, L_hat, pv.get("PX", 0.0))

    def ssb_to_psb_xyz_ICRS(self, epoch=None) -> np.ndarray:
        """Unit vector(s) SSB -> pulsar in ICRS at the MJD epoch(s), proper
        motion applied, on the host (reference ``astrometry.py:80``); the
        default epoch is POSEPOCH, else the model's PEPOCH."""
        model = self._parent
        if epoch is None:
            table = model.params_table
            pe = table.get("POSEPOCH")
            if pe is None or pe.value is None:
                pe = table.get("PEPOCH")
            if pe is None or pe.value is None:
                raise ValueError("No POSEPOCH/PEPOCH to evaluate the "
                                 "position at")
            epoch = model.epoch_value(pe.name)
        ep = torch.as_tensor(np.atleast_1d(np.asarray(epoch,
                                                      dtype=np.float64)),
                             dtype=torch.float64)
        xyz = self.ssb_to_psb_xyz(model.const_pv(), ep).numpy()
        return xyz.reshape(np.shape(epoch) + (3,)) if np.shape(epoch) \
            else xyz[0]


class AstrometryEquatorial(Astrometry):
    """Config: ``has_posepoch`` (POSEPOCH set)."""

    register = True

    def declare(self):
        self.add_param(AngleParameter("RAJ", angle_type="hms", aliases=["RA"],
                                      description="Right ascension (J2000)"))
        self.add_param(AngleParameter("DECJ", angle_type="dms",
                                      aliases=["DEC"],
                                      description="Declination (J2000)"))
        self.add_param(floatParameter(
            "PMRA", value=0.0, units="mas/yr",
            description="Proper motion in RA (mu_alpha* = mu_alpha cos(dec))"))
        self.add_param(floatParameter("PMDEC", value=0.0, units="mas/yr",
                                      description="Proper motion in DEC"))
        self.add_param(floatParameter("PX", value=0.0, units="mas",
                                      description="Parallax"))
        self.add_param(MJDParameter("POSEPOCH",
                                    description="Epoch of position"))

    def validate(self):
        if self.RAJ.value is None or self.DECJ.value is None:
            raise MissingParameter("AstrometryEquatorial", "RAJ/DECJ")
        self._posepoch_from_pepoch(("PMRA", "PMDEC"))

    def change_posepoch(self, new_epoch):
        """Move POSEPOCH, advancing RAJ and DECJ along the proper motion
        the delay evaluates."""
        _change_posepoch(self, new_epoch, "DECJ", "RAJ", "PMDEC", "PMRA")

    def coords_as_ICRS(self):
        """(RA, Dec) [rad] at POSEPOCH (reference ``astrometry.py:202``)."""
        t = self._parent.params_table
        return float(t["RAJ"].value), float(t["DECJ"].value)

    def ssb_to_psb_xyz(self, pv, epoch_mjd):
        ra0 = pv["RAJ"]
        dec0 = pv["DECJ"]
        dt_day = self._dt_day(pv, epoch_mjd)
        dec = dec0 + pv.get("PMDEC", 0.0) * _MASYR_TO_RADDAY * dt_day
        ra = ra0 + pv.get("PMRA", 0.0) * _MASYR_TO_RADDAY * dt_day / _cos(dec0)
        cd = torch.cos(dec)
        return torch.stack([cd * torch.cos(ra), cd * torch.sin(ra),
                            torch.sin(dec)], dim=-1)


class AstrometryEcliptic(Astrometry):
    """ELONG/ELAT with PMELONG/PMELAT in the IERS2010 ecliptic, rotated to
    equatorial (reference ``astrometry.py:227-278``, ``ssb_to_psb_xyz``
    :262).  Config:
    ``has_posepoch``."""

    register = True

    def declare(self):
        self.add_param(AngleParameter("ELONG", angle_type="deg",
                                      aliases=["LAMBDA"],
                                      description="Ecliptic longitude"))
        self.add_param(AngleParameter("ELAT", angle_type="deg",
                                      aliases=["BETA"],
                                      description="Ecliptic latitude"))
        self.add_param(floatParameter(
            "PMELONG", value=0.0, units="mas/yr", aliases=["PMLAMBDA"],
            description="PM in ecliptic longitude"))
        self.add_param(floatParameter(
            "PMELAT", value=0.0, units="mas/yr", aliases=["PMBETA"],
            description="PM in ecliptic latitude"))
        self.add_param(floatParameter("PX", value=0.0, units="mas",
                                      description="Parallax"))
        self.add_param(MJDParameter("POSEPOCH",
                                    description="Epoch of position"))
        self.add_param(strParameter("ECL", value="IERS2010",
                                    description="Ecliptic convention"))

    def validate(self):
        if self.ELONG.value is None or self.ELAT.value is None:
            raise MissingParameter("AstrometryEcliptic", "ELONG/ELAT")
        self._posepoch_from_pepoch(("PMELONG", "PMELAT"))

    def change_posepoch(self, new_epoch):
        """Move POSEPOCH, advancing ELONG and ELAT along the proper motion
        the delay evaluates."""
        _change_posepoch(self, new_epoch, "ELAT", "ELONG", "PMELAT",
                         "PMELONG")

    def coords_as_ICRS(self):
        """(RA, Dec) [rad] of the position rotated to equatorial, proper
        motion left out (reference ``astrometry.py:295``)."""
        t = self._parent.params_table
        v = self.ssb_to_psb_xyz(
            {"ELONG": float(t["ELONG"].value), "ELAT": float(t["ELAT"].value),
             "PMELONG": 0.0, "PMELAT": 0.0},
            torch.zeros(1, dtype=torch.float64)).numpy()[0]
        return (float(np.arctan2(v[1], v[0]) % (2 * np.pi)),
                float(np.arcsin(v[2])))

    def ssb_to_psb_xyz(self, pv, epoch_mjd):
        dt_day = self._dt_day(pv, epoch_mjd)
        lat = pv["ELAT"] + pv.get("PMELAT", 0.0) * _MASYR_TO_RADDAY * dt_day
        lon = pv["ELONG"] + pv.get("PMELONG", 0.0) * _MASYR_TO_RADDAY \
            * dt_day / _cos(pv["ELAT"])
        cb = torch.cos(lat)
        x_e = cb * torch.cos(lon)
        y_e = cb * torch.sin(lon)
        z_e = torch.sin(lat)
        y = _COS_OBL * y_e - _SIN_OBL * z_e
        z = _SIN_OBL * y_e + _COS_OBL * z_e
        return torch.stack([x_e, y, z], dim=-1)
