"""Astrometry: sky position, proper motion and parallax (port of
``pint_tpu/models/astrometry.py:30-67,147-226``, equatorial frame).

delay = -r_obs . n_psr + the parallax term [s], positions in light-seconds.
Free parameters are (B, 1) tensors, so the unit vector is (B, N, 3) on a
grid and (N, 3) when no astrometric parameter is free.
"""

from __future__ import annotations

import math

import torch

from pint_torch.models.timing_model import DelayComponent

__all__ = ["AstrometryEquatorial"]

#: mas/yr -> rad/day
_MASYR_TO_RADDAY = (math.pi / 180.0 / 3600.0 / 1000.0) / 365.25
#: kpc in light-seconds
_KPC_LS = 3.0856775814913673e19 / 299792458.0


def _cos(x):
    return torch.cos(x) if torch.is_tensor(x) else math.cos(x)


def _rowsum(x):
    """Sum over the trailing xyz axis in index order (x + y) + z."""
    return (x[..., 0] + x[..., 1]) + x[..., 2]


class Astrometry(DelayComponent):
    category = "astrometry"

    def ssb_to_psb_xyz(self, pv, epoch_mjd):
        raise NotImplementedError

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


class AstrometryEquatorial(Astrometry):
    """Config: ``has_posepoch`` (POSEPOCH set)."""

    register = True

    def ssb_to_psb_xyz(self, pv, epoch_mjd):
        ra0 = pv["RAJ"]
        dec0 = pv["DECJ"]
        if self.config.get("has_posepoch", False) and "POSEPOCH" in pv:
            pe = pv["POSEPOCH"]
            dt_day = epoch_mjd - (pe.hi + pe.lo)
        else:
            dt_day = torch.zeros_like(epoch_mjd)
        dec = dec0 + pv.get("PMDEC", 0.0) * _MASYR_TO_RADDAY * dt_day
        ra = ra0 + pv.get("PMRA", 0.0) * _MASYR_TO_RADDAY * dt_day / _cos(dec0)
        cd = torch.cos(dec)
        return torch.stack([cd * torch.cos(ra), cd * torch.sin(ra),
                            torch.sin(dec)], dim=-1)
