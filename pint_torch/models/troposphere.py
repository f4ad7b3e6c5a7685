"""Tropospheric delay (port of ``pint_tpu/models/troposphere.py:1-245``):
the Niell mapping of the Davis et al. (1985) zenith delay at each ground
site, computed on the host (the reference's ``build_context``; it depends
on no fitted parameter) -- when the snapshot is taken, or for host TOAs by
:meth:`TroposphereDelay.host_context` -- and applied as the context's
``delay``."""

from __future__ import annotations

import numpy as np
import torch

from pint_torch.logging import log
from pint_torch.models.parameter import boolParameter
from pint_torch.models.timing_model import DelayComponent

__all__ = ["TroposphereDelay"]

C_M_S = 299792458.0
EARTH_R_KM = 6356.766  # US std atmosphere polar radius used by the reference

# Niell hydrostatic coefficients at latitudes 0,15,30,45,60,75,90 deg
_LAT = np.array([0.0, 15.0, 30.0, 45.0, 60.0, 75.0, 90.0])
_A_AVG = np.array([0.0, 1.2769934, 1.2683230, 1.2465397, 1.2196049, 1.2045996, 0.0]) * 1e-3
_B_AVG = np.array([0.0, 2.9153695, 2.9152299, 2.9288445, 2.9022565, 2.9024912, 0.0]) * 1e-3
_C_AVG = np.array([0.0, 62.610505, 62.837393, 63.721774, 63.824265, 64.258455, 0.0]) * 1e-3
_A_AMP = np.array([0.0, 0.0, 1.2709626, 2.6523662, 3.4000452, 4.1202191, 0.0]) * 1e-5
_B_AMP = np.array([0.0, 0.0, 2.1414979, 3.0160779, 7.2562722, 11.723375, 0.0]) * 1e-5
_C_AMP = np.array([0.0, 0.0, 9.0128400, 4.3497037, 84.795348, 170.37206, 0.0]) * 1e-5
_A_HT, _B_HT, _C_HT = 2.53e-5, 5.49e-3, 1.14e-3
# wet-map coefficients
_AW = np.array([0.0, 5.8021897, 5.6794847, 5.8118019, 5.9727542, 6.1641693, 0.0]) * 1e-4
_BW = np.array([0.0, 1.4275268, 1.5138625, 1.4572752, 1.5007428, 1.7599082, 0.0]) * 1e-3
_CW = np.array([0.0, 4.3472961, 4.6729510, 4.3908931, 4.4626982, 5.4736038, 0.0]) * 1e-2

_MIN_ALT_DEG = 5.0

# WGS84 ellipsoid
_WGS84_A = 6378137.0
_WGS84_F = 1.0 / 298.257223563
_WGS84_E2 = _WGS84_F * (2.0 - _WGS84_F)


def _geodetic_lat_height(xyz_m):
    """Geodetic latitude [rad] and height [m] from ITRF xyz (Bowring's
    iteration; replaces astropy EarthLocation in a dependency-free stack)."""
    x, y, z = xyz_m
    p = np.hypot(x, y)
    lat = np.arctan2(z, p * (1 - _WGS84_E2))
    for _ in range(5):
        sin_lat = np.sin(lat)
        N = _WGS84_A / np.sqrt(1 - _WGS84_E2 * sin_lat**2)
        h = p / np.cos(lat) - N
        lat = np.arctan2(z, p * (1 - _WGS84_E2 * N / (N + h)))
    sin_lat = np.sin(lat)
    N = _WGS84_A / np.sqrt(1 - _WGS84_E2 * sin_lat**2)
    h = p / np.cos(lat) - N
    return float(lat), float(h)


def _geodetic_up(xyz_m):
    """Unit surface-normal (geodetic zenith) in ITRF."""
    lat, _ = _geodetic_lat_height(xyz_m)
    lon = np.arctan2(xyz_m[1], xyz_m[0])
    return np.array([np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon),
                     np.sin(lat)])


def _herring_map(alt_rad, a, b, c):
    sin_e = np.sin(alt_rad)
    top = 1.0 + a / (1.0 + b / (1.0 + c))
    bot = sin_e + a / (sin_e + b / (sin_e + c))
    return top / bot


def _interp_coeff(abs_lat_deg, avg, amp, year_frac):
    """Nearest-neighbor latitude interpolation of the annual coefficient
    (reference ``troposphere_delay.py mapping_function``)."""
    vals = avg[None, :] + amp[None, :] * np.cos(2 * np.pi * year_frac)[:, None]
    out = np.empty(len(year_frac))
    for j in range(len(year_frac)):
        out[j] = np.interp(abs_lat_deg, _LAT, vals[j])
    return out


def pressure_from_altitude_kpa(h_m: float) -> float:
    """US standard atmosphere (CRC handbook ch. 14) pressure at altitude."""
    h_km = h_m / 1e3
    gph = EARTH_R_KM * h_km / (EARTH_R_KM + h_km)
    if gph > 11.0:
        log.warning("Pressure approximation invalid above 11 km")
    T = 288.15 - 0.0065 * gph * 1e3
    return 101.325 * (288.15 / T) ** -5.25575


def zenith_delay_s(lat_rad: float, h_m: float) -> float:
    """Davis et al. (1985) hydrostatic zenith delay in seconds."""
    p = pressure_from_altitude_kpa(h_m)
    return (p / 43.921) / (C_M_S * (1 - 0.00266 * np.cos(2 * lat_rad)
                                    - 0.00028 * h_m / 1e3))


class TroposphereDelay(DelayComponent):
    """Context: ``delay`` (N,) [s] (zeros with CORRECT_TROPOSPHERE N)."""

    register = True
    category = "troposphere"

    def declare(self):
        self.add_param(boolParameter("CORRECT_TROPOSPHERE", value=True,
                                     description="Enable tropospheric delay"))

    def host_context(self, toas):
        v = self._value("CORRECT_TROPOSPHERE")
        if not bool(True if v is None else v):
            return {"delay": np.zeros(len(toas))}
        try:
            delay = self._compute_host_delay(toas)
        except Exception as e:  # barycentric TOAs etc. have no altitude
            log.warning(f"Troposphere delay disabled: {e}")
            delay = np.zeros(len(toas))
        return {"delay": delay}

    def _compute_host_delay(self, toas) -> np.ndarray:
        from pint_torch.earth import itrf_to_gcrs_matrix
        from pint_torch.observatory import get_observatory

        astro = None
        for comp in (self._parent.components if self._parent else {}).values():
            if hasattr(comp, "coords_as_ICRS"):
                astro = comp
        if astro is None:
            raise ValueError("no astrometry component for source position")
        ra, dec = astro.coords_as_ICRS()
        psr = np.array([np.cos(dec) * np.cos(ra), np.cos(dec) * np.sin(ra),
                        np.sin(dec)])

        utc = np.asarray(toas.get_mjds(), dtype=np.float64)
        delay = np.zeros(len(toas))
        for site in np.unique(toas.get_obss()):
            m = toas.get_obss() == site
            obs = get_observatory(site)
            xyz = getattr(obs, "itrf_xyz", None)
            if xyz is None:
                continue  # barycenter/geocenter: no troposphere
            lat, h_m = _geodetic_lat_height(xyz)
            # source altitude = 90 deg - angle(zenith, psr); the geodetic
            # zenith in GCRS comes from rotating the ITRF surface normal
            up_itrf = _geodetic_up(xyz)
            R = itrf_to_gcrs_matrix(utc[m])  # (n,3,3)
            zen = np.einsum("nij,j->ni", R, up_itrf)
            alt = np.pi / 2 - np.arccos(np.clip(zen @ psr, -1.0, 1.0))
            valid = alt >= np.radians(_MIN_ALT_DEG)
            if not np.all(valid):
                log.warning(f"{np.sum(~valid)} TOAs below {_MIN_ALT_DEG} deg "
                            f"altitude at {site}: troposphere delay zeroed")
            # year fraction from MJD (reference _get_year_fraction_fast)
            yf = ((utc[m] - 28.0) % 365.25) / 365.25
            if lat < 0:
                yf = (yf + 0.5) % 1.0
            abs_lat = abs(np.degrees(lat))
            a = _interp_coeff(abs_lat, _A_AVG, _A_AMP, yf)
            b = _interp_coeff(abs_lat, _B_AVG, _B_AMP, yf)
            c = _interp_coeff(abs_lat, _C_AVG, _C_AMP, yf)
            base = _herring_map(alt, a, b, c)
            fcorr = _herring_map(alt, _A_HT, _B_HT, _C_HT)
            hmap = base + (1.0 / np.sin(alt) - fcorr) * (h_m / 1e3)
            aw = np.interp(abs_lat, _LAT, _AW)
            bw = np.interp(abs_lat, _LAT, _BW)
            cw = np.interp(abs_lat, _LAT, _CW)
            wet_map = _herring_map(alt, aw, bw, cw)
            wet_zenith = 0.0  # tempo2 default; hook for weather data
            d = zenith_delay_s(lat, h_m) * hmap + wet_zenith * wet_map
            d = np.where(valid, d, 0.0)
            delay[m] = d
        return delay

    def delay_func(self, pv, batch, ctx, acc_delay):
        d = ctx.get("delay")
        return torch.zeros_like(batch.freq) if d is None else d
