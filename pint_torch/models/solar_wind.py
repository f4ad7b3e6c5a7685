"""Solar-wind dispersion (port of ``pint_tpu/models/solar_wind.py``):
the NE_SW spherical model (SWM 0, Edwards et al. 2006 eq. 29-30), the
power-law model (SWM 1, Hazboun et al. 2022 eq. 11) and the piecewise SWX
windows; each with its ``dm_func``, the DM it adds for wideband DM
measurements.

The power-law geometry -- a 64-node Gauss-Legendre path integral per TOA
and per point -- is kernel K7 (:mod:`pint_torch.kernels.solar_wind_pl`):
one launch for NE_SW's SWP, one for all SWX windows (each TOA's geometry
at its own window's SWXP_) and one for the windows' conjunction and
opposition values (2 W "TOAs" at 1 AU, one per window and side).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pint_torch.kernels.solar_wind_pl import (AU_LS, PC_LS, solar_wind_pl,
                                              sw_i_inf)
from pint_torch.models.astrometry import _rowsum
from pint_torch.models.dispersion_model import DMconst
from pint_torch.exceptions import MissingParameter
from pint_torch.models.dispersion_model import _check_ranges
from pint_torch.models.parameter import (MJDParameter, floatParameter,
                                         prefixParameter)
from pint_torch.models.timing_model import (DelayComponent,
                                            check_contiguous_indices,
                                            stack_params)

__all__ = ["SolarWindDispersion", "SolarWindDispersionX"]

_DAY_PER_YEAR = 365.25


def solar_wind_geometry_spherical(r_ls, elongation):
    """Edwards et al. (2006) eq. 29-30 geometry in parsecs (reference
    ``solar_wind.py:73``)."""
    rho = math.pi - elongation
    return (AU_LS**2) * rho / (r_ls * torch.sin(rho)) / PC_LS


class _SolarWind(DelayComponent):
    def _theta_r(self, pv, batch):
        """(elongation (B, N), observatory-Sun distance (N,) [ls])."""
        astro = next((c for c in self._parent.components.values()
                      if hasattr(c, "sun_angle")), None)
        if astro is None:
            raise ValueError(f"{type(self).__name__} needs an astrometry "
                             "component")
        theta = astro.sun_angle(pv, batch)
        sun = batch.obs_sun_pos
        return (theta if theta.ndim == 2 else theta.unsqueeze(0),
                torch.sqrt(_rowsum(sun * sun)))


class SolarWindDispersion(_SolarWind):
    """NE_SW (with its Taylor series about SWEPOCH) times the geometry of
    SWM 0 or 1 (reference ``solar_wind.py:111-178``).  Config:
    ``num_ne_sw_terms``, ``swm``, ``has_swepoch``."""

    register = True
    category = "solar_wind"

    def declare(self):
        p = prefixParameter("NE_SW0", units="cm^-3", value=0.0,
                            description="Solar wind electron density at 1 AU",
                            aliases=["NE1AU", "SOLARN0"])
        p.name, p.prefix, p.index = "NE_SW", "NE_SW", 0
        self.add_param(p)
        self.add_param(prefixParameter("NE_SW1", units="cm^-3/yr", value=0.0,
                                       description="NE_SW derivative"))
        self.add_param(MJDParameter("SWEPOCH", description="Epoch of NE_SW"))
        self.add_param(floatParameter(
            "SWM", units="", value=0.0, continuous=False,
            description="Solar wind model (0 spherical, 1 power-law)"))
        self.add_param(floatParameter(
            "SWP", units="", value=2.0,
            description="Solar wind power-law index (SWM=1)"))

    def setup(self):
        idxs = [0] + sorted(int(n[5:]) for n in self.params
                            if n.startswith("NE_SW") and n[5:].isdigit())
        check_contiguous_indices(idxs, "SolarWindDispersion", "NE_SW")
        self.config["num_ne_sw_terms"] = len(idxs)

    def finish_config(self):
        self.config["swm"] = int(self._value("SWM") or 0)
        self._finish_epoch("has_swepoch", "SWEPOCH")

    def validate(self):
        if int(self.SWM.value or 0) not in (0, 1):
            raise MissingParameter("SolarWindDispersion", "SWM",
                                   f"SWM={self.SWM.value} not implemented")
        higher = any(self._value(f"NE_SW{i}")
                     for i in range(1, self.config["num_ne_sw_terms"]))
        if higher and self.SWEPOCH.value is None:
            raise MissingParameter("SolarWindDispersion", "SWEPOCH")

    def ne_sw(self, pv, batch):
        n = int(self.config.get("num_ne_sw_terms", 1))
        terms = [pv.get("NE_SW", 0.0)] + [pv.get(f"NE_SW{i}", 0.0)
                                          for i in range(1, n)]
        if len(terms) == 1:
            return terms[0] * torch.ones_like(batch.freq)
        if self.config.get("has_swepoch", False) and "SWEPOCH" in pv:
            ep = pv["SWEPOCH"].hi + pv["SWEPOCH"].lo
        else:
            ep = batch.tdb0
        dt_yr = (batch.tdb.hi - ep) / _DAY_PER_YEAR
        acc = torch.zeros_like(dt_yr)
        for i in range(len(terms) - 1, -1, -1):
            acc = acc * dt_yr + terms[i] / math.factorial(i)
        return acc

    def geometry(self, pv, batch):
        """The geometry [pc] at n_earth = 1 cm^-3, (B, N)."""
        theta, r = self._theta_r(pv, batch)
        if int(self.config.get("swm", 0)) == 0:
            return solar_wind_geometry_spherical(r, theta)
        p = stack_params(pv, ["SWP"], batch.device) if "SWP" in pv \
            else torch.full((1, 1), 2.0, dtype=theta.dtype,
                            device=theta.device)
        return solar_wind_pl(r, theta, p, sw_i_inf(p))

    def dm_func(self, pv, batch, ctx):
        return self.ne_sw(pv, batch) * self.geometry(pv, batch)

    def delay_func(self, pv, batch, ctx, acc_delay):
        freq = self.barycentric_freq(pv, batch)
        return self.dm_func(pv, batch, ctx) * DMconst / (freq * freq)


class SolarWindDispersionX(_SolarWind):
    """Piecewise solar-wind DM (reference ``solar_wind.py:181-300``):
    SWXDM_ scaled per window by (g - g_opp) / (g_conj - g_opp) at the
    window's SWXP_, g_conj and g_opp at 1 AU and the conjunction's and
    opposition's elongation ``theta0``.  Config: ``swx_indices``; context:
    ``masks`` (n, N) of 0/1 and ``theta0``."""

    register = True
    category = "solar_windx"

    def declare(self):
        self.add_param(prefixParameter(
            "SWXDM_0001", units="pc/cm3", value=0.0,
            description="Max solar-wind DM in range"))
        self.add_param(prefixParameter(
            "SWXP_0001", units="", value=2.0,
            description="Radial power-law index in range"))
        self.add_param(prefixParameter("SWXR1_0001", units="MJD",
                                       description="Range start MJD"))
        self.add_param(prefixParameter("SWXR2_0001", units="MJD",
                                       description="Range end MJD"))

    def setup(self):
        idx = sorted(int(n[6:]) for n in self.params
                     if n.startswith("SWXDM_"))
        self.config["swx_indices"] = idx
        for i in idx:
            if f"SWXP_{i:04d}" not in self._params_dict:
                self.add_param(self._params_dict["SWXP_0001"].new_param(
                    i, value=2.0))

    def validate(self):
        _check_ranges(self, "SolarWindDispersionX",
                      self.config["swx_indices"], ("SWXR1_", "SWXR2_"))

    def remove_swx_range(self, index) -> None:
        """Remove the SWX bin(s) ``index``: their SWXDM_, SWXP_, SWXR1_
        and SWXR2_ parameters; ValueError for an index not in the
        model."""
        indices = [index] if isinstance(index, (int, np.integer)) \
            else list(index)
        for i in indices:
            i = int(i)
            if f"SWXDM_{i:04d}" not in self.params:
                raise ValueError(f"Index {i} not in SWX model")
            for pre in ("SWXDM_", "SWXP_", "SWXR1_", "SWXR2_"):
                self.remove_param(f"{pre}{i:04d}")
        self.setup()
        if self._parent is not None:
            self._parent.setup()

    def host_context(self, toas):
        return {"masks": self._range_masks(toas, self.config["swx_indices"],
                                           "SWXR1_", "SWXR2_"),
                "theta0": self._theta0()}

    def _theta0(self) -> float:
        """The conjunction's elongation from the pulsar's ecliptic latitude
        on a circular Earth orbit (reference ``solar_wind.py:96-108``)."""
        from pint_torch.pulsar_ecliptic import OBL_IERS2010_RAD

        astro = next(c for c in self._parent.components.values()
                     if hasattr(c, "coords_as_ICRS"))
        ra, dec = astro.coords_as_ICRS()
        v = np.array([np.cos(dec) * np.cos(ra), np.cos(dec) * np.sin(ra),
                      np.sin(dec)])
        ce, se = np.cos(OBL_IERS2010_RAD), np.sin(OBL_IERS2010_RAD)
        z_ecl = -se * v[1] + ce * v[2]
        beta = abs(float(np.arcsin(np.clip(z_ecl, -1, 1))))
        return max(beta, 1e-3)

    def _layers(self, ctx):
        """Each TOA's window index (-1: none), one layer per window a TOA
        belongs to: one layer where the windows are disjoint; a TOA in
        several windows adds them in window order, as the reference's sum
        does."""
        masks = ctx["masks"]
        cache = self.__dict__.setdefault("_layer_cache", {})
        hit = cache.get(id(masks))
        if hit is not None and hit[0] is masks:
            return hit[1]
        member = masks > 0.5
        rank = torch.cumsum(member.to(torch.int64), dim=0) * member
        widx = torch.arange(masks.shape[0], device=masks.device)[:, None]
        layers = []
        for d in range(1, int(rank.max()) + 1 if masks.numel() else 1):
            at = rank == d
            layers.append(torch.where(at.any(dim=0), (widx * at).sum(dim=0),
                                      -1))
        cache[id(masks)] = (masks, layers)
        return layers

    def swx_dm(self, pv, batch, ctx):
        theta, r = self._theta_r(pv, batch)
        idx = self.config["swx_indices"]
        p = stack_params(pv, [f"SWXP_{i:04d}" for i in idx], batch.device)
        vals = stack_params(pv, [f"SWXDM_{i:04d}" for i in idx],
                            batch.device)
        # read on the device, not on the host: an evaluation may be
        # captured in a CUDA graph (the fused grid sweep)
        theta0 = ctx["theta0"].to(dtype=p.dtype).reshape(1)
        i_inf = sw_i_inf(p)
        # conjunction and opposition at 1 AU: window k's at "TOAs" k and
        # W + k
        W = p.shape[1]
        ends = torch.cat([theta0.expand(W), (math.pi - theta0).expand(W)])
        g = solar_wind_pl(torch.full_like(ends, AU_LS), ends[None], p, i_inf,
                          torch.arange(2 * W, device=p.device) % W)
        g_conj, g_opp = g[:, :W], g[:, W:]
        dm = torch.zeros_like(theta)
        for win in self._layers(ctx):
            g = solar_wind_pl(r, theta, p, i_inf, win)
            w = win.clamp(min=0)
            go = g_opp[:, w]
            scale = (g - go) / (g_conj[:, w] - go)
            dm = dm + torch.where(win >= 0, vals[:, w] * scale, 0.0)
        return dm

    def dm_func(self, pv, batch, ctx):
        if ctx.get("masks") is None or not self.config.get("swx_indices"):
            return torch.zeros_like(batch.freq)
        return self.swx_dm(pv, batch, ctx)

    def delay_func(self, pv, batch, ctx, acc_delay):
        if ctx.get("masks") is None or not self.config.get("swx_indices"):
            return torch.zeros_like(batch.freq)
        freq = self.barycentric_freq(pv, batch)
        return self.swx_dm(pv, batch, ctx) * DMconst / (freq * freq)
