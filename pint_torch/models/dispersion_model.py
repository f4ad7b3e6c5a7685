"""Dispersion delays: the DM Taylor series and DMX windows (port of
``pint_tpu/models/dispersion_model.py:28-313``).

delay = K * DM(t) / f^2 with K = 1/2.41e-4 s MHz^2 cm^3/pc and f the
barycentric frequency.  DMX windows are per-window 0/1 masks built on the
host; the windows are disjoint, so the masked sum below is exact in any
summation order.
"""

from __future__ import annotations

import math

import torch

from pint_torch.models.timing_model import DelayComponent, stack_params

__all__ = ["DispersionDM", "DispersionDMX", "DMconst"]

#: dispersion constant [s MHz^2 cm^3 / pc]
DMconst = 1.0 / 2.41e-4
_DAY_PER_YEAR = 365.25


class Dispersion(DelayComponent):
    category = "dispersion_constant"

    def dispersion_time_delay(self, dm, freq):
        return dm * DMconst / (freq * freq)


class DispersionDM(Dispersion):
    """Config: ``num_dm_terms``, ``has_dmepoch``."""

    register = True

    def base_dm(self, pv, batch):
        n = int(self.config["num_dm_terms"])
        terms = [pv.get("DM", 0.0)] + [pv.get(f"DM{i}", 0.0)
                                       for i in range(1, n)]
        if len(terms) == 1:
            return terms[0] * torch.ones_like(batch.freq)
        if self.config.get("has_dmepoch", False) and "DMEPOCH" in pv:
            dmepoch = pv["DMEPOCH"].hi + pv["DMEPOCH"].lo
        else:
            dmepoch = batch.tdb0
        dt_yr = (batch.tdb.hi - dmepoch) / _DAY_PER_YEAR
        acc = torch.zeros_like(dt_yr)
        for i in range(len(terms) - 1, -1, -1):
            acc = acc * dt_yr + terms[i] / math.factorial(i)
        return acc

    def delay_func(self, pv, batch, ctx, acc_delay):
        freq = self.barycentric_freq(pv, batch)
        return self.dispersion_time_delay(self.base_dm(pv, batch), freq)


class DispersionDMX(Dispersion):
    """Config: ``dmx_indices``; context: ``masks`` (n_dmx, N) of 0/1."""

    register = True
    category = "dispersion_dmx"

    def dmx_dm(self, pv, batch, ctx):
        masks = ctx.get("masks")
        if masks is None:
            return torch.zeros_like(batch.freq)
        names = [f"DMX_{i:04d}" for i in self.config["dmx_indices"]]
        vals = stack_params(pv, names, batch.device)  # (B, n_dmx)
        return vals @ masks

    def delay_func(self, pv, batch, ctx, acc_delay):
        freq = self.barycentric_freq(pv, batch)
        return self.dispersion_time_delay(self.dmx_dm(pv, batch, ctx), freq)
