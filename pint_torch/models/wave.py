"""Tempo-style WAVE sinusoids (port of ``pint_tpu/models/wave.py:20-66``):
phase = F0 sum_k [a_k sin(k om dt) + b_k cos(k om dt)], om = WAVE_OM
[rad/day], dt the barycentric days from WAVEEPOCH, (a_k, b_k) the pair
parameter WAVEk [s]."""

from __future__ import annotations

import torch

from pint_torch.exceptions import MissingParameter
from pint_torch.models.parameter import (MJDParameter, floatParameter,
                                         pairParameter)
from pint_torch.models.timing_model import PhaseComponent
from pint_torch.phase import Phase

__all__ = ["Wave"]

DAY_S = 86400.0


class Wave(PhaseComponent):
    """Config: ``num_wave_terms``; WAVEk are pair parameters."""

    register = True
    category = "wave"

    def declare(self):
        self.add_param(MJDParameter(
            "WAVEEPOCH", description="Reference epoch for wave solution"))
        self.add_param(floatParameter(
            "WAVE_OM", units="rad/d",
            description="Base frequency of wave solution"))
        self.add_param(pairParameter("WAVE1", units="s", continuous=False,
                                     description="Wave sin/cos amplitudes"))

    def setup(self):
        terms = sorted(int(p[4:]) for p in self.params
                       if p.startswith("WAVE") and p[4:].isdigit())
        self.config["num_wave_terms"] = len(terms)
        if terms and terms != list(range(1, max(terms) + 1)):
            missing = min(set(range(1, max(terms) + 1)) - set(terms))
            raise MissingParameter("Wave", f"WAVE{missing}")

    def validate(self):
        if self.WAVE_OM.value is None:
            raise MissingParameter("Wave", "WAVE_OM")
        if self.WAVEEPOCH.value is None:
            pep = self._parent_param("PEPOCH")
            if pep is None or pep.value is None:
                raise MissingParameter("Wave", "WAVEEPOCH",
                                       "WAVEEPOCH or PEPOCH required")
            self.WAVEEPOCH.value = pep.value

    def phase_func(self, pv, batch, ctx, delay):
        ep = pv["WAVEEPOCH"]
        dt_day = (batch.tdb.hi - (ep.hi + ep.lo)) + batch.tdb.lo \
            - delay / DAY_S
        base = pv.get("WAVE_OM", 0.0) * dt_day
        times = torch.zeros_like(dt_day)
        table = self._parent.params_table
        for k in range(1, int(self.config.get("num_wave_terms", 0)) + 1):
            p = table.get(f"WAVE{k}")
            if p is None or p.value is None:
                continue
            a, b = pv[f"WAVE{k}"]
            arg = k * base
            times = times + a * torch.sin(arg) + b * torch.cos(arg)
        return Phase.from_float(times * pv.get("F0", 0.0))
