"""Fourier-basis delays: WaveX, DMWaveX and CMWaveX (port of
``pint_tpu/models/wavex.py:25-264``): sum_i SIN_i sin(2 pi f_i dt) +
COS_i cos(2 pi f_i dt), f_i [1/d], dt the barycentric days from the
epoch, term by term in the reference's order (``series``, :125-136); a
delay [s], a DM (delay DMconst DM / f^2) or a chromatic measure (delay
DMconst CM f^-TNCHROMIDX)."""

from __future__ import annotations

import math

import torch

from pint_torch.models.chromatic import chromatic_scale
from pint_torch.models.dispersion_model import DMconst
from pint_torch.exceptions import MissingParameter
from pint_torch.models.parameter import MJDParameter, prefixParameter
from pint_torch.models.timing_model import DelayComponent

__all__ = ["WaveX", "DMWaveX", "CMWaveX"]

DAY_S = 86400.0
_TWO_PI = 2.0 * math.pi


class _WaveXBase(DelayComponent):
    """Config: ``indices``."""

    prefixes = ("WXFREQ_", "WXSIN_", "WXCOS_")
    epoch_name = "WXEPOCH"
    amp_units = "s"

    def declare(self):
        name = type(self).__name__
        fpre, spre, cpre = self.prefixes
        self.add_param(MJDParameter(self.epoch_name,
                                    description=f"{name} reference epoch"))
        self.add_param(prefixParameter(
            f"{fpre}0001", units="1/d",
            description=f"{name} component frequency"))
        self.add_param(prefixParameter(
            f"{spre}0001", units=self.amp_units, value=0.0,
            description=f"{name} sine amplitude"))
        self.add_param(prefixParameter(
            f"{cpre}0001", units=self.amp_units, value=0.0,
            description=f"{name} cosine amplitude"))

    def setup(self):
        pf = self.prefixes[0]
        idx = sorted(int(p[len(pf):]) for p in self.params
                     if p.startswith(pf))
        self.config["indices"] = idx
        # grow missing sine/cosine partners with zero amplitude
        for i in idx:
            for pre in self.prefixes[1:]:
                if f"{pre}{i:04d}" not in self._params_dict:
                    ex = next(self._params_dict[p] for p in self.params
                              if p.startswith(pre))
                    self.add_param(ex.new_param(i, value=0.0))

    def validate(self):
        ep = getattr(self, self.epoch_name)
        if ep.value is None:
            pep = self._parent_param("PEPOCH")
            if pep is None or pep.value is None:
                raise MissingParameter(type(self).__name__, self.epoch_name)
            ep.value = pep.value
        pf = self.prefixes[0]
        for i in self.config["indices"]:
            if self._value(f"{pf}{i:04d}") in (None, 0.0):
                raise MissingParameter(type(self).__name__, f"{pf}{i:04d}")

    def series(self, pv, batch, acc_delay):
        ep = pv[self.epoch_name]
        dt_day = (batch.tdb.hi - (ep.hi + ep.lo)) + batch.tdb.lo \
            - acc_delay / DAY_S
        fpre, spre, cpre = self.prefixes
        out = torch.zeros_like(dt_day)
        for i in self.config.get("indices", []):
            arg = _TWO_PI * pv.get(f"{fpre}{i:04d}", 0.0) * dt_day
            out = out + pv.get(f"{spre}{i:04d}", 0.0) * torch.sin(arg) \
                + pv.get(f"{cpre}{i:04d}", 0.0) * torch.cos(arg)
        return out


class WaveX(_WaveXBase):
    """Achromatic Fourier delay (reference ``wavex.py:139``)."""

    register = True
    category = "wavex"

    def delay_func(self, pv, batch, ctx, acc_delay):
        return self.series(pv, batch, acc_delay)


class DMWaveX(_WaveXBase):
    """Fourier DM (reference ``wavex.py:180``)."""

    register = True
    category = "dmwavex"
    prefixes = ("DMWXFREQ_", "DMWXSIN_", "DMWXCOS_")
    epoch_name = "DMWXEPOCH"
    amp_units = "pc/cm3"

    def dm_func(self, pv, batch, ctx):
        return self.series(pv, batch, torch.zeros_like(batch.freq))

    def delay_func(self, pv, batch, ctx, acc_delay):
        dm = self.series(pv, batch, acc_delay)
        freq = self.barycentric_freq(pv, batch)
        return dm * DMconst / (freq * freq)


class CMWaveX(_WaveXBase):
    """Fourier chromatic measure (reference ``wavex.py:225``)."""

    register = True
    category = "cmwavex"
    prefixes = ("CMWXFREQ_", "CMWXSIN_", "CMWXCOS_")
    epoch_name = "CMWXEPOCH"
    amp_units = "pc/cm3"

    def delay_func(self, pv, batch, ctx, acc_delay):
        cm = self.series(pv, batch, acc_delay)
        freq = self.barycentric_freq(pv, batch)
        return cm * DMconst * chromatic_scale(freq,
                                              pv.get("TNCHROMIDX", 4.0))
