"""Fourier-basis delays: WaveX, DMWaveX and CMWaveX (port of
``pint_tpu/models/wavex.py:25-264``): sum_i SIN_i sin(2 pi f_i dt) +
COS_i cos(2 pi f_i dt), f_i [1/d], dt the barycentric days from the
epoch, term by term in the reference's order (``series``, :125-136); a
delay [s], a DM (delay DMconst DM / f^2) or a chromatic measure (delay
DMconst CM f^-TNCHROMIDX)."""

from __future__ import annotations

import math

import numpy as np
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
                if f"{pre}{i:04d}" not in self.params:
                    self.add_param(self._exemplar(pre).new_param(
                        i, value=0.0))

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

    # -- adding and removing terms (reference ``wavex.py:63-123``) -------
    def get_indices(self) -> np.ndarray:
        """The indices of the terms in use."""
        return np.array(self.config["indices"])

    def _exemplar(self, pre):
        """A member of the ``pre`` family (any: index 1 may be gone)."""
        for p in self.params:
            if p.startswith(pre):
                return self._param_obj(p)
        raise KeyError(f"No {pre} parameter left to use as an exemplar")

    def _add_component(self, freq, index=None, sin=0.0, cos=0.0,
                       frozen=True):
        fpre, spre, cpre = self.prefixes
        if index is None:
            index = max(self.config["indices"], default=0) + 1
        index = int(index)
        if f"{fpre}{index:04d}" in self.params \
                and self._value(f"{fpre}{index:04d}") is not None:
            raise ValueError(f"Index {index} already in use ({fpre})")
        table = self._parent.params_table
        for pre, val, fr in ((fpre, float(freq), True),
                             (spre, float(sin), frozen),
                             (cpre, float(cos), frozen)):
            nm = f"{pre}{index:04d}"
            if nm in self.params:
                table[nm].value = val
                if pre != fpre:
                    table[nm].frozen = bool(fr)
            else:
                self.add_param(self._exemplar(pre).new_param(
                    index, value=val, frozen=bool(fr)))
        self.setup()
        self._parent._edited()
        return index

    def _remove_component(self, index) -> None:
        idxs = {int(i) for i in np.atleast_1d(index)}
        if idxs >= set(self.config["indices"]):
            raise ValueError(
                "Removing the last component would leave the model unable "
                "to evaluate; delete the component instead")
        for idx in idxs:
            for pre in self.prefixes:
                self.remove_param(f"{pre}{idx:04d}")
        self.setup()
        self._parent._edited()

    def _add_components(self, freqs, indices=None, sins=0.0, coses=0.0,
                        frozens=True):
        freqs = np.atleast_1d(freqs)
        n = len(freqs)
        if indices is None:
            start = max(self.config["indices"], default=0)
            indices = list(range(start + 1, start + 1 + n))
        sins = np.broadcast_to(np.atleast_1d(sins), (n,))
        coses = np.broadcast_to(np.atleast_1d(coses), (n,))
        frozens = np.broadcast_to(np.atleast_1d(frozens), (n,))
        if len(set(int(i) for i in indices)) != n:
            raise ValueError("Duplicate indices in add_components")
        return [self._add_component(f, index=int(i), sin=si, cos=c,
                                    frozen=bool(fr))
                for f, i, si, c, fr in zip(freqs, indices, sins, coses,
                                           frozens)]

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

    def add_wavex_component(self, wxfreq, index=None, wxsin=0,
                            wxcos=0, frozen=True):
        """Add one term (frequency [1/d], sine and cosine amplitudes,
        their ``frozen``); returns its index."""
        return self._add_component(wxfreq, index=index, sin=wxsin,
                                   cos=wxcos, frozen=frozen)

    def add_wavex_components(self, wxfreqs, indices=None, wxsins=0,
                             wxcoses=0, frozens=True):
        """Add several terms; returns their indices."""
        return self._add_components(wxfreqs, indices=indices,
                                    sins=wxsins, coses=wxcoses,
                                    frozens=frozens)

    def remove_wavex_component(self, index):
        """Remove the term(s) ``index``."""
        self._remove_component(index)


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

    def add_dmwavex_component(self, dmwxfreq, index=None, dmwxsin=0,
                              dmwxcos=0, frozen=True):
        """Add one term (frequency [1/d], sine and cosine amplitudes,
        their ``frozen``); returns its index."""
        return self._add_component(dmwxfreq, index=index, sin=dmwxsin,
                                   cos=dmwxcos, frozen=frozen)

    def add_dmwavex_components(self, dmwxfreqs, indices=None, dmwxsins=0,
                               dmwxcoses=0, frozens=True):
        """Add several terms; returns their indices."""
        return self._add_components(dmwxfreqs, indices=indices,
                                    sins=dmwxsins, coses=dmwxcoses,
                                    frozens=frozens)

    def remove_dmwavex_component(self, index):
        """Remove the term(s) ``index``."""
        self._remove_component(index)


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

    def add_cmwavex_component(self, cmwxfreq, index=None, cmwxsin=0,
                              cmwxcos=0, frozen=True):
        """Add one term (frequency [1/d], sine and cosine amplitudes,
        their ``frozen``); returns its index."""
        return self._add_component(cmwxfreq, index=index, sin=cmwxsin,
                                   cos=cmwxcos, frozen=frozen)

    def add_cmwavex_components(self, cmwxfreqs, indices=None, cmwxsins=0,
                               cmwxcoses=0, frozens=True):
        """Add several terms; returns their indices."""
        return self._add_components(cmwxfreqs, indices=indices,
                                    sins=cmwxsins, coses=cmwxcoses,
                                    frozens=frozens)

    def remove_cmwavex_component(self, index):
        """Remove the term(s) ``index``."""
        self._remove_component(index)
