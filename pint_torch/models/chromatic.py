"""Chromatic (nu^-alpha) delays: the ChromaticCM Taylor series and the
CMX windows (port of ``pint_tpu/models/chromatic.py``):
delay = CM(t) DMconst f^-TNCHROMIDX, f the barycentric frequency [MHz],
CM a Taylor series in years about CMEPOCH plus 0/1-masked CMX_ offsets in
disjoint windows."""

from __future__ import annotations

import math

import torch

from pint_torch.exceptions import MissingParameter
from pint_torch.models.dispersion_model import DMconst, _check_ranges
from pint_torch.models.parameter import (MJDParameter, floatParameter,
                                         prefixParameter)
from pint_torch.models.timing_model import (DelayComponent,
                                            check_contiguous_indices,
                                            stack_params)

__all__ = ["ChromaticCM", "ChromaticCMX", "chromatic_scale"]

_DAY_PER_YEAR = 365.25


def chromatic_scale(freq, alpha):
    """f^-alpha by one power with a tensor exponent, as the reference's
    ``jnp.power`` (no square or reciprocal shortcut for integral alpha)."""
    ex = -alpha if torch.is_tensor(alpha) \
        else torch.full((), -float(alpha), dtype=freq.dtype,
                        device=freq.device)
    return torch.pow(freq, ex)


class Chromatic(DelayComponent):
    category = "chromatic_constant"

    def chromatic_time_delay(self, cm, alpha, freq):
        return cm * DMconst * chromatic_scale(freq, alpha)


class ChromaticCM(Chromatic):
    """Reference ``chromatic.py:32-88``.  Config: ``num_cm_terms``,
    ``has_cmepoch``."""

    register = True

    def declare(self):
        p = prefixParameter("CM0", units="pc/cm3", value=0.0,
                            description="Chromatic measure")
        p.name, p.prefix, p.index = "CM", "CM", 0
        self.add_param(p)
        self.add_param(prefixParameter(
            "CM1", units="pc/cm3/yr", value=0.0,
            description="Chromatic measure derivative"))
        self.add_param(floatParameter("TNCHROMIDX", units="", value=4.0,
                                      description="Chromatic index alpha"))
        self.add_param(MJDParameter("CMEPOCH",
                                    description="Epoch of CM measurement"))

    def setup(self):
        idxs = [0] + sorted(int(n[2:]) for n in self.params
                            if n.startswith("CM") and n[2:].isdigit())
        check_contiguous_indices(idxs, "ChromaticCM", "CM")
        self.config["num_cm_terms"] = len(idxs)

    def finish_config(self):
        self._finish_epoch("has_cmepoch", "CMEPOCH")

    def validate(self):
        higher = any(self._value(f"CM{i}")
                     for i in range(1, self.config["num_cm_terms"]))
        if higher and self.CMEPOCH.value is None:
            pep = self._parent_param("PEPOCH")
            if pep is not None and pep.value is not None:
                self.CMEPOCH.value = pep.value
            else:
                raise MissingParameter("ChromaticCM", "CMEPOCH")

    def base_cm(self, pv, batch):
        n = int(self.config.get("num_cm_terms", 1))
        terms = [pv.get("CM", 0.0)] + [pv.get(f"CM{i}", 0.0)
                                       for i in range(1, n)]
        if len(terms) == 1:
            return terms[0] * torch.ones_like(batch.freq)
        if self.config.get("has_cmepoch", False) and "CMEPOCH" in pv:
            ep = pv["CMEPOCH"].hi + pv["CMEPOCH"].lo
        else:
            ep = batch.tdb0
        dt_yr = (batch.tdb.hi - ep) / _DAY_PER_YEAR
        acc = torch.zeros_like(dt_yr)
        for i in range(len(terms) - 1, -1, -1):
            acc = acc * dt_yr + terms[i] / math.factorial(i)
        return acc

    def delay_func(self, pv, batch, ctx, acc_delay):
        freq = self.barycentric_freq(pv, batch)
        return self.chromatic_time_delay(self.base_cm(pv, batch),
                                         pv.get("TNCHROMIDX", 4.0), freq)


class ChromaticCMX(Chromatic):
    """Piecewise chromatic offsets (reference ``chromatic.py:90-131``).
    Config: ``cmx_indices``; context: ``masks`` (n, N) of 0/1."""

    register = True
    category = "chromatic_cmx"

    def declare(self):
        self.add_param(prefixParameter("CMX_0001", units="pc/cm3", value=0.0,
                                       description="CM offset in range"))
        self.add_param(prefixParameter("CMXR1_0001", units="MJD",
                                       description="Range start MJD"))
        self.add_param(prefixParameter("CMXR2_0001", units="MJD",
                                       description="Range end MJD"))

    def setup(self):
        self.config["cmx_indices"] = sorted(
            int(n[4:]) for n in self.params if n.startswith("CMX_"))

    def validate(self):
        _check_ranges(self, "ChromaticCMX", self.config["cmx_indices"],
                      ("CMXR1_", "CMXR2_"))

    def host_context(self, toas):
        return {"masks": self._range_masks(toas, self.config["cmx_indices"],
                                           "CMXR1_", "CMXR2_")}

    def delay_func(self, pv, batch, ctx, acc_delay):
        masks = ctx.get("masks")
        if masks is None:
            return torch.zeros_like(batch.freq)
        names = [f"CMX_{i:04d}" for i in self.config["cmx_indices"]]
        cm = stack_params(pv, names, batch.device) @ masks
        freq = self.barycentric_freq(pv, batch)
        return self.chromatic_time_delay(cm, pv.get("TNCHROMIDX", 4.0), freq)
