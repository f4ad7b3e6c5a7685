"""Dispersion delays: the DM Taylor series, DMX windows, DMJUMP and
FDJUMPDM (port of ``pint_tpu/models/dispersion_model.py:28-400``), each
with its ``dm_func``, the DM it adds [pc/cm^3] that
``TimingModel.total_dm`` sums for wideband DM measurements.

delay = K * DM(t) / f^2 with K = 1/2.41e-4 s MHz^2 cm^3/pc and f the
barycentric frequency.  DMX windows are per-window 0/1 masks built on the
host; the windows are disjoint, so the masked sum below is exact in any
summation order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pint_torch.exceptions import MissingParameter
from pint_torch.models.parameter import (MJDParameter, floatParameter,
                                         maskParameter, prefixParameter)
from pint_torch.models.timing_model import (DelayComponent,
                                            check_contiguous_indices,
                                            stack_params)

__all__ = ["DispersionDM", "DispersionDMX", "DispersionJump", "FDJumpDM",
           "DMconst"]

#: dispersion constant [s MHz^2 cm^3 / pc]
DMconst = 1.0 / 2.41e-4
_DAY_PER_YEAR = 365.25


def _check_ranges(comp, name, indices, prefixes) -> None:
    """Each window ``i`` has its ``<prefix>_<i:04d>`` bounds set (the
    reference's DMX/CMX/SWX ``validate``)."""
    for i in indices:
        for pre in prefixes:
            if comp._value(f"{pre}{i:04d}") is None:
                raise MissingParameter(name, f"{pre}{i:04d}")


class Dispersion(DelayComponent):
    category = "dispersion_constant"

    def dispersion_time_delay(self, dm, freq):
        return dm * DMconst / (freq * freq)


class DispersionDM(Dispersion):
    """Config: ``num_dm_terms``, ``has_dmepoch``."""

    register = True

    def declare(self):
        dm0 = prefixParameter("DM0", units="pc/cm3",
                              description="Dispersion measure")
        # DM is the canonical name for index 0
        dm0.name, dm0.prefix, dm0.index = "DM", "DM", 0
        self.add_param(dm0)
        self.add_param(prefixParameter("DM1", units="pc/cm3/yr", value=0.0,
                                       description="DM derivative"))
        self.add_param(MJDParameter("DMEPOCH",
                                    description="Epoch of DM measurement"))

    def setup(self):
        idxs = [0] + sorted(int(n[2:]) for n in self.params
                            if n.startswith("DM") and n[2:].isdigit())
        check_contiguous_indices(idxs, "DispersionDM", "DM")
        self.config["num_dm_terms"] = len(idxs)

    def finish_config(self):
        self._finish_epoch("has_dmepoch", "DMEPOCH")

    def validate(self):
        if self.DM.value is None:
            raise MissingParameter("DispersionDM", "DM")
        higher = any(self._value(f"DM{i}")
                     for i in range(1, self.config["num_dm_terms"]))
        if higher and self.DMEPOCH.value is None:
            pep = self._parent_param("PEPOCH")
            if pep is not None and pep.value is not None:
                self.DMEPOCH.value = pep.value
            else:
                raise MissingParameter("DispersionDM", "DMEPOCH")

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

    def dm_func(self, pv, batch, ctx):
        return self.base_dm(pv, batch)

    def delay_func(self, pv, batch, ctx, acc_delay):
        freq = self.barycentric_freq(pv, batch)
        return self.dispersion_time_delay(self.base_dm(pv, batch), freq)


class DispersionDMX(Dispersion):
    """Config: ``dmx_indices``; context: ``masks`` (n_dmx, N) of 0/1."""

    register = True
    category = "dispersion_dmx"

    def declare(self):
        # bare DMX: the nominal bin width [d] (informational)
        self.add_param(floatParameter("DMX", units="d", frozen=True,
                                      description="Nominal DMX bin width"))
        self.add_param(prefixParameter("DMX_0001", units="pc/cm3", value=0.0,
                                       description="DM offset in range"))
        self.add_param(prefixParameter("DMXR1_0001", units="MJD",
                                       description="Range start MJD"))
        self.add_param(prefixParameter("DMXR2_0001", units="MJD",
                                       description="Range end MJD"))

    def setup(self):
        self.config["dmx_indices"] = sorted(
            int(n[4:]) for n in self.params if n.startswith("DMX_"))

    def validate(self):
        _check_ranges(self, "DispersionDMX", self.config["dmx_indices"],
                      ("DMXR1_", "DMXR2_"))

    def host_context(self, toas):
        return {"masks": self._range_masks(toas, self.config["dmx_indices"],
                                           "DMXR1_", "DMXR2_")}

    def remove_DMX_range(self, index) -> None:
        """Remove the DMX bin(s) ``index`` (an index or a list of them):
        their DMX_, DMXR1_ and DMXR2_ parameters; ValueError for an index
        not in the model."""
        indices = [index] if isinstance(index, (int, np.integer)) \
            else list(index)
        for i in indices:
            i = int(i)
            if f"DMX_{i:04d}" not in self.params:
                raise ValueError(f"Index {i} not in DMX model")
            for pre in ("DMX_", "DMXR1_", "DMXR2_"):
                self.remove_param(f"{pre}{i:04d}")
        self.setup()
        if self._parent is not None:
            self._parent.setup()

    def dmx_dm(self, pv, batch, ctx):
        masks = ctx.get("masks")
        if masks is None:
            return torch.zeros_like(batch.freq)
        names = [f"DMX_{i:04d}" for i in self.config["dmx_indices"]]
        vals = stack_params(pv, names, batch.device)  # (B, n_dmx)
        return vals @ masks

    def dm_func(self, pv, batch, ctx):
        return self.dmx_dm(pv, batch, ctx)

    def delay_func(self, pv, batch, ctx, acc_delay):
        freq = self.barycentric_freq(pv, batch)
        return self.dispersion_time_delay(self.dmx_dm(pv, batch, ctx), freq)


class DispersionJump(Dispersion):
    """DMJUMP (reference ``dispersion_model.py:316-355``): offsets of the
    wideband DM measurements only, so no delay.  Config: ``dm_jumps``;
    context: ``masks`` {name: (N,)}."""

    register = True
    category = "dispersion_jump"

    def declare(self):
        self.add_param(maskParameter(
            "DMJUMP", index=1, units="pc/cm3", value=0.0,
            description="DM offset for selected TOAs"))

    def setup(self):
        self.config["dm_jumps"] = [p for p in self.params
                                   if p.startswith("DMJUMP")]

    def host_context(self, toas):
        return {"masks": self._select_masks(toas,
                                            self.config.get("dm_jumps", []))}

    def jump_dm(self, pv, batch, ctx):
        out = torch.zeros_like(batch.freq)
        for j in self.config.get("dm_jumps", []):
            out = out - pv.get(j, 0.0) * ctx["masks"][j]
        return out

    def dm_func(self, pv, batch, ctx):
        return self.jump_dm(pv, batch, ctx)

    def delay_func(self, pv, batch, ctx, acc_delay):
        return torch.zeros_like(batch.freq)


class FDJumpDM(Dispersion):
    """FDJUMPDM (reference ``dispersion_model.py:358-400``): system DM
    offsets that disperse the TOAs, dm = -FDJUMPDM on the selected ones.
    Config: ``fdjump_dms``; context: ``masks`` {name: (N,)}."""

    register = True
    category = "fdjumpdm"

    def declare(self):
        self.add_param(maskParameter(
            "FDJUMPDM", index=1, units="pc/cm3", value=0.0,
            description="System-dependent DM offset"))

    def setup(self):
        self.config["fdjump_dms"] = [p for p in self.params
                                     if p.startswith("FDJUMPDM")]

    def host_context(self, toas):
        return {"masks": self._select_masks(
            toas, self.config.get("fdjump_dms", []))}

    def fdjump_dm(self, pv, batch, ctx):
        out = torch.zeros_like(batch.freq)
        for j in self.config.get("fdjump_dms", []):
            out = out - pv.get(j, 0.0) * ctx["masks"][j]
        return out

    def dm_func(self, pv, batch, ctx):
        return self.fdjump_dm(pv, batch, ctx)

    def delay_func(self, pv, batch, ctx, acc_delay):
        freq = self.barycentric_freq(pv, batch)
        return self.dispersion_time_delay(self.fdjump_dm(pv, batch, ctx),
                                          freq)
