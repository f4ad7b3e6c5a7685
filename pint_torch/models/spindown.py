"""Spindown: Taylor-series pulse phase F0, F1, ... (port of
``pint_tpu/models/spindown.py:67-123``).

dt = (tdb - delay) - PEPOCH is split into exact float64 fold components
and a small tail; F0 times each fold is folded mod 1 exactly, and the rest
goes into the fraction.  The whole composition is kernel K1
(:mod:`pint_torch.kernels.spin_phase`).
"""

from __future__ import annotations

import torch

from pint_torch import F64
from pint_torch.exceptions import MissingParameter
from pint_torch.kernels.spin_phase import spin_phase
from pint_torch.models.parameter import MJDParameter, prefixParameter
from pint_torch.models.timing_model import PhaseComponent, stack_params
from pint_torch.phase import Phase

__all__ = ["Spindown"]


class Spindown(PhaseComponent):
    """Config: ``num_spin_terms``, ``has_pepoch``."""

    register = True
    category = "spindown"

    def declare(self):
        self.add_param(prefixParameter("F0", units="Hz",
                                       description="Spin frequency"))
        self.add_param(prefixParameter(
            "F1", units="Hz/s", description="Spin frequency derivative"))
        self.add_param(MJDParameter("PEPOCH",
                                    description="Epoch of spin parameters"))

    def setup(self):
        idxs = sorted(int(name[1:]) for name in self.params
                      if name.startswith("F") and name[1:].isdigit())
        self.config["num_spin_terms"] = len(idxs)
        if idxs != list(range(len(idxs))):
            missing = min(set(range(max(idxs) + 1)) - set(idxs))
            raise MissingParameter("Spindown", f"F{missing}",
                                   "Spin terms F0..Fn must be contiguous")

    def finish_config(self):
        self._finish_epoch("has_pepoch", "PEPOCH")

    def validate(self):
        if self.F0.value is None:
            raise MissingParameter("Spindown", "F0")

    def phase_func(self, pv, batch, ctx, delay) -> Phase:
        S = int(self.config["num_spin_terms"])
        F = stack_params(pv, [f"F{i}" for i in range(S)], batch.device)
        has_pe = bool(self.config.get("has_pepoch", True)) and "PEPOCH" in pv
        pe = pv.get("PEPOCH") if has_pe else None
        hi, lo = (pe.hi, pe.lo) if pe is not None else (0.0, 0.0)
        # filled on the device, not copied from the host: an evaluation
        # may be captured in a CUDA graph (the fused grid sweep)
        pepoch = torch.full((1, 2), float(hi), dtype=F64,
                            device=batch.device)
        pepoch[:, 1] = float(lo)
        if delay.ndim == 1:
            delay = delay.unsqueeze(0)
        k, f = spin_phase(batch.tdb_s.hi, batch.tdb_s.lo, batch.tdb0, pepoch,
                          delay, F, has_pepoch=has_pe)
        return Phase(k, f)
