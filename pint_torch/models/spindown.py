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
from pint_torch.kernels.spin_phase import spin_phase
from pint_torch.models.timing_model import PhaseComponent, stack_params
from pint_torch.phase import Phase

__all__ = ["Spindown"]


class Spindown(PhaseComponent):
    """Config: ``num_spin_terms``, ``has_pepoch``."""

    register = True
    category = "spindown"

    def phase_func(self, pv, batch, ctx, delay) -> Phase:
        S = int(self.config["num_spin_terms"])
        F = stack_params(pv, [f"F{i}" for i in range(S)], batch.device)
        has_pe = bool(self.config.get("has_pepoch", True)) and "PEPOCH" in pv
        pe = pv.get("PEPOCH") if has_pe else None
        pepoch = torch.tensor([[pe.hi, pe.lo] if pe is not None
                               else [0.0, 0.0]], dtype=F64,
                              device=batch.device)
        if delay.ndim == 1:
            delay = delay.unsqueeze(0)
        k, f = spin_phase(batch.tdb_s.hi, batch.tdb_s.lo, batch.tdb0, pepoch,
                          delay, F, has_pepoch=has_pe)
        return Phase(k, f)
