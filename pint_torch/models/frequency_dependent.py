"""FD: polynomial-in-log-frequency profile-evolution delay (port of
``pint_tpu/models/frequency_dependent.py``):
delay = sum_{i>=1} FD_i ln(f_bary / 1 GHz)^i [s]."""

from __future__ import annotations

import torch

from pint_torch.models.parameter import prefixParameter
from pint_torch.models.timing_model import (DelayComponent,
                                            check_contiguous_indices)

__all__ = ["FD"]


class FD(DelayComponent):
    """Config: ``num_FD_terms``."""

    register = True
    category = "frequency_dependent"

    def declare(self):
        self.add_param(prefixParameter(
            "FD1", units="s", value=0.0,
            description="Log-frequency polynomial delay coefficient"))

    def setup(self):
        terms = sorted(int(p[2:]) for p in self.params
                       if p.startswith("FD") and p[2:].isdigit())
        self.config["num_FD_terms"] = len(terms)
        if terms:
            check_contiguous_indices(terms, "FD", "FD", start=1)

    def delay_func(self, pv, batch, ctx, acc_delay):
        freq = self.barycentric_freq(pv, batch)
        log_f = torch.log(freq / 1000.0)
        log_f = torch.where(torch.isfinite(log_f), log_f, 0.0)
        acc = torch.zeros_like(batch.freq)
        for i in range(int(self.config["num_FD_terms"]), 0, -1):
            acc = (acc + pv.get(f"FD{i}", 0.0)) * log_f
        return acc
