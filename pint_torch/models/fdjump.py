"""FDJUMP: system-dependent frequency-dependent profile delays (port of
``pint_tpu/models/fdjump.py:26-76``): delay += FDpJUMPq y^p on the
selected TOAs, y = ln(f / 1 GHz) (FDJUMPLOG Y) or f / 1 GHz, f the
topocentric frequency; y^p by the reference's integer-power products."""

from __future__ import annotations

import re

import torch

from pint_torch.models.binary.engines import _ipow
from pint_torch.models.parameter import boolParameter, maskParameter
from pint_torch.models.timing_model import DelayComponent

__all__ = ["FDJump"]

#: the highest FD polynomial index an FDJUMP may carry
fdjump_max_index = 20

_FDJ_RE = re.compile(r"^FD(\d+)JUMP(\d+)")


class FDJump(DelayComponent):
    """Config: ``fdjumps`` (the names with a mask, in the reference's
    order); context: ``masks`` {name: (N,)}; FDJUMPLOG a bool
    parameter."""

    register = True
    category = "fdjump"

    def declare(self):
        self.add_param(boolParameter(
            "FDJUMPLOG", value=True,
            description="Use log-frequency (Y) or linear frequency (N) for "
            "FDJUMPs"))
        # exemplars carry value=None so unset indices select no TOAs
        for j in range(1, fdjump_max_index + 1):
            self.add_param(maskParameter(
                f"FD{j}JUMP", index=1, units="s",
                description=f"System-dependent FD delay of polynomial index "
                f"{j}"))

    def setup(self):
        self.config["fdjumps"] = [p for p in self.params if _FDJ_RE.match(p)]

    def host_context(self, toas):
        """Masks of the FD jumps with a selector or a non-zero value (the
        reference's ``build_context``)."""
        table = self._parent.params_table
        names = [p for p in self.config.get("fdjumps", [])
                 if not (table[p].key is None
                         and table[p].value in (None, 0.0))]
        return {"masks": self._select_masks(toas, names)}

    def delay_func(self, pv, batch, ctx, acc_delay):
        f_ghz = batch.freq / torch.full_like(batch.freq, 1000.0)
        p = self._parent.params_table.get("FDJUMPLOG")
        if p is None or p.value is None or bool(p.value):
            y = torch.log(f_ghz)
            y = torch.where(torch.isfinite(y), y, 0.0)
        else:
            y = f_ghz
        d = torch.zeros_like(batch.freq)
        masks = ctx.get("masks") or {}
        for name in self.config.get("fdjumps", []):
            if name not in masks:
                continue
            k = int(_FDJ_RE.match(name).group(1))
            d = d + pv.get(name, 0.0) * _ipow(y, k) * masks[name]
        return d
