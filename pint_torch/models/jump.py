"""Phase jumps between receiver/backend groups (port of
``pint_tpu/models/jump.py:19-47``): JUMPs are mask parameters whose 0/1
masks are built on the host."""

from __future__ import annotations

import torch

from pint_torch.models.timing_model import PhaseComponent
from pint_torch.phase import Phase

__all__ = ["PhaseJump"]


class PhaseJump(PhaseComponent):
    """Config: ``jumps`` (names); context: ``masks`` {name: (N,)}."""

    register = True
    category = "phase_jump"

    def phase_func(self, pv, batch, ctx, delay) -> Phase:
        jphase = torch.zeros_like(batch.freq)
        F0 = pv.get("F0", 0.0)
        for j in self.config["jumps"]:
            jphase = jphase + pv.get(j, 0.0) * F0 * ctx["masks"][j]
        return Phase.from_float(jphase)

