"""Phase jumps between receiver/backend groups and tempo-style delay
jumps (port of ``pint_tpu/models/jump.py:19-47,118-147``): JUMPs are mask
parameters whose 0/1 masks are built on the host."""

from __future__ import annotations

import torch

from pint_torch.models.parameter import maskParameter
from pint_torch.models.timing_model import DelayComponent, PhaseComponent
from pint_torch.phase import Phase

__all__ = ["PhaseJump", "DelayJump"]


class PhaseJump(PhaseComponent):
    """Config: ``jumps`` (names); context: ``masks`` {name: (N,)}."""

    register = True
    category = "phase_jump"

    def declare(self):
        self.add_param(maskParameter(
            "JUMP", index=1, units="s", value=0.0,
            description="Phase jump (seconds) for selected TOAs"))

    def setup(self):
        self.config["jumps"] = [p for p in self.params
                                if p.startswith("JUMP")]

    def host_context(self, toas):
        return {"masks": self._select_masks(toas, self.config["jumps"])}

    def phase_func(self, pv, batch, ctx, delay) -> Phase:
        jphase = torch.zeros_like(batch.freq)
        F0 = pv.get("F0", 0.0)
        for j in self.config["jumps"]:
            jphase = jphase + pv.get(j, 0.0) * F0 * ctx["masks"][j]
        return Phase.from_float(jphase)



class DelayJump(DelayComponent):
    """Tempo-style delay jumps (reference ``jump.py:118-147``): delay
    -JUMP [s] on the selected TOAs.  Config: ``jumps``; context:
    ``masks`` {name: (N,)}."""

    register = True
    category = "jump_delay"

    def declare(self):
        self.add_param(maskParameter("JUMP", index=1, units="s", value=0.0,
                                     description="Delay jump (seconds)"))

    setup = PhaseJump.setup

    def host_context(self, toas):
        return {"masks": self._select_masks(toas,
                                            self.config.get("jumps", []))}

    def delay_func(self, pv, batch, ctx, acc_delay):
        d = torch.zeros_like(batch.freq)
        for j in self.config.get("jumps", []):
            d = d - pv.get(j, 0.0) * ctx["masks"][j]
        return d
