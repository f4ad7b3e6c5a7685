"""Explicit fitted overall phase offset PHOFF (port of
``pint_tpu/models/phase_offset.py``).

With this component the implicit Offset design column is dropped and PHOFF
is fitted like any other parameter.  Its phase is -PHOFF on every TOA but
the TZR TOA, whose context ``apply`` is 0 (otherwise PHOFF would cancel
out of the absolute phase).
"""

from __future__ import annotations

import numpy as np

from pint_torch.models.parameter import floatParameter
from pint_torch.models.timing_model import PhaseComponent
from pint_torch.phase import Phase

__all__ = ["PhaseOffset"]


class PhaseOffset(PhaseComponent):
    """Context: ``apply`` (N,), 1 on the model's TOAs and 0 on the TZR
    row."""

    register = True
    category = "phase_offset"

    def declare(self):
        self.add_param(floatParameter("PHOFF", value=0.0, units="",
                                      description="Overall phase offset"))

    def host_context(self, toas):
        # the host TZR TOA carries a "tzr" flag (make_single_toa)
        return {"apply": np.array([0.0 if "tzr" in fl else 1.0
                                   for fl in toas.flags])}

    def phase_func(self, pv, batch, ctx, delay) -> Phase:
        return Phase.from_float(-pv.get("PHOFF", 0.0) * ctx["apply"])
