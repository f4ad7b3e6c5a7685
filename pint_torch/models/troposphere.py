"""Tropospheric delay (port of ``pint_tpu/models/troposphere.py:108-245``):
the Niell mapping of the Davis et al. (1985) zenith delay at each ground
site, computed on the host when the snapshot is taken (the reference's
``build_context``; it depends on no fitted parameter) and applied as the
context's ``delay``."""

from __future__ import annotations

import torch

from pint_torch.models.timing_model import DelayComponent

__all__ = ["TroposphereDelay"]


class TroposphereDelay(DelayComponent):
    """Context: ``delay`` (N,) [s] (zeros with CORRECT_TROPOSPHERE N)."""

    register = True
    category = "troposphere"

    def delay_func(self, pv, batch, ctx, acc_delay):
        d = ctx.get("delay")
        return torch.zeros_like(batch.freq) if d is None else d
