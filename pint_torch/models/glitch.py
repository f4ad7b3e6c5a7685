"""Glitches: permanent frequency steps and exponential recoveries (port
of ``pint_tpu/models/glitch.py:25-89``).  For t after GLEP_i the phase
gains GLPH + dt (GLF0 + dt (GLF1/2 + dt GLF2/6)) + GLF0D tau (1 -
exp(-dt/tau)), dt the barycentric seconds since GLEP_i, tau = GLTD_i days;
the step is a ``where`` on dt, so the partials are one-sided as the
reference's."""

from __future__ import annotations

import torch

from pint_torch.models.timing_model import PhaseComponent
from pint_torch.phase import Phase

__all__ = ["Glitch"]

DAY_S = 86400.0


def _where(cond, a, b):
    """``jnp.where`` on a Python bool (GLTD_i frozen) or a tensor
    condition (GLTD_i free)."""
    if torch.is_tensor(cond):
        return torch.where(cond, a, b)
    return a if cond else b


class Glitch(PhaseComponent):
    """Config: ``glitch_indices``."""

    register = True
    category = "glitch"

    def phase_func(self, pv, batch, ctx, delay):
        t_s = batch.tdb_seconds()
        phase = torch.zeros_like(delay)
        for i in self.config.get("glitch_indices", []):
            glep = pv.get(f"GLEP_{i}", 0.0)
            dt = (t_s.hi - (glep - batch.tdb0) * DAY_S) + t_s.lo - delay
            on = dt > 0.0
            dtp = torch.where(on, dt, 0.0)
            poly = pv.get(f"GLPH_{i}", 0.0) + dtp * (
                pv.get(f"GLF0_{i}", 0.0)
                + dtp * (0.5 * pv.get(f"GLF1_{i}", 0.0)
                         + dtp * pv.get(f"GLF2_{i}", 0.0) / 6.0))
            tau = pv.get(f"GLTD_{i}", 0.0) * DAY_S
            has = tau > 0.0
            safe_tau = _where(has, tau, 1.0)
            decay = _where(has, pv.get(f"GLF0D_{i}", 0.0) * safe_tau
                          * (1.0 - torch.exp(-dtp / safe_tau)), 0.0)
            phase = phase + torch.where(on, poly + decay, 0.0)
        return Phase.from_float(phase)
