"""Glitches: permanent frequency steps and exponential recoveries (port
of ``pint_tpu/models/glitch.py:25-89``).  For t after GLEP_i the phase
gains GLPH + dt (GLF0 + dt (GLF1/2 + dt GLF2/6)) + GLF0D tau (1 -
exp(-dt/tau)), dt the barycentric seconds since GLEP_i, tau = GLTD_i days;
the step is a ``where`` on dt, so the partials are one-sided as the
reference's."""

from __future__ import annotations

import torch

from pint_torch.exceptions import MissingParameter
from pint_torch.models.parameter import prefixParameter
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


def _grow_indexed(comp, prefixes) -> list:
    """The indices ``i`` of the set ``<prefix>i`` parameters, each family
    grown with zeros to every such index (unpadded names; the reference's
    glitch and piecewise ``setup``)."""
    pd = comp._params_dict
    idx = sorted({int(n.split("_")[1]) for n in comp.params
                  if "_" in n and pd[n].value is not None})
    for i in idx:
        for pre in prefixes:
            if f"{pre}{i}" not in pd:
                newp = pd[f"{pre}1"].new_param(i, value=0.0)
                newp.name = f"{pre}{i}"
                comp.add_param(newp)
    return idx


class Glitch(PhaseComponent):
    """Config: ``glitch_indices``."""

    register = True
    category = "glitch"

    def declare(self):
        # value=None exemplars: par files may number glitches from 2
        for name, units, desc in [
            ("GLEP_1", "MJD", "Epoch of glitch"),
            ("GLPH_1", "pulse phase", "Glitch phase increment"),
            ("GLF0_1", "Hz", "Permanent glitch spin frequency increment"),
            ("GLF1_1", "Hz/s",
             "Permanent glitch frequency-derivative increment"),
            ("GLF2_1", "Hz/s^2", "Permanent glitch second-derivative increment"),
            ("GLF0D_1", "Hz", "Decaying glitch frequency increment"),
            ("GLTD_1", "day", "Glitch decay time constant"),
        ]:
            self.add_param(prefixParameter(name, units=units,
                                           description=desc))

    def setup(self):
        # a glitch index exists iff some GL*_i parameter is set; grow the
        # family so every live index has the full set
        self.config["glitch_indices"] = _grow_indexed(
            self, ("GLEP_", "GLPH_", "GLF0_", "GLF1_", "GLF2_", "GLF0D_",
                   "GLTD_"))

    def validate(self):
        for i in self.config["glitch_indices"]:
            if (self._value(f"GLEP_{i}") or 0.0) == 0.0:
                raise MissingParameter("Glitch", f"GLEP_{i}")
            if (self._value(f"GLF0D_{i}") or 0.0) != 0.0 and \
                    (self._value(f"GLTD_{i}") or 0.0) == 0.0:
                raise MissingParameter(
                    "Glitch", f"GLTD_{i}",
                    f"GLF0D_{i} set but GLTD_{i} is zero")

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
