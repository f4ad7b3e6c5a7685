"""Piecewise spindown solutions (port of
``pint_tpu/models/piecewise.py:20-72``): TOAs with PWSTART_i <= t <=
PWSTOP_i gain PWPH + dt (PWF0 + dt (PWF1/2 + dt PWF2/6)), dt the
barycentric seconds since PWEP_i."""

from __future__ import annotations

import torch

from pint_torch.exceptions import MissingParameter
from pint_torch.models.glitch import _grow_indexed
from pint_torch.models.parameter import prefixParameter
from pint_torch.models.timing_model import PhaseComponent
from pint_torch.phase import Phase

__all__ = ["PiecewiseSpindown"]

DAY_S = 86400.0


class PiecewiseSpindown(PhaseComponent):
    """Config: ``pw_indices``."""

    register = True
    category = "piecewise_spindown"

    def declare(self):
        # value=None exemplars: ranges may start at index 2 or later
        for name, units, desc in [
            ("PWEP_1", "MJD", "Piecewise solution reference epoch"),
            ("PWSTART_1", "MJD", "Piecewise solution range start"),
            ("PWSTOP_1", "MJD", "Piecewise solution range stop"),
            ("PWPH_1", "pulse phase", "Piecewise solution phase offset"),
            ("PWF0_1", "Hz", "Piecewise solution frequency offset"),
            ("PWF1_1", "Hz/s",
             "Piecewise solution frequency-derivative offset"),
            ("PWF2_1", "Hz/s^2",
             "Piecewise solution second-derivative offset"),
        ]:
            self.add_param(prefixParameter(name, units=units,
                                           description=desc))

    def setup(self):
        self.config["pw_indices"] = _grow_indexed(
            self, ("PWEP_", "PWSTART_", "PWSTOP_", "PWPH_", "PWF0_", "PWF1_",
                   "PWF2_"))

    def validate(self):
        for i in self.config["pw_indices"]:
            for pre in ("PWEP_", "PWSTART_", "PWSTOP_"):
                if (self._value(f"{pre}{i}") or 0.0) == 0.0:
                    raise MissingParameter("PiecewiseSpindown", f"{pre}{i}")

    def phase_func(self, pv, batch, ctx, delay):
        t_s = batch.tdb_seconds()
        t_mjd = batch.tdb.hi + batch.tdb.lo - delay / DAY_S
        phase = torch.zeros_like(delay)
        for i in self.config.get("pw_indices", []):
            ep = pv.get(f"PWEP_{i}", 0.0)
            dt = (t_s.hi - (ep - batch.tdb0) * DAY_S) + t_s.lo - delay
            on = (t_mjd >= pv.get(f"PWSTART_{i}", 0.0)) \
                & (t_mjd <= pv.get(f"PWSTOP_{i}", 0.0))
            dtp = torch.where(on, dt, 0.0)
            poly = pv.get(f"PWPH_{i}", 0.0) + dtp * (
                pv.get(f"PWF0_{i}", 0.0)
                + dtp * (0.5 * pv.get(f"PWF1_{i}", 0.0)
                         + dtp * pv.get(f"PWF2_{i}", 0.0) / 6.0))
            phase = phase + torch.where(on, poly, 0.0)
        return Phase.from_float(phase)
