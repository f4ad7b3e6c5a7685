"""Solar-system Shapiro delay (port of
``pint_tpu/models/solar_system_shapiro.py:28-54``):
-2 T ln((r - r.n_psr)/AU) for the Sun, and for planets when PLANET_SHAPIRO
is set."""

from __future__ import annotations

import torch

from pint_torch.models.timing_model import DelayComponent

__all__ = ["SolarSystemShapiro"]

#: AU in light-seconds
_AU_LS = 1.495978707e11 / 299792458.0
#: G M / c^3 [s] of the Sun and the planets
TSUN = 4.925490947641267e-06
_T_PLANET = {
    "jupiter": 4.702799555505529e-09,
    "saturn": 1.408128810019423e-09,
    "venus": 1.2052652550219583e-11,
    "uranus": 2.1505895513637613e-10,
    "neptune": 2.5374099721577516e-10,
}


def _rowsum(x):
    return (x[..., 0] + x[..., 1]) + x[..., 2]


class SolarSystemShapiro(DelayComponent):
    """Config: ``planet_shapiro``."""

    register = True
    category = "solar_system_shapiro"

    @staticmethod
    def ss_obj_shapiro_delay(obj_pos_ls, psr_dir, T_obj):
        r = torch.sqrt(_rowsum(obj_pos_ls * obj_pos_ls))
        rcostheta = _rowsum(obj_pos_ls * psr_dir)
        return -2.0 * T_obj * torch.log((r - rcostheta) / _AU_LS)

    def _psr_dir(self, pv, batch):
        for comp in self._parent.components.values():
            if hasattr(comp, "ssb_to_psb_xyz"):
                return comp.ssb_to_psb_xyz(pv, batch.tdb.hi)
        raise ValueError("SolarSystemShapiro requires an astrometry component")

    def delay_func(self, pv, batch, ctx, acc_delay):
        psr_dir = self._psr_dir(pv, batch)
        delay = self.ss_obj_shapiro_delay(batch.obs_sun_pos, psr_dir, TSUN)
        if self.config.get("planet_shapiro", False):
            for name, T in _T_PLANET.items():
                if name in batch.planet_pos:
                    delay = delay + self.ss_obj_shapiro_delay(
                        batch.planet_pos[name], psr_dir, T)
        return delay
