"""Par-facing binary components (port of
``pint_tpu/models/binary/components.py:76-205,458-475``): the barycentric
time tt0 = (TDB - T0) * 86400 - acc_delay in double-double, handed as
float64 to the DD engine -- kernel K2 (:mod:`pint_torch.kernels.dd_binary`),
whose arithmetic is :mod:`pint_torch.models.binary.engines`."""

from __future__ import annotations

from pint_torch.dd import dd_mul, dd_sub
from pint_torch.kernels import dd_binary as K2
from pint_torch.models.timing_model import DelayComponent, stack_params

__all__ = ["PulsarBinary", "BinaryDD"]

DAY_S = 86400.0


class PulsarBinary(DelayComponent):
    """Config: ``nfb`` and ``nwaves`` (FBX / ORBWAVES orbits; this slice
    runs the PB parameterization only)."""

    category = "pulsar_system"
    epoch_param = "T0"

    def _check_orbits(self):
        if self.config.get("nfb", 0) or self.config.get("nwaves", 0):
            raise NotImplementedError(
                f"{type(self).__name__}: FBX/ORBWAVES orbits are not ported "
                "yet; this slice evaluates PB/PBDOT orbits")

    def _tt0(self, pv, batch, acc_delay):
        epoch = pv[self.epoch_param]
        d = dd_mul(dd_sub(batch.tdb, epoch), DAY_S)
        return (d.hi + d.lo) - acc_delay

    def binary_delay(self, pv, tt0):
        raise NotImplementedError

    def delay_func(self, pv, batch, ctx, acc_delay):
        tt0 = self._tt0(pv, batch, acc_delay)
        if tt0.ndim == 1:
            tt0 = tt0.unsqueeze(0)
        return self.binary_delay(pv, tt0)


class BinaryDD(PulsarBinary):
    """Damour & Deruelle model (reference ``components.py:458``)."""

    register = True

    def binary_delay(self, pv, tt0):
        self._check_orbits()
        return K2.dd_binary(tt0, stack_params(pv, K2.DD_PARAMS, tt0.device))
