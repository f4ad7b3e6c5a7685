"""Par-facing binary components (port of
``pint_tpu/models/binary/components.py:76-205,458-475,589-627,672-719``):
the barycentric time since the epoch, (TDB - T0|TASC) * 86400 - acc_delay
in double-double, handed as float64 to an engine kernel -- K2
(:mod:`pint_torch.kernels.dd_binary`) for DD, K4
(:mod:`pint_torch.kernels.ell1_binary`) for ELL1, ELL1k and ELL1H --
whose arithmetic is :mod:`pint_torch.models.binary.engines`."""

from __future__ import annotations

from pint_torch.dd import dd_mul, dd_sub
from pint_torch.kernels import dd_binary as K2
from pint_torch.kernels import ell1_binary as K4
from pint_torch.models.binary.engines import (ELL1, ELL1_PARAMS, ELL1H_EXACT,
                                              ELL1H_HARMONIC, ELL1H_PARAMS,
                                              ELL1K)
from pint_torch.models.timing_model import DelayComponent, stack_params

__all__ = ["PulsarBinary", "BinaryDD", "BinaryELL1", "BinaryELL1k",
           "BinaryELL1H"]

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


class BinaryELL1(PulsarBinary):
    """Low-eccentricity Lange et al. (2001) model, epoch TASC (reference
    ``components.py:589``)."""

    register = True
    epoch_param = "TASC"
    mode = ELL1

    def binary_delay(self, pv, tt0):
        self._check_orbits()
        return K4.ell1_binary(tt0, stack_params(pv, ELL1_PARAMS,
                                                tt0.device), self.mode)


class BinaryELL1k(BinaryELL1):
    """ELL1 with exponential eccentricity evolution and periastron advance
    (Susobhanan+ 2018; reference ``components.py:705``)."""

    register = True
    mode = ELL1K


class BinaryELL1H(BinaryELL1):
    """ELL1 with the orthometric Shapiro delay H3 with STIGMA, or H3 with
    H4 (Freire & Wex 2010; reference ``components.py:672-700``).  The form
    is chosen as the reference chooses it: exact when STIGMA is set and not
    0, else the harmonics 3..NHARMS of stigma = STIGMA, or H4/H3 when H4
    is set and STIGMA is not."""

    register = True

    def _value(self, name):
        p = self._parent.params_table.get(name)
        return None if p is None else p.value

    def validate(self):
        if self._value("H3") is None:
            raise ValueError("BinaryELL1H: H3 is required")
        if self._value("H4") is not None \
                and self._value("STIGMA") is not None:
            raise ValueError("BinaryELL1H: provide H4 or STIGMA, not both")

    def binary_delay(self, pv, tt0):
        self._check_orbits()
        stigma, h4 = self._value("STIGMA"), self._value("H4")
        exact = stigma is not None and stigma != 0.0
        mode = ELL1H_EXACT if exact else ELL1H_HARMONIC
        return K4.ell1_binary(
            tt0, stack_params(pv, ELL1H_PARAMS, tt0.device), mode,
            nharms=int(self._value("NHARMS") or 7),
            use_h4=h4 is not None and stigma is None)
