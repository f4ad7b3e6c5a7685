"""Absolute phase reference TZRMJD/TZRSITE/TZRFRQ (port of
``pint_tpu/models/absolute_phase.py``).

The model phase is referenced to the pulse that arrives at TZRSITE at
TZRMJD, observed at TZRFRQ: :meth:`TimingModel.phase` with
``abs_phase=True`` subtracts the phase of that one TOA.  As in the
reference (``get_TZR_toas``, ``absolute_phase.py:38-55``) the TZR TOA is
built on the host (:func:`pint_torch.toa.make_single_toa`) and frozen into
a one-row :class:`~pint_torch.toa.TOABatch` (``tzr=True``) with each
component's context for it; a snapshot may carry that row already, and
then the bridge hands it to this component.
"""

from __future__ import annotations

import numpy as np

from pint_torch.exceptions import MissingParameter
from pint_torch.models.parameter import (MJDParameter, floatParameter,
                                         strParameter)
from pint_torch.models.timing_model import Component

__all__ = ["AbsPhase"]


class AbsPhase(Component):
    """Context: ``tzr_batch``, the one-row TZR batch on the model's
    device, where a snapshot carries it; built from the host layer
    otherwise."""

    register = True
    category = "absolute_phase"
    kind = "tzr"

    def declare(self):
        self.add_param(MJDParameter("TZRMJD",
                                    description="Epoch of the zero phase TOA"))
        self.add_param(strParameter(
            "TZRSITE", description="Observatory of the zero phase TOA"))
        self.add_param(floatParameter(
            "TZRFRQ", units="MHz",
            description="Frequency of the zero phase TOA"))

    def validate(self):
        if self.TZRMJD.value is None:
            raise MissingParameter("AbsPhase", "TZRMJD")

    def get_TZR_toas(self, model=None):
        """The one-TOA host table at the TZR epoch (cached)."""
        if self.__dict__.get("_tzr_toas") is None:
            from pint_torch.toa import make_single_toa

            model = model or self._parent
            mjd = self._value("TZRMJD")
            if mjd is None:
                raise ValueError("AbsPhase has no TZRMJD")
            site = self._value("TZRSITE") or "ssb"
            freq = self._value("TZRFRQ") or np.inf
            ephem = model["EPHEM"].value if "EPHEM" in model else None
            planets = bool("PLANET_SHAPIRO" in model
                           and model["PLANET_SHAPIRO"].value)
            self._tzr_toas = make_single_toa(
                np.longdouble(mjd[0]) + np.longdouble(mjd[1]), site,
                freq_mhz=freq, ephem=ephem or "DE440", planets=planets)
        return self._tzr_toas

    def host_tzr_batch(self, device=None):
        """The TZR row built by the host layer, on ``device`` (the
        model's by default), with every component's context for it."""
        model = self._parent
        return self.get_TZR_toas(model).to_batch(
            device=model.device if device is None else device, model=model,
            tzr=True)

    @property
    def tzr_batch(self):
        batch = self.context.get("tzr_batch")
        if batch is None:
            batch = self.__dict__.get("_host_tzr")
            if batch is None:
                batch = self._host_tzr = self.host_tzr_batch()
        return batch
