"""Absolute phase reference TZRMJD/TZRSITE/TZRFRQ (port of
``pint_tpu/models/absolute_phase.py``).

The model phase is referenced to the pulse that arrives at TZRSITE at
TZRMJD, observed at TZRFRQ: :meth:`TimingModel.phase` with
``abs_phase=True`` subtracts the phase of that one TOA.  The reference
builds the TZR TOA on the host (``get_TZR_toas``, ``absolute_phase.py:38``);
the port has no host ingest, so the snapshot carries the TZR TOA's batch
row and each component's context for it, and the bridge hands them to this
component as a one-row :class:`~pint_torch.toa.TOABatch` (``tzr=True``).
"""

from __future__ import annotations

from pint_torch.models.timing_model import Component

__all__ = ["AbsPhase"]


class AbsPhase(Component):
    """Context: ``tzr_batch``, the one-row TZR batch on the model's
    device."""

    register = True
    category = "absolute_phase"
    kind = "tzr"

    @property
    def tzr_batch(self):
        batch = self.context.get("tzr_batch")
        if batch is None:
            raise ValueError("AbsPhase has no TZR TOA: the snapshot holds no "
                             "tzr/ row")
        return batch
