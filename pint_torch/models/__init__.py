"""Timing-model components of the port (the stand-ins' set: equatorial
and ecliptic astrometry, solar-system Shapiro, DM/DMX dispersion, the DD
family's BT, DD, DDS, DDH, DDGR and DDK binaries, ELL1, ELL1k and ELL1H
binaries, FD, spindown, jumps, the absolute phase
and an explicit phase offset, EFAC/EQUAD/ECORR and power-law red
noise)."""

from pint_torch.models import (absolute_phase, astrometry,  # noqa: F401
                               dispersion_model, frequency_dependent, jump,
                               noise_model, phase_offset,
                               solar_system_shapiro, spindown)
from pint_torch.models.binary import components as _binary  # noqa: F401
from pint_torch.models.timing_model import (Component, Param,  # noqa: F401
                                            TimingModel)

__all__ = ["Component", "Param", "TimingModel"]
