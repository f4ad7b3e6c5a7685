"""Timing-model components of the port (the stand-ins' set: equatorial
and ecliptic astrometry, solar-system Shapiro, DM/DMX dispersion, DD, ELL1
and ELL1k binaries, FD, spindown, jumps, EFAC/EQUAD/ECORR and power-law
red noise)."""

from pint_torch.models import (astrometry, dispersion_model,  # noqa: F401
                               frequency_dependent, jump, noise_model,
                               solar_system_shapiro, spindown)
from pint_torch.models.binary import components as _binary  # noqa: F401
from pint_torch.models.timing_model import (Component, Param,  # noqa: F401
                                            TimingModel)

__all__ = ["Component", "Param", "TimingModel"]
