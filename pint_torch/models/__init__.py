"""Timing-model components of the port: equatorial and ecliptic
astrometry, solar-system Shapiro, the troposphere, DM/DMX dispersion with
DMJUMP and FDJUMPDM, solar-wind dispersion (NE_SW and SWX), chromatic
CM/CMX, the DD family's BT, DD, DDS, DDH, DDGR and DDK binaries, the
piecewise BT, ELL1, ELL1k and ELL1H binaries (each on PB, FBX or ORBWAVES
orbits), FD and FDJUMP, delay and phase jumps, spindown, glitches,
piecewise spindown, WAVE, WaveX/DMWaveX/CMWaveX, IFUNC, the absolute
phase and an explicit phase offset, EFAC/EQUAD/ECORR and the power-law
red, DM, chromatic and solar-wind noise."""

from pint_torch.models import (absolute_phase, astrometry,  # noqa: F401
                               chromatic, dispersion_model, fdjump,
                               frequency_dependent, glitch, ifunc, jump,
                               noise_model, phase_offset, piecewise,
                               solar_system_shapiro, solar_wind, spindown,
                               troposphere, wave, wavex)
from pint_torch.models.binary import components as _binary  # noqa: F401
from pint_torch.models.timing_model import (Component, Param,  # noqa: F401
                                            TimingModel)
from pint_torch.models.parameter import (  # noqa: F401
    AngleParameter, MJDParameter, Parameter, boolParameter, floatParameter,
    intParameter, maskParameter, prefixParameter, strParameter)
from pint_torch.models.model_builder import (  # noqa: F401
    AllComponents, ModelBuilder, get_model, get_model_and_toas,
    parse_parfile)

__all__ = ["Component", "Param", "TimingModel", "AllComponents",
           "ModelBuilder", "get_model", "get_model_and_toas",
           "parse_parfile"]
