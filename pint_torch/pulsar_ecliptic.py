"""The pulsar ecliptic frame's obliquity table (port of
``pint_tpu/pulsar_ecliptic.py:29-41`` and ``pint_tpu/__init__.py:78-79``).

The named IAU/IERS obliquities [rad], copied: a physical-constants table
has one correct spelling.  The ecliptic astrometry component
(:class:`pint_torch.models.astrometry.AstrometryEcliptic`) evaluates with
the IERS2010 value, as the reference's does.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["OBL", "OBL_IERS2010_ARCSEC", "OBL_IERS2010_RAD", "ARCSEC_RAD"]

#: obliquity of the ecliptic, IERS2010 [arcsec]
OBL_IERS2010_ARCSEC = 84381.406
#: the same in radians, by the reference's expression
OBL_IERS2010_RAD = OBL_IERS2010_ARCSEC * (1.0 / 3600.0) \
    * 3.141592653589793 / 180.0

ARCSEC_RAD = np.pi / (180.0 * 3600.0)

#: named obliquity values [rad]
OBL: Dict[str, float] = {
    "IAU1976": 84381.448 * ARCSEC_RAD,
    "IERS1992": 84381.412 * ARCSEC_RAD,
    "DE403": 84381.412 * ARCSEC_RAD,
    "IERS2003": 84381.4059 * ARCSEC_RAD,
    "IERS2010": OBL_IERS2010_RAD,
    "IAU2005": OBL_IERS2010_RAD,
    "DEFAULT": OBL_IERS2010_RAD,
}
