"""Energy-dependent component normalizations (reference
``templates/lcenorm.py``; a copy of ``pint_tpu/templates/lcenorm.py``,
numpy on the host).

The normalization angles drift linearly in log10(energy) about a pivot
energy, exactly parallel to :class:`LCEPrimitive`:
``a_i(E) = a_i + slope_i * (log10(E) - log10(E0))``.
"""

from __future__ import annotations

import numpy as np

from pint_torch.templates.lcnorm import NormAngles

__all__ = ["ENormAngles"]


class ENormAngles(NormAngles):
    def __init__(self, norms, slopes=None, e0_mev: float = 1000.0):
        super().__init__(norms)
        self.e0 = float(e0_mev)
        self.slopes = (np.zeros(self.dim) if slopes is None
                       else np.asarray(slopes, dtype=np.float64))
        if len(self.slopes) != self.dim:
            raise ValueError("one slope per norm angle required")
        # parameter vector: [angles..., slopes...]
        self.p = np.concatenate([self.p, self.slopes])
        self.free = np.ones(2 * self.dim, dtype=bool)

    def is_energy_dependent(self) -> bool:
        return True

    def __call__(self, log10_ens=None) -> np.ndarray:
        angles, slopes = self.p[:self.dim], self.p[self.dim:]
        if log10_ens is None:
            return self._angles_to_norms(angles)
        le = np.atleast_1d(np.asarray(log10_ens, dtype=np.float64))
        dle = le - np.log10(self.e0)
        a = angles[None, :] + dle[:, None] * slopes[None, :]
        # row-wise spherical map, vectorized over photons
        s2 = np.sin(a) ** 2
        c2 = np.cos(a) ** 2
        prod = np.concatenate(
            [np.ones((len(le), 1)), np.cumprod(c2, axis=1)[:, :-1]], axis=1)
        out = s2 * prod
        return out[0] if np.isscalar(log10_ens) else out

    def num_parameters(self, free: bool = True) -> int:
        return int(self.free.sum()) if free else len(self.p)

    def set_single_norm(self, index: int, value: float):
        norms = self._angles_to_norms(self.p[:self.dim])
        norms[index] = value
        if norms.sum() > 1:
            raise ValueError("norms would sum to > 1")
        self.p[:self.dim] = self._norms_to_angles(norms)

    def __repr__(self):
        return (f"ENormAngles(norms={self._angles_to_norms(self.p[:self.dim])!r}, "
                f"slopes={self.p[self.dim:]!r})")


#: reference re-export (each template module offers isvector)
from pint_torch.templates.lcnorm import isvector  # noqa: E402,F401
