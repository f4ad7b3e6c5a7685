"""Normalization of light-curve component weights.

A copy of ``pint_tpu/templates/lcnorm.py`` (numpy on the host), the
reference's ``templates/lcnorm.py NormAngles``: the n component
weights (each in [0,1], summing to <= 1, remainder = uniform background) are
parameterized by n angles so unconstrained optimizers can fit them.  Using
the same spherical parameterization as the reference:

    norm_i = cos^2(a_1) ... cos^2(a_{i-1}) sin^2(a_i) ... (product chain)

which maps R^n -> the simplex interior.
"""

from __future__ import annotations

import numpy as np

__all__ = ["NormAngles"]


def isvector(x):
    """True when x has at least one array dimension (reference
    ``templates/lcnorm.py:16``; re-exported across the template modules
    there)."""
    import numpy as _np

    return len(_np.asarray(x).shape) > 0


class NormAngles:
    def __init__(self, norms):
        norms = np.asarray(norms, dtype=np.float64)
        if norms.sum() > 1.0:
            raise ValueError("Provided norms sum to > 1")
        self.dim = len(norms)
        self.p = self._norms_to_angles(norms)
        self.free = np.ones(self.dim, dtype=bool)

    # -- mapping -------------------------------------------------------------
    @staticmethod
    def _angles_to_norms(angles):
        """sin^2(a_i) * prod_{j<i} cos^2(a_j)."""
        s2 = np.sin(angles) ** 2
        c2 = np.cos(angles) ** 2
        prod = np.concatenate([[1.0], np.cumprod(c2)[:-1]])
        return s2 * prod

    @staticmethod
    def _norms_to_angles(norms):
        angles = np.empty(len(norms))
        rem = 1.0
        for i, n in enumerate(norms):
            frac = 0.0 if rem <= 0 else min(n / rem, 1.0)
            angles[i] = np.arcsin(np.sqrt(frac))
            rem -= n
        return angles

    # -- API -----------------------------------------------------------------
    def __call__(self) -> np.ndarray:
        return self._angles_to_norms(self.p)

    def copy(self) -> "NormAngles":
        import copy as _copy

        return _copy.deepcopy(self)

    def get_total(self) -> float:
        """Sum of the amplitudes (reference ``lcnorm.py get_total``)."""
        return float(self().sum())

    def set_total(self, total: float) -> None:
        """Rescale the amplitudes to the given sum (reference
        ``lcnorm.py set_total``)."""
        if not 0.0 <= total <= 1.0:
            # same domain the constructor enforces; silently clamping
            # would destroy the amplitude ratios
            raise ValueError(f"total must be within [0, 1], got {total}")
        cur = self.get_total()
        if cur <= 0:
            raise ValueError("cannot rescale zero-amplitude norms")
        self.p[:self.dim] = self._norms_to_angles(
            self._angles_to_norms(self.p[:self.dim]) * (total / cur))

    def get_free_mask(self) -> np.ndarray:
        return np.asarray(self.free, dtype=bool)

    def get_parameter_names(self, free: bool = True) -> list:
        idx = np.nonzero(self.free)[0] if free else range(len(self.p))
        return [f"Ang{i + 1}" for i in idx]

    def get_bounds(self) -> list:
        """[(lo, hi)] per free angle (angles live in [0, pi/2])."""
        return [(0.0, np.pi / 2)] * int(np.sum(self.free))

    def get_errors(self, free: bool = True) -> np.ndarray:
        e = getattr(self, "errors", np.zeros_like(self.p))
        return e[self.free] if free else e

    def set_errors(self, errs, free: bool = True) -> None:
        """Store parameter errors; a free-length vector scatters into the
        full-length store so :meth:`get_errors` masks consistently."""
        errs = np.asarray(errs, dtype=np.float64)
        if free and len(errs) != len(self.p):
            full = np.zeros_like(self.p)
            full[self.free] = errs
            errs = full
        self.errors = errs

    def is_energy_dependent(self) -> bool:
        return False

    def gradient(self, log10_ens=None, free: bool = True,
                 eps: float = 1e-7) -> np.ndarray:
        """(n_norm, n_param) finite-difference d(amplitudes)/d(angles)
        (reference ``lcnorm.py gradient`` is analytic; FD here).  With
        per-photon energies the energy-averaged gradient is returned."""
        p0 = self.get_parameters(free=free).copy()

        def amps():
            if log10_ens is None:
                return np.asarray(self())
            if not self.is_energy_dependent():
                raise TypeError(
                    "log10_ens given but these norms are not "
                    "energy-dependent (use ENormAngles)")
            v = np.asarray(self(log10_ens))
            return v if v.ndim == 1 else v.mean(axis=0)

        out = np.empty((self.dim, len(p0)))
        for i in range(len(p0)):
            pp = p0.copy()
            pp[i] += eps
            self.set_parameters(pp, free=free)
            hi = amps()
            pp[i] -= 2 * eps
            self.set_parameters(pp, free=free)
            lo = amps()
            out[:, i] = (hi - lo) / (2 * eps)
            self.set_parameters(p0, free=free)
        return out

    def sanity_checks(self) -> bool:
        return bool(np.all(np.isfinite(self.p)))

    def get_parameters(self, free: bool = True) -> np.ndarray:
        return self.p[self.free] if free else self.p.copy()

    def set_parameters(self, p, free: bool = True):
        if free:
            self.p[self.free] = p
        else:
            self.p[:] = p

    def num_parameters(self, free: bool = True) -> int:
        return int(self.free.sum()) if free else self.dim

    def set_single_norm(self, index: int, value: float):
        norms = self()
        norms[index] = value
        if norms.sum() > 1:
            raise ValueError("norms would sum to > 1")
        self.p = self._norms_to_angles(norms)

    def __repr__(self):
        return f"NormAngles(norms={self()!r})"


def numerical_gradient(fn, x0, eps: float = 1e-6) -> np.ndarray:
    """Central-difference gradient of a scalar/vector function (reference
    ``lcnorm.py numerical_gradient``)."""
    x0 = np.asarray(x0, dtype=np.float64)
    cols = []
    for i in range(len(x0)):
        xp = x0.copy()
        xp[i] += eps
        hi = np.asarray(fn(xp))
        xp[i] -= 2 * eps
        lo = np.asarray(fn(xp))
        cols.append((hi - lo) / (2 * eps))
    return np.array(cols)


def numerical_hessian(fn, x0, eps: float = 1e-4):
    """Central-difference Hessian of a scalar function (reference
    ``lcnorm.py numerical_hessian``) — thin wrapper over the package's
    one implementation in :func:`pint_torch.templates.lcfitters.hessian`."""
    from pint_torch.templates.lcfitters import hessian

    return hessian(fn, x0, eps=eps)
