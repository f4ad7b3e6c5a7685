"""Energy-dependent light-curve primitives (reference
``templates/lceprimitives.py``; a copy of
``pint_tpu/templates/lceprimitives.py``, numpy on the host: the photon
fitters pass no energies).

A peak's parameters drift linearly in log10(energy) about a reference
energy: ``p_i(E) = p_i + slope_i * (log10(E) - log10(E0))``, with widths
kept positive.  Evaluation takes (phases, log10_ens) pairs — each photon
carries its own energy — which is the form the Fermi-LAT weighted-photon
likelihood consumes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from pint_torch.templates.lcprimitives import (LCGaussian, LCGaussian2, LCSkewGaussian,
                                             LCLorentzian, LCLorentzian2,
                                             LCPrimitive, LCVonMises)

__all__ = ["LCEPrimitive", "LCEGaussian", "LCEGaussian2", "LCESkewGaussian",
           "LCEWrappedFunction", "edep_gradient",
           "LCELorentzian",
           "LCELorentzian2", "LCEVonMises"]


class LCEPrimitive(LCPrimitive):
    """Wraps a primitive shape with per-parameter log-energy slopes.

    Parameter vector: [base parameters..., slopes...].  ``E0`` (MeV) sets
    the pivot energy at which the base parameters apply.
    """

    base_cls = LCPrimitive

    def __init__(self, p=None, slopes=None, e0_mev: float = 1000.0):
        base = self.base_cls(p)
        nb = len(base.p)
        slopes = np.zeros(nb) if slopes is None else np.asarray(
            slopes, dtype=np.float64)
        if len(slopes) != nb:
            raise ValueError("one slope per base parameter required")
        self.nb = nb
        self.e0 = float(e0_mev)
        self.p = np.concatenate([base.p, slopes])
        self.free = np.ones_like(self.p, dtype=bool)
        self.pnames = list(self.base_cls.pnames) + [
            f"Slope_{n}" for n in self.base_cls.pnames]

    def is_energy_dependent(self) -> bool:
        return True

    def _base_at_current(self):
        """A base-class primitive carrying this primitive's CURRENT base
        parameters — shape queries (hwhm, two-sidedness) must come from
        the base shape, not LCPrimitive defaults."""
        b = self.base_cls()
        b.p = np.asarray(self.p[:self.nb], dtype=np.float64).copy()
        return b

    def is_two_sided(self) -> bool:
        return self._base_at_current().is_two_sided()

    def hwhm(self, right: bool = False) -> float:
        return self._base_at_current().hwhm(right=right)

    def get_location(self) -> float:
        return float(self.p[self.nb - 1])

    def set_location(self, loc: float):
        self.p[self.nb - 1] = loc % 1.0

    #: base-parameter columns clamped positive along the energy track;
    #: None means every column but the trailing location (width-like
    #: shapes).  Subclasses with sign-free shape parameters narrow this.
    clamp_cols = None

    def parameters_at(self, log10_ens) -> np.ndarray:
        """(..., nb) effective base parameters at the given energies."""
        le = np.asarray(log10_ens, dtype=np.float64)
        dle = le - np.log10(self.e0)
        base, slopes = self.p[:self.nb], self.p[self.nb:]
        out = base[None, :] + np.atleast_1d(dle)[:, None] * slopes[None, :]
        # width-like columns must stay positive at every energy
        cols = range(self.nb - 1) if self.clamp_cols is None \
            else self.clamp_cols
        for c in cols:
            out[:, c] = np.maximum(out[:, c], 1e-4)
        return out

    def __call__(self, phases, log10_ens=None):
        if log10_ens is None:
            return self.base_cls._pdf(self, np.asarray(phases), self.p[:self.nb])
        phases = np.atleast_1d(np.asarray(phases, dtype=np.float64))
        pars = self.parameters_at(log10_ens)
        if pars.shape[0] == 1:
            return self.base_cls._pdf(self, phases, pars[0])
        # one vectorized evaluation: the _pdf bodies index p[i] and broadcast
        # elementwise, so per-photon parameter COLUMNS evaluate all photons
        # at their own energies in one pass (Fermi data: all energies unique)
        return np.asarray(self.base_cls._pdf(
            self, phases, [pars[:, i] for i in range(self.nb)]))


class LCEGaussian(LCEPrimitive):
    """Energy-dependent wrapped Gaussian (reference LCEGaussian)."""

    base_cls = LCGaussian
    name = "EGaussian"


class LCELorentzian(LCEPrimitive):
    base_cls = LCLorentzian
    name = "ELorentzian"


class LCEVonMises(LCEPrimitive):
    base_cls = LCVonMises
    name = "EVonMises"


#: reference re-export (each template module offers isvector)
from pint_torch.templates.lcnorm import isvector  # noqa: E402,F401


class LCEGaussian2(LCEPrimitive):
    """Energy-dependent two-sided Gaussian (reference LCEGaussian2)."""

    base_cls = LCGaussian2
    name = "EGaussian2"


class LCELorentzian2(LCEPrimitive):
    """Energy-dependent two-sided Lorentzian (reference LCELorentzian2)."""

    base_cls = LCLorentzian2
    name = "ELorentzian2"


def edep_gradient(prim, phases, log10_ens=None, eps: float = 1e-6):
    """Numeric d(pdf)/d(params) for an energy-dependent primitive over its
    FULL parameter vector [base..., slopes...] (reference
    ``lceprimitives.py:8 edep_gradient``; this is a linear model, so the
    slope rows are the base rows weighted by dlog10(E) — computed here by
    differencing the same evaluation path the likelihood uses, which also
    respects the positivity clamp's saturated-gradient zeroing)."""
    phases = np.asarray(phases, dtype=np.float64)
    out = []
    for i in range(len(prim.p)):
        hi, lo = prim.p.copy(), prim.p.copy()
        hi[i] += eps / 2
        lo[i] -= eps / 2
        save = prim.p
        try:
            prim.p = hi
            vp = np.asarray(prim(phases, log10_ens))
            prim.p = lo
            vm = np.asarray(prim(phases, log10_ens))
        finally:
            prim.p = save
        out.append((vp - vm) / eps)
    return np.asarray(out)


class LCEWrappedFunction(LCEPrimitive):
    """Energy-dependent base for wrapped-function shapes (reference
    ``lceprimitives.py:150 LCEWrappedFunction``): subclasses set
    ``base_cls`` to an :class:`~pint_torch.templates.lcprimitives
    .LCWrappedFunction` shape, whose ``base_func``/``base_int`` hooks are
    pulled onto this class so the wrapped ``_pdf`` resolves here too."""

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if hasattr(cls.base_cls, "base_func"):
            cls.base_func = cls.base_cls.base_func
            cls.base_int = cls.base_cls.base_int

    def gradient(self, phases, log10_ens=None, free: bool = False):
        g = edep_gradient(self, phases, log10_ens)
        return g[self.free] if free else g


class LCESkewGaussian(LCEWrappedFunction):
    """Energy-dependent wrapped skew-normal (reference
    ``lceprimitives.py LCESkewGaussian``): [width, shape, location] base
    parameters plus one log-energy slope each."""

    base_cls = LCSkewGaussian
    name = "ESkewGaussian"
    clamp_cols = (0,)  # width only: Shape is legitimately signed
