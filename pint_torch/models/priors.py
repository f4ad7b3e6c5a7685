"""Parameter priors for Bayesian inference (a copy of
``pint_tpu/models/priors.py``, which imports numpy and scipy only).

``Prior`` wraps a scipy frozen distribution (or the improper
:class:`UniformUnboundedRV`) with ``pdf``, ``logpdf``, ``ppf`` and ``rvs``.
``Prior.jax_spec`` keeps the reference's name: it describes the two
families a batched lnprior evaluates on the device (uniform, normal), which
:class:`pint_torch.bayesian.BayesianTiming` reads to build its tensors.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = [
    "Prior",
    "UniformUnboundedRV",
    "UniformBoundedRV",
    "GaussianBoundedRV",
    "GaussianRV_gen",
    "RandomInclinationPrior",
]


class UniformUnboundedRV:
    """Improper flat prior over the whole real line
    (reference ``priors.py:119`` region)."""

    kind = "uniform_unbounded"

    def pdf(self, x):
        return np.ones_like(np.asarray(x, dtype=float))

    def logpdf(self, x):
        return np.zeros_like(np.asarray(x, dtype=float))

    def ppf(self, q):
        raise NotImplementedError("Unbounded uniform prior has no ppf")

    def rvs(self, size=None, random_state=None):
        raise NotImplementedError("Cannot sample an unbounded uniform prior")


def UniformBoundedRV(lower_bound: float, upper_bound: float):
    """Frozen scipy uniform on [lower, upper] (reference parity helper)."""
    from scipy.stats import uniform

    return uniform(lower_bound, upper_bound - lower_bound)


def GaussianBoundedRV(loc: float = 0.0, scale: float = 1.0,
                      lower_bound: float = -np.inf, upper_bound: float = np.inf):
    """Frozen scipy truncated normal (reference ``GaussianRV_gen``)."""
    from scipy.stats import truncnorm

    a = (lower_bound - loc) / scale
    b = (upper_bound - loc) / scale
    return truncnorm(a, b, loc=loc, scale=scale)


def GaussianRV_gen(loc: float = 0.0, scale: float = 1.0):
    """Frozen scipy normal under the reference's spelling
    (``priors.py:119 GaussianRV_gen``); the bounded variant is
    :func:`GaussianBoundedRV`."""
    from scipy.stats import norm

    return norm(loc=loc, scale=scale)


class Prior:
    """Prior distribution attached to a Parameter (reference ``priors.py:14``).

    Wraps any scipy frozen distribution (or :class:`UniformUnboundedRV`).
    ``jax_spec`` returns ("uniform", lo, hi) / ("normal", mu, sigma) / None,
    letting the ensemble sampler evaluate simple priors on the device.
    """

    def __init__(self, rv):
        self._rv = rv

    def pdf(self, value):
        return self._rv.pdf(value)

    def logpdf(self, value):
        return self._rv.logpdf(value)

    def ppf(self, q):
        return self._rv.ppf(q)

    def rvs(self, size=None, random_state=None):
        return self._rv.rvs(size=size, random_state=random_state)

    @property
    def is_unbounded(self) -> bool:
        return isinstance(self._rv, UniformUnboundedRV)

    def jax_spec(self) -> Optional[tuple]:
        """("uniform", lo, hi) or ("normal", mu, sigma) when the wrapped rv
        is one of the two vectorizable families, else None."""
        rv = self._rv
        name = getattr(getattr(rv, "dist", None), "name", None)
        if name == "uniform":
            lo = float(rv.ppf(0.0))
            hi = float(rv.ppf(1.0))
            return ("uniform", lo, hi)
        if name == "norm":
            return ("normal", float(rv.mean()), float(rv.std()))
        return None

    def __repr__(self):
        return f"Prior({self._rv!r})"


#: reference-spelled alias (``priors.py:119 GaussianRV_gen``)
GaussianRV_gen = GaussianBoundedRV


class RandomInclinationPrior:
    """pdf of sin(i) under an isotropic (uniform-in-cos-i) inclination
    prior: p(x) = x / sqrt(1 - x^2) on [0, 1) (reference ``priors.py:73``).
    Wrap in :class:`Prior` and attach to SINI."""

    a, b = 0.0, 1.0

    def pdf(self, v):
        v = np.asarray(v, dtype=np.float64)
        ok = (v >= 0) & (v < 1)
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(ok, v / np.sqrt(1.0 - np.where(ok, v, 0.0) ** 2),
                            0.0)

    def logpdf(self, v):
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.log(self.pdf(v))

    def ppf(self, q):
        # CDF = 1 - sqrt(1 - v^2)  =>  v = sqrt(1 - (1-q)^2)
        q = np.asarray(q, dtype=np.float64)
        return np.sqrt(1.0 - (1.0 - q) ** 2)

    def rvs(self, size=None, random_state=None):
        if isinstance(random_state, np.random.RandomState):
            # legacy-RandomState parity with the scipy-frozen priors
            return self.ppf(random_state.random_sample(size))
        return self.ppf(np.random.default_rng(random_state).random(size))
