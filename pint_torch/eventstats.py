"""Pulsation-significance statistics for photon phases (a copy of
``pint_tpu/eventstats.py``, numpy and scipy on the host).

The reference's ``eventstats.py``: Z^2_m test
(Buccheri et al. 1983), H-test (de Jager et al. 1989/2010), their survival
functions, and sigma conversions.  All accept optional photon weights
(Kerr 2011).
"""

from __future__ import annotations

import numpy as np
from scipy.stats import chi2, norm

__all__ = ["vec", "to_array", "from_array",
           "z2m", "z2mw", "sf_z2m", "cosm", "best_m", "em_four", "em_lc",
           "hm", "hmw", "sf_hm", "sf_h20_dj1989", "sf_h20_dj2010",
           "sig2h20", "sigma_trials", "h2sig", "sig2sigma", "sigma2sig",
           "sf_stackedh"]

TWOPI = 2 * np.pi


def z2m(phases, m: int = 2, weights=None):
    """Z^2_m statistics for harmonics 1..m; returns array of the cumulative
    statistic at each harmonic (reference ``eventstats.py z2m``)."""
    phases = np.asarray(phases, dtype=np.float64)
    n = len(phases)
    if weights is None:
        weights = np.ones(n)
    w = np.asarray(weights, dtype=np.float64)
    # normalization: sum w^2 replaces n for weighted events (Kerr 2011)
    denom = np.sum(w**2)
    ks = np.arange(1, m + 1)
    arg = TWOPI * np.outer(ks, phases)
    c = (np.cos(arg) * w).sum(axis=1)
    s = (np.sin(arg) * w).sum(axis=1)
    return np.cumsum(2.0 / denom * (c**2 + s**2))


def sf_z2m(ts, m: int = 2) -> float:
    """Survival function (p-value) of the Z^2_m statistic: chi2, 2m dof."""
    return float(chi2.sf(ts, 2 * m))


def hm(phases, m: int = 20, c: float = 4.0):
    """H-test: max_k (Z^2_k - c*(k-1)) over k = 1..m
    (reference ``eventstats.py hm``)."""
    zs = z2m(phases, m=m)
    return float(np.max(zs - c * np.arange(m)))


def hmw(phases, weights, m: int = 20, c: float = 4.0):
    """Weighted H-test (Kerr 2011)."""
    zs = z2m(phases, m=m, weights=weights)
    return float(np.max(zs - c * np.arange(m)))


def sf_hm(h: float, m: int = 20, c: float = 4.0) -> float:
    """H-test survival function; the de Jager & Busching (2010) calibration
    sf = exp(-0.4 h) (valid for m=20, c=4)."""
    if m == 20 and c == 4.0:
        return float(np.exp(-0.4 * h))
    # fall back to a conservative chi2 bound on the max statistic
    ks = np.arange(1, m + 1)
    return float(min(1.0, np.sum(chi2.sf(h + c * (ks - 1), 2 * ks))))


def h2sig(h: float) -> float:
    """H-test value -> Gaussian sigma equivalent."""
    return sig2sigma(sf_hm(h))


def sig2sigma(sig: float) -> float:
    """p-value -> one-sided Gaussian sigma (reference ``eventstats.py``)."""
    if sig <= 0:
        return np.inf
    if sig >= 1:
        return 0.0
    return float(norm.isf(sig))


def sigma2sig(sigma: float) -> float:
    """Gaussian sigma -> one-sided p-value."""
    return float(norm.sf(sigma))


def sf_stackedh(k: int, h: float, l: float = 0.398405) -> float:
    """Survival function for the sum of k independent H statistics
    (reference ``eventstats.py sf_stackedh``, Kerr thesis eqn)."""
    import math

    c = l * h
    p = sum(c**i / math.factorial(i) for i in range(k))
    return float(p * np.exp(-c)) if c < 700 else 0.0


def z2mw(phases, weights, m: int = 2):
    """Weighted Z^2_m (CLT-calibrated when weights are well distributed;
    reference ``eventstats.py:157``)."""
    ph = np.asarray(phases) * TWOPI
    w = np.asarray(weights, dtype=np.float64)
    ks = np.arange(1, m + 1)[:, None]
    s = (np.cos(ks * ph) * w).sum(axis=1) ** 2 \
        + (np.sin(ks * ph) * w).sum(axis=1) ** 2
    return np.cumsum(s) * (2.0 / np.sum(w * w))


def cosm(phases, m: int = 2):
    """Cosine test per harmonic (de Jager et al. 1994; reference
    ``eventstats.py:176``)."""
    ph = np.asarray(phases) * TWOPI
    ks = np.arange(1, m + 1)[:, None]
    return (2.0 / len(ph)) * np.cumsum(np.cos(ks * ph).sum(axis=1))


def best_m(phases, weights=None, m: int = 100) -> int:
    """Harmonic count maximizing the H statistic's penalized Z^2
    (reference ``eventstats.py:204``)."""
    w = np.ones(len(phases)) if weights is None else np.asarray(weights)
    z = z2mw(phases, w, m=m)
    return int(np.arange(1, m + 1)[np.argmax(z - 4 * np.arange(0, m))])


def em_four(phases, m: int = 2, weights=None):
    """Empirical Fourier coefficients (a_k, b_k) up to harmonic m
    (reference ``eventstats.py:209``)."""
    ph = np.asarray(phases) * TWOPI
    n = len(ph) if weights is None else np.sum(weights)
    w = 1.0 if weights is None else np.asarray(weights)
    ks = np.arange(1, m + 1)[:, None]
    aks = (w * np.cos(ks * ph)).sum(axis=-1) / n
    bks = (w * np.sin(ks * ph)).sum(axis=-1) / n
    return aks, bks


def em_lc(coeffs, dom):
    """Evaluate the light curve from empirical Fourier coefficients at
    phases in [0, 1) (reference ``eventstats.py:228``)."""
    dom = np.asarray(dom) * TWOPI
    aks, bks = coeffs
    out = np.ones_like(dom)
    for i in range(1, len(aks) + 1):
        out = out + 2 * (aks[i - 1] * np.cos(i * dom)
                         + bks[i - 1] * np.sin(i * dom))
    return out


def sf_h20_dj1989(h: float) -> float:
    """H-test chance probability, de Jager et al. 1989 calibration
    (reference ``eventstats.py:319``; kept for parity — the quadratic term
    is known to be approximate)."""
    if h <= 23:
        return 0.9999755 * np.exp(-0.39802 * h)
    return 4e-8 if h > 50 else 1.210597 * np.exp(-0.45901 * h + 0.00229 * h**2)


def sf_h20_dj2010(h: float) -> float:
    """H-test chance probability, de Jager & Busching 2010 asymptotic."""
    return float(np.exp(-0.4 * h))


def sig2h20(sig: float) -> float:
    """Invert the 2010 calibration: H for a given chance probability."""
    return float(-np.log(sig) / 0.4)


def sigma_trials(sigma: float, trials: float) -> float:
    """Correct a significance for a trials factor (reference
    ``eventstats.py:125``)."""
    if sigma >= 20:
        return float((sigma**2 - 2 * np.log(trials)) ** 0.5)
    p = sigma2sig(sigma) * trials
    return 0.0 if p >= 1 else sig2sigma(p)


def vec(func):
    """Vectorize a scalar statistic, preserving its docstring (reference
    ``eventstats.py:35``)."""
    return np.vectorize(func, doc=func.__doc__)


def to_array(x, dtype=None):
    """Promote a scalar to a 1-element array; pass arrays through
    (reference ``eventstats.py:41``)."""
    x = np.asarray(x, dtype=dtype)
    return np.asarray([x]) if x.ndim == 0 else x


def from_array(x):
    """Inverse of :func:`to_array`: unwrap 1-element arrays (reference
    ``eventstats.py:46``)."""
    return x[0] if (x.ndim == 1) and (x.shape[0] == 1) else x
