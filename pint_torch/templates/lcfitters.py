"""Maximum-likelihood fitting of pulse-profile templates to photon phases
(a copy of ``pint_tpu/templates/lcfitters.py``, which is numpy and scipy
on the host).

``LCFitter``: unbinned
(optionally weighted) Poisson log-likelihood over photon phases, maximized
with scipy; chi-squared binned fit as a fallback.  The log-likelihood is
the reference's eqn (Pletsch & Clark 2015): sum_i log(w_i f(phi_i) + 1-w_i).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from pint_torch.logging import log
from pint_torch.templates.lctemplate import LCTemplate

__all__ = ["LCFitter", "hessian", "get_errors", "make_err_plot"]


def hessian(func, x0, eps: float = 1e-5) -> np.ndarray:
    """Numerical Hessian by central differences."""
    n = len(x0)
    H = np.zeros((n, n))
    f0 = func(x0)
    for i in range(n):
        for j in range(i, n):
            xpp = x0.copy(); xpp[i] += eps; xpp[j] += eps
            xpm = x0.copy(); xpm[i] += eps; xpm[j] -= eps
            xmp = x0.copy(); xmp[i] -= eps; xmp[j] += eps
            xmm = x0.copy(); xmm[i] -= eps; xmm[j] -= eps
            H[i, j] = H[j, i] = (func(xpp) - func(xpm) - func(xmp) + func(xmm)) \
                / (4 * eps * eps)
    return H


def shifted(m, delta: float = 0.5):
    """Binned profile circularly shifted in phase by ``delta`` via the FFT
    shift theorem (reference ``lcfitters.py:30``)."""
    m = np.asarray(m, dtype=np.float64)
    f = np.fft.fft(m, axis=-1)
    n = f.shape[-1]
    arg = np.fft.fftfreq(n) * (n * np.pi * 2.0j * delta)
    return np.real(np.fft.ifft(np.exp(arg) * f, axis=-1))


def weighted_light_curve(nbins: int, phases, weights, normed: bool = False,
                         phase_shift: float = 0.0):
    """(bin edges, weighted counts, errors) of a weighted folded profile
    (reference ``lcfitters.py:38``)."""
    phases = np.asarray(phases, dtype=np.float64)
    weights = np.asarray(weights, dtype=np.float64)
    bins = np.linspace(0 + phase_shift, 1 + phase_shift, nbins + 1)
    counts = np.histogram(phases, bins=bins)[0]
    w1 = np.histogram(phases, bins=bins, weights=weights)[0].astype(float)
    w2 = np.histogram(phases, bins=bins,
                      weights=weights**2)[0].astype(float)
    errors = np.where(counts > 1, w2**0.5, counts)
    norm = w1.sum() / nbins if normed else 1.0
    return bins, w1 / norm, errors / norm


def hess_from_grad(grad_fn, x0, eps: float = 1e-5) -> np.ndarray:
    """Hessian by finite-differencing a gradient function (reference
    ``lcfitters.py hess_from_grad``)."""
    x0 = np.asarray(x0, dtype=np.float64)
    n = len(x0)
    H = np.empty((n, n))
    for i in range(n):
        xp = x0.copy()
        xp[i] += eps
        gp = np.asarray(grad_fn(xp))
        xp[i] -= 2 * eps
        gm = np.asarray(grad_fn(xp))
        H[i] = (gp - gm) / (2 * eps)
    return 0.5 * (H + H.T)


def calc_step_size(fit_values, errors, minstep: float = 1e-5) -> np.ndarray:
    """Per-parameter optimizer step sizes from current errors (reference
    ``lcfitters.py calc_step_size``)."""
    errors = np.asarray(errors, dtype=np.float64)
    vals = np.abs(np.asarray(fit_values, dtype=np.float64))
    return np.maximum(np.where(errors > 0, errors, 0.1 * vals), minstep)


class LCFitter:
    def __init__(self, template: LCTemplate, phases, weights=None,
                 binned_bins: int = 100):
        self.template = template
        self.phases = np.asarray(phases, dtype=np.float64) % 1.0
        self.weights = (np.asarray(weights, dtype=np.float64)
                        if weights is not None else None)
        self.binned_bins = binned_bins
        self.ll_best = None

    # -- likelihood ----------------------------------------------------------
    def loglikelihood(self, p=None) -> float:
        """log L = sum log(w f(phi) + (1-w)); unweighted w == 1."""
        if p is not None:
            self.template.set_parameters(p)
        f = np.asarray(self.template(self.phases))
        if self.weights is None:
            vals = f
        else:
            vals = self.weights * f + (1.0 - self.weights)
        if np.any(vals <= 0):
            return -np.inf
        return float(np.sum(np.log(vals)))

    def __call__(self, p=None) -> float:
        return -self.loglikelihood(p)

    # -- fitting -------------------------------------------------------------
    def fit(self, method: str = "Nelder-Mead", maxiter: int = 2000,
            estimate_errors: bool = True, quiet: bool = True) -> bool:
        """Default optimizer is Nelder-Mead: the likelihood surface mixes
        very different scales (widths ~1e-2, angles ~1) and gradient-free
        simplex handles it far more reliably than numerically-differenced
        L-BFGS here."""
        from scipy.optimize import minimize

        x0 = self.template.get_parameters()

        def nll(p):
            try:
                v = self(p)
            except (ValueError, FloatingPointError):
                return 1e30
            return v if np.isfinite(v) else 1e30

        res = minimize(nll, x0, method=method,
                       options={"maxiter": maxiter})
        self.template.set_parameters(res.x)
        for p in self.template.primitives:
            p.set_location(p.get_location() % 1.0)
        self.ll_best = -res.fun
        if estimate_errors:
            self.errors = self._hessian_errors(nll, res.x)
        if not quiet:
            log.info(f"LCFitter: logL = {self.ll_best:.2f}, "
                     f"success = {res.success}")
        return bool(res.success)

    def fit_position(self, unbinned: bool = True) -> tuple:
        """Fit only an overall rotation of the template; returns
        (shift, error) (reference ``lcfitters.py fit_position``)."""
        from scipy.optimize import minimize_scalar

        base = [p.get_location() for p in self.template.primitives]

        def nll(dphi):
            for p, b in zip(self.template.primitives, base):
                p.set_location((b + dphi) % 1.0)
            return -self.loglikelihood()

        res = minimize_scalar(nll, bounds=(-0.5, 0.5), method="bounded",
                              options={"xatol": 1e-6})
        shift = float(res.x)
        # curvature -> error
        eps = 1e-4
        d2 = (nll(shift + eps) - 2 * nll(shift) + nll(shift - eps)) / eps**2
        err = 1.0 / np.sqrt(d2) if d2 > 0 else np.nan
        for p, b in zip(self.template.primitives, base):
            p.set_location((b + shift) % 1.0)
        return shift, float(err)

    # -- reference fit-method family and stats (lcfitters.py) ---------------
    def fit_fmin(self, **kw):
        """Nelder-Mead fit (reference ``lcfitters.py fit_fmin``)."""
        return self.fit(method="Nelder-Mead", **kw)

    def fit_bfgs(self, **kw):
        """BFGS fit (reference ``lcfitters.py fit_bfgs``)."""
        return self.fit(method="BFGS", **kw)

    def fit_cg(self, **kw):
        """Conjugate-gradient fit (reference ``lcfitters.py fit_cg``)."""
        return self.fit(method="CG", **kw)

    def fit_l_bfgs_b(self, **kw):
        """L-BFGS-B fit (reference ``lcfitters.py fit_l_bfgs_b``)."""
        return self.fit(method="L-BFGS-B", **kw)

    def fit_tnc(self, **kw):
        """Truncated-Newton fit (reference ``lcfitters.py fit_tnc``)."""
        return self.fit(method="TNC", **kw)

    def aic(self) -> float:
        """Akaike information criterion at the current parameters
        (reference ``lcfitters.py aic``)."""
        k = self.template.num_parameters()
        return 2.0 * k - 2.0 * self.loglikelihood()

    def bic(self) -> float:
        """Bayesian information criterion (reference
        ``lcfitters.py bic``)."""
        k = self.template.num_parameters()
        return k * np.log(len(self.phases)) - 2.0 * self.loglikelihood()

    def chi(self, bins: int = 50):
        """(chi2, dof) of the binned profile against the template
        (reference ``lcfitters.py chi``)."""
        edges = np.linspace(0.0, 1.0, bins + 1)
        centers = 0.5 * (edges[1:] + edges[:-1])
        if self.weights is None:
            counts, _ = np.histogram(self.phases, bins=edges)
            ntot = len(self.phases)
        else:
            counts, _ = np.histogram(self.phases, bins=edges,
                                     weights=self.weights)
            ntot = float(self.weights.sum())
        expect = np.asarray(self.template(centers)) / bins * ntot
        var = np.maximum(expect, 1e-12)
        chi2 = float(np.sum((counts - expect) ** 2 / var))
        return chi2, bins - self.template.num_parameters()

    def _hessian_errors(self, nll, x0) -> np.ndarray:
        """sqrt(diag(H^-1)) of the negative log-likelihood at ``x0``,
        restoring the template (the probe mutates it) — the ONE
        implementation behind both fit() and hess_errors()."""
        try:
            H = hessian(nll, x0)
            cov = np.linalg.inv(H)
            errs = np.sqrt(np.maximum(np.diag(cov), 0.0))
        except np.linalg.LinAlgError:
            log.warning("Hessian not invertible; no template errors")
            errs = np.zeros(len(x0))
        self.template.set_parameters(x0)
        for p in self.template.primitives:
            p.set_location(p.get_location() % 1.0)
        return errs

    def hess_errors(self) -> np.ndarray:
        """Parameter errors from the likelihood Hessian at the current
        parameters (reference ``lcfitters.py hess_errors``)."""
        x0 = self.template.get_parameters().copy()

        def nll(p):
            # same guard as fit(): a probe stepping into zero density must
            # register as a huge nll, not inf/exception (inv(H with inf)
            # silently yields NaN)
            try:
                v = self(p)
            except (ValueError, FloatingPointError):
                return 1e30
            return v if np.isfinite(v) else 1e30

        self.errors = self._hessian_errors(nll, x0)
        return self.errors

    def bootstrap_errors(self, nsamp: int = 20, fit_kwargs=None,
                         rng=None) -> np.ndarray:
        """Parameter errors by refitting phase resamples (reference
        ``lcfitters.py bootstrap_errors``)."""
        import copy as _copy

        rng = rng or np.random.default_rng()
        fit_kwargs = dict(fit_kwargs or {})
        fit_kwargs.setdefault("estimate_errors", False)
        x0 = self.template.get_parameters().copy()
        samples = []
        for _ in range(nsamp):
            idx = rng.integers(0, len(self.phases), len(self.phases))
            sub = LCFitter(_copy.deepcopy(self.template), self.phases[idx],
                           weights=None if self.weights is None
                           else self.weights[idx])
            sub.template.set_parameters(x0.copy())
            sub.fit(**fit_kwargs)
            samples.append(sub.template.get_parameters().copy())
        self.template.set_parameters(x0)
        errs = np.std(np.asarray(samples), axis=0)
        self.errors = errs
        return errs

    def binned_loglikelihood(self, p=None, bins: int = None) -> float:
        """log-likelihood on a binned profile (Poisson factor dropped;
        reference ``lcfitters.py binned_loglikelihood``)."""
        bins = bins or self.binned_bins
        if p is not None:
            self.template.set_parameters(p)
        edges = np.linspace(0.0, 1.0, bins + 1)
        centers = 0.5 * (edges[1:] + edges[:-1])
        f = np.asarray(self.template(centers))
        counts, _ = np.histogram(self.phases, bins=edges)  # raw photons/bin
        if self.weights is None:
            vals = f
        else:
            wsum, _ = np.histogram(self.phases, bins=edges,
                                   weights=self.weights)
            wbar = np.divide(wsum, np.maximum(counts, 1))
            vals = wbar * f + (1.0 - wbar)
        if np.any(vals[counts > 0] <= 0):
            return -np.inf
        return float(np.sum(counts * np.log(np.maximum(vals, 1e-300))))

    def binned_gradient(self, p=None, bins: int = None,
                        eps: float = 1e-6) -> np.ndarray:
        """Finite-difference gradient of :meth:`binned_loglikelihood`
        (reference ``lcfitters.py binned_gradient``)."""
        x0 = self.template.get_parameters().copy() if p is None \
            else np.asarray(p, dtype=np.float64)
        g = np.empty(len(x0))
        for i in range(len(x0)):
            xp = x0.copy()
            xp[i] += eps
            lp = self.binned_loglikelihood(xp, bins=bins)
            xp[i] -= 2 * eps
            lm = self.binned_loglikelihood(xp, bins=bins)
            g[i] = (lp - lm) / (2 * eps)
        self.template.set_parameters(x0)
        return g

    def remap_errors(self):  # parity no-op
        pass

    def __str__(self):
        ll = self.ll_best if self.ll_best is not None else self.loglikelihood()
        return f"LCFitter: {len(self.phases)} photons, logL = {ll:.2f}\n" \
            + repr(self.template)


def get_errors(template, total, n: int = 100, rng=None, quiet: bool = True):
    """Monte-Carlo estimate of template TOA (phase) errors (reference
    ``lcfitters.py:908 get_errors``).

    For each of ``n`` realizations: draw ``total`` photons from the
    template, re-fit the overall phase by maximum likelihood, and measure
    the log-likelihood curvature at the optimum two ways — with a fixed
    0.01-cycle step and with a step equal to the first estimate itself
    (the reference's self-consistent re-measurement).

    Returns ``(fitvals - ph0, errors, errors_r)``: the phase-fit offsets
    and the two curvature error estimates, each length ``n``.
    """
    from scipy.optimize import minimize_scalar

    rng = rng or np.random.default_rng()
    ph0 = template.get_location()
    work = template.copy()

    def logl(phi, phases):
        work.set_overall_phase(phi % 1)
        vals = np.asarray(work(phases))
        if np.any(vals <= 0):
            return np.inf
        return -np.log(vals).sum()

    fitvals = np.empty(n)
    errors = np.empty(n)
    errors_r = np.empty(n)
    delta = 0.01
    mean = 0.0
    for i in range(n):
        work.set_overall_phase(ph0)
        ph = work.random(total, rng=rng)
        res = minimize_scalar(logl, bounds=(ph0 - 0.5, ph0 + 0.5),
                              args=(ph,), method="bounded",
                              options={"xatol": 1e-7})
        phi0, fopt = float(res.x), float(res.fun)
        fitvals[i] = phi0
        mean += logl(phi0 + delta, ph) - fopt
        curv = (logl(phi0 + delta, ph) - 2 * fopt
                + logl(phi0 - delta, ph)) / delta**2
        if curv > 0:
            errors[i] = curv
            step = curv ** -0.5
            errors_r[i] = (logl(phi0 + step, ph) - 2 * fopt
                           + logl(phi0 - step, ph)) / step**2
        else:
            # flat/concave likelihood at the bounded optimum (low counts):
            # no meaningful curvature error for this realization
            errors[i] = errors_r[i] = np.nan
    if not quiet:
        log.info(f"get_errors: mean dlogL at +{delta} = {mean / n:.2f}")
    return fitvals - ph0, errors ** -0.5, errors_r ** -0.5


def make_err_plot(template, totals=(10, 20, 50, 100, 500), n: int = 100,
                  rng=None, fignum=None):
    """Histogram of the normalized MC phase-fit offsets of
    :func:`get_errors` (reference ``lcfitters.py:942``): needs matplotlib,
    which the port does not depend on (plotting is ROADMAP queue A item
    12)."""
    raise NotImplementedError(
        "make_err_plot draws with matplotlib; plotting is ROADMAP queue A "
        "item 12 (get_errors gives the offsets and errors it histograms)")


#: reference re-export (each template module offers isvector)
from pint_torch.templates.lcnorm import isvector  # noqa: E402,F401
