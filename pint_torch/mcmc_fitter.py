"""MCMC fitter: posterior sampling of timing-model parameters (port of
``pint_tpu/mcmc_fitter.py:101-343``).

``MCMCFitter.fit_toas`` advances a walker ensemble with
:class:`~pint_torch.sampler.EnsembleSampler`, each half-ensemble evaluated
by :meth:`BayesianTiming.lnposterior_batch` on the model's device, and
sets the model to the maximum-posterior sample.  A ``checkpoint`` file
persists the chain with the generator's state and a fingerprint of the
run, so that a resumed run continues the chain bit-identically and a
checkpoint of another run is refused.

The photon-template fitters live in :mod:`pint_torch.event_fitter` and
import from here too, as the reference's do.  Not in the port yet: walker
plans (ROADMAP queue A item 9), which raise ``NotImplementedError`` naming
the item.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from pint_torch.bayesian import BayesianTiming, apply_prior_info
from pint_torch.fitter import Fitter
from pint_torch.logging import log
from pint_torch.sampler import EnsembleSampler, MCMCSampler, NpzBackend

__all__ = ["MCMCFitter", "MCMCFitterBinnedTemplate",
           "MCMCFitterAnalyticTemplate", "set_priors_basic", "lnprior_basic",
           "lnlikelihood_basic", "lnlikelihood_chi2", "concat_toas"]


def __getattr__(name):
    # the photon-template fitters live with the template machinery; the
    # reference's import location works too (``mcmc_fitter.py:441``)
    if name in ("MCMCFitterBinnedTemplate", "MCMCFitterAnalyticTemplate"):
        import pint_torch.event_fitter as ef

        return getattr(ef, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def lnprior_basic(ftr, theta) -> float:
    """Sum of parameter log-priors at ``theta`` (reference
    ``mcmc_fitter.py lnprior_basic``)."""
    theta = np.asarray(theta, dtype=np.float64)
    if isinstance(ftr, MCMCFitter):
        return float(ftr.bt.lnprior(theta))
    return float(sum(ftr.model[p].prior.logpdf(v)
                     for p, v in zip(ftr.fitkeys, theta)))


def lnlikelihood_chi2(ftr, theta) -> float:
    """Residual-based log-likelihood at ``theta`` (reference
    ``mcmc_fitter.py lnlikelihood_chi2``)."""
    if not isinstance(ftr, MCMCFitter):
        raise TypeError(
            f"{type(ftr).__name__} has no residual chi2 likelihood; use "
            "its lnposterior (photon-template) instead")
    return float(ftr.bt.lnlikelihood(np.asarray(theta, dtype=np.float64)))


def lnlikelihood_basic(ftr, theta):
    """Photon-template log-likelihood at ``theta`` (reference
    ``mcmc_fitter.py:59``): template density at the wrapped event phases,
    weight-mixed when photon weights are present, clamped at 1e-300 as the
    fitter's own batched posterior is; on the host, from the model's
    phases (the parameters keep the values afterwards)."""
    if not hasattr(ftr, "_template_density"):
        raise TypeError(
            f"{type(ftr).__name__} has no photon template; "
            "lnlikelihood_basic is for the template MCMC fitters "
            "(use lnlikelihood_chi2 for residual fitters)")
    for p, v in zip(ftr.fitkeys, np.atleast_1d(np.asarray(theta, float))):
        ftr.model[p].value = float(v)
    ph = ftr.model.phase(ftr.batch).frac.cpu().numpy() % 1.0
    probs = np.maximum(np.asarray(ftr._template_density(ph)), 1e-300)
    if getattr(ftr, "weights", None) is None:
        return float(np.sum(np.log(probs)))
    return float(np.sum(np.log(ftr.weights * probs + 1.0 - ftr.weights)))


def set_priors_basic(ftr, priorerrfact: float = 10.0):
    """Uniform priors at +/- priorerrfact * uncertainty around the current
    values (reference ``mcmc_fitter.py set_priors_basic``); raises for a
    free parameter with no uncertainty."""
    info = {}
    for p in ftr.fitkeys:
        par = ftr.model[p]
        if not par.uncertainty:
            raise ValueError(
                f"Parameter {p} has no uncertainty; cannot build its "
                "basic uniform prior")
        half = priorerrfact * float(par.uncertainty)
        v = float(par.value or 0.0)
        info[p] = {"distr": "uniform", "pmin": v - half, "pmax": v + half}
    apply_prior_info(ftr.model, info)
    if hasattr(ftr, "_bt"):
        ftr._bt = None  # the cached BayesianTiming must see the new priors
    return info


def concat_toas(toas_list):
    """Concatenate TOA batches (reference ``mcmc_fitter.py concat_toas``;
    :func:`pint_torch.toa.merge_TOAs`)."""
    from pint_torch.toa import merge_TOAs

    return merge_TOAs(list(toas_list))


class MCMCFitter(Fitter):
    """Posterior sampling fit (reference ``mcmc_fitter.py:109``).

    A sampler object (default: :class:`EnsembleSampler` with 32 walkers),
    optional prior_info, custom ``lnprior``/``lnlike`` callables with
    signature (fitter, theta).  ``fit_toas(maxiter=N)`` runs N ensemble
    steps and sets the model to the maximum-posterior sample.
    """

    def __init__(self, batch, model, sampler: Optional[MCMCSampler] = None,
                 prior_info: Optional[dict] = None,
                 use_pulse_numbers: bool = False, nwalkers: int = 32,
                 errfact: float = 0.1, resids: bool = True,
                 lnprior=None, lnlike=None, setpriors=None,
                 weights=None, phs=None, phserr=None,
                 minMJD: float = 40000.0, maxMJD: float = 60000.0, **kw):
        if not resids:
            raise TypeError(
                "resids=False selects the reference's photon-template mode; "
                "use MCMCFitterBinnedTemplate / MCMCFitterAnalyticTemplate "
                "(pint_torch.event_fitter) for that")
        super().__init__(batch, model, **kw)
        self.method = "MCMC"
        self.sampler = sampler or EnsembleSampler(nwalkers)
        self.errfact = errfact
        # custom lnprior/lnlike callables switch sampling onto a scalar
        # host path, as the reference's do; with the defaults the batched
        # BayesianTiming posterior runs on the device
        self.use_resids = True
        self._custom_post = lnprior is not None or lnlike is not None
        self.lnprior = lnprior if lnprior is not None else lnprior_basic
        self.lnlikelihood = (lnlike if lnlike is not None
                             else lnlikelihood_chi2)
        self.set_priors = setpriors if setpriors is not None \
            else set_priors_basic
        self.weights = weights
        self.phs, self.phserr = phs, phserr
        self.minMJD, self.maxMJD = minMJD, maxMJD
        # constructor priors install on the live model once, so every
        # (re)build of the BayesianTiming below sees them; it is built
        # lazily to allow the reference flow (construct the fitter, then
        # set_priors_basic)
        if prior_info:
            apply_prior_info(self.model, prior_info)
        self._bt: Optional[BayesianTiming] = None
        self._bt_args = dict(use_pulse_numbers=use_pulse_numbers)
        self.fitkeys = list(self.model.free_params)
        self.n_fit_params = len(self.fitkeys)
        self.maxpost = -np.inf
        self.maxpost_fitvals = None

    @property
    def bt(self) -> BayesianTiming:
        if self._bt is not None \
                and self._bt.param_labels != self.model.free_params:
            self._bt = None  # free-parameter set changed since first build
        if self._bt is None:
            self._bt = BayesianTiming(self.model, self.batch, **self._bt_args)
            if self.fitkeys != list(self._bt.param_labels):
                if getattr(self.sampler, "ntotal", 0) \
                        and hasattr(self.sampler, "reset"):
                    log.warning(
                        "Free-parameter set changed after sampling started; "
                        "resetting the chain (old samples would mislabel "
                        "columns)")
                    self.sampler.reset()
                self.fitkeys = list(self._bt.param_labels)
                self.n_fit_params = len(self.fitkeys)
        return self._bt

    def get_fitvals(self) -> np.ndarray:
        return np.array([float(self.model[p].value or 0.0)
                         for p in self.fitkeys])

    def get_fiterrs(self) -> np.ndarray:
        return np.array([float(self.model[p].uncertainty or 0.0)
                         for p in self.fitkeys])

    def batched_posterior(self):
        """The batched lnposterior the ensemble sampling evaluates
        (:class:`pint_torch.bayesian.BatchedPosterior`)."""
        return self.bt.batched_posterior()

    def lnposterior(self, theta) -> float:
        if self._custom_post:
            lp = self.lnprior(self, theta)
            if not np.isfinite(lp):
                return -np.inf
            return lp + self.lnlikelihood(self, theta)
        return self.bt.lnposterior(theta)

    def fit_toas(self, maxiter: int = 100, pos=None,
                 seed: Optional[int] = None,
                 burn_frac: float = 0.25, checkpoint: Optional[str] = None,
                 plan=None, **kw) -> float:
        """Run the ensemble for *maxiter* steps; the model is set to the
        maximum-posterior sample (uncertainties: the posterior stds after
        ``burn_frac`` of the chain) and the chi2 there is returned and
        written to CHI2.

        ``checkpoint`` names an npz file: the chain and the generator's
        exact state persist through :class:`NpzBackend`, and a run whose
        file exists resumes from it -- only the remaining steps are
        sampled, continuing the chain bit-identically to an uninterrupted
        run."""
        if plan is not None:
            raise NotImplementedError(
                "walker plans are ROADMAP queue A item 9")
        if checkpoint is not None:
            from pint_torch.grid import _model_param_sig
            from pint_torch.runtime.checkpoint import fingerprint_of

            if not isinstance(self.sampler, EnsembleSampler):
                raise TypeError(
                    "checkpoint= requires the batched EnsembleSampler")
            if self.sampler.backend is None \
                    or getattr(self.sampler.backend, "path", None) \
                    not in (checkpoint, checkpoint + ".npz"):
                self.sampler.backend = NpzBackend(checkpoint)
            # run identity: the fit keys, the data and the frozen
            # parameters; the free values are the sampled quantities and
            # move when a chain is extended on the same fitter
            self.sampler.fingerprint = fingerprint_of(
                fitkeys=tuple(self.fitkeys), ntoas=self.batch.ntoas,
                toas_version=0,
                frozen=tuple(s for s in _model_param_sig(self.model)
                             if s[0] not in self.fitkeys))
            if self.sampler.backend.exists() and pos is None:
                pos = self.sampler.resume()
                maxiter = max(0, maxiter - self.sampler.iteration)
        if self._custom_post:
            # the bt property resyncs fitkeys/n_fit_params when the free
            # set changed since construction
            _ = self.bt

            def post_batch(thetas):
                return np.array([self.lnposterior(t)
                                 for t in np.asarray(thetas)])

            if isinstance(self.sampler, EnsembleSampler):
                self.sampler.initialize_batched(post_batch,
                                                self.n_fit_params)
            else:
                self.sampler.initialize_sampler(self.lnposterior,
                                                self.n_fit_params)
        else:
            post_batch = self.bt.lnposterior_batch
            if isinstance(self.sampler, EnsembleSampler):
                self.sampler.initialize_batched(post_batch,
                                                self.n_fit_params)
            else:
                self.sampler.initialize_sampler(self.bt.lnposterior,
                                                self.n_fit_params)
        if pos is None:
            pos = self.sampler.get_initial_pos(
                self.fitkeys, self.get_fitvals(), self.get_fiterrs(),
                self.errfact, seed=seed)
            # clip the initial ball inside the prior support
            lp = post_batch(pos)
            bad = ~np.isfinite(lp)
            if bad.any():
                pos[bad] = self.get_fitvals()
        self.sampler.run_mcmc(pos, maxiter)
        # burn-in from the total accumulated chain, so that a resumed run
        # is equivalent to an uninterrupted one
        nsteps = self.sampler.get_chain().shape[0]
        chain = self.sampler.get_chain(flat=True,
                                       discard=int(nsteps * burn_frac))
        lnp = self.sampler.get_log_prob(flat=True,
                                        discard=int(nsteps * burn_frac))
        imax = int(np.argmax(lnp))
        self.maxpost = float(lnp[imax])
        self.maxpost_fitvals = chain[imax]
        stds = chain.std(axis=0)
        for i, p in enumerate(self.fitkeys):
            self.model[p].value = float(self.maxpost_fitvals[i])
            self.model[p].uncertainty = float(stds[i])
            self.errors[p] = float(stds[i])
        self.fitted_params = list(self.fitkeys)
        self.update_resids()
        chi2 = self.resids.chi2
        self.model["CHI2"].value = chi2
        self.converged = True
        return chi2

    def get_posterior_samples(self, burn_frac: float = 0.25) -> np.ndarray:
        n = self.sampler.get_chain().shape[0]
        return self.sampler.get_chain(flat=True, discard=int(n * burn_frac))

    def get_fit_summary(self, burn_frac: float = 0.25) -> str:
        samples = self.get_posterior_samples(burn_frac)
        nsteps = self.sampler.get_chain().shape[0]
        lines = [f"MCMC fit: {self.sampler.nwalkers} walkers x "
                 f"{nsteps} steps, acceptance "
                 f"{self.sampler.acceptance_fraction:.2f}",
                 f"{'PAR':<12} {'median':>20} {'std':>12} {'maxpost':>20}"]
        med = np.median(samples, axis=0)
        std = np.std(samples, axis=0)
        for i, p in enumerate(self.fitkeys):
            lines.append(f"{p:<12} {med[i]:>20.12g} {std[i]:>12.3g} "
                         f"{self.maxpost_fitvals[i]:>20.12g}")
        return "\n".join(lines)
