"""Photon-domain MCMC fitters: sample timing parameters against a pulse
profile template using per-photon likelihoods (port of
``pint_tpu/event_fitter.py``).

lnlike = sum_i log(w_i f(phi_i) + (1 - w_i)) (Pletsch & Clark 2015), with f
a binned template lookup (:class:`MCMCFitterBinnedTemplate`, the fitter of
``event_optimize``) or the analytic ``LCTemplate``
(:class:`MCMCFitterAnalyticTemplate`).  A half-ensemble is one call: the
model's phase at every walker row and photon is one
:meth:`TimingModel.evaluate` on the (B, ndim) walker rows, then the prior
and, through the hand kernel K8 (:mod:`pint_torch.kernels.photon_lnlike`),
the template density and each row's log-likelihood sum on the model's
device.  An analytic template whose peaks are not all ``LCGaussian`` is
evaluated by its primitives' torch ``_pdf`` branches and a torch log-sum
instead; the choice is made once, from the template's classes, when the
batched function is built, and shows in the fitter's ``repr``.

The photon prior is the reference's (``event_fitter.py:111-121``): 0 inside
a uniform box and -inf outside, ``-0.5 ((v - mu) / sigma)^2`` for a normal
prior, without the normalizations that :mod:`pint_torch.bayesian` adds;
a prior of any other family adds nothing.  Device-resident walker batches
(the reference's mesh path) are ROADMAP queue A item 9 and the
phaseogram's plot item 12.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from pint_torch import F64
from pint_torch.fitter import Fitter
from pint_torch.kernels.photon_lnlike import (BINNED, GAUSS, MIXED,
                                              MIXED_CODES, gauss_table,
                                              mixed_table, photon_lnlike)
from pint_torch.sampler import EnsembleSampler
from pint_torch.templates import lcprimitives as _prims
from pint_torch.templates.lcprimitives import LCGaussian
from pint_torch.templates.lctemplate import LCTemplate

#: the closed-form primitives K8's MIXED mode evaluates
_MIXED_CLASSES = tuple(getattr(_prims, name) for name in MIXED_CODES)

__all__ = ["MCMCFitterBinnedTemplate", "MCMCFitterAnalyticTemplate",
           "marginalize_over_phase"]


def marginalize_over_phase(phases, template_bins, weights=None,
                           nbins: Optional[int] = None):
    """Maximize the template likelihood over a constant phase offset by
    brute-force scan (reference ``event_optimize.py marginalize_over_phase``).
    Returns (dphis, lnlikes)."""
    template_bins = np.asarray(template_bins, dtype=np.float64)
    n = len(template_bins)
    dphis = np.arange(n) / n
    phases = np.asarray(phases) % 1.0
    lnls = np.empty(n)
    w = weights
    for i, dphi in enumerate(dphis):
        idx = ((phases + dphi) * n).astype(int) % n
        f = template_bins[idx]
        vals = f if w is None else w * f + (1 - w)
        lnls[i] = np.sum(np.log(np.maximum(vals, 1e-300)))
    return dphis, lnls


class _PhotonMCMCFitter(Fitter):
    """Shared machinery: free timing params sampled, photon-template
    likelihood, batched ensemble."""

    def __init__(self, batch, model, template, weights=None,
                 sampler: Optional[EnsembleSampler] = None, nwalkers: int = 32,
                 prior_info: Optional[dict] = None, errfact: float = 0.1,
                 minMJD=None, maxMJD=None, backend=None, seed=None, **kw):
        if weights is not None:
            weights = np.asarray(weights, dtype=np.float64)
        if minMJD is not None or maxMJD is not None:
            mjds = np.asarray(batch.mjds, dtype=np.float64)
            keep = np.ones(batch.ntoas, dtype=bool)
            if minMJD is not None:
                keep &= mjds >= float(minMJD)
            if maxMJD is not None:
                keep &= mjds <= float(maxMJD)
            batch = batch.select(keep, model)
            if weights is not None:
                weights = weights[keep]
        super().__init__(batch, model, **kw)
        self.method = "MCMC_photon"
        self.template = template
        if weights is not None:
            self.weights = weights
        elif batch.weights is not None:
            self.weights = batch.weights.cpu().numpy()
        else:
            self.weights = None
        self.sampler = sampler or EnsembleSampler(nwalkers, seed=seed,
                                                  backend=backend)
        self.errfact = errfact
        if prior_info is not None:
            from pint_torch.bayesian import apply_prior_info

            apply_prior_info(self.model, prior_info)
        self.fitkeys = list(self.model.free_params)
        self.n_fit_params = len(self.fitkeys)
        self.maxpost = -np.inf
        self.maxpost_fitvals = None
        self._batch_fn = None

    # -- the template density on the device (subclasses provide) -------------
    def _table(self):
        """(mode, table tensor on the batch's device) for K8, or None where
        the template is evaluated by its primitives' torch branches."""
        raise NotImplementedError

    def density_route(self) -> str:
        """How the template density is evaluated on the device."""
        kt = self._table()
        if kt is None:
            names = sorted({type(p).__name__
                            for p in self.template.primitives})
            return f"torch _pdf ({', '.join(names)})"
        return "K8 photon_lnlike " + {BINNED: "BINNED", GAUSS: "GAUSS",
                                      MIXED: "MIXED"}[kt[0]]

    def _density(self, frac: torch.Tensor) -> torch.Tensor:
        """The template density at ``frac mod 1`` (any shape; K8 takes it
        as (B, N) rows)."""
        kt = self._table()
        if kt is None:
            return self.template(torch.remainder(frac, 1.0))
        rows = frac.reshape(-1, frac.shape[-1]) if frac.ndim else \
            frac.reshape(1, 1)
        return photon_lnlike(rows, None, kt[1], kt[0],
                             density=True).reshape(frac.shape)

    def _lnlike(self, frac: torch.Tensor, w) -> torch.Tensor:
        """(B,) sums of log(max(w f + 1 - w, 1e-300)) over each row."""
        kt = self._table()
        if kt is not None:
            return photon_lnlike(frac, w, kt[1], kt[0])
        f = self._density(frac)
        vals = f if w is None else w * f + (1.0 - w)
        floor = torch.full((), 1e-300, dtype=F64, device=f.device)
        return torch.sum(torch.log(torch.maximum(vals, floor)), dim=-1)

    def _template_density(self, phifrac):
        """Template density at the given phases (host numpy in and out),
        the reference's hook that :func:`pint_torch.mcmc_fitter
        .lnlikelihood_basic` reads."""
        x = torch.as_tensor(np.asarray(phifrac, dtype=np.float64),
                            dtype=F64, device=self.batch.device)
        return self._density(x).cpu().numpy()

    def _build_batch(self):
        """(B, ndim) -> (B,) on the model's device (reference
        ``event_fitter.py:90-129``)."""
        model, batch = self.model, self.batch
        dev = batch.device
        free = tuple(self.fitkeys)
        const_pv = model.const_pv()
        w = None if self.weights is None else torch.as_tensor(
            self.weights, dtype=F64, device=dev)
        zero = torch.zeros((), dtype=F64, device=dev)
        ninf = torch.full((), -math.inf, dtype=F64, device=dev)
        priors = []
        for i, p in enumerate(self.fitkeys):
            spec = model[p].prior.jax_spec()
            if spec is None:
                continue  # improper flat prior contributes 0
            kind, a, b = spec
            priors.append((i, kind, torch.tensor(a, dtype=F64, device=dev),
                           torch.tensor(b, dtype=F64, device=dev)))
        self._table()  # the template's route, chosen before the first call

        def fn(values: torch.Tensor) -> torch.Tensor:
            lnpr = 0.0
            for i, kind, a, b in priors:
                v = values[:, i]
                if kind == "uniform":
                    lnpr = lnpr + torch.where((v >= a) & (v <= b), zero,
                                              ninf)
                else:
                    d = (v - a) / b
                    lnpr = lnpr - 0.5 * (d * d)
            ph, _ = model.evaluate(values, free, batch, const_pv)
            return lnpr + self._lnlike(ph.frac, w)

        return fn

    def lnposterior_batch(self, pts):
        """lnposterior over (B, ndim) host points: one batched call on the
        model's device, one read back."""
        if torch.is_tensor(pts):
            raise NotImplementedError(
                "device-resident walker batches (the reference's mesh path) "
                "are ROADMAP queue A item 9; pass host points")
        if self._batch_fn is None:
            self._batch_fn = self._build_batch()
        vals = torch.as_tensor(np.atleast_2d(np.asarray(pts,
                                                        dtype=np.float64)),
                               dtype=F64, device=self.batch.device)
        return self._batch_fn(vals).cpu().numpy()

    def lnposterior(self, theta) -> float:
        return float(self.lnposterior_batch(np.asarray(theta)[None, :])[0])

    def get_fitvals(self):
        return np.array([float(self.model[p].value or 0.0)
                         for p in self.fitkeys])

    def get_fiterrs(self):
        return np.array([float(self.model[p].uncertainty or 0.0)
                         for p in self.fitkeys])

    def fit_toas(self, maxiter: int = 200, pos=None, seed=None,
                 burn_frac: float = 0.25, resume: bool = False,
                 autocorr: bool = False, **kw) -> float:
        """With ``autocorr=True`` the chain runs until the autocorrelation
        convergence criteria hold (reference ``event_optimize.py:239
        run_sampler_autocorr``) instead of a fixed length."""
        self.sampler.initialize_batched(self.lnposterior_batch,
                                        self.n_fit_params)
        requested_steps = maxiter  # burn-in is a fraction of the REQUEST,
        # unaffected by the resume subtraction below
        if resume:
            # continue the chain from the backend checkpoint (bit-identical
            # to an uninterrupted run; reference event_optimize --backend)
            pos = self.sampler.resume()
            maxiter = max(0, maxiter - len(self.sampler._chain))
        elif pos is None:
            pos = self.sampler.get_initial_pos(
                self.fitkeys, self.get_fitvals(), self.get_fiterrs(),
                self.errfact, seed=seed)
            lp = self.lnposterior_batch(pos)
            pos[~np.isfinite(lp)] = self.get_fitvals()
        if maxiter > 0 and autocorr:
            from pint_torch.sampler import run_sampler_autocorr

            self.autocorr = run_sampler_autocorr(
                self.sampler, pos, maxiter,
                int(requested_steps * burn_frac))
        elif maxiter > 0:
            self.sampler.run_mcmc(pos, maxiter)
        if not len(self.sampler._chain):
            raise ValueError(
                "fit_toas produced an empty chain (maxiter=0 with no resumed "
                "steps); request at least one step or resume a backend")
        if autocorr:
            # the chain may stop early on convergence (or the resume may
            # already satisfy the request), but the requested burn-in is
            # absolute — never re-fraction a shortened chain
            discard = max(0, min(int(requested_steps * burn_frac),
                                 len(self.sampler._chain) - 1))
        else:
            discard = int(len(self.sampler._chain) * burn_frac)
        chain = self.sampler.get_chain(flat=True, discard=discard)
        lnp = self.sampler.get_log_prob(flat=True, discard=discard)
        imax = int(np.argmax(lnp))
        self.maxpost = float(lnp[imax])
        self.maxpost_fitvals = chain[imax]
        stds = chain.std(axis=0)
        for i, p in enumerate(self.fitkeys):
            self.model[p].value = float(self.maxpost_fitvals[i])
            self.model[p].uncertainty = float(stds[i])
            self.errors[p] = float(stds[i])
        self.fitted_params = list(self.fitkeys)
        self.converged = True
        return self.maxpost

    def update_resids(self):  # photon data has no time residuals
        return None

    # -- reference MCMCFitter accessor surface (mcmc_fitter.py:109+) --------
    def get_event_phases(self) -> np.ndarray:
        """Fractional pulse phase of every photon under the current model
        (reference ``mcmc_fitter.py get_event_phases``)."""
        return self.phaseogram_phases()

    def get_weights(self) -> np.ndarray:
        """Per-photon weights (ones when unweighted; reference
        ``mcmc_fitter.py get_weights``)."""
        return self.weights if self.weights is not None \
            else np.ones(self.batch.ntoas)

    def get_template_vals(self, phases) -> np.ndarray:
        """Template density at the given phases (reference
        ``mcmc_fitter.py get_template_vals``), computed on the model's
        device (K8's density where it evaluates the template)."""
        return self._template_density(phases)

    def get_parameters(self) -> np.ndarray:
        """Current sampled-parameter values (reference
        ``mcmc_fitter.py get_parameters``)."""
        return np.asarray(self.get_fitvals(), dtype=np.float64)

    def set_parameters(self, theta) -> None:
        """Write sampled-parameter values into the model (reference
        ``mcmc_fitter.py set_parameters``)."""
        for p, v in zip(self.fitkeys, np.asarray(theta, dtype=np.float64)):
            self.model[p].value = float(v)

    def get_parameter_names(self) -> list:
        """Names of the sampled parameters (reference
        ``mcmc_fitter.py get_parameter_names``)."""
        return list(self.fitkeys)

    def get_model_parameters(self) -> dict:
        """{name: value} of the sampled timing parameters (reference
        ``mcmc_fitter.py get_model_parameters``)."""
        return dict(zip(self.fitkeys, self.get_parameters()))

    def get_template_parameters(self):
        """Template parameters when an LCTemplate is attached (reference
        ``mcmc_fitter.py get_template_parameters``); None for binned
        array templates."""
        if isinstance(self.template, LCTemplate):
            return self.template.get_parameters()
        return None

    def clip_template_params(self, pos):
        """Hook clipping template-parameter walkers into bounds (reference
        ``mcmc_fitter.py clip_template_params``); timing-only sampling
        here, so positions pass through."""
        return pos

    def get_errors(self) -> np.ndarray:
        """Current per-parameter errors (reference
        ``mcmc_fitter.py get_errors``)."""
        return np.asarray(self.get_fiterrs(), dtype=np.float64)

    def phaseogram(self, bins: int = 64, rotate: float = 0.0, file=None):
        """Phaseogram plot (reference ``mcmc_fitter.py phaseogram``): needs
        matplotlib, which the port does not depend on."""
        raise NotImplementedError(
            "phaseogram draws with matplotlib; plotting is ROADMAP queue A "
            "item 12 (phaseogram_phases gives the phases it folds)")

    def phaseogram_phases(self) -> np.ndarray:
        ph = self.model.phase(self.batch)
        return ph.frac.cpu().numpy() % 1.0

    def __repr__(self):
        return (f"{type(self).__name__}({self.batch.ntoas} photons, "
                f"{'weighted' if self.weights is not None else 'unweighted'}"
                f", free {self.fitkeys}, template density: "
                f"{self.density_route()})")


class MCMCFitterBinnedTemplate(_PhotonMCMCFitter):
    """Template held as a binned lookup (reference ``mcmc_fitter.py:441``)."""

    def __init__(self, batch, model, template, nbins: int = 256, **kw):
        if isinstance(template, LCTemplate):
            grid = (np.arange(nbins) + 0.5) / nbins
            template_bins = np.asarray(template(grid), dtype=np.float64)
        else:
            template_bins = np.asarray(template, dtype=np.float64)
            nbins = len(template_bins)
            # normalize to a density (mean 1 over the cycle)
            template_bins = template_bins / template_bins.mean()
        self.template_bins = template_bins
        self.nbins = nbins
        self._bins = None
        super().__init__(batch, model, template, **kw)

    def set_template(self, template):
        """Replace the template (e.g. after an FFTFIT start-phase rotation):
        rebuilds the binned lookup AND drops the batched likelihood, which
        holds the bins."""
        self.template = template
        if isinstance(template, LCTemplate):
            grid = (np.arange(self.nbins) + 0.5) / self.nbins
            self.template_bins = np.asarray(template(grid), dtype=np.float64)
        else:
            tb = np.asarray(template, dtype=np.float64)
            self.template_bins = tb / tb.mean()
        self._bins = None
        self._batch_fn = None

    def _table(self):
        if self._bins is None:
            self._bins = torch.as_tensor(self.template_bins, dtype=F64,
                                         device=self.batch.device)
        return BINNED, self._bins

    def density_route(self) -> str:
        return super().density_route() + f" ({self.nbins} bins)"


class MCMCFitterAnalyticTemplate(_PhotonMCMCFitter):
    """Analytic LCTemplate evaluated on the device (reference
    ``mcmc_fitter.py:485``); template parameters stay fixed during timing
    sampling (fit them separately with LCFitter).  The route (K8's GAUSS
    mode for a template of ``LCGaussian`` peaks, its MIXED mode for any
    other mixture of the closed-form primitives, else -- an
    energy-dependent template, ``LCSkewGaussian``, ``LCEmpiricalFourier``,
    ``LCKernelDensity`` -- the primitives' torch branches) is chosen at
    the first evaluation; the template's parameters
    are read at every call, as the reference's traced density reads
    them, and go to the device only when they changed (a host-to-device
    copy between an evaluation's kernels would wait for them)."""

    def __init__(self, batch, model, template: LCTemplate, **kw):
        if not isinstance(template, LCTemplate):
            raise TypeError("MCMCFitterAnalyticTemplate needs an LCTemplate")
        self._mode = None
        self._kernel_table = (None, None)
        super().__init__(batch, model, template, **kw)

    def _table(self):
        if self._mode is None:
            prims = self.template.primitives
            closed = not self.template.is_energy_dependent()
            self._mode = GAUSS if closed and all(
                type(p) is LCGaussian for p in prims) else MIXED \
                if closed and all(type(p) in _MIXED_CLASSES
                                  for p in prims) else False
        if self._mode is False:
            return None
        host = gauss_table(self.template) if self._mode == GAUSS \
            else mixed_table(self.template)
        if not np.array_equal(host, self._kernel_table[0]):
            self._kernel_table = (host, torch.as_tensor(
                host, dtype=F64, device=self.batch.device))
        return self._mode, self._kernel_table[1]
