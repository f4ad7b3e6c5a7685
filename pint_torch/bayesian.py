"""Bayesian timing interface: lnprior / prior_transform / lnlikelihood /
lnposterior for external samplers, and the batched lnposterior over walker
ensembles (port of ``pint_tpu/bayesian.py``).

The batched posterior (:meth:`BayesianTiming.batched_posterior`) is one
call of :meth:`TimingModel.evaluate` on a (B, ndim) tensor of parameter
points -- every free parameter its own value in each row, so every delay
component and kernel works on (B, N) rows that differ in every input --
plus :meth:`TimingModel.evaluate_dm` for wideband TOAs, then the prior, the
weighted mean and the chi2 on the model's device.  ``lnposterior_batch``
takes and returns numpy, with one read from the device per call.

The batched function is not differentiable in reverse mode: the kernels'
``autograd.Function``s define ``jvp`` and ``vmap`` but no ``backward``
(ROADMAP queue B).  With ``use_pulse_numbers`` the TOAs' pulse numbers
are computed under the model and every residual is tracked by them (the
phase's integer part enters).  Device-resident walker batches (the
reference's mesh path) wait for queue A item 9.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pint_torch import F64
from pint_torch.models.priors import Prior
from pint_torch.residuals import Residuals

__all__ = ["BatchedPosterior", "BayesianTiming", "apply_prior_info"]

#: log(sqrt(2 pi)), the normal prior's normalization
_LOG_SQRT_2PI = 0.9189385332046727


class BatchedPosterior(NamedTuple):
    """The typed batched-lnposterior entry point: ``fn`` maps a (B, ndim)
    float64 tensor of parameter points on the model's device to (B,)
    log-posteriors there, beside the free-parameter labels and their
    ``Prior.jax_spec()`` tuples."""

    fn: Callable                    #: (B, ndim) -> (B,) tensors
    param_labels: Tuple[str, ...]   #: free-parameter names, in order
    prior_specs: Tuple[tuple, ...]  #: per-param Prior.jax_spec() tuples

    @property
    def ndim(self) -> int:
        return len(self.param_labels)


def apply_prior_info(model, prior_info: Dict[str, dict]):
    """Install uniform/normal priors from a prior_info dict onto the model's
    parameters."""
    from scipy.stats import norm, uniform

    for par, info in prior_info.items():
        if info["distr"] == "uniform":
            model[par].prior = Prior(
                uniform(info["pmin"], info["pmax"] - info["pmin"]))
        elif info["distr"] == "normal":
            model[par].prior = Prior(norm(info["mu"], info["sigma"]))
        else:
            raise NotImplementedError(
                "Only uniform and normal priors supported in prior_info")


class BayesianTiming:
    """The posterior of a model's free parameters given the TOA batch
    (reference ``bayesian.py:64``): the WLS likelihood, or the wideband
    one when the batch carries DMs."""

    def __init__(self, model, batch, use_pulse_numbers: bool = False,
                 prior_info: Optional[Dict[str, dict]] = None):
        self.model = model.copy()
        self.batch = batch = model.batch_for(batch)
        if use_pulse_numbers:
            batch.compute_pulse_numbers(self.model)
        self.track_mode = "use_pulse_numbers" if use_pulse_numbers \
            else "nearest"
        self.is_wideband = batch.wideband
        self.param_labels: List[str] = list(self.model.free_params)
        self.params = [self.model[p] for p in self.param_labels]
        self.nparams = len(self.param_labels)

        if prior_info is not None:
            apply_prior_info(self.model, prior_info)
        self._validate_priors()
        self.likelihood_method = self._decide_likelihood_method()
        self._batch_fn = None
        #: whether lnposterior_batch vectorizes, decided at its first call
        self._vectorized = None

    def _validate_priors(self):
        for p in self.params:
            if p.prior.is_unbounded:
                raise NotImplementedError(
                    f"Unbounded uniform priors are not supported (param: "
                    f"{p.name}); set an informative prior or pass prior_info")

    def _decide_likelihood_method(self) -> str:
        if self.model.has_correlated_errors:
            raise NotImplementedError(
                "GLS likelihood for correlated noise is not yet implemented "
                "(the reference has the same restriction)")
        return "wb_wls" if self.is_wideband else "wls"

    # -- scalar API ----------------------------------------------------------
    def lnprior(self, params) -> float:
        if len(params) != self.nparams:
            raise IndexError(f"expected {self.nparams} parameters")
        lnp = 0.0
        for p, v in zip(self.params, params):
            lnp += float(p.prior.logpdf(float(v)))
        return lnp

    def prior_transform(self, cube) -> np.ndarray:
        return np.array([p.prior.ppf(c) for p, c in zip(self.params, cube)])

    def lnlikelihood(self, params) -> float:
        """-chi2/2 - sum(log sigma) at ``params``, through the model's own
        residuals (the parameters keep the values afterwards, as the
        reference's do)."""
        for p, v in zip(self.params, params):
            p.value = float(v)
        if self.is_wideband:
            from pint_torch.wideband import WidebandTOAResiduals

            r = WidebandTOAResiduals(
                self.batch, self.model,
                toa_resid_args={"track_mode": self.track_mode})
            chi2 = r.calc_chi2()
            sigmas = torch.cat([r.toa.get_data_error(),
                                r.dm.get_data_error()])
        else:
            r = Residuals(self.batch, self.model,
                          track_mode=self.track_mode)
            chi2 = r.calc_chi2()
            sigmas = r.get_data_error()
        return -0.5 * float(chi2) - float(torch.sum(torch.log(sigmas)))

    def lnposterior(self, params) -> float:
        lnpr = self.lnprior(params)
        if not np.isfinite(lnpr):
            return -np.inf
        return lnpr + self.lnlikelihood(params)

    # -- the batched ensemble API --------------------------------------------
    def _can_vectorize(self) -> bool:
        """The batched path needs the scaled uncertainties fixed (no free
        noise parameters) and priors of the uniform/normal pair."""
        if any(self.model._is_noise_param(p) for p in self.param_labels):
            return False
        return all(p.prior.jax_spec() is not None for p in self.params)

    def batched_posterior(self) -> BatchedPosterior:
        """The batched lnposterior (see :class:`BatchedPosterior`); raises
        :class:`~pint_torch.fitter.UsageError` when this posterior cannot
        be vectorized (free noise parameters, or a prior family outside
        the uniform/normal pair)."""
        if not self._can_vectorize():
            from pint_torch.fitter import UsageError

            raise UsageError(
                "this posterior cannot be vectorized: free noise "
                "parameters or priors outside the uniform/normal pair (the "
                "host scalar lnposterior path still works)")
        if self._batch_fn is None:
            self._batch_fn = self._build_batch_fn()
        return BatchedPosterior(
            fn=self._batch_fn,
            param_labels=tuple(self.param_labels),
            prior_specs=tuple(p.prior.jax_spec() for p in self.params))

    def _build_batch_fn(self):
        """(B, ndim) -> (B,) on the model's device (reference
        ``bayesian.py:166-232``).  The scaled sigmas, F0 and the values of
        the frozen parameters are read once, here; the mean subtracted
        from the phase residuals is weighted by the raw TOA errors, as the
        scalar path's is, and skipped with a PhaseOffset.  Under
        ``use_pulse_numbers`` a row's residual is its phase's integer part
        (K1's ``k`` output) less the TOAs' pulse numbers plus their added
        pulses, plus its fraction; otherwise the fraction plus the added
        pulses."""
        model, batch = self.model, self.batch
        dev = batch.device
        free = tuple(self.param_labels)
        const_pv = model.const_pv()
        sigma_np = model.scaled_toa_uncertainty(batch)
        sigma = torch.as_tensor(sigma_np, dtype=F64, device=dev)
        raw_err = batch.error_us
        w = 1.0 / raw_err**2 if bool((raw_err > 0).all()) \
            else torch.ones_like(raw_err)
        wsum = torch.sum(w)
        lognorm = float(np.sum(np.log(sigma_np)))
        F0 = model.value("F0")
        subtract_mean = "PhaseOffset" not in model.components
        pn = batch.get_pulse_numbers()
        use_pn = self.track_mode == "use_pulse_numbers" and pn is not None
        dpn = batch.delta_pulse_number
        dpn = 0.0 if dpn is None else dpn
        specs = [p.prior.jax_spec() for p in self.params]
        uni = torch.tensor([s[0] == "uniform" for s in specs], device=dev)
        a = torch.tensor([s[1] for s in specs], dtype=F64, device=dev)
        b = torch.tensor([s[2] for s in specs], dtype=F64, device=dev)
        # each uniform prior's -log(b - a) inside its box; a normal one's
        # normalization -log(sigma) - log(sqrt(2 pi))
        norm = torch.tensor([-math.log(s[2] - s[1]) if s[0] == "uniform"
                             else -math.log(s[2]) - _LOG_SQRT_2PI
                             for s in specs], dtype=F64, device=dev)
        wideband = self.is_wideband
        if wideband:
            dm_data = batch.dm
            dm_sig_np = model.scaled_dm_uncertainty(batch)
            dm_sig = torch.as_tensor(dm_sig_np, dtype=F64, device=dev)
            lognorm += float(np.sum(np.log(dm_sig_np)))
        self.lognorm = lognorm

        def fn(values: torch.Tensor) -> torch.Tensor:
            inb = (values >= a) & (values <= b)
            terms = torch.where(
                uni, torch.where(inb, norm, -math.inf),
                norm - 0.5 * ((values - a) / b) ** 2)
            lnpr = torch.sum(terms, dim=1)
            ph, _ = model.evaluate(values, free, batch, const_pv)
            if use_pn:
                resid = (ph.int_ - pn + dpn) + ph.frac
            else:
                resid = ph.frac + dpn
            if subtract_mean:
                mean = torch.sum(w * resid, dim=1, keepdim=True) / wsum
                resid = resid - mean
            chi2 = torch.sum((resid / F0 / sigma) ** 2, dim=1)
            if wideband:
                dm_model = model.evaluate_dm(values, free, batch)
                chi2 = chi2 + torch.sum(((dm_data - dm_model) / dm_sig) ** 2,
                                        dim=1)
            return lnpr - 0.5 * chi2 - lognorm

        return fn

    def lnposterior_batch(self, points: np.ndarray) -> np.ndarray:
        """lnposterior over (B, ndim) host points: the batched function on
        the model's device, one read back per call; a host loop of the
        scalar path where the posterior cannot be vectorized."""
        if torch.is_tensor(points):
            raise NotImplementedError(
                "device-resident walker batches (the reference's mesh path) "
                "are ROADMAP queue A item 9; pass host points, or call "
                "batched_posterior().fn")
        points = np.atleast_2d(np.asarray(points, dtype=np.float64))
        if self._vectorized is None:
            # decided once, as the reference does: the check reads every
            # prior's spec through scipy, ~0.1 ms a parameter
            self._vectorized = self._can_vectorize()
        if not self._vectorized:
            return np.array([self.lnposterior(p) for p in points])
        if self._batch_fn is None:
            self._batch_fn = self._build_batch_fn()
        vals = torch.as_tensor(points, dtype=F64, device=self.model.device)
        return self._batch_fn(vals).cpu().numpy()
