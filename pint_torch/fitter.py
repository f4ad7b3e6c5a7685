"""Fitters without correlated noise, the Levenberg-Marquardt and Powell
fitters, the dispatch to the fitter a model and its TOAs need, and the
model states of a downhill fit (port of ``pint_tpu/fitter.py``:
``Fitter.auto`` :78-92, the ``Fitter`` helpers with the Huber IRLS
harness :113-180, ``update_model`` :207-232, the maximum-likelihood noise
fit :235-280, the labelled covariance, the parameter accessors, the
report and ``minimize_func`` :283-500; ``_wls_step`` :506-518,
``WLSFitter`` :520-585, the ``DownhillFitter`` with its robust entry and
its alternation of timing and noise fits :588-749, ``DownhillWLSFitter``
:752-759, ``LMFitter`` :762-857, ``PowellFitter`` :858-887;
``apply_Sdiag_threshold``, ``fit_wls_svd`` and the GLS normal-equation
helpers :895-966; ``ModelState`` and its flavours :970-1079; the
exceptions of ``pint_tpu/exceptions.py`` they raise).

The WLS solve whitens the design matrix and residuals by the scaled TOA
uncertainties, normalizes the columns and takes ``torch.linalg.svd`` of
the (N, 1 + nfree) matrix on the model's device; singular values at or
below ``threshold * max`` are dropped with a :class:`DegeneracyWarning`
that names the degenerate parameter combination.  The iteration (the
downhill line search, parameter updates, the IRLS reweighting of
``robust="huber"``, the noise fit's L-BFGS-B) stays on the host, as in
the reference.  Powell's search runs in scipy on the host, each of its
evaluations one residual-and-chi2 pass on the model's device.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from pint_torch import F64
from pint_torch.integrity.robust import (HUBER_K, huber_weights,
                                         irls_converged, median)
from pint_torch.residuals import Residuals
from pint_torch.exceptions import (ConvergenceFailure, CorrelatedErrors,
                                   DegeneracyWarning, MaxiterReached,
                                   NonFiniteSystemError, StepProblem,
                                   UsageError)
from pint_torch.utils import normalize_designmatrix

__all__ = ["Fitter", "WLSFitter", "DownhillFitter", "DownhillWLSFitter",
           "fit_wls_svd", "apply_Sdiag_threshold", "DegeneracyWarning",
           "CorrelatedErrors", "ConvergenceFailure", "StepProblem",
           "MaxiterReached", "NonFiniteSystemError", "UsageError",
           "LMFitter", "PowellFitter", "ModelState", "WLSState", "GLSState",
           "WidebandState", "get_gls_mtcm_mtcy",
           "get_gls_mtcm_mtcy_fullcov"]


class Fitter:
    """Holds a copy of the model, the TOA batch, residuals and fit
    products."""

    #: per-TOA Huber weights (float64 tensor on the batch's device) during
    #: and after a ``fit_toas(robust="huber")``; None for a plain fit
    robust_weights = None
    robust_iterations = 0

    @staticmethod
    def auto(batch, model, downhill: bool = True, **kw) -> "Fitter":
        """The fitter the model and TOAs call for (reference
        ``fitter.py:78-92``): for wideband TOAs ``WidebandDownhillFitter``
        (``WidebandTOAFitter`` when ``downhill`` is False), with correlated
        noise ``DownhillGLSFitter`` (``GLSFitter``), otherwise
        ``DownhillWLSFitter`` (``WLSFitter``)."""
        if batch.wideband:
            from pint_torch.wideband import (WidebandDownhillFitter,
                                             WidebandTOAFitter)

            return (WidebandDownhillFitter if downhill
                    else WidebandTOAFitter)(batch, model, **kw)
        if model.has_correlated_errors:
            from pint_torch.gls_fitter import DownhillGLSFitter, GLSFitter

            return (DownhillGLSFitter if downhill else GLSFitter)(
                batch, model, **kw)
        return (DownhillWLSFitter if downhill else WLSFitter)(batch, model,
                                                               **kw)

    def __init__(self, batch, model, residuals: Optional[Residuals] = None,
                 track_mode: Optional[str] = None):
        """``residuals`` (a :class:`~pint_torch.residuals.Residuals`) are
        the fitter's first residuals in place of a fresh computation, as
        the reference's; ``track_mode`` is the residuals' (None:
        ``"use_pulse_numbers"`` where the TOAs carry pulse numbers).
        ``batch`` may be host TOAs (the model's batch of them); a batch
        frozen for the model before an edit is made again with its
        contexts (:meth:`TimingModel.batch_for`).  ``device_profile`` is
        the preflight's profile of the model's device
        (:func:`pint_torch.runtime.preflight.check_device`)."""
        from pint_torch.runtime.preflight import check_device

        self.batch = model.batch_for(batch)
        self.model_init = model
        self.model = model.copy()
        self.track_mode = track_mode
        self.device_profile = check_device(device=model.device)
        if residuals is not None:
            self.resids = residuals
        else:
            self.update_resids()
        # the reference's prefit residuals (``fitter.py:60``): residuals of
        # this fitter's own model, first read when the report asks, so
        # after a fit they hold the fitted model's as the reference's do
        self.resids_init = self.make_resids(self.model)
        self.method = "base"
        self.converged = False
        self.errors: Dict[str, float] = {}
        self.covariance: Optional[np.ndarray] = None
        self.fitted_params: List[str] = []
        self.solve_diagnostics = None
        self.chi2: Optional[float] = None

    def update_resids(self) -> Residuals:
        self.resids = Residuals(self.batch, self.model,
                                track_mode=self.track_mode)
        return self.resids

    def fit_toas(self, maxiter: int = 1, **kw) -> float:
        raise NotImplementedError

    def update_model(self, chi2: Optional[float] = None) -> None:
        """Stamp the fit's products and the TOAs' properties into the model
        (reference ``fitter.py:207``): START, FINISH (the MJDs' float64
        extremes), NTOA, EPHEM and DMDATA always; with ``chi2`` also CHI2,
        CHI2R, TRES [us] and, wideband, DMRES."""
        m = self.model
        mjds = self.batch.mjds
        if mjds is not None and len(mjds):
            mjds = np.asarray(mjds, dtype=np.float64)
            m["START"].value = (float(mjds.min()), 0.0)
            m["FINISH"].value = (float(mjds.max()), 0.0)
        m["NTOA"].value = self.batch.ntoas
        if self.batch.ephem:
            m["EPHEM"].value = self.batch.ephem
        wideband = getattr(self, "is_wideband", False)
        m["DMDATA"].value = "Y" if wideband else None
        if chi2 is not None:
            m["CHI2"].value = chi2
            dof = self.resids.dof
            m["CHI2R"].value = chi2 / dof if dof > 0 else None
            rms = self.resids.rms_weighted()
            if wideband:
                m["TRES"].value = rms["toa"] * 1e6
                m["DMRES"].value = rms["dm"]
            else:
                m["TRES"].value = rms * 1e6

    # -- the labelled covariance (reference ``fitter.py:283-364``) -----------
    @property
    def parameter_covariance_matrix(self):
        """The post-fit parameter covariance as a labelled
        :class:`~pint_torch.pint_matrix.CovarianceMatrix` over the fitted
        parameters (Offset first where fitted), or None before a fit."""
        from pint_torch.pint_matrix import CovarianceMatrix

        if self.covariance is None:
            return None
        labels = {p: (i, i + 1, "") for i, p in enumerate(self.fitted_params)}
        return CovarianceMatrix(self.covariance, [labels, labels])

    @property
    def covariance_matrix(self):
        return self.parameter_covariance_matrix

    def get_parameter_correlation_matrix(self, pretty_print: bool = False):
        cov = self.parameter_covariance_matrix
        if cov is None:
            return None
        corr = cov.to_correlation_matrix()
        if pretty_print:
            print(corr.prettyprint())
        return corr

    def get_parameter_covariance_matrix(self, with_phase: bool = False):
        """The labelled covariance, with the Offset row only when
        ``with_phase``."""
        cov = self.parameter_covariance_matrix
        if cov is None or with_phase:
            return cov
        names = [n for n in cov.get_label_names(axis=0) if n != "Offset"]
        return cov.get_label_matrix(names)

    # -- parameter accessors (reference ``fitter.py:283-342``) ---------------
    def get_fitparams(self) -> dict:
        return {p: self.model[p].value for p in self.model.free_params}

    def get_allparams(self) -> dict:
        return {p: self.model[p].value for p in self.model.params}

    def get_fitparams_num(self) -> dict:
        return {p: self.model.value(p) for p in self.model.free_params}

    def get_fitparams_uncertainty(self) -> dict:
        return {p: self.model[p].uncertainty for p in self.model.free_params}

    def get_params_dict(self, which: str = "free",
                        kind: str = "quantity") -> dict:
        names = self.model.free_params if which == "free" \
            else self.model.params
        if kind in ("quantity", "value"):
            return {p: self.model[p].value for p in names}
        if kind == "uncertainty":
            return {p: self.model[p].uncertainty for p in names}
        raise UsageError(f"Unknown kind {kind!r}")

    def set_params(self, fitp: dict) -> None:
        for p, v in fitp.items():
            self.model[p].value = v

    set_fitparams = set_params

    def set_param_uncertainties(self, fitp: dict) -> None:
        for p, v in fitp.items():
            self.model[p].uncertainty = float(v)

    def make_resids(self, model) -> Residuals:
        """Residuals of this fitter's TOAs under any model, in its
        ``track_mode``."""
        return Residuals(self.batch, model, track_mode=self.track_mode)

    def reset_model(self) -> None:
        """Forget the fit: the initial model and fresh residuals."""
        self.model = self.model_init.copy()
        self.converged = False
        self.covariance = None
        self.fitted_params = []
        self.errors = {}
        self.update_resids()

    def ftest(self, parameter, component=None, remove: bool = False,
              full_output: bool = False, maxiter: int = 1):
        """The F-test of adding ``parameter`` (a
        :mod:`pint_torch.models.parameter` object or a
        :class:`~pint_torch.models.timing_model.Param`, or a list of them)
        to the named ``component`` (one per parameter), or of removing it
        (``remove``): a copy of the model edited, set up and refit by this
        fitter's class in its ``track_mode`` for ``maxiter`` iterations,
        against this fit (reference ``fitter.py:397-445``).  Returns
        ``{"ft": p}``; with ``full_output`` also the refit's weighted rms
        [us] (``resid_rms_test``), ``chi2_test`` and ``dof_test``.  The
        two-number form ``ftest(chi2_other, dof_other)`` tests another fit
        against this one."""
        import copy

        from pint_torch.utils import FTest

        if isinstance(parameter, (int, float, np.integer, np.floating)) \
                and isinstance(component,
                               (int, float, np.integer, np.floating)):
            return FTest(float(parameter), int(component),
                         self.resids.chi2, self.resids.dof)
        params = parameter if isinstance(parameter, (list, tuple)) \
            else [parameter]
        comps = component if isinstance(component, (list, tuple)) \
            else [component] * len(params)
        if not remove and len(comps) != len(params):
            raise UsageError("one component per parameter required")
        m = self.model.copy()
        if remove:
            for p in params:
                m.remove_param(p.name)
        else:
            for p, cname in zip(params, comps):
                if cname not in m.components:
                    raise UsageError(f"component {cname!r} not in model")
                par = copy.deepcopy(p)
                par.frozen = False
                m.components[cname].add_param(par, setup=True)
        m.setup()
        f2 = type(self)(self.batch, m, track_mode=self.track_mode)
        f2.fit_toas(maxiter=max(1, maxiter))
        chi2_base, dof_base = self.resids.chi2, self.resids.dof
        chi2_new, dof_new = f2.resids.chi2, f2.resids.dof
        if remove:
            ft = FTest(chi2_new, dof_new, chi2_base, dof_base)
        else:
            ft = FTest(chi2_base, dof_base, chi2_new, dof_new)
        out = {"ft": ft}
        if full_output:
            rms = f2.resids.rms_weighted()
            if isinstance(rms, dict):
                rms = rms["toa"]
            out["resid_rms_test"] = rms * 1e6
            out["chi2_test"] = chi2_new
            out["dof_test"] = dof_new
        return out

    def doctor(self, designmatrix: bool = True) -> str:
        """A readable audit of this fit's inputs and state: the device
        profile, the TOAs and their quarantine, the model/TOA
        compatibility findings (mask parameters selecting nothing,
        degenerate free-parameter pairs), the robust weights
        (:mod:`pint_torch.integrity.doctor`)."""
        from pint_torch.integrity.doctor import render_doctor_report

        return render_doctor_report(self, designmatrix=designmatrix)

    # -- the report (reference ``fitter.py:450-494``) ------------------------
    def print_summary(self) -> None:
        print(self.get_summary())

    def _value_text(self, model, p) -> str:
        par = model[p]
        return str(model.epoch_value(p)) if par.kind == "mjd" \
            else str(par.value)

    def get_summary(self, nodmx: bool = True) -> str:
        """The fit's report: method, TOAs and free parameters, pre- and
        post-fit weighted rms, chi2, a row per free parameter (prefit,
        postfit, uncertainty, units; DMX rows left out with ``nodmx``),
        then :meth:`get_derived_params`."""
        r = self.resids

        def toa_rms(resids):
            rms = resids.rms_weighted()
            return rms["toa"] if isinstance(rms, dict) else rms

        lines = [
            f"Fitted model using {self.method} with "
            f"{len(self.model.free_params)} free parameters to "
            f"{self.batch.ntoas} TOAs",
            f"Prefit residuals Wrms = {toa_rms(self.resids_init) * 1e6:.4f} "
            f"us, Postfit residuals Wrms = {toa_rms(r) * 1e6:.4f} us",
            f"Chisq = {r.chi2:.3f} for {r.dof} d.o.f. for reduced Chisq of "
            f"{r.reduced_chi2:.3f}",
            "",
            f"{'PAR':<12} {'Prefit':>20} {'Postfit':>20} "
            f"{'Uncertainty':>14} {'Units':>10}",
        ]
        for p in self.model.free_params:
            if nodmx and p.startswith("DMX"):
                continue
            unc = self.errors.get(p)
            lines.append(
                f"{p:<12} {self._value_text(self.model_init, p):>20} "
                f"{self._value_text(self.model, p):>20} "
                f"{(f'{unc:.3g}' if unc is not None else '-'):>14} "
                f"{self.model[p].units:>10}")
        return "\n".join(lines) + "\n\n" + self.get_derived_params()

    def get_derived_params(self, returndict: bool = False):
        """The model's derived quantities, the post-fit TOA rms feeding the
        ELL1 validity check."""
        rms = self.resids.rms_weighted()
        if isinstance(rms, dict):
            rms = rms["toa"]
        return self.model.get_derived_params(
            rms=rms * 1e6, ntoas=self.batch.ntoas, returndict=returndict)

    def minimize_func(self, values, params) -> float:
        """chi2 with ``params`` set to ``values``: one residual-and-chi2
        pass on the model's device, one host read."""
        for v, p in zip(values, params):
            self.model[p].value = float(v)
        self.update_resids()
        return self.resids.chi2

    def get_designmatrix(self):
        """``(M, names)``; constant (linear) columns come from the model's
        cache, as the reference's iterative fits take them."""
        return self.model.designmatrix(self.batch, reuse_linear=True)

    def _data_sigma(self) -> torch.Tensor:
        """The scaled TOA uncertainties the linear solves consume [s];
        under a robust fit the Huber weights enter as sigma / sqrt(w)."""
        sigma = self.resids.get_data_error()
        if self.robust_weights is not None:
            sigma = sigma / torch.sqrt(torch.clamp(self.robust_weights,
                                                   min=1e-12))
        return sigma

    def _robust_update_weights(self, huber_k: float) -> torch.Tensor:
        """Huber weights of the current whitened residuals, centered on
        their median (reference ``fitter.py:123-137``): the mean the
        residuals subtract is itself pulled by outliers."""
        z = self.resids.time_resids / self.resids.get_data_error()
        finite = torch.isfinite(z)
        if bool(finite.any()):
            z = z - median(z[finite])
        return huber_weights(z, k=huber_k)

    @staticmethod
    def _check_robust_arg(robust) -> bool:
        if robust not in (None, False, "huber"):
            raise UsageError(
                f"robust must be None or 'huber', got {robust!r}")
        return bool(robust)

    def _run_irls(self, inner_fit, huber_k: Optional[float],
                  robust_maxiter: int, robust_tol: float,
                  tolerate_step_problem: bool = False) -> float:
        """The IRLS loop both robust entry points share (reference
        ``fitter.py:146-180``): weights from the current residuals,
        ``inner_fit()`` with them held, reweight, until the weights move by
        less than ``robust_tol``.  With ``tolerate_step_problem`` a later
        round whose inner fit cannot lower its objective goes on to the
        convergence check.  Returns the plain (unweighted) chi2."""
        k = huber_k if huber_k is not None else HUBER_K
        self.update_resids()
        self.robust_weights = self._robust_update_weights(k)
        for it in range(max(1, robust_maxiter)):
            self.robust_iterations = it + 1
            try:
                inner_fit()
            except StepProblem:
                if not tolerate_step_problem or it == 0:
                    raise
            w_new = self._robust_update_weights(k)
            done = irls_converged(self.robust_weights, w_new, robust_tol)
            self.robust_weights = w_new
            if done:
                break
        else:
            warnings.warn(f"Huber IRLS hit robust_maxiter={robust_maxiter} "
                          "without the weights settling")
        chi2 = self.resids.chi2
        self.chi2 = chi2
        self.update_model(chi2)
        return chi2

    def _set_covariance(self, cov, params) -> None:
        """Keep the post-fit parameter covariance (host float64, in the
        order of ``params``) and each parameter's uncertainty, the square
        root of its diagonal."""
        self.covariance = cov.cpu().numpy()
        self.fitted_params = list(params)
        for i, p in enumerate(params):
            if p == "Offset":
                continue
            err = float(np.sqrt(self.covariance[i, i]))
            self.errors[p] = err
            self.model[p].uncertainty = err

    # -- maximum-likelihood noise fitting -----------------------------------
    def _get_free_noise_params(self) -> List[str]:
        """The free noise parameters the likelihood can fit (reference
        ``fitter.py:235``)."""
        from pint_torch.noisefit import free_noise_params

        return free_noise_params(self.model,
                                 wideband=getattr(self, "is_wideband", False))

    def _update_noise_params(self, names, values, errors=None) -> None:
        """Write a noise fit's values (and uncertainties) to the model;
        parameters that enter the likelihood squared take their
        non-negative branch (reference ``fitter.py:241``)."""
        for i, p in enumerate(names):
            v = float(values[i])
            if p.startswith(("EFAC", "EQUAD", "ECORR", "DMEFAC", "DMEQUAD")):
                v = abs(v)
            self.model[p].value = v
            if errors is not None:
                err = float(errors[i])
                self.model[p].uncertainty = err
                self.errors[p] = err

    def fit_noise(self, uncertainty: bool = False,
                  noisefit_method: str = "L-BFGS-B"):
        """One maximum-likelihood noise fit at the current timing solution
        (:func:`pint_torch.noisefit.fit_noise_ml`; reference
        ``fitter.py:256``): a ``NoiseFitResult``, None when no noise
        parameter is free; the model is not changed.  Wideband fitters fit
        the joint TOA+DM likelihood."""
        from pint_torch.noisefit import fit_noise_ml

        dm_resids = self.resids.dm.resids \
            if getattr(self, "is_wideband", False) else None
        return fit_noise_ml(self.model, self.batch, self.resids.time_resids,
                            dm_resids=dm_resids, method=noisefit_method,
                            uncertainty=uncertainty)


def apply_Sdiag_threshold(Sdiag, VT, threshold, params):
    """Replace singular values <= ``threshold * Sdiag.max()`` with inf and
    warn, naming the degenerate parameter combination (reference
    ``fitter.py:895``); dividing by inf then drops those directions.  Host
    numpy in and out: the vector and ``VT`` are small."""
    Sdiag = np.asarray(Sdiag, dtype=np.float64).copy()
    VT = np.asarray(VT)
    smax = Sdiag.max() if Sdiag.size else 1.0
    for c in np.nonzero(Sdiag <= threshold * smax)[0]:
        v = VT[c]
        v = v / max(np.abs(v).max(), 1e-300)
        combo = " + ".join(f"{co:.3g}*{p}" for co, p in
                           sorted(zip(v, params), key=lambda t: -abs(t[0]))
                           if abs(co) > threshold)
        warnings.warn("Parameter degeneracy; the following linear "
                      f"combination yields almost no change: {combo}",
                      DegeneracyWarning)
        Sdiag[c] = np.inf
    return Sdiag


def fit_wls_svd(r, sigma, M, params, threshold):
    """One whitened, column-normalized SVD WLS solve (reference
    ``fitter.py:917``): ``(dpars, Sigma, Adiag, (U, S, VT))`` with
    ``Sigma`` the parameter covariance and ``Adiag`` the column norms;
    tensors on ``M``'s device.  Degenerate directions are dropped by
    :func:`apply_Sdiag_threshold`."""
    if not (bool(torch.isfinite(r).all()) and bool(torch.isfinite(M).all())
            and bool(torch.isfinite(sigma).all())):
        raise NonFiniteSystemError(
            "WLS residuals/design matrix/uncertainties contain NaN/inf; "
            "refusing the solve (the SVD would emit silent garbage or "
            "fail untyped)")
    Mw = M / sigma[:, None]
    rw = r / sigma
    Mn, Adiag = normalize_designmatrix(Mw)
    U, S, VT = torch.linalg.svd(Mn, full_matrices=False)
    S = torch.as_tensor(apply_Sdiag_threshold(S.cpu().numpy(),
                                              VT.cpu().numpy(), threshold,
                                              list(params)),
                        dtype=F64, device=M.device)
    dpars = (VT.T @ ((U.T @ rw) / S)) / Adiag
    Sigma = ((VT.T / S**2) @ VT) / torch.outer(Adiag, Adiag)
    return dpars, Sigma, Adiag, (U, S, VT)


def _wls_step(M, params, r, sigma, threshold: Optional[float] = None):
    """``(dpars, cov)`` of :func:`fit_wls_svd` at the default threshold
    ``eps * max(M.shape)`` (reference ``fitter.py:506``)."""
    if threshold is None:
        threshold = np.finfo(np.float64).eps * max(M.shape)
    dpars, cov, _, _ = fit_wls_svd(r, sigma, M, list(params), threshold)
    return dpars, cov


def _apply(model, dpars, params, base=None, lam: float = 1.0):
    dp = dpars.cpu().numpy()
    for i, p in enumerate(params):
        if p == "Offset":
            continue
        par = model[p]
        start = base[p] if base is not None else float(par.value or 0.0)
        par.value = start + lam * float(dp[i])


class WLSFitter(Fitter):
    """One-shot weighted-least-squares fitter (reference
    ``fitter.py:520``)."""

    def __init__(self, batch, model, **kw):
        super().__init__(batch, model, **kw)
        if model.has_correlated_errors:
            raise CorrelatedErrors(model)
        self.method = "weighted_least_square"

    def fit_toas(self, maxiter: int = 1, threshold: Optional[float] = None,
                 debug: bool = False, robust=None,
                 huber_k: Optional[float] = None, robust_maxiter: int = 30,
                 robust_tol: float = 1e-3) -> float:
        """``maxiter`` linearized WLS steps; returns the post-fit chi2.
        ``robust="huber"`` wraps them in the IRLS loop that Huber-weights
        outlying TOAs (``robust_weights``).  ``debug`` is accepted and, as
        in the reference, changes nothing."""
        if self._check_robust_arg(robust):
            return self._run_irls(
                lambda: self._fit_wls(maxiter, threshold), huber_k,
                robust_maxiter, robust_tol)
        self.robust_weights = None
        self.robust_iterations = 0
        return self._fit_wls(maxiter, threshold)

    def _fit_wls(self, maxiter: int, threshold: Optional[float]) -> float:
        for _ in range(max(1, maxiter)):
            M, params = self.get_designmatrix()
            dpars, cov = _wls_step(M, params, self.resids.time_resids,
                                   self._data_sigma(), threshold)
            _apply(self.model, dpars, params)
            self.update_resids()
            chi2 = self.resids.chi2
            self._set_covariance(cov, params)
        self.converged = True
        self.chi2 = chi2
        self.update_model(chi2)
        return chi2


class DownhillFitter(Fitter):
    """Iterative fitter with a lambda-halving line search (reference
    ``fitter.py:588``).  ``iterations`` counts the steps solved in the last
    ``fit_toas``, over all its timing fits."""

    def __init__(self, batch, model, **kw):
        super().__init__(batch, model, **kw)
        self.method = "downhill"

    def _solve_step(self):
        M, params = self.get_designmatrix()
        dpars, cov = _wls_step(M, params, self.resids.time_resids,
                               self._data_sigma())
        return dpars, params, cov

    def _fit_metric(self) -> float:
        """What the line search minimizes: chi2, or the Huber-weighted
        chi2 while an IRLS round holds its weights (reference
        ``fitter.py:606-615``)."""
        if self.robust_weights is None:
            return self.resids.chi2
        z = self.resids.time_resids / self.resids.get_data_error()
        return float(torch.sum(self.robust_weights * z * z))

    def fit_toas(self, maxiter: int = 20,
                 required_chi2_decrease: float = 1e-2,
                 max_chi2_increase: float = 1e-2, min_lambda: float = 1e-3,
                 debug: bool = False, noise_fit_niter: int = 2,
                 noisefit_method: str = "L-BFGS-B",
                 compute_noise_uncertainties: bool = True,
                 raise_on_maxiter: bool = False, robust=None,
                 huber_k: Optional[float] = None, robust_maxiter: int = 30,
                 robust_tol: float = 1e-3) -> float:
        """Downhill timing fit: each step's solution is taken whole or
        halved until chi2 stops rising by more than ``max_chi2_increase``;
        converged once a whole step lowers chi2 by less than
        ``required_chi2_decrease``.  With free noise parameters it
        alternates with maximum-likelihood noise fits (reference
        ``fitter.py:652-667``): ``noise_fit_niter`` rounds of (timing fit,
        noise fit), the Hessian's uncertainties on the last round, then a
        final timing fit; ``noise_fit_results`` keeps each round's
        result.  ``robust="huber"`` (WLS family only) wraps the timing fit
        in the IRLS loop.  ``debug`` is accepted and, as in the reference,
        changes nothing."""
        self.iterations = 0
        timing_kw = dict(maxiter=maxiter,
                         required_chi2_decrease=required_chi2_decrease,
                         max_chi2_increase=max_chi2_increase,
                         min_lambda=min_lambda,
                         raise_on_maxiter=raise_on_maxiter)
        if self._check_robust_arg(robust):
            if not isinstance(self, DownhillWLSFitter) \
                    and type(self) is not DownhillFitter:
                raise UsageError(
                    "robust fitting is available on the WLS-family fitters "
                    "only (Huber IRLS assumes uncorrelated errors)")
            if self._get_free_noise_params():
                raise UsageError(
                    "robust fitting cannot be combined with free noise "
                    "parameters; freeze them or fit noise separately")
            return self._run_irls(lambda: self._fit_toas_timing(**timing_kw),
                                  huber_k, robust_maxiter, robust_tol,
                                  tolerate_step_problem=True)
        self.robust_weights = None
        self.robust_iterations = 0
        self.noise_fit_results = []
        if self._get_free_noise_params():
            for ii in range(noise_fit_niter):
                self._fit_toas_timing(**timing_kw)
                last = ii == noise_fit_niter - 1
                res = self.fit_noise(
                    uncertainty=last and compute_noise_uncertainties,
                    noisefit_method=noisefit_method)
                self._update_noise_params(res.names, res.values, res.errors)
                self.update_resids()
                self.noise_fit_results.append(res)
        return self._fit_toas_timing(**timing_kw)

    def _fit_toas_timing(self, maxiter, required_chi2_decrease,
                         max_chi2_increase, min_lambda,
                         raise_on_maxiter) -> float:
        best_chi2 = self._fit_metric()
        self.converged = False
        for it in range(maxiter):
            self.iterations += 1
            dpars, params, cov = self._solve_step()
            base = {p: float(self.model[p].value or 0.0)
                    for p in params if p != "Offset"}
            lam = 1.0
            improved = False
            while lam >= min_lambda:
                _apply(self.model, dpars, params, base, lam)
                self.update_resids()
                chi2 = self._fit_metric()
                if chi2 < best_chi2 + max_chi2_increase:
                    improved = True
                    break
                lam *= 0.5
            if not improved:
                for p, v in base.items():
                    self.model[p].value = v
                self.update_resids()
                if it == 0:
                    raise StepProblem(
                        f"chi2 would not decrease from {best_chi2:.3f}")
                break
            decrease = best_chi2 - chi2
            best_chi2 = chi2
            self._set_covariance(cov, params)
            if decrease < required_chi2_decrease and lam == 1.0:
                self.converged = True
                break
        else:
            if raise_on_maxiter:
                raise MaxiterReached(
                    f"Downhill fit hit maxiter={maxiter} without meeting "
                    f"tolerance (chi2 {best_chi2:.3f})")
            warnings.warn(f"Downhill fit hit maxiter={maxiter}")
        self.chi2 = best_chi2
        self.update_model(best_chi2)
        return best_chi2


class DownhillWLSFitter(DownhillFitter):
    """Reference ``fitter.py:752``."""

    def __init__(self, batch, model, **kw):
        if model.has_correlated_errors:
            raise CorrelatedErrors(model)
        super().__init__(batch, model, **kw)
        self.method = "downhill_wls"


class LMFitter(Fitter):
    """Levenberg-Marquardt fitter (reference ``fitter.py:762``): damped
    normal equations ``M^T C^-1 M + phiinv + lambda diag(M^T C^-1 M)`` of
    the augmented GLS system, solved by SVD, with the reference's lambda
    schedule -- halved (to ``min_lambda``, where the step is plain
    Gauss-Newton) after a step that lowers chi2, tripled after one that
    raises it.  The uncertainties come from the undamped curvature at the
    final parameters."""

    #: the wideband fitter stacks the DM rows
    wideband_system = False

    def __init__(self, batch, model, **kw):
        super().__init__(batch, model, **kw)
        self.method = "levenberg_marquardt"
        self._noise_dims = None

    def _residual_vector(self) -> torch.Tensor:
        return self.resids.time_resids

    def _normal_system(self):
        """(mtcm_plain, phiinv, mtcy, norm, params) at the current
        model."""
        from pint_torch.gls_fitter import build_augmented_system

        r = self._residual_vector()
        M, params, norm, phiinv, Nvec, dims = build_augmented_system(
            self.model, self.batch, wideband=self.wideband_system)
        self._noise_dims = dims
        cinv = 1.0 / Nvec
        return (M.T @ (cinv[:, None] * M), phiinv, M.T @ (cinv * r), norm,
                params)

    def fit_toas(self, maxiter: int = 50, min_chi2_decrease: float = 1e-3,
                 lambda_factor_decrease: float = 2.0,
                 lambda_factor_increase: float = 3.0,
                 min_lambda: float = 0.5, threshold: float = 1e-14,
                 debug: bool = False) -> float:
        from pint_torch.gls_fitter import _solve_svd

        self.update_resids()
        chi2 = self.resids.calc_chi2()
        lam = min_lambda
        self.converged = False
        for _ in range(maxiter):
            mtcm_plain, phiinv, mtcy, norm, params = self._normal_system()
            lf = lam if lam > min_lambda else 0.0
            A = mtcm_plain + torch.diag(phiinv) \
                + lf * torch.diag(torch.diagonal(mtcm_plain))
            _, xhat, self.solve_diagnostics = _solve_svd(A, mtcy, threshold,
                                                         params)
            base = {p: self.model.value(p) for p in params if p != "Offset"}
            _apply(self.model, xhat / norm, params)
            self.update_resids()
            new_chi2 = self.resids.calc_chi2()
            decrease = chi2 - new_chi2
            if not np.isfinite(new_chi2) or decrease < -min_chi2_decrease:
                # refuse the step: restore and raise the damping
                for p, v in base.items():
                    self.model[p].value = v
                self.update_resids()
                lam *= lambda_factor_increase
                if lam > 1e9:
                    raise ConvergenceFailure("LM damping diverged")
                continue
            # take it; a small change of either sign is convergence
            chi2 = new_chi2
            if decrease < min_chi2_decrease:
                self.converged = True
                break
            lam = max(lam / lambda_factor_decrease, min_lambda)
        else:
            warnings.warn(f"LM fit hit maxiter={maxiter}")
        mtcm_plain, phiinv, mtcy, norm, params = self._normal_system()
        xvar, _, _ = _solve_svd(mtcm_plain + torch.diag(phiinv), mtcy,
                                threshold, params)
        ntm = len(params)
        self._set_covariance(((xvar / norm).T / norm)[:ntm, :ntm], params)
        self.chi2 = chi2
        self.update_model(chi2)
        return chi2


class PowellFitter(Fitter):
    """Derivative-free scipy Powell minimization of chi2 over the free
    parameters (reference ``fitter.py:858``): the search on the host, each
    evaluation one residual-and-chi2 pass on the model's device.  Each
    parameter moves in units of its uncertainty, or 1e-8 of its value
    (1e-10 at 0) without one.  ``nfev`` and ``nit`` keep scipy's
    counts."""

    def __init__(self, batch, model, **kw):
        super().__init__(batch, model, **kw)
        self.method = "Powell"
        self.nfev = self.nit = 0

    def fit_toas(self, maxiter: int = 20, **kw) -> float:
        from scipy.optimize import minimize

        params = list(self.model.free_params)
        x0 = np.array([self.model.value(p) for p in params])
        scale = np.array([
            float(self.model[p].uncertainty or 0.0)
            or (abs(x) * 1e-8 if x else 1e-10) for p, x in zip(params, x0)])

        def fun(z):
            return self.minimize_func(list(x0 + z * scale), params)

        res = minimize(fun, np.zeros(len(params)), method="Powell",
                       options={"maxiter": maxiter, "xtol": 1e-10,
                                "ftol": 1e-10})
        self.minimize_func(list(x0 + res.x * scale), params)
        self.nfev, self.nit = int(res.nfev), int(res.nit)
        self.fitted_params = params
        self.converged = bool(res.success)
        chi2 = self.resids.chi2
        self.chi2 = chi2
        self.update_model(chi2)
        return chi2


def get_gls_mtcm_mtcy(phiinv, Nvec, M, residuals):
    """``(M^T N^-1 M + diag(phiinv), M^T N^-1 y)`` of the basis-augmented
    GLS normal equations (reference ``fitter.py:942``): ``M`` the timing
    columns and the noise basis, ``Nvec`` the white variances, ``phiinv``
    the prior weights; tensors on ``M``'s device."""
    Ninv = 1.0 / Nvec
    mtcm = M.T @ (Ninv[:, None] * M) + torch.diag(phiinv)
    mtcy = M.T @ (Ninv * residuals)
    return mtcm, mtcy


def get_gls_mtcm_mtcy_fullcov(cov, M, residuals):
    """``(M^T C^-1 M, M^T C^-1 y)`` with the dense data covariance ``C``
    through its Cholesky factor (reference ``fitter.py:957``)."""
    cf = torch.linalg.cholesky(cov)
    cm = torch.cholesky_solve(M, cf)
    return M.T @ cm, cm.T @ residuals


class ModelState:
    """A model and its fit products during a downhill fit (reference
    ``fitter.py:970``): residuals, chi2, the linearized step and its
    covariance, each computed once when first read, by the matching
    downhill fitter's ``_solve_step`` -- the numbers the fit itself uses.
    Taking a step gives a new state."""

    def __init__(self, fitter, model=None):
        self.fitter = fitter
        self.model = model if model is not None else fitter.model
        self._cache = {}

    def _fitter_cls(self):
        return DownhillWLSFitter

    def _work(self):
        if "work" not in self._cache:
            self._cache["work"] = self._fitter_cls()(
                self.fitter.batch, self.model,
                track_mode=getattr(self.fitter, "track_mode", None))
        return self._cache["work"]

    @property
    def params(self):
        return list(self.model.free_params)

    @property
    def resids(self):
        return self._work().resids

    @property
    def chi2(self) -> float:
        if "chi2" not in self._cache:
            self._cache["chi2"] = float(self.resids.chi2)
        return self._cache["chi2"]

    def _solve(self):
        if "step" not in self._cache:
            dpars, params, cov = self._work()._solve_step()
            self._cache["step"] = (dpars.cpu().numpy(), list(params),
                                   cov.cpu().numpy())
        return self._cache["step"]

    @property
    def step(self) -> np.ndarray:
        return self._solve()[0]

    @property
    def parameter_covariance_matrix(self) -> np.ndarray:
        return self._solve()[2]

    def predicted_chi2(self, step=None, lambda_: float = 1.0) -> float:
        """chi2 after ``lambda_ * step`` on the quadratic model: chi2 less
        ``(2 lambda - lambda^2) s^T Sigma^+ s`` in the solver's own metric
        (the covariance's pseudo-inverse as numpy's ``lstsq`` takes it, on
        the host, as the reference does)."""
        dpars, _, cov = self._solve()
        s = np.asarray(dpars if step is None else step, dtype=np.float64)
        sn, *_ = np.linalg.lstsq(cov, s, rcond=None)
        dec = float(s @ sn)
        return self.chi2 - (2 * lambda_ - lambda_**2) * dec

    def take_step_model(self, step, lambda_: float = 1.0):
        """A new model moved by ``lambda_ * step`` along the solver's
        parameters (the Offset has no model parameter)."""
        _, params, _ = self._solve()
        new = self.model.copy()
        for p, s in zip(params, np.asarray(step) * lambda_):
            if p not in new.params:
                continue
            new[p].value = new.value(p) + float(s)
        return new

    def take_step(self, step=None, lambda_: float = 1.0) -> "ModelState":
        if step is None:
            step = self.step
        return type(self)(self.fitter, self.take_step_model(step, lambda_))


class WLSState(ModelState):
    """The uncorrelated-noise state."""


class GLSState(ModelState):
    """The correlated-noise (GLS) state."""

    def _fitter_cls(self):
        from pint_torch.gls_fitter import DownhillGLSFitter

        return DownhillGLSFitter


class WidebandState(ModelState):
    """The wideband (TOA + DM) state."""

    def _fitter_cls(self):
        from pint_torch.wideband import WidebandDownhillFitter

        return WidebandDownhillFitter
