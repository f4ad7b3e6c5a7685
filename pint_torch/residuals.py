"""Residuals: observed-minus-model phase and time, with the GLS chi2 and
the Gaussian log-likelihood (port of ``pint_tpu/residuals.py:22-148,
266-277``).

Phase residuals are the model phase's fractional part ('nearest' pulse
tracking) -- the absolute phase, TZR TOA subtracted, where the model has
an AbsPhase -- minus their weighted mean unless a PhaseOffset fits the
offset; time residuals divide by F0.  The chi2 is diagonal without
correlated noise; otherwise the Sherman-Morrison form for ECORR alone
with an explicit PhaseOffset, else the scaled-basis Woodbury form with the
overall offset marginalized.
"""

from __future__ import annotations

import math

import torch

from pint_torch import F64
from pint_torch.utils import sherman_morrison_dot, weighted_mean, woodbury_dot

__all__ = ["Residuals"]


class Residuals:
    """Residuals of ``batch`` under ``model``; results are float64 tensors
    on the batch's device."""

    def __init__(self, batch, model, subtract_mean: bool = True,
                 use_weighted_mean: bool = True):
        self.batch = batch
        self.model = model
        self.subtract_mean = subtract_mean \
            and "PhaseOffset" not in model.components
        self.use_weighted_mean = use_weighted_mean
        self._phase_resids = None
        self._time_resids = None

    def calc_phase_resids(self) -> torch.Tensor:
        """Residual phase in cycles."""
        abs_phase = "AbsPhase" in self.model.components
        resids = self.model.phase(self.batch, abs_phase=abs_phase).frac \
            .clone()
        if self.subtract_mean:
            err = self.batch.error_us
            if self.use_weighted_mean and not bool((err == 0).any()):
                mean, _ = weighted_mean(resids, 1.0 / (err * err))
            else:
                mean = torch.mean(resids)
            resids = resids - mean
        self._phase_resids = resids
        return resids

    @property
    def phase_resids(self) -> torch.Tensor:
        if self._phase_resids is None:
            self.calc_phase_resids()
        return self._phase_resids

    @property
    def time_resids(self) -> torch.Tensor:
        """Residuals in seconds (phase / F0)."""
        if self._time_resids is None:
            self._time_resids = self.phase_resids / self.model.value("F0")
        return self._time_resids

    @property
    def resids(self) -> torch.Tensor:
        return self.time_resids

    def get_data_error(self) -> torch.Tensor:
        """EFAC/EQUAD-scaled TOA uncertainties in seconds."""
        return torch.as_tensor(self.model.scaled_toa_uncertainty(self.batch),
                               dtype=F64, device=self.batch.device)

    def _corr_basis_weight(self):
        U, w = self.model.noise_model_basis_weight(self.batch)
        return self.model.augment_basis_for_offset(U, w,
                                                   n=self.batch.ntoas)

    def calc_chi2(self) -> float:
        r = self.time_resids
        sigma = self.get_data_error()
        if bool((sigma == 0).any()):
            return float("inf")
        if not self.model.has_correlated_errors:
            return float(torch.sum((r / sigma) ** 2))
        dev = r.device
        ecorr_only = all(getattr(c, "is_ecorr", False)
                         for c in self.model.noise_components
                         if c.introduces_correlated_errors)
        if ecorr_only and "PhaseOffset" in self.model.components:
            U, w = self.model.noise_model_basis_weight(self.batch)
            dot_fn = sherman_morrison_dot
        else:
            U, w = self._corr_basis_weight()
            dot_fn = woodbury_dot
        dot, _ = dot_fn(sigma * sigma,
                        torch.as_tensor(U, dtype=F64, device=dev),
                        torch.as_tensor(w, dtype=F64, device=dev), r, r)
        return float(dot)

    @property
    def chi2(self) -> float:
        return self.calc_chi2()

    def lnlikelihood(self) -> float:
        """Gaussian log-likelihood with the noise log-determinant,
        -(chi2 + logdet C + n log 2 pi) / 2, C through the scaled-basis
        Woodbury form with the overall offset marginalized."""
        r = self.time_resids
        sigma = self.get_data_error()
        n = r.shape[0]
        if not self.model.has_correlated_errors:
            chi2 = torch.sum((r / sigma) ** 2)
            logdet = torch.sum(torch.log(sigma**2))
        else:
            U, w = self._corr_basis_weight()
            chi2, logdet = woodbury_dot(
                sigma**2, torch.as_tensor(U, dtype=F64, device=r.device),
                torch.as_tensor(w, dtype=F64, device=r.device), r, r)
        return float(-0.5 * (chi2 + logdet + n * math.log(2 * math.pi)))

    @property
    def dof(self) -> int:
        return self.batch.ntoas - len(self.model.free_params) \
            - int(self.subtract_mean)

    @property
    def reduced_chi2(self) -> float:
        return self.chi2 / self.dof
