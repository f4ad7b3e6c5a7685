"""Wideband (TOA + DM) residuals and fitters (port of
``pint_tpu/wideband.py:49-455``: ``WidebandDMResiduals``,
``CombinedResiduals``, ``WidebandTOAResiduals``, ``WidebandTOAFitter``,
``WidebandDownhillFitter`` and ``WidebandLMFitter``).

Wideband TOAs carry an independent DM measurement each (the batch's
``dm``/``dm_error``).  The fits solve one linear system over the stacked
residual vector ``[time_resids (s); dm_resids (pc/cm^3)]`` with the
stacked design matrix ``[M_toa; M_dm]`` -- columns aligned per parameter,
the DM block zero for parameters that do not move DM.  Correlated-noise
bases span only the TOA rows and the DM block is diagonal, so the joint
chi2 is the TOA GLS chi2 plus the diagonal DM chi2.  Residuals and the
solves are float64 tensors on the batch's device.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from pint_torch import F64
from pint_torch.fitter import DownhillFitter, Fitter, LMFitter
from pint_torch.gls_fitter import (GLSFitter, build_augmented_system,
                                   solve_system)
from pint_torch.residuals import Residuals
from pint_torch.runtime.solve import NonFiniteSystemError
from pint_torch.utils import normalize_designmatrix

__all__ = ["WidebandDMResiduals", "CombinedResiduals",
           "WidebandTOAResiduals", "WidebandTOAFitter",
           "WidebandDownhillFitter", "WidebandLMFitter"]


class WidebandDMResiduals:
    """DM residuals: the measured wideband DM minus the model's total DM
    (reference ``wideband.py:49``)."""

    residual_type = "dm"

    def __init__(self, batch, model):
        self.batch = batch
        self.model = model
        self.dm_data = batch.dm
        if self.dm_data is None:
            raise ValueError(
                "Input TOAs do not have wideband DM values (-pp_dm flags)")
        self._resids = None

    @property
    def resids(self) -> torch.Tensor:
        if self._resids is None:
            self._resids = self.dm_data - self.model.total_dm(self.batch)
        return self._resids

    def get_data_error(self) -> torch.Tensor:
        """The DMEFAC/DMEQUAD-scaled DM uncertainties [pc/cm^3]."""
        return torch.as_tensor(self.model.scaled_dm_uncertainty(self.batch),
                               dtype=F64, device=self.batch.device)

    def calc_chi2(self) -> float:
        err = self.get_data_error()
        if bool((err == 0).any()):
            return float("inf")
        return float(torch.sum((self.resids / err) ** 2))

    @property
    def chi2(self) -> float:
        return self.calc_chi2()


class CombinedResiduals:
    """Residuals of several data types stacked without units (reference
    ``wideband.py:144``)."""

    def __init__(self, residuals: List):
        self.residual_objs: Dict[str, object] = {
            r.residual_type: r for r in residuals}

    @property
    def _combined_resids(self) -> torch.Tensor:
        return torch.cat([r.resids for r in self.residual_objs.values()])

    @property
    def chi2(self) -> float:
        return sum(r.chi2 for r in self.residual_objs.values())


class WidebandTOAResiduals(CombinedResiduals):
    """TOA and DM residuals of one wideband data set (reference
    ``wideband.py:190``)."""

    def __init__(self, batch, model):
        self.batch = batch
        self.model = model
        toa = Residuals(batch, model)
        toa.residual_type = "toa"
        super().__init__([toa, WidebandDMResiduals(batch, model)])
        self._chi2 = None

    @property
    def toa(self) -> Residuals:
        return self.residual_objs["toa"]

    @property
    def dm(self) -> WidebandDMResiduals:
        return self.residual_objs["dm"]

    @property
    def time_resids(self) -> torch.Tensor:
        """The TOA block [s]."""
        return self.toa.time_resids

    @property
    def chi2(self) -> float:
        if self._chi2 is None:
            self._chi2 = self.calc_chi2()
        return self._chi2

    def calc_chi2(self) -> float:
        """The joint chi2 of the stacked system: the noise basis spans only
        the TOA rows, so it is the TOA chi2 (white, ECORR or Woodbury) plus
        the diagonal DM chi2 (reference ``residuals.py:1240``)."""
        return self.toa.calc_chi2() + self.dm.calc_chi2()

    @property
    def dof(self) -> int:
        return 2 * self.batch.ntoas - len(self.model.free_params) - 1

    @property
    def reduced_chi2(self) -> float:
        return self.chi2 / self.dof


class WidebandTOAFitter(Fitter):
    """GLS fit of the stacked TOA+DM system (reference
    ``wideband.py:247``): the Schur path as ``GLSFitter``'s, or with
    ``full_cov`` the dense block-diagonal covariance through its
    Cholesky factor."""

    is_wideband = True

    def __init__(self, batch, model):
        super().__init__(batch, model)
        self.method = "General_Data_Fitter"
        self._gls_cache: dict = {}
        self._noise_dims = None
        self.noise_ampls = {}

    def update_resids(self) -> WidebandTOAResiduals:
        self.resids = WidebandTOAResiduals(self.batch, self.model)
        return self.resids

    def get_noise_covariancematrix(self) -> torch.Tensor:
        """The block-diagonal stacked data covariance: the TOA block with
        its correlated noise, the DM block diagonal."""
        toa_cov = self.model.toa_covariance_matrix(self.batch)
        dm_sig = self.resids.dm.get_data_error()
        return torch.block_diag(toa_cov, torch.diag(dm_sig**2))

    def _wideband_step(self, threshold: float = 0.0,
                       full_cov: bool = False):
        """One linearized solve of the stacked system: (dpars, errs,
        covmat, params)."""
        r = self.resids._combined_resids
        self._noise_dims = None
        if full_cov:
            M_toa, params = self.model.designmatrix(self.batch)
            M_dm, _ = self.model.dm_designmatrix(self.batch)
            M, norm = normalize_designmatrix(torch.cat([M_toa, M_dm]))
            out = solve_system(self, M, r, params, norm, threshold=threshold,
                               cov=self.get_noise_covariancematrix())
            return (*out, params)
        M, params, norm, phiinv, Nvec, dims = build_augmented_system(
            self.model, self.batch, wideband=True)
        self._noise_dims = dims
        return (*solve_system(self, M, r, params, norm, phiinv, Nvec,
                              threshold), params)

    def _store_noise_ampls(self, dpars, ntm):
        if self._noise_dims:
            self.noise_ampls = {comp: dpars[ntm + off:ntm + off + size]
                                for comp, (off, size)
                                in self._noise_dims.items()}

    def fit_toas(self, maxiter: int = 1, threshold: float = 0.0,
                 full_cov: bool = False) -> float:
        """``maxiter`` linearized steps; returns the joint chi2."""
        self.update_resids()
        for _ in range(max(1, maxiter)):
            dpars, errs, covmat, params = self._wideband_step(threshold,
                                                              full_cov)
            GLSFitter._apply_step(self, dpars, errs, covmat, params)
            self.update_resids()
            if not full_cov:
                self._store_noise_ampls(dpars, len(params))
        chi2 = self.resids.calc_chi2()
        if np.isnan(chi2):
            # inf stands for a zero DM error; NaN is a poisoned solve
            raise NonFiniteSystemError(
                "wideband fit produced NaN chi2 (non-finite residuals or a "
                "poisoned solve)")
        self.converged = True
        self.chi2 = chi2
        return chi2


class WidebandDownhillFitter(WidebandTOAFitter, DownhillFitter):
    """The wideband solve under the downhill line search (reference
    ``wideband.py:406``), which reads the joint chi2; with free noise
    parameters it alternates with the joint TOA+DM noise fit.  The noise
    amplitudes come from one more solve at the accepted point."""

    def __init__(self, batch, model):
        super().__init__(batch, model)
        self.method = "downhill_wideband"
        self.threshold = 0.0

    def _solve_step(self):
        dpars, _, covmat, params = self._wideband_step(self.threshold)
        ntm = len(params)
        return dpars[:ntm], params, covmat[:ntm, :ntm]

    def fit_toas(self, maxiter: int = 20, threshold: float = 0.0,
                 **kw) -> float:
        self.threshold = threshold
        chi2 = DownhillFitter.fit_toas(self, maxiter=maxiter, **kw)
        dpars, _, _, params = self._wideband_step(threshold)
        self._store_noise_ampls(dpars, len(params))
        return chi2


class WidebandLMFitter(LMFitter, WidebandTOAFitter):
    """Levenberg-Marquardt over the stacked TOA+DM system (reference
    ``wideband.py:441``)."""

    wideband_system = True

    def __init__(self, batch, model):
        super().__init__(batch, model)
        self.method = "lm_wideband"

    def _residual_vector(self) -> torch.Tensor:
        return self.resids._combined_resids
