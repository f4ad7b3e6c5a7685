"""Generalized-least-squares fitter (port of ``pint_tpu/gls_fitter.py``:
``_solve_cholesky``/``_solve_svd`` :50-88, ``build_augmented_system``
:91-129, ``gls_normal_equations`` :162-185, ``_schur_gls_solve`` and
``_try_schur_path`` :188-287, ``GLSFitter`` :408-730,
``DownhillGLSFitter`` :733-763).

The augmented system is ``[M_timing | U_noise]``, unit-norm columns, with
the enterprise 1e40 prior on timing columns and the noise weights on the
basis columns; with wideband TOAs the timing rows stack ``[M_toa;
M_dm]`` and the basis gets zero DM rows.  The noise block is identical on
every iteration, so the
Schur-complement path factors it once per fit and solves only the timing
system per step.  The Gram products are float64 ``torch.matmul`` on the
model's device; the solves go through the hardened ladder.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from pint_torch import F64
from pint_torch.fitter import (DegeneracyWarning, DownhillFitter, Fitter,
                               UsageError)
from pint_torch.runtime.solve import (NonFiniteSystemError, SingularMatrixError,
                                      SolveDiagnostics, hardened_cholesky,
                                      solve_normal_cholesky)
from pint_torch.utils import normalize_designmatrix

__all__ = ["GLSFitter", "DownhillGLSFitter", "build_augmented_system",
           "gls_normal_equations", "solve_system", "DegeneracyWarning"]


def _solve_cholesky(mtcm, mtcy):
    return solve_normal_cholesky(mtcm, mtcy, name="GLS normal equations")


def _solve_svd(mtcm, mtcy, threshold: float, params):
    """SVD solve with degenerate directions removed."""
    if not (bool(torch.isfinite(mtcm).all())
            and bool(torch.isfinite(mtcy).all())):
        raise NonFiniteSystemError(
            "GLS normal equations contain NaN/inf; refusing the SVD solve")
    U, s, Vt = torch.linalg.svd(mtcm, full_matrices=False)
    if threshold > 0:
        bad = s < threshold * s.max()
        if bool(bad.any()):
            warnings.warn("Degenerate parameter directions removed",
                          DegeneracyWarning)
        s = torch.where(bad, torch.inf, s)
    xvar = (Vt.T / s) @ Vt
    xhat = Vt.T @ ((U.T @ mtcy) / s)
    sf = s[torch.isfinite(s)]
    cond = float(sf.max() / torch.clamp(sf.min(), min=1e-300)) \
        if sf.numel() else float("inf")
    return xvar, xhat, SolveDiagnostics(method="svd", jitter=0.0,
                                        attempts=1, condition=cond)


def build_augmented_system(model, batch, wideband: bool = False):
    """Normalized ``[M_timing | noise basis]`` with (params, norm, phiinv,
    Nvec, noise_dims): the 1e40 timing prior (enterprise convention, enters
    only as phiinv = 1e-40 / norm^2) and the noise weights.  With
    ``wideband`` the timing rows are the stacked ``[M_toa; M_dm]``, the
    noise basis is padded with zero DM rows and Nvec is ``[sigma_toa^2;
    sigma_dm^2]``."""
    dev = batch.device
    M_q, params = model.designmatrix(batch, reuse_linear=True)
    if wideband:
        M_q = torch.cat([M_q, model.dm_designmatrix(batch)[0]], dim=0)
    Us, ws, dims = model.noise_basis_by_component(batch)
    weights = np.full(len(params), 1e40)
    if Us:
        U = np.hstack(Us)
        U = np.vstack([U, np.zeros((M_q.shape[0] - U.shape[0], U.shape[1]))])
        M = torch.cat([M_q, torch.as_tensor(U, dtype=F64, device=dev)], dim=1)
        weights = np.concatenate([weights] + ws)
    else:
        M = M_q
    M, norm = normalize_designmatrix(M)
    phiinv = 1.0 / torch.as_tensor(weights, dtype=F64, device=dev) / norm**2
    sigma = model.scaled_toa_uncertainty(batch)
    if wideband:
        sigma = np.concatenate([sigma, model.scaled_dm_uncertainty(batch)])
    Nvec = torch.as_tensor(sigma**2, dtype=F64, device=dev)
    return M, params, norm, phiinv, Nvec, dims


def gls_normal_equations(M, r, Nvec=None, phiinv=None, cov=None):
    """``M^T C^-1 M + diag(phiinv)`` and ``M^T C^-1 r``: C diagonal
    (``Nvec``, the Woodbury form) or the dense ``cov``, through its
    Cholesky factor (no prior)."""
    if cov is not None:
        cf, _, _ = hardened_cholesky(cov, name="TOA covariance")
        cm = torch.cholesky_solve(M, cf)
        return M.T @ cm, cm.T @ r
    cinv = 1.0 / Nvec
    mtcm = M.T @ (cinv[:, None] * M) + torch.diag(phiinv)
    mtcy = M.T @ (cinv * r)
    return mtcm, mtcy


def _cho_solve(L, b):
    return torch.cholesky_solve(b[:, None] if b.ndim == 1 else b, L) \
        .reshape(b.shape)


def _schur_gls_solve(M, r, Nvec, phiinv, ntm: int, cache: dict):
    """Solve through the Schur complement of the noise block; returns
    (xvar_t, xhat, diagnostics).  The noise block's factor is cached while
    its inputs are unchanged."""
    if not bool(torch.isfinite(r).all()):
        raise NonFiniteSystemError(
            "GLS residual vector contains NaN/inf; refusing the solve")
    W = 1.0 / Nvec
    M_t, M_u = M[:, :ntm], M[:, ntm:]
    pu = phiinv[ntm:]
    WM_u = W[:, None] * M_u
    hit = cache.get("schur")
    if (hit is not None and hit[0] == tuple(M.shape) and hit[1] == ntm
            and torch.equal(hit[2], pu) and torch.equal(hit[3], Nvec)
            and torch.equal(hit[4], M_u)):
        L_D, jit_D = hit[5], hit[6]
    else:
        D = M_u.T @ WM_u + torch.diag(pu)
        L_D, jit_D, _ = hardened_cholesky(D, name="GLS noise block")
        cache["schur"] = (tuple(M.shape), ntm, pu.clone(), Nvec.clone(),
                          M_u.clone(), L_D, jit_D)
    A = M_t.T @ (W[:, None] * M_t) + torch.diag(phiinv[:ntm])
    C = M_t.T @ WM_u
    b_t = M_t.T @ (W * r)
    b_u = WM_u.T @ r
    Y = torch.linalg.solve_triangular(L_D, C.T, upper=False)
    z_u = torch.linalg.solve_triangular(L_D, b_u[:, None], upper=False)[:, 0]
    S = A - Y.T @ Y
    L_S, jit_S, attempts = hardened_cholesky(S, name="GLS Schur complement")
    x_t = _cho_solve(L_S, b_t - Y.T @ z_u)
    xvar_t = _cho_solve(L_S, torch.eye(ntm, dtype=F64, device=M.device))
    x_u = _cho_solve(L_D, b_u - C.T @ x_t)
    dS = torch.diagonal(L_S)
    jitter = max(jit_D, jit_S)
    diag = SolveDiagnostics(
        method="cholesky" if jitter == 0.0 else "cholesky-jitter",
        jitter=float(jitter), attempts=attempts,
        condition=float((dS.max() / torch.clamp(dS.min(), min=1e-300)) ** 2))
    return xvar_t, torch.cat([x_t, x_u]), diag


def _try_schur_path(fitter, M, r, Nvec, phiinv, ntm, norm):
    """(dpars, errs, covmat) from the Schur path, or None when its ladder
    is exhausted (the caller's dense path takes over)."""
    try:
        xvar_t, xhat, diag = _schur_gls_solve(M, r, Nvec, phiinv, ntm,
                                              fitter._gls_cache)
    except SingularMatrixError:
        return None
    fitter.solve_diagnostics = diag
    dpars = xhat / norm
    errs = torch.cat([
        torch.sqrt(torch.clamp(torch.diagonal(xvar_t), min=0.0)) / norm[:ntm],
        torch.zeros(len(norm) - ntm, dtype=F64, device=norm.device)])
    covmat = (xvar_t / norm[:ntm]).T / norm[:ntm]
    return dpars, errs, covmat


def solve_system(fitter, M, r, params, norm, phiinv=None, Nvec=None,
                 threshold: float = 0.0, cov=None):
    """(dpars, errs, covmat) of one normalized GLS system: the Schur path
    where the system has noise columns (and no dense ``cov``), else the
    Cholesky ladder, else the SVD -- at once with ``threshold > 0``."""
    ntm = len(params)
    if cov is None and threshold <= 0 and M.shape[1] > ntm:
        out = _try_schur_path(fitter, M, r, Nvec, phiinv, ntm, norm)
        if out is not None:
            return out
    mtcm, mtcy = gls_normal_equations(M, r, Nvec, phiinv, cov)
    if threshold <= 0:
        try:
            xvar, xhat, diag = _solve_cholesky(mtcm, mtcy)
        except SingularMatrixError:
            xvar, xhat, diag = _solve_svd(mtcm, mtcy, threshold, params)
    else:
        xvar, xhat, diag = _solve_svd(mtcm, mtcy, threshold, params)
    fitter.solve_diagnostics = diag
    dpars = xhat / norm
    errs = torch.sqrt(torch.diagonal(xvar)) / norm
    covmat = (xvar / norm).T / norm
    return dpars, errs, covmat


class GLSFitter(Fitter):
    """One-shot GLS fitter (reference ``gls_fitter.py:408``)."""

    def __init__(self, batch, model):
        super().__init__(batch, model)
        self.method = "generalized_least_square"
        self._gls_cache: dict = {}
        self._noise_dims = None
        self.noise_ampls = {}

    def _gls_step(self, threshold: float = 0.0):
        """One linearized GLS solve: (dpars, errs, covmat, params)."""
        M, params, norm, phiinv, Nvec, dims = build_augmented_system(
            self.model, self.batch)
        self._noise_dims = dims
        return (*solve_system(self, M, self.resids.time_resids, params,
                              norm, phiinv, Nvec, threshold), params)

    def _apply_step(self, dpars, errs, covmat, params):
        dp = dpars.cpu().numpy()
        er = errs.cpu().numpy()
        for i, p in enumerate(params):
            if p == "Offset":
                continue
            par = self.model[p]
            par.value = float(par.value or 0.0) + float(dp[i])
            par.uncertainty = float(er[i])
            self.errors[p] = float(er[i])
        ntm = len(params)
        self.covariance = covmat[:ntm, :ntm].cpu().numpy()
        self.fitted_params = list(params)

    def _store_noise_ampls(self, dpars, ntm):
        if self._noise_dims is None:
            return
        self.noise_ampls = {comp: dpars[ntm + off:ntm + off + size]
                            for comp, (off, size) in self._noise_dims.items()}
        self.resids.noise_ampls = self.noise_ampls

    def fit_toas(self, maxiter: int = 1, threshold: float = 0.0,
                 robust=None) -> float:
        """``maxiter`` linearized GLS steps; returns the post-fit chi2."""
        if self._check_robust_arg(robust):
            raise UsageError(
                "robust fitting is available on the WLS-family fitters "
                "only (Huber IRLS assumes uncorrelated errors)")
        self.update_resids()
        for _ in range(max(1, maxiter)):
            dpars, errs, covmat, params = self._gls_step(threshold=threshold)
            self._apply_step(dpars, errs, covmat, params)
            self.update_resids()
            self._store_noise_ampls(dpars, len(params))
        chi2 = self.resids.calc_chi2()
        if np.isnan(chi2):
            raise NonFiniteSystemError(
                "GLS fit produced NaN chi2 (non-finite residuals or a "
                "poisoned solve)")
        self.converged = True
        self.chi2 = chi2
        self.update_model(chi2)
        return chi2


class DownhillGLSFitter(DownhillFitter):
    """Iterative GLS with the downhill line search (reference
    ``gls_fitter.py:733-763``): each step is :meth:`GLSFitter._gls_step`'s
    solution, taken whole or halved by :class:`DownhillFitter`; the noise
    amplitudes come from one more solve at the accepted point."""

    def __init__(self, batch, model):
        super().__init__(batch, model)
        self.method = "downhill_gls"
        self.threshold = 0.0
        self._gls_cache: dict = {}
        self._noise_dims = None
        self.noise_ampls = {}

    def _solve_step(self):
        dpars, _, covmat, params = GLSFitter._gls_step(
            self, threshold=self.threshold)
        ntm = len(params)
        return dpars[:ntm], params, covmat[:ntm, :ntm]

    def fit_toas(self, maxiter: int = 20, threshold: float = 0.0,
                 **kw) -> float:
        self.threshold = threshold
        chi2 = super().fit_toas(maxiter=maxiter, **kw)
        # the noise amplitudes of the accepted parameters, not of a step
        # that was halved or rejected
        dpars, _, _, params = GLSFitter._gls_step(self, threshold=threshold)
        GLSFitter._store_noise_ampls(self, dpars, len(params))
        return chi2
