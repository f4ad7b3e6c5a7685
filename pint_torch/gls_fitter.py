"""Generalized-least-squares fitter (port of ``pint_tpu/gls_fitter.py``:
``_solve_cholesky``/``_solve_svd`` :50-88, ``build_augmented_system``
:91-129, ``gls_normal_equations`` :162-185, ``_schur_gls_solve`` and
``_try_schur_path`` :188-287, ``GLSFitter`` :408-730).

The augmented system is ``[M_timing | U_noise]``, unit-norm columns, with
the enterprise 1e40 prior on timing columns and the noise weights on the
basis columns.  The noise block is identical on every iteration, so the
Schur-complement path factors it once per fit and solves only the timing
system per step.  The Gram products are float64 ``torch.matmul`` on the
model's device; the solves go through the hardened ladder.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from pint_torch import F64
from pint_torch.fitter import Fitter
from pint_torch.runtime.solve import (NonFiniteSystemError, SingularMatrixError,
                                      SolveDiagnostics, hardened_cholesky,
                                      solve_normal_cholesky)
from pint_torch.utils import normalize_designmatrix

__all__ = ["GLSFitter", "build_augmented_system", "gls_normal_equations",
           "DegeneracyWarning"]


class DegeneracyWarning(UserWarning):
    """Degenerate parameter directions were removed from an SVD solve."""


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


def build_augmented_system(model, batch):
    """Normalized ``[M_timing | noise basis]`` with (params, norm, phiinv,
    Nvec, noise_dims): the 1e40 timing prior (enterprise convention, enters
    only as phiinv = 1e-40 / norm^2) and the noise weights."""
    dev = batch.device
    M_tm, params = model.designmatrix(batch, reuse_linear=True)
    Us, ws, dims = model.noise_basis_by_component(batch)
    weights = np.full(len(params), 1e40)
    if Us:
        U = torch.as_tensor(np.hstack(Us), dtype=F64, device=dev)
        M = torch.cat([M_tm, U], dim=1)
        weights = np.concatenate([weights] + ws)
    else:
        M = M_tm
    M, norm = normalize_designmatrix(M)
    phiinv = 1.0 / torch.as_tensor(weights, dtype=F64, device=dev) / norm**2
    Nvec = torch.as_tensor(model.scaled_toa_uncertainty(batch) ** 2,
                           dtype=F64, device=dev)
    return M, params, norm, phiinv, Nvec, dims


def gls_normal_equations(M, r, Nvec, phiinv):
    """``M^T C^-1 M + diag(phiinv)`` and ``M^T C^-1 r`` (Woodbury form)."""
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
        r = self.resids.time_resids
        M, params, norm, phiinv, Nvec, dims = build_augmented_system(
            self.model, self.batch)
        self._noise_dims = dims
        ntm = len(params)
        if threshold <= 0 and M.shape[1] > ntm:
            out = _try_schur_path(self, M, r, Nvec, phiinv, ntm, norm)
            if out is not None:
                return (*out, params)
        mtcm, mtcy = gls_normal_equations(M, r, Nvec, phiinv)
        if threshold <= 0:
            try:
                xvar, xhat, diag = _solve_cholesky(mtcm, mtcy)
            except SingularMatrixError:
                xvar, xhat, diag = _solve_svd(mtcm, mtcy, threshold, params)
        else:
            xvar, xhat, diag = _solve_svd(mtcm, mtcy, threshold, params)
        self.solve_diagnostics = diag
        dpars = xhat / norm
        errs = torch.sqrt(torch.diagonal(xvar)) / norm
        covmat = (xvar / norm).T / norm
        return dpars, errs, covmat, params

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

    def fit_toas(self, maxiter: int = 1, threshold: float = 0.0) -> float:
        """``maxiter`` linearized GLS steps; returns the post-fit chi2."""
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
        return chi2
