"""Generalized-least-squares fitter (port of ``pint_tpu/gls_fitter.py``:
``_solve_cholesky``/``_solve_svd`` :50-88, ``build_augmented_system``
:91-129, ``linearized_system`` :132, ``gls_normal_equations`` :162-185,
``_schur_gls_solve`` and ``_try_schur_path`` :188-287, ``GLSFitter``
:408-730 with its streaming entry points :626-660,
``DownhillGLSFitter`` :733-763).

The augmented system is ``[M_timing | U_noise]``, unit-norm columns, with
the enterprise 1e40 prior on timing columns and the noise weights on the
basis columns; with wideband TOAs the timing rows stack ``[M_toa;
M_dm]`` and the basis gets zero DM rows.  The noise block is identical on
every iteration, so the
Schur-complement path factors it once per fit and solves only the timing
system per step.  The Gram products run on the model's device through
the ``gls.design`` precision segment (:func:`pint_torch.precision.matmul`:
float64 ``torch.matmul`` by default, kernel K11 under a reduced spec),
resolved once a step; the solves go through the hardened ladder, entered at
the autotuner's tuned rung where a manifest holds one.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from pint_torch import F64
from pint_torch.fitter import (DegeneracyWarning, DownhillFitter, Fitter,
                               UsageError)
from pint_torch.precision import matmul as _pmatmul
from pint_torch.runtime.solve import (JITTER_LADDER, NonFiniteSystemError,
                                      SingularMatrixError, SolveDiagnostics,
                                      hardened_cholesky,
                                      solve_normal_cholesky)
from pint_torch.utils import normalize_designmatrix

__all__ = ["GLSFitter", "DownhillGLSFitter", "build_augmented_system",
           "linearized_system", "gls_normal_equations", "solve_system",
           "DegeneracyWarning"]


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


def linearized_system(model, batch, resids=None):
    """``(M, r, w, phiinv, params, norm)``: the normalized Woodbury-form
    linearized GLS system at the model's current state, as float64
    tensors on the batch's device (``params`` a tuple): the entry the
    serving batcher and the streaming engine stack or ingest.  ``w`` is
    the white-noise weight ``1/Nvec`` (a zero weight marks a padded row
    downstream); ``resids`` defaults to a fresh
    :class:`~pint_torch.residuals.Residuals` at the current state."""
    if resids is None:
        from pint_torch.residuals import Residuals

        resids = Residuals(batch, model)
    M, params, norm, phiinv, Nvec, _ = build_augmented_system(model, batch)
    return M, resids.time_resids, 1.0 / Nvec, phiinv, tuple(params), norm


def _design_spec(model, batch):
    """The resolved ``gls.design`` precision segment of this workload
    (override -> manifest ``precision.gls.design`` key -> the bit-identical
    float64 default), resolved once a step."""
    from pint_torch.precision import segment_spec

    return segment_spec("gls.design", model=model, toas=batch)


def gls_normal_equations(M, r, Nvec=None, phiinv=None, cov=None, spec=None):
    """``M^T C^-1 M + diag(phiinv)`` and ``M^T C^-1 r``: C diagonal
    (``Nvec``, the Woodbury form) or the dense ``cov``, through its
    Cholesky factor (no prior).  ``spec`` is the ``gls.design`` segment's
    :class:`~pint_torch.precision.SegmentSpec` (None or float64: the plain
    products)."""
    if cov is not None:
        cf, _, _ = hardened_cholesky(cov, name="TOA covariance")
        cm = torch.cholesky_solve(M, cf)
        return _pmatmul(M.T, cm, spec), _pmatmul(cm.T, r, spec)
    cinv = 1.0 / Nvec
    mtcm = _pmatmul(M.T, cinv[:, None] * M, spec) + torch.diag(phiinv)
    mtcy = _pmatmul(M.T, cinv * r, spec)
    return mtcm, mtcy


def _cho_solve(L, b):
    return torch.cholesky_solve(b[:, None] if b.ndim == 1 else b, L) \
        .reshape(b.shape)


def _schur_gls_solve(M, r, Nvec, phiinv, ntm: int, cache: dict,
                     ladder=None, spec=None):
    """Solve through the Schur complement of the noise block; returns
    (xvar_t, xhat, diagnostics).  The noise block's factor is cached while
    its inputs and the ``gls.design`` spec are unchanged.  Both
    factorizations run through the hardened jitter ``ladder`` (the
    autotuner's tuned entry-rung suffix; default the full ladder); its
    Grams through the ``gls.design`` segment ``spec``."""
    ladder = ladder or JITTER_LADDER
    if not bool(torch.isfinite(r).all()):
        raise NonFiniteSystemError(
            "GLS residual vector contains NaN/inf; refusing the solve")
    W = 1.0 / Nvec
    M_t, M_u = M[:, :ntm], M[:, ntm:]
    pu = phiinv[ntm:]
    WM_u = W[:, None] * M_u
    skey = None if spec is None else spec.key()
    hit = cache.get("schur")
    if (hit is not None and hit[0] == tuple(M.shape) and hit[1] == ntm
            and torch.equal(hit[2], pu) and torch.equal(hit[3], Nvec)
            and torch.equal(hit[4], M_u) and hit[7] == skey):
        L_D, jit_D = hit[5], hit[6]
    else:
        D = _pmatmul(M_u.T, WM_u, spec) + torch.diag(pu)
        L_D, jit_D, _ = hardened_cholesky(D, name="GLS noise block",
                                          ladder=ladder)
        cache["schur"] = (tuple(M.shape), ntm, pu.clone(), Nvec.clone(),
                          M_u.clone(), L_D, jit_D, skey)
    A = _pmatmul(M_t.T, W[:, None] * M_t, spec) + torch.diag(phiinv[:ntm])
    C = _pmatmul(M_t.T, WM_u, spec)
    b_t = M_t.T @ (W * r)
    b_u = WM_u.T @ r
    Y = torch.linalg.solve_triangular(L_D, C.T, upper=False)
    z_u = torch.linalg.solve_triangular(L_D, b_u[:, None], upper=False)[:, 0]
    S = A - Y.T @ Y
    L_S, jit_S, attempts = hardened_cholesky(S, name="GLS Schur complement",
                                             ladder=ladder)
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


def _try_schur_path(fitter, M, r, Nvec, phiinv, ntm, norm, spec=None):
    """(dpars, errs, covmat) from the Schur path, or None when its ladder
    is exhausted (the caller's dense path takes over).  The fitter carries
    the cross-iteration cache and, when tuned, the ladder's entry rung
    (``_solve_ladder``)."""
    try:
        xvar_t, xhat, diag = _schur_gls_solve(
            M, r, Nvec, phiinv, ntm, fitter._gls_cache,
            ladder=getattr(fitter, "_solve_ladder", None), spec=spec)
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
                 threshold: float = 0.0, cov=None, spec=None):
    """(dpars, errs, covmat) of one normalized GLS system: the Schur path
    where the system has noise columns (and no dense ``cov``), else the
    Cholesky ladder, else the SVD -- at once with ``threshold > 0``.
    ``spec`` is the ``gls.design`` segment of the Grams (None: float64)."""
    ntm = len(params)
    if cov is None and threshold <= 0 and M.shape[1] > ntm:
        out = _try_schur_path(fitter, M, r, Nvec, phiinv, ntm, norm, spec)
        if out is not None:
            return out
    mtcm, mtcy = gls_normal_equations(M, r, Nvec, phiinv, cov, spec=spec)
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

    def __init__(self, batch, model, residuals=None, track_mode=None):
        super().__init__(batch, model, residuals=residuals,
                         track_mode=track_mode)
        self.method = "generalized_least_square"
        self._gls_cache: dict = {}
        self._noise_dims = None
        self.noise_ampls = {}

    def _gls_step(self, threshold: float = 0.0, full_cov: bool = False):
        """One linearized GLS solve: (dpars, errs, covmat, params).  The
        ``gls.design`` segment is resolved once a step and kept on
        ``_precision_spec``.  With ``full_cov`` the timing design matrix
        alone is solved against the dense N x N TOA covariance through
        its Cholesky factor (reference ``gls_fitter.py:439-444``): no
        noise columns, so no noise amplitudes."""
        self._precision_spec = _design_spec(self.model, self.batch)
        if full_cov:
            self._noise_dims = None
            M_tm, params = self.get_designmatrix()
            M, norm = normalize_designmatrix(M_tm)
            cov = self.model.toa_covariance_matrix(self.batch)
            return (*solve_system(self, M, self.resids.time_resids, params,
                                  norm, threshold=threshold, cov=cov,
                                  spec=self._precision_spec), params)
        M, params, norm, phiinv, Nvec, dims = build_augmented_system(
            self.model, self.batch)
        self._noise_dims = dims
        return (*solve_system(self, M, self.resids.time_resids, params,
                              norm, phiinv, Nvec, threshold,
                              spec=self._precision_spec), params)

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
                 full_cov: bool = False, debug: bool = False,
                 robust=None, plan=None) -> float:
        """``maxiter`` linearized GLS steps; returns the post-fit chi2.
        ``full_cov`` solves against the dense TOA covariance (no noise
        amplitudes are stored); ``debug`` is accepted and, as in the
        reference, changes nothing; ``plan`` (the TOA axis over a device
        mesh) is ROADMAP queue A item 9 and raises."""
        from pint_torch import autotune

        if plan is not None:
            raise NotImplementedError(
                "GLSFitter.fit_toas(plan=...): the normal equations over a "
                "device mesh are ROADMAP queue A item 9")
        # the tuned solve-ladder entry rung, resolved once a fit (None: the
        # full ladder, also the healthy rung-0 outcome)
        self._solve_ladder = autotune.resolve_solve_ladder(self)
        if self._check_robust_arg(robust):
            raise UsageError(
                "robust fitting is available on the WLS-family fitters "
                "only (Huber IRLS assumes uncorrelated errors)")
        self.update_resids()
        for _ in range(max(1, maxiter)):
            dpars, errs, covmat, params = self._gls_step(
                threshold=threshold, full_cov=full_cov)
            self._apply_step(dpars, errs, covmat, params)
            self.update_resids()
            if not full_cov:
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


    # -- streaming updates (pint_torch.streaming) ---------------------------
    def streaming(self, **kw):
        """The fitter's :class:`~pint_torch.streaming.update.StreamingGLS`
        engine, built on first use from the current state (construction
        options -- block ladder, warm steps -- only then)."""
        if getattr(self, "_stream", None) is None:
            from pint_torch.streaming.update import StreamingGLS

            self._stream = StreamingGLS(self, **kw)
        elif kw:
            raise UsageError(
                "this fitter's streaming engine already exists; "
                "construction options must be passed on the first "
                "streaming()/update_toas() call")
        return self._stream

    def update_toas(self, new_toas, steps=None, **engine_kw):
        """Ingest newly arrived TOAs incrementally: the validate/quarantine
        gate, a rank-k update of the normal-equation factor (K9) for the
        certified rows, warm-started Gauss-Newton from the previous
        solution.  ``steps`` is a per-call override; any other keyword is
        a construction option of :meth:`streaming`.  Returns the
        :class:`~pint_torch.streaming.update.UpdateOutcome`."""
        return self.streaming(**engine_kw).update_toas(new_toas, steps=steps)

    def quarantine_rows(self, block_id: int, rows):
        """Quarantine certified rows of one stream block: a rank-k
        downdate of exactly those rows and a warm refit."""
        return self.streaming().quarantine_rows(block_id, rows)

    def release_quarantined(self, block_id: int, rows):
        """Release repaired rows back into the fit: a rank-k update, never
        a full rebuild, and a warm refit."""
        return self.streaming().release_quarantined(block_id, rows)


class DownhillGLSFitter(DownhillFitter):
    """Iterative GLS with the downhill line search (reference
    ``gls_fitter.py:733-763``): each step is :meth:`GLSFitter._gls_step`'s
    solution, taken whole or halved by :class:`DownhillFitter`; the noise
    amplitudes come from one more solve at the accepted point (none under
    ``full_cov``)."""

    def __init__(self, batch, model, **kw):
        super().__init__(batch, model, **kw)
        self.method = "downhill_gls"
        self.full_cov = False
        self.threshold = 0.0
        self._gls_cache: dict = {}
        self._noise_dims = None
        self.noise_ampls = {}

    def _solve_step(self):
        dpars, _, covmat, params = GLSFitter._gls_step(
            self, threshold=self.threshold, full_cov=self.full_cov)
        ntm = len(params)
        return dpars[:ntm], params, covmat[:ntm, :ntm]

    def fit_toas(self, maxiter: int = 20, full_cov: bool = False,
                 threshold: float = 0.0, **kw) -> float:
        """The downhill fit of :class:`DownhillFitter` on GLS steps;
        ``full_cov`` takes each step against the dense TOA covariance
        (reference ``gls_fitter.py:749-760``)."""
        self.full_cov = full_cov
        self.threshold = threshold
        chi2 = super().fit_toas(maxiter=maxiter, **kw)
        if not full_cov:
            # the noise amplitudes of the accepted parameters, not of a
            # step that was halved or rejected
            dpars, _, _, params = GLSFitter._gls_step(self,
                                                      threshold=threshold)
            GLSFitter._store_noise_ampls(self, dpars, len(params))
        return chi2
