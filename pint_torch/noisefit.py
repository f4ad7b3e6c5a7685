"""Maximum-likelihood noise-parameter fitting (port of
``pint_tpu/noisefit.py``: ``free_noise_params`` :39, ``_value_getter``
:67, ``_white_ops`` :81, ``_corr_weight_builders`` :101,
``build_noise_lnlikelihood`` with the wideband ``lnlike_wb`` :166,
``NoiseFitResult`` :288, ``_scales_for`` :304, ``fit_noise_ml`` :322).

EFAC/EQUAD/ECORR, the power-law Fourier-process amplitudes and, for
wideband TOAs, DMEFAC/DMEQUAD are estimated by maximizing the Gaussian
log-likelihood -- log-determinant included -- at fixed timing parameters.
The likelihood is one torch function of the free noise values ``x`` on
the model's device: the white-noise variances (masked updates, so both
autodiff modes pass through them), the ECORR block weights and the power
law in its factored form are all functions of ``x``, and the Woodbury
form is :func:`pint_torch.utils.woodbury_dot`.  ``torch.func`` gives the
exact gradient (``grad_and_value``) and the Hessian the uncertainties come
from (``hessian``, forward over reverse); scipy's L-BFGS-B drives the
search on the host, as in the reference.
"""

from __future__ import annotations

import math
import warnings
from typing import Callable, List, Optional

import numpy as np
import torch
from torch.func import grad_and_value, hessian

from pint_torch import F64
from pint_torch.models.noise_model import (EcorrNoise, PLRedNoise, _masked,
                                           _PLNoise, _powerlaw_psd,
                                           _tdb_seconds,
                                           ecorr_quantization_matrix)
from pint_torch.models.timing_model import OFFSET_PRIOR_WEIGHT
from pint_torch.utils import woodbury_dot

__all__ = ["free_noise_params", "build_noise_lnlikelihood", "NoiseFitResult",
           "fit_noise_ml"]

_LOG_TWO_PI = math.log(2.0 * math.pi)


def free_noise_params(model, wideband: bool = False) -> List[str]:
    """The free noise parameters the likelihood can fit.  Left out with a
    warning: TNEQ (the reference turns it into an EQUAD when it sets the
    model up: a flat direction) and, for narrowband TOAs, DMEFAC/DMEQUAD
    (the TOA likelihood has no DM term)."""
    out = []
    for c in model.noise_components:
        for p in c.params:
            par = model[p]
            if par.frozen or par.value is None:
                continue
            if p.startswith("TNEQ"):
                warnings.warn(f"{p} is free but TNEQ is converted to an "
                              "EQUAD equivalent at setup; excluding it from "
                              "the noise fit (free the EQUAD instead)")
                continue
            if p.startswith(("DMEFAC", "DMEQUAD")) and not wideband:
                warnings.warn(f"{p} is free but the data are narrowband (no "
                              "wideband DM measurements); excluding it from "
                              "the noise fit")
                continue
            out.append(p)
    return out


def _value_getter(model, free_names: List[str], device) -> Callable:
    """getv(x, name): a noise parameter's value as a 0-d tensor -- an
    element of ``x`` when free, the model's value when frozen."""
    index = {n: i for i, n in enumerate(free_names)}

    def getv(x, name):
        if name in index:
            return x[index[name]]
        return torch.tensor(float(model[name].value or 0.0), dtype=F64,
                            device=device)

    return getv


def _white_ops(model, category: str = "scale_toa_error",
               prefixes=("EQUAD", "EFAC"), device=None):
    """(kind, mask, parameter) in the order the component scales sigma:
    all quadrature adds, then all multipliers; masks (N,) bool tensors."""
    ops = []
    for c in model.noise_components:
        if c.category != category:
            continue
        for prefix in prefixes:
            for p, _, m in _masked(c, prefix):
                if m.any():
                    ops.append((prefix, torch.as_tensor(m, device=device), p))
    return ops


def _corr_weight_builders(model, batch) -> List[Callable]:
    """Per correlated component, in ``noise_basis_by_component``'s column
    order, a function ``w(x, getv)`` of its basis weights."""
    dev = batch.device
    builders = []
    for c in model.components.values():
        if c.kind != "noise" or not hasattr(c, "basis_weight_pair"):
            continue
        if isinstance(c, EcorrNoise):
            t = _tdb_seconds(batch)
            blocks = [(p, ecorr_quantization_matrix(t[np.nonzero(m)[0]])
                       .shape[1]) for p, _, m in _masked(c, "ECORR")]

            def w_ecorr(x, getv, blocks=blocks):
                segs = [((getv(x, p) * 1e-6) ** 2).reshape(1).expand(k)
                        for p, k in blocks if k]
                return torch.cat(segs) if segs \
                    else torch.zeros(0, dtype=F64, device=dev)

            builders.append(w_ecorr)
        elif isinstance(c, _PLNoise):
            _, f = c.get_time_frequencies(batch)
            df = np.diff(np.concatenate([[0.0], f]))
            f_rep = torch.as_tensor(np.repeat(f, 2), dtype=F64, device=dev)
            df_rep = torch.as_tensor(np.repeat(df, 2), dtype=F64, device=dev)
            amp_p, gam_p = c._plc
            table = model.params_table
            # the tempo1 RNAMP/RNIDX convention where TNREDAMP is unset
            use_rn = isinstance(c, PLRedNoise) \
                and getattr(table.get("RNAMP"), "value", None) is not None \
                and getattr(table.get(amp_p), "value", None) is None

            def w_pl(x, getv, amp_p=amp_p, gam_p=gam_p, use_rn=use_rn,
                     f_rep=f_rep, df_rep=df_rep):
                if use_rn:
                    amp = getv(x, "RNAMP") / PLRedNoise.RN_FAC
                    gam = -getv(x, "RNIDX")
                else:
                    amp = 10.0 ** getv(x, amp_p)
                    gam = getv(x, gam_p)
                return _powerlaw_psd(f_rep, amp, gam) * df_rep

            builders.append(w_pl)
        else:  # a correlated component without fit parameters
            _, w = c.basis_weight_pair(model, batch)
            w_const = torch.as_tensor(np.asarray(w), dtype=F64, device=dev)
            builders.append(lambda x, getv, w_const=w_const: w_const)
    return builders


def build_noise_lnlikelihood(model, batch, wideband: bool = False):
    """(lnlike, x0, free_names): ``lnlike(x, r)`` is the Gaussian
    log-likelihood of the time residuals ``r`` [s], a torch function of the
    free noise values ``x`` (float64 tensors on the batch's device):
    ``-(chi2 + logdet C + n log 2 pi) / 2`` with ``C = diag(N) + U phi
    U^T`` through the Woodbury identity and the overall offset
    marginalized, as :meth:`Residuals.lnlikelihood`.

    With ``wideband`` it is ``lnlike(x, r, r_dm)``: the joint likelihood
    adds the diagonal DM term of the DMEFAC/DMEQUAD-scaled variances (the
    noise basis spans only the TOA rows) and DMEFAC/DMEQUAD join ``x``."""
    dev = batch.device
    free = free_noise_params(model, wideband=wideband)
    if any(p in ("RNAMP", "RNIDX") for p in free):
        tn = model.params_table.get("TNREDAMP")
        if tn is not None and tn.value is not None:
            # TNREDAMP takes precedence: the likelihood is flat in RNAMP
            warnings.warn(
                "RNAMP/RNIDX are free but TNREDAMP is set and takes "
                "precedence -- the likelihood is flat in RNAMP/RNIDX; free "
                "TNREDAMP/TNREDGAM instead")
    getv = _value_getter(model, free, dev)
    sigma0_sq = (batch.error_us * 1e-6) ** 2
    ops = _white_ops(model, device=dev)
    Us, _, _ = model.noise_basis_by_component(batch)
    n = batch.ntoas
    U = offset_phi = None
    if Us:
        U0 = np.hstack(Us)
        U_aug, _ = model.augment_basis_for_offset(U0, np.zeros(U0.shape[1]),
                                                  n=n)
        if U_aug.shape[1] > U0.shape[1]:
            offset_phi = torch.tensor([OFFSET_PRIOR_WEIGHT], dtype=F64,
                                      device=dev)
        U = torch.as_tensor(U_aug, dtype=F64, device=dev)
    builders = _corr_weight_builders(model, batch)

    def scaled_var(var, x, ops, quad_scale):
        # masked updates equal the reference's scatter bitwise (adding 0 or
        # multiplying by 1 elsewhere) and pass both autodiff modes
        for kind, m, p in ops:
            v = getv(x, p)
            if kind.endswith("EQUAD"):
                var = var + torch.where(m, (v * quad_scale) ** 2, 0.0)
            else:
                var = var * torch.where(m, v * v, 1.0)
        return var

    def lnlike_toa(x, r):
        var = scaled_var(sigma0_sq, x, ops, 1e-6)
        if U is None:
            chi2 = torch.sum(r * r / var)
            logdet = torch.sum(torch.log(var))
        else:
            segs = [b(x, getv) for b in builders]
            if offset_phi is not None:
                segs.append(offset_phi)
            chi2, logdet = woodbury_dot(var, U, torch.cat(segs), r, r)
        return -0.5 * (chi2 + logdet + n * _LOG_TWO_PI)

    x0 = np.array([float(model[p].value) for p in free])
    if not wideband:
        return lnlike_toa, x0, free

    dm_err = batch.dm_error
    if dm_err is None:
        raise ValueError("wideband noise fit requested but the TOAs carry "
                         "no wideband DM measurements (-pp_dm flags)")
    dm_sig0_sq = dm_err**2
    dm_ops = _white_ops(model, category="scale_dm_error",
                        prefixes=("DMEQUAD", "DMEFAC"), device=dev)

    def lnlike_wb(x, r, r_dm):
        var_dm = scaled_var(dm_sig0_sq, x, dm_ops, 1.0)  # DMEQUAD in pc/cm3
        lnl_dm = -0.5 * (torch.sum(r_dm * r_dm / var_dm)
                         + torch.sum(torch.log(var_dm)) + n * _LOG_TWO_PI)
        return lnlike_toa(x, r) + lnl_dm

    return lnlike_wb, x0, free


class NoiseFitResult:
    """Values, uncertainties and diagnostics of one noise fit: the
    L-BFGS-B iterations (``nit``) and likelihood evaluations (``nfev``)
    beside the reference's fields."""

    def __init__(self, names, values, errors, lnlike, converged, message,
                 nit: int = 0, nfev: int = 0):
        self.names = list(names)
        self.values = np.asarray(values)
        self.errors = None if errors is None else np.asarray(errors)
        self.lnlike = float(lnlike)
        self.converged = bool(converged)
        self.message = message
        self.nit = int(nit)
        self.nfev = int(nfev)

    def __repr__(self):
        rows = ", ".join(f"{n}={v:.6g}" for n, v in zip(self.names,
                                                         self.values))
        return f"NoiseFitResult({rows}, lnlike={self.lnlike:.3f})"


def _scales_for(names: List[str], x0: np.ndarray) -> np.ndarray:
    """Per-parameter step scales so that L-BFGS sees O(1) curvature."""
    s = np.ones(len(names))
    for i, nm in enumerate(names):
        if nm.startswith("RNAMP"):
            # tempo1 linear amplitude, typically 1e-3..1e-1
            s[i] = max(0.5 * abs(x0[i]), 1e-4)
        elif nm.startswith("DMEQUAD"):
            # pc/cm3; wideband DM errors are typically ~1e-4..1e-3
            s[i] = max(0.25 * abs(x0[i]), 1e-5)
        elif nm.startswith(("EFAC", "EQUAD", "ECORR", "DMEFAC")):
            s[i] = max(0.25 * abs(x0[i]), 0.05)
        else:  # log10 amplitudes, spectral indices
            s[i] = 0.25
    return s


def fit_noise_ml(model, batch, resids_s, dm_resids=None,
                 method: str = "L-BFGS-B", uncertainty: bool = False,
                 maxiter: int = 200) -> Optional[NoiseFitResult]:
    """Maximize the noise likelihood at fixed timing parameters: scipy's
    ``method`` on the host over the value and gradient on the device, the
    uncertainties from the Hessian's pseudo-inverse.  None when no noise
    parameter is free.  ``dm_resids`` [pc/cm^3] fits the joint wideband
    likelihood with DMEFAC/DMEQUAD."""
    import scipy.optimize as opt

    dev = batch.device
    wideband = dm_resids is not None
    free = tuple(free_noise_params(model, wideband=wideband))
    if not free:
        return None
    # the built functions hold the bases, masks and frozen values: keep
    # them across the alternation's rounds while those are unchanged
    frozen_vals = tuple((p, str(model[p].value))
                        for c in model.noise_components for p in c.params
                        if p not in free)
    key = ("noisefit_fns", free, batch, frozen_vals, wideband)
    cached = model._cache.get(key)
    if cached is None:
        lnlike, _, names = build_noise_lnlikelihood(model, batch,
                                                    wideband=wideband)

        def neg(x, *r):
            return -lnlike(x, *r)

        cached = (grad_and_value(neg), hessian(neg), names)
        model._cache[key] = cached
    vg_fn, hess_fn, names = cached
    x0 = np.array([float(model[p].value) for p in names])
    rs = [torch.as_tensor(resids_s, dtype=F64, device=dev)]
    if wideband:
        rs.append(torch.as_tensor(dm_resids, dtype=F64, device=dev))
    scale = _scales_for(names, x0)

    def fun(y):
        g, v = vg_fn(torch.as_tensor(x0 + y * scale, dtype=F64, device=dev),
                     *rs)
        v = float(v)
        g = g.cpu().numpy() * scale
        if not np.isfinite(v):  # keep the line search inside the domain
            return 1e30, np.zeros_like(g)
        return v, g

    res = opt.minimize(fun, np.zeros_like(x0), jac=True, method=method,
                       options={"maxiter": maxiter})
    x = x0 + res.x * scale
    errs = None
    if uncertainty:
        H = hess_fn(torch.as_tensor(x, dtype=F64, device=dev), *rs)
        errs = np.sqrt(np.abs(np.diag(np.linalg.pinv(H.cpu().numpy()))))
    return NoiseFitResult(names, x, errs, -res.fun, res.success, res.message,
                          nit=res.nit, nfev=res.nfev)
