"""Chi2 over a parameter grid with a refit per point (port of
``pint_tpu/grid.py``: ``WrappedFitter`` and ``doonefit`` :75-106,
``_classify_linear_columns`` and ``_classified_columns_cached``
:109-216, the WLS ``build_grid_chi2_fn`` :219-376,
``build_grid_gls_chi2_fn`` :427-1051, ``_extraout`` :1054, ``grid_chisq``
:1183-1366 and the derived and tuple grids ``grid_chisq_derived``,
``tuple_chisq`` and ``tuple_chisq_derived`` :1490-1555).

Grid parameters are frozen per point and the remaining free parameters are
refit by ``niter`` Gauss-Newton steps.  Points go through in fixed-size
chunks on an explicit leading batch axis: every kernel sees the chunk as
its batch B.  Per step, only the design columns that are nonlinear in the
parameters are re-derived (``torch.func.jvp`` over one-hot tangents); the
constant columns are hoisted per grid.  ``grid_chisq`` dispatches on the
noise model, as the reference does (``grid.py:1251``):

* correlated noise (GLS): the Gram blocks of the constant columns and the
  noise block's factor are hoisted per grid, the marginalized timing
  system of each point is solved by kernel K3
  (:mod:`pint_torch.kernels.schur_cholesky_solve`), and the final chi2 is
  the Woodbury form with the overall offset marginalized, exactly as
  :class:`~pint_torch.residuals.Residuals` computes it.  A point whose
  solve fails is poisoned (NaN chi2, never a fabricated one); chunks
  holding such points re-run at escalated ridges, and only the failed
  points take the escalated values;
* white noise only (WLS): each step solves the whitened system with an
  explicit offset column by the normalized SVD least squares of kernel K5
  (:mod:`pint_torch.kernels.wls_lstsq`), the reference's ``lstsq``, and the
  chi2 is the weighted sum of squares.  A point whose singular values are
  not finite is poisoned (rung -1).
"""

from __future__ import annotations

import weakref
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import jvp, vmap

from pint_torch import F64
from pint_torch.kernels.schur_cholesky_solve import schur_cholesky_solve
from pint_torch.kernels.wls_lstsq import wls_lstsq
from pint_torch.runtime.solve import SVD_RUNG, hardened_cholesky
from pint_torch.utils import classify_linear_columns, linearity_probe_steps

__all__ = ["build_grid_chi2_fn", "build_grid_gls_chi2_fn", "grid_chisq",
           "grid_chisq_derived", "tuple_chisq", "tuple_chisq_derived",
           "WrappedFitter", "doonefit", "point_spans", "RIDGE", "ESCALATION"]

#: base ridge of the normalized Schur solve (the reference's CPU branch:
#: normalize by diag(A - Y^T Y), ridge 1e-12; H100 float64 is IEEE)
RIDGE = 1e-12
#: ridge multipliers of the chunk-level escalation ladder
ESCALATION = (1.0, 1e3, 1e6)


def _classify_linear_columns(jac_fn, free_init, nfit: int, ngrid: int,
                             grid_spans: Optional[Sequence[float]] = None):
    """(J0 (N, nfit), nonlinear column indices, probed grid spans): columns
    that stay put (rel < 1e-7) when every parameter moves by a ~1e-3-cycle
    phase step and the grid axes sweep their span are constant.
    Bit-indexed sign probes keep two parameters' effects from cancelling
    in every probe."""
    J0_full = jac_fn(free_init)
    J0 = J0_full[:, :nfit]
    J0_np = J0.cpu().numpy()
    dp = linearity_probe_steps(J0_full.cpu().numpy())
    dp[~np.isfinite(dp)] = 0.0
    fi = free_init[0].cpu().numpy()
    for gi in range(ngrid):
        gv = float(fi[nfit + gi])
        span = 0.0
        if grid_spans is not None and gi < len(grid_spans):
            span = float(grid_spans[gi])
        if span <= 0.0:
            span = max(abs(gv) * 0.1, dp[nfit + gi])
        dp[nfit + gi] = span
    n = len(dp)
    nbits = max(1, int(np.ceil(np.log2(max(n, 2)))))
    idx = np.arange(n)
    nl: set = set()
    probed = np.zeros(ngrid)
    for k in range(nbits + 1):
        s = np.where((idx >> k) & 1, -1.0, 1.0) if k < nbits else np.ones(n)
        dp_eff = dp * s
        for _ in range(4):
            v_pert = torch.as_tensor((fi + dp_eff)[None, :], dtype=F64,
                                     device=free_init.device)
            J1 = jac_fn(v_pert)[:, :nfit].cpu().numpy()
            if np.all(np.isfinite(J1)):
                break
            dp_eff = dp_eff / 8.0
        probed = np.maximum(probed, np.abs(dp_eff[nfit:nfit + ngrid]))
        nl |= set(classify_linear_columns(J0_np, J1).tolist())
    return J0, sorted(nl), probed


def _classified_columns_cached(model, batch, jac_fn, free_init, nfit, ngrid,
                               grid_spans, all_names):
    """Classification cached on the model: reused while the expansion point
    is unchanged and every grid axis stays within 2x the span it was
    classified at."""
    key = ("grid_classify", all_names, nfit)
    spans = tuple(float(s) for s in (grid_spans or ()))
    fi = free_init[0].cpu().numpy()
    cached = model._cache.get(key)
    if cached is not None and cached[4]() is not batch:
        cached = None
    if cached is not None:
        c_spans, c_fi, J0, nl_fit, _ = cached
        if (np.array_equal(c_fi, fi) and len(c_spans) == len(spans)
                and all(s <= 2.0 * cs for s, cs in zip(spans, c_spans))):
            return J0, nl_fit
        if len(c_spans) == len(spans):
            spans = tuple(max(s, cs) for s, cs in zip(spans, c_spans))
    J0, nl_fit, probed = _classify_linear_columns(
        jac_fn, free_init, nfit, ngrid, spans if spans else None)
    model._cache[key] = (tuple(float(p) for p in probed), fi, J0, nl_fit,
                         weakref.ref(batch))
    return J0, nl_fit


def _tri(L, b):
    """L^-1 b for lower-triangular L and b (..., n, m)."""
    return torch.linalg.solve_triangular(L, b, upper=False)


def _grid_bundle(model, batch, evaluate, jac_fn, all_names, nfit, ngrid,
                 grid_spans, F0):
    """The per-grid constants of the GLS grid (reference
    ``grid.py:540-633``): expansion point, white weights, the classified
    constant columns with their unit-W-norm scaling and Gram blocks, the
    noise block's factor and Y = L_D^-1 C^T, and the Woodbury chi2 factor
    with the offset marginalized."""
    dev = batch.device
    sigma = model.scaled_toa_uncertainty(batch)
    w = torch.as_tensor(1.0 / sigma**2, dtype=F64, device=dev)
    Us, ws, _ = model.noise_basis_by_component(batch)
    if not Us:
        raise ValueError("the model has no correlated noise: its grid is "
                         "the WLS one (build_grid_chi2_fn)")
    U = torch.as_tensor(np.hstack(Us), dtype=F64, device=dev)
    phi = torch.as_tensor(np.concatenate(ws), dtype=F64, device=dev)
    free_init = torch.tensor([[model.value(p) for p in all_names]],
                             dtype=F64, device=dev)
    int0 = evaluate(free_init)[0].int_
    # (1) constant (linear) design columns, classified numerically
    J0, nl_fit = _classified_columns_cached(
        model, batch, jac_fn, free_init, nfit, ngrid, grid_spans, all_names)
    # (2) noise-basis Gram and the Woodbury chi2 factor
    Uw = w[:, None] * U
    U_chi_np, phi_chi_np = model.augment_basis_for_offset(
        np.hstack(Us), np.concatenate(ws), n=batch.ntoas)
    U_chi = torch.as_tensor(U_chi_np, dtype=F64, device=dev)
    phi_chi = torch.as_tensor(phi_chi_np, dtype=F64, device=dev)
    Sigma_chi = torch.diag(1.0 / phi_chi) + U_chi.T @ (w[:, None] * U_chi)
    cf_chi, _, _ = hardened_cholesky(Sigma_chi,
                                     name="grid Woodbury chi2 Gram")
    # (3) Schur-complement constants with the unit-W-norm column scaling
    ones = torch.ones((batch.ntoas, 1), dtype=F64, device=dev)
    B_base = torch.cat([ones, -J0 / F0], dim=1)
    s_col = torch.sqrt((w[:, None] * B_base**2).sum(dim=0))
    s_col = torch.where(s_col > 0, s_col, 1.0)
    B_base = B_base / s_col
    A_base = B_base.T @ (w[:, None] * B_base)
    L_D, _, _ = hardened_cholesky(torch.diag(1.0 / phi) + U.T @ Uw,
                                  name="grid noise block")
    Y_base = _tri(L_D, (B_base.T @ Uw).T)
    return (free_init, int0, w, nl_fit, B_base, A_base, Y_base, Uw, L_D,
            s_col, U_chi, cf_chi)


def _setup(model, batch, grid_params, fit_params, chunk):
    """What both grid builders share: the validated chunk, the fit/grid
    split and the model's evaluation and Jacobian at (B, n) values."""
    if isinstance(chunk, bool) or not isinstance(chunk, (int, np.integer)) \
            or int(chunk) <= 0:
        raise ValueError(f"chunk must be a positive integer, got {chunk!r}")
    grid_params = tuple(grid_params)
    if fit_params is None:
        fit_params = tuple(p for p in model.free_params
                           if p not in grid_params)
    all_names = tuple(fit_params) + grid_params
    const_pv = model.const_pv()

    def evaluate(v):
        return model.evaluate(v, all_names, batch, const_pv)

    def jac_fn(v):
        return model.jac_frac(v, all_names, batch, const_pv)

    return int(chunk), grid_params, tuple(fit_params), all_names, evaluate, \
        jac_fn


def _cached_bundle(model, batch, slot_name, all_names, nfit, grid_spans,
                   build):
    """The hoisted per-grid constants: a pure function of the parameter
    values (mask selectors included), the batch and the fit/grid split,
    so one cached slot serves repeated grids at unchanged values."""
    vkey = (tuple((n, str(p.value), p.key, tuple(p.key_value))
                  for n, p in model.params_table.items()
                  if p.component != "TimingModel"),
            all_names, nfit, None if grid_spans is None
            else tuple(float(s) for s in grid_spans))
    slot = model._cache.get(slot_name)
    if slot is not None and slot[0] == vkey and slot[1]() is batch:
        return slot[2]
    bundle = build()
    model._cache[slot_name] = (vkey, weakref.ref(batch), bundle)
    return bundle


def _resid_seconds_fn(evaluate, int0, w, F0):
    """Residuals [s] at (B, n) values, pulse numbers tracked from ``int0``
    and the weighted mean subtracted (the Offset)."""
    def resid_seconds(v):
        ph, _ = evaluate(v)
        r = (ph.int_ - int0) + ph.frac
        r = r - (r * w).sum(dim=-1, keepdim=True) / w.sum()
        return r / F0

    return resid_seconds


def _nonlinear_columns_fn(evaluate, nl_idx):
    """d frac / d v[:, nl] per point: (B, N, k), by ``jvp`` over one-hot
    tangents."""
    k = len(nl_idx)

    def nonlinear_columns(v):
        basis = torch.zeros((k,) + tuple(v.shape), dtype=F64, device=v.device)
        basis[torch.arange(k, device=v.device), :, nl_idx] = 1.0

        def one(t):
            return jvp(lambda x: evaluate(x)[0].frac, (v,), (t,))[1]

        return vmap(one)(basis).permute(1, 2, 0)

    return nonlinear_columns


def _blocks(points, chunk, dev):
    """``[(block, kept rows)]``: ``points`` in chunks of ``chunk`` rows,
    the last padded with copies of its last point."""
    points = torch.as_tensor(np.asarray(points), dtype=F64, device=dev)
    blocks = []
    for i in range(0, points.shape[0], chunk):
        blk = points[i:i + chunk]
        keep = blk.shape[0]
        if keep < chunk:
            blk = torch.cat([blk, blk[-1:].expand(chunk - keep,
                                                  blk.shape[1])])
        blocks.append((blk, keep))
    return blocks


def _wls_bundle(model, batch, evaluate, jac_fn, all_names, nfit, ngrid,
                grid_spans, F0):
    """The per-grid constants of the WLS grid (reference
    ``grid.py:245-270``): expansion point, reference pulse numbers,
    sqrt(w), the classified constant columns, whitened ((B, N, 1 + nfit)
    with the offset column first)."""
    dev = batch.device
    sigma = model.scaled_toa_uncertainty(batch)
    w = torch.as_tensor(1.0 / sigma**2, dtype=F64, device=dev)
    sw = torch.sqrt(w)
    free_init = torch.tensor([[model.value(p) for p in all_names]],
                             dtype=F64, device=dev)
    int0 = evaluate(free_init)[0].int_
    J0, nl_fit = _classified_columns_cached(
        model, batch, jac_fn, free_init, nfit, ngrid, grid_spans, all_names)
    Aw_base = torch.cat([sw[:, None], (-J0 / F0) * sw[:, None]], dim=1)
    return free_init, int0, w, sw, nl_fit, Aw_base


def build_grid_chi2_fn(model, batch, grid_params: Sequence[str],
                       fit_params: Optional[Sequence[str]] = None,
                       niter: int = 4, chunk: int = 256,
                       grid_spans: Optional[Sequence[float]] = None):
    """Return ``(fn, free_init, fit_params)`` where ``fn(points (P, G))``
    gives ``(chi2 (P,), vfit (P, nfit), diag (P, 3))``; diag columns are
    (ladder rung, ridge applied, condition estimate) per point.

    A model with correlated noise takes the GLS grid
    (:func:`build_grid_gls_chi2_fn`), as the reference dispatches.  Without
    it each point runs ``niter`` whitened Gauss-Newton steps with an
    explicit offset column, each solved by kernel K5's normalized SVD
    least squares (reference ``grid.py:219-376``); its rung is
    ``SVD_RUNG``, or -1 where a step's singular values were not finite,
    its ridge 0 and its condition estimate the largest s_max / s_min of
    its steps."""
    if model.noise_basis_by_component(batch)[0]:
        return build_grid_gls_chi2_fn(model, batch, grid_params,
                                      fit_params=fit_params, niter=niter,
                                      chunk=chunk, grid_spans=grid_spans)
    chunk, grid_params, fit_params, all_names, evaluate, jac_fn = _setup(
        model, batch, grid_params, fit_params, chunk)
    dev = batch.device
    nfit = len(fit_params)
    F0 = model.value("F0")
    free_init, int0, w, sw, nl_fit, Aw_base = _cached_bundle(
        model, batch, "grid_wls_bundle", all_names, nfit, grid_spans,
        lambda: _wls_bundle(model, batch, evaluate, jac_fn, all_names, nfit,
                            len(grid_params), grid_spans, F0))
    nl_idx = torch.as_tensor(nl_fit, dtype=torch.long, device=dev)
    resid_seconds = _resid_seconds_fn(evaluate, int0, w, F0)
    nonlinear_columns = _nonlinear_columns_fn(evaluate, nl_idx)

    def chunk_fn(gvals):
        Bp = gvals.shape[0]
        v = torch.cat([free_init[:, :nfit].expand(Bp, nfit), gvals], dim=1)
        failed = torch.zeros(Bp, dtype=torch.bool, device=dev)
        cond = torch.full((Bp,), -torch.inf, dtype=F64, device=dev)
        for _ in range(niter):
            rw = resid_seconds(v) * sw
            Aw = Aw_base.expand(Bp, *Aw_base.shape)
            if len(nl_fit):
                Aw = Aw.clone()
                Aw[:, :, nl_idx + 1] = (-nonlinear_columns(v) / F0) \
                    * sw[:, None]
            x, sv, norms = wls_lstsq(Aw, rw)
            ok = torch.isfinite(sv).all(dim=1)
            cnd = sv.amax(dim=1) / torch.clamp(sv.amin(dim=1), min=1e-300)
            v = torch.cat([v[:, :nfit] + x[:, 1:] / norms[:, 1:],
                           v[:, nfit:]], dim=1)
            failed = failed | ~ok
            cond = torch.maximum(cond, torch.where(ok, cnd, torch.nan))
        r = resid_seconds(v)
        chi2 = (w * r * r).sum(dim=-1)
        rung = torch.where(failed, -1.0, float(SVD_RUNG))
        return torch.stack([chi2, rung, torch.zeros_like(chi2), cond],
                           dim=1), v[:, :nfit]

    def fn(points):
        outs = []
        for blk, keep in _blocks(points, chunk, dev):
            d, vf = chunk_fn(blk)
            outs.append((d[:keep].cpu().numpy(), vf[:keep].cpu().numpy()))
        d = np.concatenate([o[0] for o in outs])
        return d[:, 0], np.concatenate([o[1] for o in outs]), d[:, 1:]

    fn.nonlinear_columns = tuple(nl_fit)
    return fn, free_init, fit_params


def build_grid_gls_chi2_fn(model, batch, grid_params: Sequence[str],
                           fit_params: Optional[Sequence[str]] = None,
                           niter: int = 4, chunk: int = 256,
                           grid_spans: Optional[Sequence[float]] = None):
    """Return ``(fn, free_init, fit_params)`` where ``fn(points (P, G))``
    gives ``(chi2 (P,), vfit (P, nfit), diag (P, 3))``; diag columns are
    (ladder rung, ridge applied, condition estimate) per point."""
    chunk, grid_params, fit_params, all_names, evaluate, jac_fn = _setup(
        model, batch, grid_params, fit_params, chunk)
    dev = batch.device
    nfit = len(fit_params)
    nt = 1 + nfit
    F0 = model.value("F0")
    (free_init, int0, w, nl_fit, B_base, A_base, Y_base, Uw, L_D, s_col,
     U_chi, cf_chi) = _cached_bundle(
        model, batch, "grid_gls_bundle", all_names, nfit, grid_spans,
        lambda: _grid_bundle(model, batch, evaluate, jac_fn, all_names, nfit,
                             len(grid_params), grid_spans, F0))
    nl_idx = torch.as_tensor(nl_fit, dtype=torch.long, device=dev)
    nlp_idx = nl_idx + 1
    k = len(nl_fit)
    resid_seconds = _resid_seconds_fn(evaluate, int0, w, F0)
    nonlinear_columns = _nonlinear_columns_fn(evaluate, nl_idx)

    def chunk_fn(gvals, ridge_scale: float):
        Bp = gvals.shape[0]
        v = torch.cat([free_init[:, :nfit].expand(Bp, nfit), gvals], dim=1)
        solved = torch.ones(Bp, dtype=torch.bool, device=dev)
        cond = torch.full((Bp,), -torch.inf, dtype=F64, device=dev)
        for _ in range(niter):
            r = resid_seconds(v)
            wr = w * r
            if k:
                M_nl = (-nonlinear_columns(v) / F0) / s_col[nlp_idx]
                wM = w[:, None] * M_nl
                A_cols = B_base.T @ wM                        # (B, nt, k)
                A_cols[:, nlp_idx, :] = M_nl.transpose(1, 2) @ wM
                A = A_base.expand(Bp, nt, nt).clone()
                A[:, :, nlp_idx] = A_cols
                A[:, nlp_idx, :] = A_cols.transpose(1, 2)
                C_rows = M_nl.transpose(1, 2) @ Uw            # (B, k, nu)
                Y = Y_base.expand(Bp, *Y_base.shape).clone()
                Y[:, :, nlp_idx] = _tri(L_D, C_rows.transpose(1, 2))
                b_t = wr @ B_base
                b_t[:, nlp_idx] = (M_nl.transpose(1, 2) @ wr[:, :, None])[..., 0]
            else:
                A = A_base.expand(Bp, nt, nt)
                Y = Y_base.expand(Bp, *Y_base.shape)
                b_t = wr @ B_base
            b_u = r @ Uw
            z_u = _tri(L_D, b_u.T).T
            Ar = A - Y.transpose(1, 2) @ Y
            rhs = b_t - (Y.transpose(1, 2) @ z_u[:, :, None])[..., 0]
            x, ok, cnd = schur_cholesky_solve(Ar, rhs, RIDGE * ridge_scale)
            v = torch.cat([v[:, :nfit] + (x / s_col)[:, 1:nt], v[:, nfit:]],
                          dim=1)
            solved = solved & ok
            cond = torch.maximum(cond, cnd)
        r = resid_seconds(v)
        wr = w * r
        z = _tri(cf_chi, (wr @ U_chi).T)                      # (nu+1, B)
        chi2 = (r * wr).sum(dim=-1) - (z * z).sum(dim=0)
        return chi2, v[:, :nfit], solved, cond

    def fn(points):
        blocks = _blocks(points, chunk, dev)
        first = [chunk_fn(blk, 1.0) for blk, _ in blocks]
        out_c, out_v, out_d = [], [], []
        for (blk, keep), res in zip(blocks, first):
            c2, vf, dg = _escalate(blk, keep, res)
            out_c.append(c2)
            out_v.append(vf)
            out_d.append(dg)
        return (np.concatenate(out_c), np.concatenate(out_v),
                np.concatenate(out_d))

    def _escalate(blk, keep, res):
        """Re-run a chunk holding unsolved points at escalated ridges; only
        the failed points take the escalated values."""
        c2, vf, ok, cnd = (t[:keep].cpu().numpy() for t in res)
        c2, vf, cond = c2.copy(), vf.copy(), cnd.copy()
        solved = ok.copy()
        rung = np.where(solved, 0, -1)
        for ri in range(1, len(ESCALATION)):
            if solved.all():
                break
            c2e, vfe, oke, cde = (t[:keep].cpu().numpy()
                                  for t in chunk_fn(blk, ESCALATION[ri]))
            newly = ~solved & oke
            c2[newly] = c2e[newly]
            vf[newly] = vfe[newly]
            cond[newly] = cde[newly]
            rung[newly] = ri
            solved |= newly
        ridge = np.where(rung >= 0, RIDGE * np.take(np.asarray(ESCALATION),
                                                    np.maximum(rung, 0)),
                         np.nan)
        return c2, vf, np.stack([rung.astype(np.float64), ridge, cond], axis=1)

    fn.nonlinear_columns = tuple(nl_fit)
    return fn, free_init, tuple(fit_params)


def point_spans(model, parnames, pts) -> list:
    """Classification spans: the farthest each parameter's points sit from
    the model's current value."""
    spans = []
    for j, p in enumerate(parnames):
        cur = model.value(p)
        col = np.asarray(pts)[:, j]
        spans.append(float(np.max(np.abs(col - cur))) if len(col) else 0.0)
    return spans


class WrappedFitter:
    """A fitter that freezes chosen parameters at given values before it
    fits (reference ``grid.py:75``): one-off frozen fits; the batched grid
    (:func:`grid_chisq`) serves bulk grids."""

    def __init__(self, ftr, **fitargs):
        self.ftr = ftr
        self.fitargs = fitargs

    def doonefit(self, parnames: Sequence[str], parvalues: Sequence[float],
                 extraparnames: Sequence[str] = ()) -> Tuple[float, list]:
        """Fit with ``parnames`` frozen at ``parvalues``: (chi2, the
        values of ``extraparnames``)."""
        model = self.ftr.model.copy()
        for name, value in zip(parnames, parvalues):
            model[name].value = float(value)
            model[name].frozen = True
        f = type(self.ftr)(self.ftr.batch, model)
        chi2 = float(f.fit_toas(**self.fitargs))
        return chi2, [f.model[n].value for n in extraparnames]


def doonefit(ftr, parnames: Sequence[str], parvalues: Sequence[float],
             extraparnames: Sequence[str] = (),
             **fitargs) -> Tuple[float, list]:
    """One frozen-parameter fit (reference ``grid.py:101``)."""
    return WrappedFitter(ftr, **fitargs).doonefit(parnames, parvalues,
                                                  extraparnames)


def _extraout(extraparnames, fit_params, grid_params, vfit, pts, model,
              shape=None) -> dict:
    """Each point's value of ``extraparnames`` (reference
    ``grid.py:1054``): a refit parameter's from the point's Gauss-Newton
    state, a grid parameter's from the point, any other the model's."""
    out = {}
    fit_params, grid_params = list(fit_params), list(grid_params)
    pts = np.asarray(pts)
    for name in extraparnames:
        if name in fit_params:
            col = vfit[:, fit_params.index(name)]
        elif name in grid_params:
            col = pts[:, grid_params.index(name)]
        else:
            col = np.full(len(pts), model.value(name))
        out[name] = col.reshape(shape) if shape is not None else col
    return out


def _attach_grid_diagnostics(ftr, diag, nonlinear_columns, shape=None):
    """The per-point solve diagnostics on ``ftr.last_grid_diagnostics``:
    ``ladder_rung`` (-1 a poisoned point), ``ridge`` and ``condition``,
    shaped as the grid, and the nonlinear columns."""
    out = {"ladder_rung": diag[:, 0].astype(int), "ridge": diag[:, 1],
           "condition": diag[:, 2]}
    if shape is not None:
        out = {k: v.reshape(shape) for k, v in out.items()}
    out["nonlinear_columns"] = nonlinear_columns
    ftr.last_grid_diagnostics = out
    return out


def _points_chisq(ftr, parnames, pts, niter, chunk):
    """(chi2, vfit, diag, fit_params, fn) at the points ``pts`` (P, G) of
    ``parnames``, by the GLS or the WLS grid, the classification spanning
    the actual points."""
    model, batch = ftr.model, ftr.batch
    fn, _, fit_params = build_grid_chi2_fn(
        model, batch, tuple(parnames), niter=niter, chunk=chunk,
        grid_spans=point_spans(model, tuple(parnames), pts))
    chi2, vfit, diag = fn(pts)
    return chi2, vfit, diag, fit_params, fn


def grid_chisq(ftr, parnames: Sequence[str], parvalues: Sequence,
               extraparnames: Sequence[str] = (), niter: int = 4,
               chunk: int = 256) -> Tuple[np.ndarray, dict]:
    """Chi2 over the outer-product grid of ``parvalues``, by the GLS grid
    where the model has correlated noise and the WLS grid otherwise
    (:func:`build_grid_chi2_fn`); returns the chi2 array (grid-shaped) and
    ``{name: grid-shaped values}`` for ``extraparnames``.  Per-point solve
    diagnostics land on ``ftr.last_grid_diagnostics``."""
    parnames = tuple(parnames)
    grids = [np.asarray(v, dtype=np.float64) for v in parvalues]
    shape = tuple(len(g) for g in grids)
    pts = np.stack([g.ravel() for g in np.meshgrid(*grids, indexing="ij")],
                   axis=-1)
    chi2, vfit, diag, fit_params, fn = _points_chisq(ftr, parnames, pts,
                                                     niter, chunk)
    _attach_grid_diagnostics(ftr, diag, fn.nonlinear_columns, shape)
    return chi2.reshape(shape), _extraout(extraparnames, fit_params,
                                          parnames, vfit, pts, ftr.model,
                                          shape)


def grid_chisq_derived(ftr, parnames: Sequence[str], parfuncs: Sequence,
                       gridvalues: Sequence,
                       extraparnames: Sequence[str] = (), niter: int = 4,
                       chunk: int = 256):
    """Chi2 over the outer-product grid of ``gridvalues`` in derived
    quantities: model parameter i is ``parfuncs[i](*point)`` (reference
    ``grid.py:1490``).  Returns (chi2, the grid's mesh arrays, extra
    parameter values), grid-shaped."""
    parnames = tuple(parnames)
    grids = [np.asarray(v, dtype=np.float64) for v in gridvalues]
    shape = tuple(len(g) for g in grids)
    mesh = np.meshgrid(*grids, indexing="ij")
    flat = [g.ravel() for g in mesh]
    pts = np.stack([np.asarray([f(*vals) for vals in zip(*flat)],
                               dtype=np.float64) for f in parfuncs], axis=-1)
    chi2, vfit, diag, fit_params, fn = _points_chisq(ftr, parnames, pts,
                                                     niter, chunk)
    _attach_grid_diagnostics(ftr, diag, fn.nonlinear_columns, shape)
    return (chi2.reshape(shape), [g.reshape(shape) for g in mesh],
            _extraout(extraparnames, fit_params, parnames, vfit, pts,
                      ftr.model, shape))


def tuple_chisq(ftr, parnames: Sequence[str], parvalues: Sequence,
                extraparnames: Sequence[str] = (), niter: int = 4,
                chunk: int = 256):
    """Chi2 at a list of parameter tuples, any number of them (reference
    ``grid.py:1517``): (chi2 (P,), extra parameter values)."""
    parnames = tuple(parnames)
    pts = np.asarray(parvalues, dtype=np.float64)
    chi2, vfit, diag, fit_params, fn = _points_chisq(ftr, parnames, pts,
                                                     niter, chunk)
    _attach_grid_diagnostics(ftr, diag, fn.nonlinear_columns)
    return chi2, _extraout(extraparnames, fit_params, parnames, vfit, pts,
                           ftr.model)


def tuple_chisq_derived(ftr, parnames: Sequence[str], parfuncs: Sequence,
                        parvalues: Sequence,
                        extraparnames: Sequence[str] = (), niter: int = 4,
                        chunk: int = 256):
    """Chi2 at tuples of derived quantities: model parameter i is
    ``parfuncs[i](*point)`` (reference ``grid.py:1535``).  Returns (chi2,
    each derived quantity's values, extra parameter values)."""
    parnames = tuple(parnames)
    raw = np.asarray(parvalues, dtype=np.float64)
    pts = np.stack([np.asarray([f(*vals) for vals in raw], dtype=np.float64)
                    for f in parfuncs], axis=-1)
    chi2, vfit, diag, fit_params, fn = _points_chisq(ftr, parnames, pts,
                                                     niter, chunk)
    _attach_grid_diagnostics(ftr, diag, fn.nonlinear_columns)
    return (chi2, [raw[:, i] for i in range(raw.shape[1])],
            _extraout(extraparnames, fit_params, parnames, vfit, pts,
                      ftr.model))
