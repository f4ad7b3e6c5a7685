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

``grid_chisq`` takes the reference's whole signature.  ``fuse=K`` on the
GLS grid retires K chunks a dispatch: on the card one CUDA graph, captured
once per (grid bundle, chunk, ``niter``, K) and replayed; on the CPU the
group's chunks run one after another.  ``checkpoint=`` runs the sweep
through :func:`pint_torch.runtime.checkpoint.checkpointed_map` (chunks
persisted, retried under ``retry`` and resumed bitwise).  The GLS grid's
per-point products are the ``grid.gram`` precision segment and its
Woodbury chi2 correction the ``grid.correction`` one
(:mod:`pint_torch.precision`; float64 and bit-identical by default), and
``chunk="auto"`` resolves through the tuning manifest
(:func:`pint_torch.autotune.resolve_grid_chunk`).  Meshes and execution
plans are ROADMAP queue A item 9.
"""

from __future__ import annotations

import gc

import weakref
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import jvp, vmap

from pint_torch import F64
from pint_torch import config as _config
from pint_torch.exceptions import UsageError
from pint_torch.kernels.schur_cholesky_solve import schur_cholesky_solve
from pint_torch.kernels.wls_lstsq import wls_lstsq
from pint_torch.logging import log
from pint_torch.precision import SegmentSpec, downcast
from pint_torch.precision import matmul as _pm
from pint_torch.runtime.solve import SVD_RUNG, hardened_cholesky
from pint_torch.utils import classify_linear_columns, linearity_probe_steps

__all__ = ["build_grid_chi2_fn", "build_grid_gls_chi2_fn", "grid_chisq",
           "grid_chisq_derived", "tuple_chisq", "tuple_chisq_derived",
           "WrappedFitter", "doonefit", "point_spans", "default_gls_chunk",
           "RIDGE", "ESCALATION"]

#: base ridge of the normalized Schur solve (the reference's CPU branch:
#: normalize by diag(A - Y^T Y), ridge 1e-12; H100 float64 is IEEE)
RIDGE = 1e-12
#: ridge multipliers of the chunk-level escalation ladder
ESCALATION = (1.0, 1e3, 1e6)
#: the static GLS chunk by device type: 256 on the card (every chip run of
#: the port used it), the reference's 128 on the CPU; a point's result does
#: not depend on the chunk
_STATIC_CHUNK = {"cuda": 256, "cpu": 128}
#: the WLS grid's chunk when none is given
_WLS_CHUNK = 256
_warned_executor = False


def default_gls_chunk(device=None) -> int:
    """The GLS grid's chunk on ``device`` (default: the card where one is
    visible, else the CPU): the process override
    (:func:`pint_torch.config.set_grid_chunk` / ``PINT_TORCH_GRID_CHUNK``,
    a typed :class:`UsageError` when malformed) wins, else
    :data:`_STATIC_CHUNK`."""
    override = _config.grid_chunk()
    if override is not None:
        return int(override)
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return _STATIC_CHUNK.get(torch.device(device).type, _STATIC_CHUNK["cpu"])


def _resolve_auto_chunk(model, batch, chunk, gls: bool = True):
    """The ``chunk`` string contract: ``"auto"`` resolves the tuning
    manifest's decision (:func:`pint_torch.autotune.resolve_grid_chunk`;
    the static default, logged, on any miss) and is ``None`` on the WLS
    grid, any other string a :class:`UsageError`; anything else passes
    through."""
    if not isinstance(chunk, str):
        return chunk
    if chunk != "auto":
        raise UsageError(
            f"chunk={chunk!r}: pass a positive integer, 'auto', or "
            "None for the static default")
    if not gls:
        return None
    from pint_torch import autotune

    resolved = autotune.resolve_grid_chunk(model, batch)
    log.info(f"grid chunk 'auto': {resolved} (the tuning manifest's "
             "decision where it holds one for this workload, else the "
             f"static default {default_gls_chunk(batch.device)})")
    return resolved


def _value_str(par) -> str:
    """``str`` of a parameter's value as the reference holds it: an epoch's
    (hi, lo) pair as the long double it was read as, a pair parameter as a
    list, an integer parameter as an int."""
    v = par.value
    if v is None:
        return "None"
    if par.kind == "mjd":
        return str(np.longdouble(v[0]) + np.longdouble(v[1]))
    if par.kind == "pair":
        return str(list(v))
    if par.kind == "int":
        return str(int(v))
    return str(v)


def _model_param_sig(model) -> tuple:
    """Value signature of every component parameter, mask selectors
    included (reference ``grid.py:45-58``), each value spelled as the
    reference's ``str``: the run identity a checkpoint fingerprint hashes
    and the tuning manifest's model-bound vkeys carry.  Mask parameters
    (EFAC/ECORR/JUMP selectors) contribute their key/key_value because
    editing a selector's range changes weights and noise bases at an
    unchanged parameter value."""
    def sig(par, name):
        s = (name, _value_str(par))
        if par.kind == "mask" or par.key is not None:
            s += (str(par.key), tuple(str(v) for v in par.key_value))
        return s

    return tuple(sig(model.params_table[p], p)
                 for c in model.components.values() for p in c.params)


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
    noise block's factor and Y = L_D^-1 C^T, the Woodbury chi2 factor
    with the offset marginalized, and an empty dict for the fused sweep's
    CUDA graphs, which live and die with the bundle."""
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
            s_col, U_chi, cf_chi, {})


def _setup(model, batch, grid_params, fit_params, chunk, gls: bool):
    """What both grid builders share: the validated chunk (``None`` the
    static default, ``"auto"`` resolved), the fit/grid split and the
    model's evaluation and Jacobian at (B, n) values."""
    chunk = _resolve_auto_chunk(model, batch, chunk, gls)
    if chunk is None:
        chunk = default_gls_chunk(batch.device) if gls else _WLS_CHUNK
    if isinstance(chunk, bool) or not isinstance(chunk, (int, np.integer)) \
            or int(chunk) <= 0:
        raise UsageError(
            f"chunk must be a positive integer or 'auto', got {chunk!r}")
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


def _nonlinear_columns_fn(evaluate, nl_idx, n: int):
    """d frac / d v[:, nl] per point: (B, N, k), by ``jvp`` over one-hot
    tangents.  The one-hot rows are built once, so an evaluation issues
    no indexing with host values (it may be captured in a CUDA graph)."""
    onehot = torch.eye(n, dtype=F64, device=nl_idx.device)[nl_idx]

    def nonlinear_columns(v):
        basis = onehot[:, None, :].expand(len(onehot), *v.shape)

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
                       niter: int = 4,
                       grid_spans: Optional[Sequence[float]] = None,
                       chunk=None):
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
    its steps.  ``chunk`` (points a batch; ``None`` 256) does not change
    a point's result."""
    if model.noise_basis_by_component(batch)[0]:
        return build_grid_gls_chi2_fn(model, batch, grid_params,
                                      fit_params=fit_params, niter=niter,
                                      chunk=chunk, grid_spans=grid_spans)
    chunk, grid_params, fit_params, all_names, evaluate, jac_fn = _setup(
        model, batch, grid_params, fit_params, chunk, gls=False)
    dev = batch.device
    nfit = len(fit_params)
    F0 = model.value("F0")
    free_init, int0, w, sw, nl_fit, Aw_base = _cached_bundle(
        model, batch, "grid_wls_bundle", all_names, nfit, grid_spans,
        lambda: _wls_bundle(model, batch, evaluate, jac_fn, all_names, nfit,
                            len(grid_params), grid_spans, F0))
    nl_idx = torch.as_tensor(nl_fit, dtype=torch.long, device=dev)
    resid_seconds = _resid_seconds_fn(evaluate, int0, w, F0)
    nonlinear_columns = _nonlinear_columns_fn(evaluate, nl_idx,
                                              len(all_names))

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


def build_grid_gls_chi2_fn(model, toas, grid_params: Sequence[str],
                           fit_params: Optional[Sequence[str]] = None,
                           niter: int = 4, chunk=None,
                           grid_spans: Optional[Sequence[float]] = None,
                           correction_dtype: Optional[str] = None,
                           precision=None):
    """Return ``(fn, free_init, fit_params)`` where ``fn(points (P, G))``
    gives ``(chi2 (P,), vfit (P, nfit), diag (P, 3))``; diag columns are
    (ladder rung, ridge applied, condition estimate) per point.  ``toas``
    is the :class:`~pint_torch.toa.TOABatch`.  ``chunk`` is the points a
    batch (``None``: :func:`default_gls_chunk`; ``"auto"`` the tuning
    manifest's decision, else the same).

    ``correction_dtype`` (``"float64"`` | ``"float32"``) is the precision
    of the Woodbury chi2 correction: ``None`` takes the precision
    override's ``grid.correction`` segment, else the tuning manifest's
    decision, which keeps float64 unless recorded for exactly this system.
    Under float32 the correction's operands are cast once a build (the
    cached bundle stays float64), the triangular solve runs in float32 and
    ``z.z`` comes back as float64.  ``precision`` is the ``grid.gram``
    segment's :class:`~pint_torch.precision.SegmentSpec` (``None``: the
    active one): the per-point design and Gram products run through
    :func:`pint_torch.precision.matmul`, a float64 spec being the plain
    products bit for bit.

    ``fn.fused(points, fuse=8)`` gives the same surface retiring ``fuse``
    chunks a dispatch (reference ``grid.py:919-974``); the last group is
    padded by repeating its final block.  On the card each group is one
    replay of a CUDA graph of ``fuse`` chunk evaluations, captured at the
    first call after an eager warm-up chunk on a side stream and kept in
    the cached grid bundle (a new bundle drops it); a capture that fails
    raises.  Each captured graph, one a (niter, chunk, correction dtype,
    ``grid.gram`` precision key, fuse), keeps its private
    memory pool (its intermediates: reserved device memory, not counted
    by ``max_memory_allocated``) for as long as the bundle lives, so
    sweeps at several ``fuse`` widths hold a pool each until the
    parameter values change.  On the CPU the group's chunks run one
    after another.  Chunks holding unsolved points then re-run eagerly
    at escalated ridges, as in ``fn``.  ``fn.dispatch_count()`` counts the last call's dispatches
    as the reference does: each eager chunk, each escalation re-run and
    each fused group once.  ``fn.graph_stats()`` gives, per captured
    graph, its replays and the kernel launches it captured (the wrappers
    count a launch when it is captured, not when it is replayed)."""
    from pint_torch import precision as _precision

    batch = toas
    chunk, grid_params, fit_params, all_names, evaluate, jac_fn = _setup(
        model, batch, grid_params, fit_params, chunk, gls=True)
    if correction_dtype is None:
        corr_override = _precision.override_spec("grid.correction")
        if corr_override is not None:
            correction_dtype = "float32" if corr_override.reduced \
                else "float64"
        else:
            from pint_torch import autotune

            correction_dtype = autotune.resolve_correction_dtype(model,
                                                                 batch)
    if correction_dtype not in ("float64", "float32"):
        raise UsageError(
            f"correction_dtype must be 'float64' or 'float32', got "
            f"{correction_dtype!r}")
    if precision is None:
        precision = _precision.segment_spec("grid.gram", model=model,
                                            toas=batch)
    elif not isinstance(precision, SegmentSpec):
        raise UsageError(
            f"precision must be a SegmentSpec or None, got "
            f"{type(precision).__name__}")
    gspec = precision if precision.reduced else None
    dev = batch.device
    nfit = len(fit_params)
    nt = 1 + nfit
    F0 = model.value("F0")
    (free_init, int0, w, nl_fit, B_base, A_base, Y_base, Uw, L_D, s_col,
     U_chi, cf_chi, graphs) = _cached_bundle(
        model, batch, "grid_gls_bundle", all_names, nfit, grid_spans,
        lambda: _grid_bundle(model, batch, evaluate, jac_fn, all_names, nfit,
                             len(grid_params), grid_spans, F0))
    f32_corr = correction_dtype == "float32"
    if f32_corr:
        U_chi = downcast(U_chi, "float32")
        cf_chi = downcast(cf_chi, "float32")
    nl_idx = torch.as_tensor(nl_fit, dtype=torch.long, device=dev)
    nlp_idx = nl_idx + 1
    k = len(nl_fit)
    resid_seconds = _resid_seconds_fn(evaluate, int0, w, F0)
    nonlinear_columns = _nonlinear_columns_fn(evaluate, nl_idx,
                                              len(all_names))

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
                A_cols = _pm(B_base.T, wM, gspec)             # (B, nt, k)
                A_cols[:, nlp_idx, :] = _pm(M_nl.transpose(1, 2), wM, gspec)
                A = A_base.expand(Bp, nt, nt).clone()
                A[:, :, nlp_idx] = A_cols
                A[:, nlp_idx, :] = A_cols.transpose(1, 2)
                C_rows = _pm(M_nl.transpose(1, 2), Uw, gspec)  # (B, k, nu)
                Y = Y_base.expand(Bp, *Y_base.shape).clone()
                Y[:, :, nlp_idx] = _tri(L_D, C_rows.transpose(1, 2))
                b_t = _pm(wr, B_base, gspec)
                b_t[:, nlp_idx] = _pm(M_nl.transpose(1, 2), wr[:, :, None],
                                      gspec)[..., 0]
            else:
                A = A_base.expand(Bp, nt, nt)
                Y = Y_base.expand(Bp, *Y_base.shape)
                b_t = _pm(wr, B_base, gspec)
            b_u = _pm(r, Uw, gspec)
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
        if f32_corr:
            z = _tri(cf_chi, (downcast(wr, "float32") @ U_chi).T)
            corr = (z * z).sum(dim=0).to(F64)
        else:
            z = _tri(cf_chi, (wr @ U_chi).T)                  # (nu+1, B)
            corr = (z * z).sum(dim=0)
        chi2 = (r * wr).sum(dim=-1) - corr
        return chi2, v[:, :nfit], solved, cond

    dispatches = [0]

    def _eval_chunk(blk, scale):
        dispatches[0] += 1
        return chunk_fn(blk, scale)

    def _host(res, keep):
        return tuple(t[:keep].cpu().numpy() for t in res)

    def fn(points):
        dispatches[0] = 0
        blocks = _blocks(points, chunk, dev)
        first = [_eval_chunk(blk, 1.0) for blk, _ in blocks]
        return _stitch([_escalate(blk, keep, _host(res, keep))
                        for (blk, keep), res in zip(blocks, first)])

    def _escalate(blk, keep, res):
        """Re-run a chunk holding unsolved points at escalated ridges; only
        the failed points take the escalated values.  ``res`` is the
        chunk's first pass on the host, cut to its ``keep`` rows."""
        c2, vf, ok, cnd = (np.array(a) for a in res)
        cond, solved = cnd, ok
        rung = np.where(solved, 0, -1)
        for ri in range(1, len(ESCALATION)):
            if solved.all():
                break
            c2e, vfe, oke, cde = _host(_eval_chunk(blk, ESCALATION[ri]), keep)
            newly = ~solved & oke
            c2[newly] = c2e[newly]
            vf[newly] = vfe[newly]
            cond[newly] = cde[newly]
            rung[newly] = ri
            solved |= newly
        if not solved.all():
            log.warning(
                f"grid GLS solve: {int((~solved).sum())} point(s) "
                "unsolved at every escalation ridge -- their chi2 is "
                "NaN (rung -1), not fabricated")
        ridge = np.where(rung >= 0, RIDGE * np.take(np.asarray(ESCALATION),
                                                    np.maximum(rung, 0)),
                         np.nan)
        return c2, vf, np.stack([rung.astype(np.float64), ridge, cond], axis=1)

    def _graph(fuse, first):
        """The CUDA graph of ``fuse`` chunk evaluations, captured once and
        kept in the bundle's slot; ``first`` (fuse, chunk, G) seeds its
        static input for the warm-up."""
        key = (niter, chunk, correction_dtype, precision.key(), fuse)
        g = graphs.get(key)
        if g is None:
            g = _FusedGraph(chunk_fn, first, fuse)
            graphs[key] = g
        return g

    def fused(points, fuse: int = 8):
        dispatches[0] = 0
        fuse = max(1, int(fuse))
        blocks = _blocks(points, chunk, dev)
        out = []
        for lo in range(0, len(blocks), fuse):
            group = blocks[lo:lo + fuse]
            dispatches[0] += 1
            if dev.type == "cuda":
                blks = [b for b, _ in group]
                blks += [blks[-1]] * (fuse - len(blks))
                stacked = torch.stack(blks)
                res = _graph(fuse, stacked).run(stacked)
            else:
                res = [tuple(t.numpy() for t in chunk_fn(b, 1.0))
                       for b, _ in group]
            out += [_escalate(blk, keep, tuple(a[:keep] for a in r))
                    for (blk, keep), r in zip(group, res)]
        return _stitch(out)

    fn.nonlinear_columns = tuple(nl_fit)
    fn.fused = fused
    fn.dispatch_count = lambda: dispatches[0]
    fn.graph_stats = lambda: {
        key[-1]: g.stats() for key, g in graphs.items()
        if key[:-1] == (niter, chunk, correction_dtype, precision.key())}
    return fn, free_init, tuple(fit_params)


def _stitch(parts):
    """Concatenate per-chunk (chi2, vfit, diag) host arrays."""
    return tuple(np.concatenate([p[i] for p in parts]) for i in range(3))


class _FusedGraph:
    """One CUDA graph running ``chunk_fn(block_f, 1.0)`` for f < ``fuse``
    on a static (fuse, chunk, G) input into static outputs.  It keeps
    ``chunk_fn`` -- and through it every tensor the graph reads -- and
    the graph's private memory pool alive for as long as it lives.
    Before the capture one eager chunk runs on a side stream, so that the
    kernels are built and loaded and the libraries initialized outside
    it."""

    def __init__(self, chunk_fn, first, fuse: int):
        from pint_torch.kernels import launch_counts

        self.chunk_fn = chunk_fn
        self.static_in = first.clone()
        side = torch.cuda.Stream(first.device)
        side.wait_stream(torch.cuda.current_stream(first.device))
        with torch.cuda.stream(side):
            chunk_fn(self.static_in[0], 1.0)
        torch.cuda.current_stream(first.device).wait_stream(side)
        before = launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        # no cyclic garbage collection inside the capture: one that frees
        # an earlier graph destroys it there, which the capture refuses
        # (cudaErrorStreamCaptureInvalidated); torch.cuda.graph collects
        # before it begins
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph):
                outs = [chunk_fn(self.static_in[f], 1.0)
                        for f in range(fuse)]
                self.static_out = tuple(torch.stack([o[i] for o in outs])
                                        for i in range(4))
        finally:
            if gc_on:
                gc.enable()
        after = launch_counts()
        self.launches = {n: after[n] - before[n] for n in after
                         if after[n] != before[n]}
        self.replays = 0

    def run(self, stacked):
        """Replay on ``stacked`` (fuse, chunk, G); per block the host
        (chi2, vfit, ok, cond)."""
        self.static_in.copy_(stacked)
        self.graph.replay()
        self.replays += 1
        host = [t.cpu().numpy() for t in self.static_out]
        return [tuple(h[f] for h in host) for f in range(stacked.shape[0])]

    def stats(self) -> dict:
        return {"replays": self.replays, "launches": dict(self.launches)}


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


def _grid_fingerprint(parnames, pts, niter, batch, gls, model,
                      free_init) -> dict:
    """The sweep's identity (reference ``grid.py:1369``): everything the
    chi2 surface depends on; the device is not part of it."""
    return dict(parnames=tuple(parnames), pts=pts, niter=niter,
                ntoas=int(batch.ntoas), gls=gls,
                toas_version=getattr(batch, "_version", 0),
                params=_model_param_sig(model),
                free_init=np.asarray(free_init))


def _checkpointed_grid(fn, pts: np.ndarray, checkpoint: str, retry,
                       fingerprint: dict, chunk: int, sidecar=None):
    """The sweep through the checkpointed executor (reference
    ``grid.py:1383``): contiguous blocks of ``chunk`` points, each one
    ``fn`` call, so a resumed sweep evaluates the same blocks and stitches
    the uninterrupted surface.  The store keeps ``chunk`` and refuses a
    resume at another one, which the reference's fingerprint would let
    through wherever both cut the points into as many chunks."""
    from pint_torch.runtime.checkpoint import checkpointed_map

    blocks = [pts[i:i + chunk] for i in range(0, len(pts), chunk)]

    def chunk_fn(blk):
        c2, vf, dg = fn(blk)
        return {"chi2": c2, "vfit": vf, "diag": dg}

    outs = checkpointed_map(chunk_fn, blocks, checkpoint=checkpoint,
                            fingerprint=fingerprint, retry=retry,
                            sidecar=sidecar, block=int(chunk))
    return tuple(np.concatenate([o[k] for o in outs])
                 for k in ("chi2", "vfit", "diag"))


def grid_chisq(ftr, parnames: Sequence[str], parvalues: Sequence,
               extraparnames: Sequence[str] = (),
               executor=None, ncpu=None, chunksize=1,
               printprogress: bool = False, niter: int = 4, mesh=None,
               chunk=None, checkpoint: Optional[str] = None, retry=None,
               plan=None, fuse: Optional[int] = None,
               **fitargs) -> Tuple[np.ndarray, dict]:
    """Chi2 over the outer-product grid of ``parvalues``, by the GLS grid
    where the model has correlated noise and the WLS grid otherwise
    (:func:`build_grid_chi2_fn`); returns the chi2 array (grid-shaped) and
    ``{name: grid-shaped values}`` for ``extraparnames``.  Per-point solve
    diagnostics land on ``ftr.last_grid_diagnostics``.  The signature is
    the reference's (``grid.py:1183``):

    * ``executor``, ``ncpu``: no-ops (points are batched on the device),
      warned once; ``chunksize``, ``printprogress`` and ``fitargs`` are
      accepted and unused;
    * ``chunk``: points a batch (``None``: :func:`default_gls_chunk` on
      the GLS grid, 256 on the WLS one; ``"auto"`` the same);
    * ``checkpoint`` (a directory) with ``retry`` (a
      :class:`~pint_torch.runtime.checkpoint.RetryPolicy`): completed
      chunks persist, failed ones retry, a crashed sweep resumes;
    * ``fuse`` (GLS grid): chunks retired a dispatch (``fn.fused``); the
      WLS grid ignores it, as the reference's does;
    * ``mesh``, ``plan``: ROADMAP queue A item 9; the reference's refusals
      of their combinations come first."""
    global _warned_executor
    if (executor is not None or ncpu not in (None, 1)) \
            and not _warned_executor:
        _warned_executor = True
        log.warning("grid_chisq: executor/ncpu are no-ops here - grid "
                    "points are batched on the device")
    from pint_torch.runtime.preflight import check_device

    check_device(device=ftr.model.device)
    model, batch = ftr.model, ftr.batch
    parnames = tuple(parnames)
    grids = [np.asarray(v, dtype=np.float64) for v in parvalues]
    shape = tuple(len(g) for g in grids)
    pts = np.stack([g.ravel() for g in np.meshgrid(*grids, indexing="ij")],
                   axis=-1)
    gls = bool(model.noise_basis_by_component(batch)[0])
    chunk = _resolve_auto_chunk(model, batch, chunk, gls=gls)
    if plan is not None and mesh is not None:
        raise UsageError("plan= and mesh= cannot be combined; the plan "
                         "carries its own mesh")
    if isinstance(plan, str) and plan != "auto":
        raise UsageError(f"plan={plan!r}: pass 'auto' or an ExecutionPlan")
    if checkpoint is not None and mesh is not None:
        raise UsageError("checkpoint= and mesh= cannot be combined; pass "
                         "plan= for elastic checkpointed multi-device "
                         "execution")
    if checkpoint is not None and plan is None and fuse is not None \
            and int(fuse) > 1:
        raise UsageError(
            "fuse= with checkpoint= needs plan= (the elastic supervisor "
            "owns fused checkpointed dispatch); drop fuse or add "
            "plan='auto'")
    if mesh is not None or plan is not None:
        raise NotImplementedError(
            "grid_chisq: mesh= and plan= (multi-device sweeps and the "
            "elastic supervisor) are ROADMAP queue A item 9")
    fn, free_init, fit_params = build_grid_chi2_fn(
        model, batch, parnames, niter=niter, chunk=chunk,
        grid_spans=point_spans(model, parnames, pts))
    if checkpoint is not None:
        chi2, vfit, diag = _checkpointed_grid(
            fn, pts, checkpoint, retry,
            fingerprint=_grid_fingerprint(parnames, pts, niter, batch, gls,
                                          model, free_init[0].cpu().numpy()),
            chunk=chunk if chunk else (default_gls_chunk(batch.device)
                                       if gls else _WLS_CHUNK),
            sidecar={"platform": batch.device.type, "num_devices": 1})
    elif fuse is not None and int(fuse) > 1 and gls:
        chi2, vfit, diag = fn.fused(pts, fuse=int(fuse))
    else:
        chi2, vfit, diag = fn(pts)
    _attach_grid_diagnostics(ftr, diag, fn.nonlinear_columns, shape)
    return chi2.reshape(shape), _extraout(extraparnames, fit_params,
                                          parnames, vfit, pts, ftr.model,
                                          shape)


def grid_chisq_derived(ftr, parnames: Sequence[str], parfuncs: Sequence,
                       gridvalues: Sequence,
                       extraparnames: Sequence[str] = (), niter: int = 4,
                       **kw):
    """Chi2 over the outer-product grid of ``gridvalues`` in derived
    quantities: model parameter i is ``parfuncs[i](*point)`` (reference
    ``grid.py:1490``).  Returns (chi2, the grid's mesh arrays, extra
    parameter values), grid-shaped.  Of ``kw`` the port reads ``chunk``
    (as :func:`grid_chisq` does) and ignores the rest, as the reference
    ignores all of it."""
    parnames = tuple(parnames)
    grids = [np.asarray(v, dtype=np.float64) for v in gridvalues]
    shape = tuple(len(g) for g in grids)
    mesh = np.meshgrid(*grids, indexing="ij")
    flat = [g.ravel() for g in mesh]
    pts = np.stack([np.asarray([f(*vals) for vals in zip(*flat)],
                               dtype=np.float64) for f in parfuncs], axis=-1)
    chi2, vfit, diag, fit_params, fn = _points_chisq(ftr, parnames, pts,
                                                     niter, kw.get("chunk"))
    _attach_grid_diagnostics(ftr, diag, fn.nonlinear_columns, shape)
    return (chi2.reshape(shape), [g.reshape(shape) for g in mesh],
            _extraout(extraparnames, fit_params, parnames, vfit, pts,
                      ftr.model, shape))


def tuple_chisq(ftr, parnames: Sequence[str], parvalues: Sequence,
                extraparnames: Sequence[str] = (), niter: int = 4, **kw):
    """Chi2 at a list of parameter tuples, any number of them (reference
    ``grid.py:1517``): (chi2 (P,), extra parameter values).  ``kw`` as in
    :func:`grid_chisq_derived`."""
    parnames = tuple(parnames)
    pts = np.asarray(parvalues, dtype=np.float64)
    chi2, vfit, diag, fit_params, fn = _points_chisq(ftr, parnames, pts,
                                                     niter, kw.get("chunk"))
    _attach_grid_diagnostics(ftr, diag, fn.nonlinear_columns)
    return chi2, _extraout(extraparnames, fit_params, parnames, vfit, pts,
                           ftr.model)


def tuple_chisq_derived(ftr, parnames: Sequence[str], parfuncs: Sequence,
                        parvalues: Sequence,
                        extraparnames: Sequence[str] = (), niter: int = 4,
                        **kw):
    """Chi2 at tuples of derived quantities: model parameter i is
    ``parfuncs[i](*point)`` (reference ``grid.py:1535``).  Returns (chi2,
    each derived quantity's values, extra parameter values).  ``kw`` as in
    :func:`grid_chisq_derived`."""
    parnames = tuple(parnames)
    raw = np.asarray(parvalues, dtype=np.float64)
    pts = np.stack([np.asarray([f(*vals) for vals in raw], dtype=np.float64)
                    for f in parfuncs], axis=-1)
    chi2, vfit, diag, fit_params, fn = _points_chisq(ftr, parnames, pts,
                                                     niter, kw.get("chunk"))
    _attach_grid_diagnostics(ftr, diag, fn.nonlinear_columns)
    return (chi2, [raw[:, i] for i in range(raw.shape[1])],
            _extraout(extraparnames, fit_params, parnames, vfit, pts,
                      ftr.model))
