"""Per-segment precision probes: measure, decide, persist (port of
``pint_tpu/precision/tune.py``).

Every probeable segment gets a probe that runs the segment's actual
consumer twice -- once at the float64 default, once at the candidate
reduced spec -- on the workload's own operands, and measures the relative
disagreement of what the segment feeds (chi2, the step, the
log-likelihood).

Decision discipline, per segment:

* **unforced** (``force=False``): the reduced spec ships only when the
  measured disagreement is below the segment's ``safe_rel`` bar -- on an
  f64-native workload this records the float64 default with the measured
  margin;
* **forced** (``force=True``): the reduced spec records with the segment's
  ``forced_budget`` as its admitted budget, and is refused (float64
  recorded, with the reason) when the measured disagreement exceeds even
  that budget;
* either way the decision persists as a ``precision.<segment>`` key in the
  tuning manifest, and a ``precision_probe`` record is logged (the
  reference's telemetry event).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from pint_torch.exceptions import UsageError
from pint_torch.logging import log
from pint_torch.precision.policy import (SEGMENTS, SegmentSpec,
                                         precision_vkey)

__all__ = ["probe_segment", "tune_precision_segments"]

#: representative joint-lnlike point of the catalog.lnlike probe
_LNLIKE_POINT = (-14.5, 13.0 / 3.0)

#: finite stand-in for an outright-failed probe (rel = inf) in the
#: manifest, which must never carry an Infinity token
_REL_FAILED_SENTINEL = 1e300


def _finite_rel(rel: float) -> float:
    return float(rel) if math.isfinite(rel) else _REL_FAILED_SENTINEL


def _emit_probe(segment: str, spec: SegmentSpec, rel: float,
                budget: float, decision: str) -> None:
    log.debug(f"precision_probe: segment={segment} "
              f"dtype={spec.compute_dtype} accumulation={spec.accumulation} "
              f"rel_err={_finite_rel(rel)} budget={float(budget)} "
              f"decision={decision}")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def _rel(a, b, scale: Optional[float] = None) -> float:
    """Relative disagreement of ``a`` against the reference ``b``: the worst
    elementwise deviation over ``scale`` (default: ``b``'s own magnitude,
    floor-clamped)."""
    a, b = _np(a), _np(b)
    if not np.all(np.isfinite(a)):
        return float("inf")
    s = scale if scale is not None else max(float(np.max(np.abs(b))),
                                            1e-300)
    return float(np.max(np.abs(a - b)) / s)


def _serve_outputs(M, r, w, phiinv, pad_free, spec: Optional[SegmentSpec]):
    """One serve-kernel evaluation under ``spec`` (the consumer itself)."""
    from pint_torch.serving.batcher import serve_kernel

    dx, err, chi2, chi2_init = serve_kernel(M, r, w, phiinv, pad_free,
                                            spec=spec)
    return _np(dx), _np(err), float(chi2), float(chi2_init)


def _serve_system_rel(ftr, spec: SegmentSpec) -> float:
    """Float64-vs-``spec`` disagreement of the linearized-fit kernel on the
    fitter's own system: the worst of chi2 (relative to chi2) and the step
    (relative to the step's own scale)."""
    from pint_torch.serving.batcher import FitRequest, pad_request

    q = FitRequest.from_fitter(ftr)
    ops = pad_request(q, q.n_toas, q.n_free)
    dx64, err64, chi2_64, _ = _serve_outputs(*ops, None)
    dxr, _, chi2_r, _ = _serve_outputs(*ops, spec)
    step_scale = max(float(np.linalg.norm(dx64)),
                     float(np.linalg.norm(err64)), 1e-300)
    return max(_rel(np.array([chi2_r]), np.array([chi2_64]),
                    scale=max(abs(chi2_64), 1e-300)),
               float(np.linalg.norm(dxr - dx64)) / step_scale)


def _probe_gls_design(ftr, spec: SegmentSpec, **_) -> float:
    """The GLS solve under the segment, on the path the fitter takes: the
    Schur path for a correlated-noise system (fresh caches both sides),
    else the normal equations and the hardened Cholesky.  A reduced Gram
    whose Cholesky fails measures as infinite disagreement."""
    from pint_torch.gls_fitter import (_schur_gls_solve, gls_normal_equations,
                                       linearized_system)
    from pint_torch.runtime.solve import (NonFiniteSystemError,
                                          SingularMatrixError,
                                          solve_normal_cholesky)

    M, r, w, phiinv, params, _ = linearized_system(ftr.model, ftr.batch,
                                                   resids=ftr.resids)
    Nvec = 1.0 / w
    ntm = len(params)
    failures = (torch.linalg.LinAlgError, SingularMatrixError,
                NonFiniteSystemError)
    if M.shape[1] > ntm:
        _, x64, _ = _schur_gls_solve(M, r, Nvec, phiinv, ntm, {})
        try:
            _, xr, _ = _schur_gls_solve(M, r, Nvec, phiinv, ntm, {},
                                        spec=spec)
        except failures:
            return float("inf")
    else:
        mtcm64, mtcy64 = gls_normal_equations(M, r, Nvec=Nvec,
                                              phiinv=phiinv)
        mtcmr, mtcyr = gls_normal_equations(M, r, Nvec=Nvec,
                                            phiinv=phiinv, spec=spec)
        _, x64, _ = solve_normal_cholesky(mtcm64, mtcy64,
                                          name="precision probe f64")
        try:
            _, xr, _ = solve_normal_cholesky(
                mtcmr, mtcyr, name="precision probe reduced")
        except failures:
            return float("inf")
    x64n, xrn = _np(x64), _np(xr)
    step_scale = max(float(np.linalg.norm(x64n)), 1e-300)
    rel_x = float(np.linalg.norm(xrn - x64n)) / step_scale
    chi2_64 = float(r @ (w * (r - M @ x64)))
    chi2_r = float(r @ (w * (r - M @ xr)))
    if not np.isfinite(chi2_r):
        return float("inf")
    return max(rel_x, abs(chi2_r - chi2_64) / max(abs(chi2_64), 1e-300))


def _probe_grid_gram(ftr, spec: SegmentSpec,
                     grid_params: Optional[Sequence[str]] = None,
                     points=None, **_) -> float:
    """The chunked GLS grid under the segment: the grid built twice (float64
    and ``spec``) over a small representative point set; the chi2 surface
    and the refit values compared."""
    from pint_torch.grid import build_grid_gls_chi2_fn

    if grid_params is None or points is None:
        raise UsageError("grid.gram probe needs grid_params + points")
    points = np.asarray(points, dtype=np.float64)[:4]
    chunk = int(points.shape[0])
    fn64, _, _ = build_grid_gls_chi2_fn(
        ftr.model, ftr.batch, tuple(grid_params), niter=1, chunk=chunk,
        precision=SegmentSpec(segment="grid.gram"))
    fnr, _, _ = build_grid_gls_chi2_fn(
        ftr.model, ftr.batch, tuple(grid_params), niter=1, chunk=chunk,
        precision=spec)
    c64, v64, _ = fn64(points)
    cr, vr, _ = fnr(points)
    rel_c = _rel(cr, c64, scale=max(float(np.max(np.abs(c64))), 1e-300))
    vscale = max(float(np.max(np.abs(v64))), 1e-300)
    return max(rel_c, float(np.max(np.abs(vr - v64))) / vscale)


def _probe_serve_gram(ftr, spec: SegmentSpec, **_) -> float:
    return _serve_system_rel(ftr, spec)


def _probe_catalog_fit(ftr, spec: SegmentSpec, catalog=None, **_) -> float:
    """The catalogue's batched fit shares the serve kernel: measured per
    member system (the worst of the first four), or on the fitter's own
    system without a catalogue."""
    if catalog is None:
        return _serve_system_rel(ftr, spec)
    pulsars = list(getattr(catalog, "pulsars", catalog))
    rels = [_serve_system_rel(p.fitter, spec) for p in pulsars[:4]]
    return max(rels) if rels else float("inf")


def _probe_catalog_lnlike(ftr, spec: SegmentSpec, catalog=None,
                          **_) -> float:
    """The joint Hellings-Downs log-likelihood under the segment at a
    representative ``(log10_A, gamma)`` point; unprobeable without a
    catalogue."""
    if catalog is None:
        raise UsageError("catalog.lnlike probe needs a catalog")
    from pint_torch.catalog.likelihood import JointLikelihood

    jl64 = JointLikelihood(catalog, n_modes=3,
                           precision=SegmentSpec(segment="catalog.lnlike"))
    jlr = JointLikelihood(catalog, n_modes=3, precision=spec)
    l64 = jl64.lnlike(*_LNLIKE_POINT)
    lr = jlr.lnlike(*_LNLIKE_POINT)
    if not np.isfinite(lr):
        return float("inf")
    return abs(lr - l64) / max(abs(l64), 1.0)


_PROBES = {
    "gls.design": _probe_gls_design,
    "grid.gram": _probe_grid_gram,
    "serve.gram": _probe_serve_gram,
    "catalog.fit": _probe_catalog_fit,
    "catalog.lnlike": _probe_catalog_lnlike,
    # grid.correction is owned by the grid's correction probe (manifest key
    # grid.correction_dtype)
}


def probe_segment(segment: str, ftr, spec: SegmentSpec, **kw) -> float:
    """Measured float64-vs-``spec`` relative disagreement of one segment's
    consumer on the workload's own operands (inf: the reduced run failed
    outright)."""
    fn = _PROBES.get(segment)
    if fn is None:
        raise UsageError(
            f"no probe for segment {segment!r} (probeable: "
            f"{sorted(_PROBES)})")
    return float(fn(ftr, spec, **kw))


def tune_precision_segments(ftr, segments: Optional[Sequence[str]] = None,
                            compute_dtype: str = "float32",
                            accumulation: str = "two_prod",
                            force: bool = False,
                            grid_params: Optional[Sequence[str]] = None,
                            points=None, catalog=None,
                            tuning_manifest=None) -> Dict[str, Any]:
    """Probe every (or the named) probeable segment of ``ftr``'s workload at
    the candidate ``(compute_dtype, accumulation)`` and record one
    ``precision.<segment>`` decision each (the module docstring's
    discipline).  Segments whose probe lacks its prerequisites (no
    catalogue for ``catalog.lnlike``, no grid axes for ``grid.gram``) are
    skipped with a log line.  Returns ``{segment: TuningDecision}``."""
    from pint_torch.autotune.manifest import TuningDecision

    if compute_dtype == "float64":
        raise UsageError("probing float64 against itself is vacuous; "
                         "pass a reduced compute_dtype")
    names = list(segments) if segments is not None else sorted(_PROBES)
    out: Dict[str, Any] = {}
    for segment in names:
        d = SEGMENTS.get(segment)
        if d is None:
            raise UsageError(f"unknown precision segment {segment!r}")
        if segment not in _PROBES:
            raise UsageError(f"segment {segment!r} has no probe (its "
                             "decision is owned elsewhere — see SEGMENTS)")
        budget = d.forced_budget if force else d.safe_rel
        cand = SegmentSpec(segment=segment, compute_dtype=compute_dtype,
                           accumulation=accumulation, budget=budget,
                           source="forced" if force else "tuned")
        try:
            rel = probe_segment(segment, ftr, cand,
                                grid_params=grid_params, points=points,
                                catalog=catalog)
        except UsageError as e:
            log.info(f"precision: segment {segment} not probed ({e})")
            continue
        safe = rel < budget
        rel_store = _finite_rel(rel)
        if safe:
            value = SegmentSpec(
                segment=segment, compute_dtype=compute_dtype,
                accumulation=accumulation, budget=budget,
                rel_err=rel_store,
                source="forced" if force else "tuned").to_value()
            decision_word = compute_dtype
        else:
            value = SegmentSpec(segment=segment).to_value()
            value["rel_err"] = rel_store
            decision_word = "float64"
        reason = (f"{compute_dtype}+{accumulation} disagrees with f64 by "
                  f"{rel:.3e} — " + ("below" if safe else "above")
                  + f" the {budget:g} "
                  + ("forced" if force else "safety") + " budget"
                  + ("" if safe else "; f64 retained"))
        vkey = precision_vkey(segment, model=ftr.model, toas=ftr.batch) \
            if d.model_bound else precision_vkey(segment)
        dec = TuningDecision(
            name=f"precision.{segment}", value=value,
            static_default=SegmentSpec(segment=segment).to_value(),
            vkey=vkey, basis="forced" if force else "probe",
            measured={"rel_err": rel_store, "budget": budget,
                      "safe_rel": d.safe_rel,
                      "probe_failed": not np.isfinite(rel)},
            reason=reason)
        if tuning_manifest is not None:
            tuning_manifest.record(dec)
        _emit_probe(segment, cand, rel, budget, decision_word)
        out[segment] = dec
    return out
