"""``Fitter.doctor()``: a readable audit of what the integrity layer knows
about one fit (port of ``pint_tpu/integrity/doctor.py``).

Sections: **Device**, the preflight profile of the fitter's device;
**TOAs**, counts, span and the quarantine report (the structural checks
run afresh where the TOAs were never validated); **Model/TOA
compatibility**, the checks that need both (free mask parameters selecting
no TOA, a JUMP over every TOA, free-parameter pairs whose design-matrix
columns are nearly collinear, correlated on the fitter's device);
**Robust weights**, the TOAs a ``fit_toas(robust="huber")`` downweighted.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

__all__ = ["render_doctor_report", "model_toa_findings", "DEGENERATE_CORR"]

#: |correlation| of two normalized design-matrix columns above which the
#: pair is reported as degenerate
DEGENERATE_CORR = 0.9999


def _host(toas):
    """The host TOAs of ``toas`` (itself, or a batch's), or None."""
    from pint_torch.toa import TOAs

    return toas if isinstance(toas, TOAs) else getattr(toas, "host", None)


def model_toa_findings(model, toas, designmatrix: bool = True) -> List[str]:
    """The compatibility problems of ``model`` with ``toas`` (a batch or
    host TOAs), as readable lines (empty: clean)."""
    from pint_torch.toa import select_toa_mask

    findings: List[str] = []
    try:
        model.validate_toas(toas)
    except Exception as e:
        findings.append(f"model.validate_toas: {e}")
    n = toas.ntoas
    host = _host(toas)
    if host is not None:
        for pname in model.params:
            par = model[pname]
            if par.kind != "mask" or par.frozen:
                continue
            try:
                sel = np.asarray(select_toa_mask(par, host))
            except Exception:
                continue
            nsel = int(sel.sum()) if sel.dtype == bool else len(sel)
            if nsel == 0:
                findings.append(
                    f"free mask parameter {pname} selects no TOAs")
            elif nsel == n and pname.startswith("JUMP"):
                findings.append(
                    f"free {pname} selects every TOA — fully degenerate "
                    f"with the overall phase offset; freeze it or narrow "
                    f"its mask")
    if designmatrix and len(model.free_params) >= 2 and n > 2:
        try:
            M, params = model.designmatrix(model.batch_for(toas))
            norms = torch.linalg.norm(M, dim=0)
            norms = torch.where(norms == 0, torch.ones_like(norms), norms)
            Mn = M / norms
            corr = (Mn.T @ Mn).abs().cpu().numpy()
            for i in range(len(params)):
                for j in range(i + 1, len(params)):
                    if corr[i, j] > DEGENERATE_CORR:
                        findings.append(
                            f"free parameters {params[i]} and {params[j]} "
                            f"are degenerate (|column corr| = "
                            f"{corr[i, j]:.6f}); freeze one of them")
        except Exception as e:  # a broken model must not break the audit
            findings.append(f"design-matrix degeneracy check failed: {e}")
    return findings


def _toa_section(fitter) -> List[str]:
    from pint_torch.integrity.quarantine import run_toa_checks

    toas = getattr(fitter, "toas_full", None) or fitter.batch
    host = _host(toas)
    n = toas.ntoas
    lines = [f"TOAs: {n} read"]
    if n:
        mjds = np.asarray(toas.mjds, dtype=np.float64)
        if host is not None:
            nobs = len(host.observatories)
        else:
            nobs = len(set(np.asarray(toas.obs).tolist())) \
                if toas.obs is not None else 1
        lines[0] += (f", span MJD {mjds.min():.1f}-{mjds.max():.1f}, "
                     f"{nobs} observatory(ies)")
    report = toas.last_validation
    if report is None and host is not None:
        report = getattr(host, "last_validation", None)
    if report is None:
        report = run_toa_checks(host if host is not None else toas,
                                check_coverage=False)
    lines.extend(report.render().splitlines())
    if getattr(fitter, "toas_full", None) is not None:
        lines.append(f"fit uses {fitter.batch.ntoas} certified TOA(s)")
    return lines


def _robust_section(fitter) -> List[str]:
    w = getattr(fitter, "robust_weights", None)
    if w is None:
        return []
    w = w.detach().cpu().numpy() if torch.is_tensor(w) else np.asarray(w)
    down = np.nonzero(w < 0.999)[0]
    lines = [f"Robust fit: Huber IRLS converged in "
             f"{getattr(fitter, 'robust_iterations', '?')} iteration(s), "
             f"{len(down)}/{len(w)} TOA(s) downweighted"]
    order = down[np.argsort(w[down])][:15]
    mjds = np.asarray(fitter.batch.mjds, dtype=np.float64)
    for i in order:
        lines.append(f"  row {int(i)} (MJD {mjds[i]:.4f}): weight "
                     f"{w[i]:.4f}")
    if len(down) > 15:
        lines.append(f"  ... and {len(down) - 15} more")
    return lines


def render_doctor_report(fitter, designmatrix: bool = True) -> str:
    """The whole audit of one fitter, as printable text."""
    out: List[str] = ["== pint_torch fit doctor =="]
    prof = getattr(fitter, "device_profile", None)
    if prof is not None:
        out.append(
            f"Device: {getattr(prof, 'platform', '?')} "
            f"({getattr(prof, 'device_kind', '?')}), "
            f"f64_native={getattr(prof, 'f64_native', '?')}")
    out.extend(_toa_section(fitter))
    compat = model_toa_findings(fitter.model, fitter.batch,
                                designmatrix=designmatrix)
    out.append(f"Model/TOA compatibility: "
               f"{'clean' if not compat else f'{len(compat)} finding(s)'}")
    out.extend("  " + f for f in compat)
    out.extend(_robust_section(fitter))
    diags = getattr(fitter, "solve_diagnostics", None)
    if diags is not None:
        out.append(f"Last solve: {diags}")
    return "\n".join(out)
