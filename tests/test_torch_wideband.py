"""The port's wideband TOA+DM fitting (``pint_torch/wideband.py``, the DM
functions of ``TimingModel``, ``ScaleDmError``, ``LMFitter``) against the
JAX package's on the CPU.

On the small wideband stand-in (``SMALL_WB_SETTINGS``: 80 TOAs near the
ecliptic with SWM 1 NE_SW -- K7's twin under ``jacfwd`` --, SWX windows,
DMWaveX, FDJUMPDM, a DMJUMP, DMEFAC/DMEQUAD), built live by the reference
package: the model's DM to 1e-12 pc/cm^3, the DM design matrix to 1e-10
of each column's largest, the scaled DM errors bitwise, the combined
residuals (1e-10 s, 1e-12 pc/cm^3) and chi2 (1e-6 rel).  Against the
committed ``small_wb_standin.npz``: each wideband fitter and
``Fitter.auto``'s at the fit bars (chi2 1e-6 rel, values 1e-2 sigma,
uncertainties 1e-6 rel, converged flags and steps).  ``LMFitter`` on the
narrowband small ELL1 stand-in at the same bars.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import _torch_standin as standin  # noqa: E402

pytestmark = pytest.mark.torch


@pytest.fixture(scope="module")
def live():
    """(reference model, reference TOAs, port model, port batch) of the
    small wideband stand-in."""
    return standin.port_and_reference(standin.SMALL_WB_SETTINGS)


def test_total_dm_matches_reference(live):
    model, toas, m, b = live
    assert b.wideband and b.dm.shape == (80,)
    got = m.total_dm(b).numpy()
    assert np.abs(got - np.asarray(model.total_dm(toas))).max() <= 1e-12
    for p in ("NE_SW", "DMJUMP1", "SWXDM_0001", "DMWXSIN_0002"):
        d = m.d_dm_d_param(b, p).numpy()
        want = np.asarray(model.d_dm_d_param(toas, p))
        assert np.abs(d - want).max() <= 1e-10 * np.abs(want).max(), p


def test_dm_designmatrix_matches_reference_jacfwd(live):
    """Column-aligned with the timing design matrix: a zero Offset column,
    zero columns where a parameter does not move DM, and the DM-bearing
    columns -- through K7's twin for NE_SW and the astrometry -- to 1e-10
    of each column's largest."""
    model, toas, m, b = live
    Mr, names_r, _ = model.dm_designmatrix(toas)
    M, names = m.dm_designmatrix(b)
    assert names == list(names_r) == m.designmatrix(b)[1]
    M = M.numpy()
    zero = ~np.asarray(Mr).any(axis=0)
    assert zero[0] and not M[:, zero].any()
    for k in ("NE_SW", "RAJ", "DECJ", "FDJUMPDM1", "DMJUMP1"):
        assert not zero[names.index(k)], k
    gap = np.abs(M - Mr).max(0) / np.maximum(np.abs(Mr).max(0), 1e-300)
    assert gap.max() <= 1e-10, names[int(gap.argmax())]


def test_scaled_dm_errors_bitwise(live):
    """ScaleDmError: all DMEQUADs in quadrature, then all DMEFACs."""
    model, toas, m, b = live
    assert "ScaleDmError" in m.components
    got = m.scaled_dm_uncertainty(b)
    want = np.asarray(model.scaled_dm_uncertainty(toas))
    assert np.array_equal(got, want)
    assert not np.array_equal(got, b.dm_error.numpy())


def test_combined_residuals_and_chi2_match_reference(live):
    from pint_tpu.wideband import WidebandTOAResiduals as RW

    from pint_torch.wideband import WidebandTOAResiduals

    model, toas, m, b = live
    wr, w = RW(toas, model), WidebandTOAResiduals(b, m)
    assert np.abs(w.time_resids.numpy()
                  - np.asarray(wr.toa.time_resids)).max() <= 1e-10
    assert np.abs(w.dm.resids.numpy() - np.asarray(wr.dm.resids)).max() \
        <= 1e-12
    assert abs(w.chi2 / wr.calc_chi2() - 1) <= 1e-6
    assert abs(w.chi2 - (w.toa.calc_chi2() + w.dm.calc_chi2())) \
        <= 1e-12 * w.chi2
    assert w._combined_resids.shape == (160,)
    assert w.dof == 160 - len(m.free_params) - 1


def _bars(f, chi2, ref, rr, key, unc_rel=1e-6):
    vals = np.array([f.model.value(p) for p in rr["postfit_params"]])
    unc = np.array([f.model[p].uncertainty for p in rr["postfit_params"]])
    sig = ref[f"ref/{key}_uncertainties"]
    assert abs(chi2 / rr[f"{key}_chi2"] - 1) <= 1e-6
    assert np.abs((vals - ref[f"ref/{key}_values"]) / sig).max() <= 1e-2
    assert np.abs(unc / sig - 1).max() <= unc_rel
    if f"{key}_converged" in rr:
        assert bool(f.converged) == rr[f"{key}_converged"]


@pytest.mark.parametrize("key", ["postfit", "full_cov", "downhill", "lm",
                                 "auto"])
def test_wideband_fitters_match_reference(key):
    """Each fit of the committed small wideband snapshot from its values:
    ``WidebandTOAFitter.fit_toas(maxiter=2)`` on the Schur path and with
    ``full_cov=True``, ``WidebandDownhillFitter``, ``WidebandLMFitter``,
    and ``Fitter.auto``'s (a ``WidebandDownhillFitter``: its class, steps
    and noise amplitudes too)."""
    from pint_torch.bridge import WB_SMALL_PATH, load_snapshot, read_snapshot
    from pint_torch.fitter import Fitter
    from pint_torch.wideband import (WidebandDownhillFitter,
                                     WidebandLMFitter, WidebandTOAFitter)

    meta, ref = read_snapshot(WB_SMALL_PATH)
    rr = meta["reference"]
    m, b = load_snapshot(WB_SMALL_PATH, device="cpu")
    maxiter = rr["settings"]["fit_maxiter"]
    f, kw = {"postfit": (WidebandTOAFitter, {"maxiter": maxiter}),
             "full_cov": (WidebandTOAFitter, {"maxiter": maxiter,
                                              "full_cov": True}),
             "downhill": (WidebandDownhillFitter, {}),
             "lm": (WidebandLMFitter, {}),
             "auto": (Fitter.auto, {})}[key]
    f = f(b, m)
    chi2 = f.fit_toas(**kw)
    _bars(f, chi2, ref, rr, key)
    if key == "postfit":
        assert f.solve_diagnostics.method == "cholesky"  # the Schur path
    if key == "auto":
        assert type(f).__name__ == rr["auto_fitter"]
        assert (bool(f.converged), f.iterations) == (rr["auto_converged"],
                                                     rr["auto_iterations"])
        want = {k.rsplit("/", 1)[1]: a for k, a in ref.items()
                if k.startswith("ref/auto_noise_ampls/")}
        assert set(f.noise_ampls) == set(want) and want
        for comp, a in want.items():
            assert np.abs(f.noise_ampls[comp].numpy() - a).max() \
                <= 1e-6 * np.abs(a).max()


def test_schur_and_dense_paths_agree_on_the_stacked_system(live):
    """The Schur path takes the stacked Nvec as it is: its step equals the
    dense normal equations' (threshold > 0 sends the step to the SVD) to
    1e-6 of each parameter's uncertainty, uncertainties to 1e-6 rel, and
    its cache keys on the 2N-long Nvec."""
    from pint_torch.wideband import WidebandTOAFitter

    _, _, m, b = live
    f = WidebandTOAFitter(b, m)
    d_schur, _, c_schur, params = f._wideband_step()
    assert f.solve_diagnostics.method == "cholesky"
    assert f._gls_cache["schur"][3].shape == (160,)
    d_svd, _, c_svd, _ = f._wideband_step(threshold=1e-300)
    assert f.solve_diagnostics.method == "svd"
    ntm = len(params)
    sig = np.sqrt(np.diag(c_schur.numpy()))
    assert np.abs((d_schur - d_svd)[:ntm].numpy() / sig).max() <= 1e-6
    assert np.abs(np.sqrt(np.diag(c_svd[:ntm, :ntm].numpy())) / sig
                  - 1).max() <= 1e-6


def test_nan_dm_data_is_refused(live):
    from pint_torch.runtime.solve import NonFiniteSystemError
    from pint_torch.wideband import WidebandTOAFitter

    _, _, m, b = live
    dm = b.dm.clone()
    dm[3] = float("nan")
    with pytest.raises(NonFiniteSystemError):
        WidebandTOAFitter(dataclasses.replace(b, dm=dm), m).fit_toas()


def test_narrowband_lm_fitter_matches_reference():
    """``LMFitter`` on the small ELL1 WLS stand-in: the reference's lambda
    schedule, at the fit bars."""
    from pint_tpu.fitter import LMFitter as RL

    from pint_torch.fitter import LMFitter

    model, toas, m, b = standin.port_and_reference(
        standin.SMALL_ELL1_SETTINGS)
    fr, f = RL(toas, model), LMFitter(b, m)
    cr, c = fr.fit_toas(), f.fit_toas()
    design = list(model.design_param_names())
    sig = np.array([float(getattr(fr.model, p).uncertainty) for p in design])
    vals = np.array([f.model.value(p) for p in design])
    want = np.array([float(getattr(fr.model, p).value) for p in design])
    unc = np.array([f.model[p].uncertainty for p in design])
    assert abs(c / cr - 1) <= 1e-6
    assert np.abs((vals - want) / sig).max() <= 1e-2
    assert np.abs(unc / sig - 1).max() <= 1e-6
    assert f.converged == fr.converged
