"""AbsPhase and PhaseOffset on the CPU: the NGC6440E-shaped stand-in of
the reference benchmark's secondary cell (``bench.py:43`` ``FALLBACK_PAR``,
62 TOAs, an absolute phase from TZRMJD/TZRSITE/TZRFRQ) and its variant
with an explicit fitted PHOFF, through both packages.

Each stand-in is simulated and exported by the reference package in this
process (the TZR TOA's batch row travels under ``tzr/``) and run through
the port: the absolute phase (its integer part exactly, its fraction to
1e-10 cycles), residuals 1e-10 s, the design matrix (no Offset column
under PhaseOffset) 1e-9 of each column, ``WLSFitter.fit_toas(maxiter=3)``
(chi2 1e-6 rel, values and PHOFF 1e-2 sigma, uncertainties 1e-6 rel),
``Fitter.auto``'s fit (or, on the PHOFF variant, the reference's own
``StepProblem`` with its message) and the 16 x 16 F0 x F1 WLS grid (1e-6
rel, the same argmin and rungs).  On the PHOFF variant every grid point's
system is rank-deficient -- the grid's explicit offset column and PHOFF's
are the same direction -- so K5's twin must keep the reference's
minimum-norm solution under its cutoff.  The ECORR-only chi2 with a
PhaseOffset (Sherman-Morrison, no offset marginalized) is held to the
reference on the small GLS stand-in without red noise.
"""

import functools
import os
import sys
import warnings

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import _torch_standin as standin  # noqa: E402

pytestmark = pytest.mark.torch


def _export(settings):
    model, toas = standin.make_standin(settings, full=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return standin.export_wls_snapshot(model, toas, settings, chunk=64)


@functools.lru_cache(maxsize=None)
def _case(name):
    from pint_torch.bridge import load_snapshot, read_snapshot

    s = {"ngc": standin.NGC_SETTINGS,
         "ngc_phoff": standin.NGC_PHOFF_SETTINGS}[name]
    arrays = _export(s)
    meta, ref = read_snapshot(arrays)
    m, b = load_snapshot(arrays, device="cpu")
    return dict(name=name, meta=meta, rr=meta["reference"], ref=ref,
                model=m, batch=b)


@pytest.fixture(scope="module", params=["ngc", "ngc_phoff"])
def case(request):
    return _case(request.param)


@pytest.fixture(scope="module")
def phoff():
    return _case("ngc_phoff")


def test_absolute_phase_and_residuals_match(case):
    from pint_torch.residuals import Residuals

    m, b, ref = case["model"], case["batch"], case["ref"]
    tzr = m.components["AbsPhase"].tzr_batch
    assert tzr.tzr and tzr.ntoas == 1
    ph = m.phase(b, abs_phase=True)
    np.testing.assert_array_equal(ph.int_.numpy(), ref["ref/abs_phase_int"])
    assert np.abs(ph.frac.numpy() - ref["ref/abs_phase_frac"]).max() <= 1e-10
    raw = m.phase(b)
    np.testing.assert_array_equal(raw.int_.numpy(), ref["ref/phase_int"])
    r = Residuals(b, m)
    assert np.abs(r.time_resids.numpy() - ref["ref/time_resids"]).max() \
        <= 1e-10
    phoff = "PhaseOffset" in m.components
    assert r.subtract_mean is not phoff
    assert r.dof == b.ntoas - len(m.free_params) - int(not phoff)


def test_phase_offset_spares_the_tzr_row(phoff):
    """PHOFF applies to every TOA but the TZR TOA, so it moves the absolute
    phase by exactly -PHOFF cycles (it would cancel otherwise)."""
    m, b = phoff["model"], phoff["batch"]
    ctx = m.components["AbsPhase"].tzr_batch.contexts["PhaseOffset"]
    assert ctx["apply"].tolist() == [0.0]
    m2 = m.copy()
    m2["PHOFF"].value = 0.25
    d = (m2.phase(b, abs_phase=True).value - m.phase(b, abs_phase=True).value)
    assert np.abs(d.numpy() + 0.25).max() <= 1e-9


def test_designmatrix_matches(case):
    m, b, ref, rr = case["model"], case["batch"], case["ref"], case["rr"]
    M, names = m.designmatrix(b)
    assert names == rr["designmatrix_names"]
    assert ("Offset" in names) is ("PhaseOffset" not in m.components)
    Mr = ref["ref/designmatrix"]
    err = np.abs(M.numpy() - Mr).max(axis=0) / np.abs(Mr).max(axis=0)
    assert err.max() <= 1e-9


def _gaps(f, chi2, case, key):
    ref, rr = case["ref"], case["rr"]
    vals = np.array([f.model.value(p) for p in rr["postfit_params"]])
    unc = np.array([f.model[p].uncertainty for p in rr["postfit_params"]])
    sig = ref[f"ref/{key}_uncertainties"]
    return (abs(chi2 / rr[f"{key}_chi2"] - 1),
            np.abs((vals - ref[f"ref/{key}_values"]) / sig),
            float(np.abs(unc / sig - 1).max()))


@pytest.fixture(scope="module")
def wls(case):
    from pint_torch.fitter import WLSFitter

    f = WLSFitter(case["batch"], case["model"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        chi2 = f.fit_toas(maxiter=case["rr"]["settings"]["fit_maxiter"])
    return f, chi2


def test_wls_fit_matches(case, wls):
    f, chi2 = wls
    c, v, u = _gaps(f, chi2, case, "postfit")
    assert c <= 1e-6 and v.max() <= 1e-2 and u <= 1e-6, (c, v, u)
    if case["name"] == "ngc_phoff":
        assert "PHOFF" in f.fitted_params
        assert v[case["rr"]["postfit_params"].index("PHOFF")] <= 1e-2


def test_auto_fit_matches_or_fails_as_the_reference_does(case):
    from pint_torch.fitter import Fitter, StepProblem

    f = Fitter.auto(case["batch"], case["model"])
    assert type(f).__name__ == case["rr"]["auto_fitter"]
    err = case["rr"].get("auto_error")
    if err is not None:
        with pytest.raises(StepProblem) as e:
            f.fit_toas()
        assert f"StepProblem: {e.value}" == err
        return
    chi2 = f.fit_toas()
    c, v, u = _gaps(f, chi2, case, "auto")
    assert c <= 1e-6 and v.max() <= 1e-2 and u <= 1e-6, (c, v, u)
    assert f.converged == case["rr"]["auto_converged"]


def test_f0_f1_grid_matches(case, wls):
    from pint_torch.grid import grid_chisq

    f, _ = wls
    ref, rr = case["ref"], case["rr"]
    assert rr["grid_params"] == ["F0", "F1"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        s, _ = grid_chisq(f, ("F0", "F1"), (ref["ref/grid_f0"],
                                            ref["ref/grid_f1"]),
                          niter=rr["settings"]["grid_niter"], chunk=256)
    assert s.shape == (16, 16) and np.isfinite(s).all()
    assert np.abs(s / ref["ref/grid_chi2"] - 1).max() <= 1e-6
    argmin = [int(i) for i in np.unravel_index(int(np.argmin(s)), s.shape)]
    assert argmin == rr["grid_argmin"]
    np.testing.assert_array_equal(f.last_grid_diagnostics["ladder_rung"],
                                  ref["ref/grid_rungs"])


def test_phoff_grid_system_is_rank_deficient(phoff):
    """With PHOFF free the grid's explicit offset column and PHOFF's are
    parallel: K5's twin keeps one fewer singular value than columns under
    the reference's cutoff, on the whitened system the grid builds."""
    import torch

    from pint_torch.kernels.wls_lstsq import wls_lstsq

    m, b = phoff["model"], phoff["batch"]
    M, names = m.designmatrix(b)
    assert "Offset" not in names and "PHOFF" in names
    sw = 1.0 / torch.as_tensor(m.scaled_toa_uncertainty(b))
    F0 = m.value("F0")
    Aw = torch.cat([torch.full((M.shape[0], 1), 1.0 / F0,
                               dtype=torch.float64), M], dim=1) * sw[:, None]
    _, sv, _ = wls_lstsq(Aw[None], torch.zeros((1, M.shape[0]),
                                               dtype=torch.float64))
    cut = np.finfo(np.float64).eps * max(Aw.shape) * float(sv[0, 0])
    assert int((sv[0] > cut).sum()) == Aw.shape[1] - 1


def test_committed_ngc_files_match_on_the_cpu():
    """The committed NGC6440E stand-ins (the ones ``chip_smoke.py`` drives)
    through the port on the CPU: residuals and the WLS fit against the
    reference outputs stored in them."""
    from pint_torch.bridge import (NGC_PATH, NGC_PHOFF_PATH, load_snapshot,
                                   read_snapshot)
    from pint_torch.fitter import WLSFitter
    from pint_torch.residuals import Residuals

    for path in (NGC_PATH, NGC_PHOFF_PATH):
        meta, ref = read_snapshot(path)
        rr = meta["reference"]
        assert rr["settings"]["ntoas"] == 62
        m, b = load_snapshot(path, device="cpu")
        r = Residuals(b, m).time_resids.numpy()
        assert np.abs(r - ref["ref/time_resids"]).max() <= 1e-10
        f = WLSFitter(b, m)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            chi2 = f.fit_toas(maxiter=3)
        assert abs(chi2 / rr["postfit_chi2"] - 1) <= 1e-6


def test_ecorr_only_chi2_with_phase_offset_matches_reference():
    """ECORR alone with a PhaseOffset: the reference takes the
    Sherman-Morrison chi2 without the marginalized offset
    (``residuals.py:113-130``); so does the port."""
    from pint_tpu.residuals import Residuals as RefResiduals

    import torch

    from pint_torch.bridge import load_snapshot
    from pint_torch.residuals import Residuals
    from pint_torch.utils import woodbury_dot

    s = dict(standin.SMALL_SETTINGS, rn_modes=0, phoff=True)
    model, toas = standin.make_standin(s, full=False)
    assert "PhaseOffset" in model.components
    assert "PLRedNoise" not in model.components
    want = RefResiduals(toas, model).chi2
    m, b = load_snapshot(standin.export_state(model, toas), device="cpu")
    r = Residuals(b, m)
    U, w = m.noise_model_basis_weight(b)
    assert U.shape[1] == model.noise_model_basis_weight(toas)[0].shape[1]
    assert abs(r.chi2 / want - 1) <= 1e-6
    assert not r.subtract_mean
    # the branch matters: with the offset marginalized the chi2 is another
    sigma = r.get_data_error()
    marg, _ = woodbury_dot(sigma * sigma, torch.tensor(np.hstack(
        [U, np.ones((len(U), 1))])), torch.tensor(np.append(w, 1e10)),
        r.time_resids, r.time_resids)
    assert abs(float(marg) / want - 1) > 1e-3
