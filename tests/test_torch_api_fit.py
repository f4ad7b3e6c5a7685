"""The port's fitter, residuals, model and grid API against the JAX
package's on the CPU, part 2: the fitters' products -- ``update_model`` on
every fitter, the labelled covariance and correlation, the parameter
accessors, the report, ``ftest``'s two-number form, the derived
parameters after a fit -- and the model states' ``predicted_chi2``.

Built live from the small stand-ins (80 TOAs) with seeded numpy.  Bars:
START, FINISH and NTOA exact, CHI2, CHI2R, TRES and DMRES 1e-6 rel; the
covariance's labels equal, its diagonal 1e-6 rel, correlations 1e-6 abs;
derived values within 1e-2 of their sigma, sigmas 1e-6 rel;
``predicted_chi2`` 1e-6 rel; the F-test 1e-12 rel.
"""

import os
import re
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import _torch_standin as standin  # noqa: E402

pytestmark = pytest.mark.torch

CASES = {"gls": standin.SMALL_SETTINGS, "ell1": standin.SMALL_ELL1_SETTINGS,
         "wb": standin.SMALL_WB_SETTINGS}


@pytest.fixture(scope="module")
def live():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = standin.port_and_reference(CASES[name])
        return cache[name]

    return get


def _classes(name):
    from pint_tpu import fitter as RF
    from pint_tpu import gls_fitter as RG
    from pint_tpu import wideband as RW

    from pint_torch import fitter as PF
    from pint_torch import gls_fitter as PG
    from pint_torch import wideband as PW

    for mod_r, mod_p in ((RF, PF), (RG, PG), (RW, PW)):
        if hasattr(mod_p, name):
            return getattr(mod_r, name), getattr(mod_p, name)
    raise KeyError(name)


#: (fitter class, stand-in, fit_toas keywords)
FITS = {"wls": ("WLSFitter", "ell1", {"maxiter": 2}),
        "wls_huber": ("WLSFitter", "ell1", {"maxiter": 2, "robust": "huber"}),
        "downhill_wls": ("DownhillWLSFitter", "ell1", {}),
        "lm": ("LMFitter", "ell1", {}),
        "gls": ("GLSFitter", "gls", {"maxiter": 2}),
        "downhill_gls": ("DownhillGLSFitter", "gls", {}),
        "wideband": ("WidebandTOAFitter", "wb", {"maxiter": 2}),
        "downhill_wideband": ("WidebandDownhillFitter", "wb", {})}


@pytest.fixture(scope="module")
def fits(live):
    cache = {}

    def get(key):
        if key not in cache:
            cls, case, kw = FITS[key]
            R, P = _classes(cls)
            model, toas, m, b = live(case)
            fr, fp = R(toas, model), P(b, m)
            cache[key] = (fr, fr.fit_toas(**kw), fp, fp.fit_toas(**kw))
        return cache[key]

    return get


@pytest.mark.parametrize("key", list(FITS))
def test_update_model_matches_reference(fits, key):
    """What ``update_model`` stamps after each fitter's fit: START and
    FINISH bitwise (the MJDs' float64 extremes), NTOA, DMDATA and EPHEM
    equal, CHI2, CHI2R, TRES and DMRES 1e-6 rel."""
    fr, _, fp, _ = fits(key)
    assert fp.model["START"].value == (float(fr.model.START.value), 0.0)
    assert fp.model["FINISH"].value == (float(fr.model.FINISH.value), 0.0)
    for k in ("NTOA", "DMDATA", "EPHEM"):
        assert fp.model[k].value == getattr(fr.model, k).value, k
    for k in ("CHI2", "CHI2R", "TRES", "DMRES"):
        want = getattr(fr.model, k).value
        got = fp.model[k].value
        if want is None:
            assert got is None, k
        else:
            assert abs(got / want - 1) <= 1e-6, k
    assert fp.model["CHI2"].value is not None


@pytest.mark.parametrize("key", ["wls", "downhill_wls", "lm", "gls",
                                 "downhill_gls", "wideband",
                                 "downhill_wideband"])
def test_labelled_covariance_matches_reference(fits, key):
    """``parameter_covariance_matrix``: the same labels, the diagonal 1e-6
    rel, the correlations 1e-6 abs; without the phase, the Offset row
    goes."""
    fr, _, fp, _ = fits(key)
    cr, cp = fr.parameter_covariance_matrix, fp.parameter_covariance_matrix
    assert cp.axis_labels == cr.axis_labels
    assert np.abs(np.diag(cp.matrix) / np.diag(cr.matrix) - 1).max() <= 1e-6
    kr = fr.get_parameter_correlation_matrix().matrix
    kp = fp.get_parameter_correlation_matrix().matrix
    assert np.abs(kp - kr).max() <= 1e-6
    assert fp.covariance_matrix.axis_labels == cr.axis_labels
    nr = fr.get_parameter_covariance_matrix()
    npm = fp.get_parameter_covariance_matrix()
    assert npm.axis_labels == nr.axis_labels
    assert "Offset" not in npm.get_label_names(axis=0) or \
        "Offset" not in cr.get_label_names(axis=0)
    assert fp.get_parameter_covariance_matrix(with_phase=True) \
        .axis_labels == cr.axis_labels


def test_fitter_accessors_match_reference(fits, live):
    from pint_torch.residuals import Residuals

    fr, chi2_r, fp, chi2_p = fits("gls")
    assert list(fp.get_fitparams()) == list(fr.get_fitparams())
    assert list(fp.get_allparams()) == list(fr.get_allparams())
    names = list(fr.get_fitparams_num())
    assert list(fp.get_fitparams_num()) == names
    unc_r, unc_p = fr.get_fitparams_uncertainty(), \
        fp.get_fitparams_uncertainty()
    assert all(abs(unc_p[p] / unc_r[p] - 1) <= 1e-6 for p in names)
    assert set(fp.get_params_dict("all", "uncertainty")) \
        == set(fr.get_params_dict("all", "uncertainty"))
    # ftest's two-number form against this fit
    want = fr.ftest(chi2_r * 1.3, fr.resids.dof + 3)
    assert abs(fp.ftest(chi2_p * 1.3, fp.resids.dof + 3) - want) \
        <= 1e-12 * want
    # its add form: F2 added to Spindown, refit as the reference's
    from pint_torch.models.parameter import prefixParameter
    from pint_tpu.models.parameter import prefixParameter as RPrefix

    got = fp.ftest(prefixParameter("F2", value=0.0, units="Hz/s^2"),
                   "Spindown", full_output=True)
    want = fr.ftest(RPrefix("F2", value=0.0, units="Hz/s^2"), "Spindown",
                    full_output=True)
    assert got["dof_test"] == want["dof_test"]
    assert abs(got["chi2_test"] / want["chi2_test"] - 1) <= 1e-6
    # minimize_func and make_resids run the residuals at given values
    _, _, m, b = live("gls")
    c2 = fp.minimize_func([fp.model.value("F0")], ["F0"])
    assert abs(c2 / chi2_p - 1) <= 1e-12
    assert isinstance(fp.make_resids(m), Residuals)
    fp.set_params({"F1": fp.model.value("F1")})
    unc = fp.model["F1"].uncertainty
    fp.set_param_uncertainties({"F1": 2e-20})
    assert fp.model["F1"].uncertainty == 2e-20
    fp.set_param_uncertainties({"F1": unc})


def test_reset_model_forgets_the_fit(live):
    from pint_torch.fitter import WLSFitter

    _, _, m, b = live("ell1")
    f = WLSFitter(b, m)
    f.fit_toas(maxiter=1)
    assert f.parameter_covariance_matrix is not None
    f.reset_model()
    assert f.parameter_covariance_matrix is None and not f.errors
    assert f.model.value("F0") == m.value("F0")


_NUMBER = re.compile(r"(?<![A-Za-z_\d.])[-+]?\d+\.?\d*(?:[eE][-+]?\d+)?")


def _close(x: str, y: str) -> bool:
    """Within 1e-6 rel, or one unit of ``y``'s last printed digit."""
    mant, _, exp = y.lower().partition("e")
    frac = mant.split(".")[1] if "." in mant else ""
    unit = 10.0 ** (-len(frac) + (int(exp) if exp else 0))
    return abs(float(x) - float(y)) <= max(1e-6 * abs(float(y)), unit)


@pytest.mark.parametrize("key", ["gls", "downhill_wls", "wideband"])
def test_summary_matches_reference_structure_and_numbers(fits, key):
    """``get_summary``: the same lines in the same order once the numbers
    are taken out; in each parameter row the prefit text equal, the
    postfit value within 1e-2 of its uncertainty and the rest as every
    other number: within 1e-6 rel or one unit of its last printed
    digit."""
    fr, _, fp, _ = fits(key)
    lr, lp = fr.get_summary().splitlines(), fp.get_summary().splitlines()
    assert [" ".join(_NUMBER.sub("#", x).split()) for x in lp] \
        == [" ".join(_NUMBER.sub("#", x).split()) for x in lr]
    rows = 0
    for a, b in zip(lp, lr):
        ta, tb = a.split(), b.split()
        if ta and ta[0] in fp.model.free_params and len(ta) >= 4:
            rows += 1
            name = ta[0]
            assert ta[1] == tb[1] and ta[4:] == tb[4:]
            assert abs(float(ta[2]) - float(tb[2])) \
                <= 1e-2 * fr.errors[name], name
            assert _close(ta[3], tb[3]), (a, b)
            continue
        for x, y in zip(_NUMBER.findall(a), _NUMBER.findall(b)):
            assert _close(x, y), (a, b)
    assert rows == len([p for p in fp.model.free_params
                        if not p.startswith("DMX")])


@pytest.mark.parametrize("key", ["gls", "ell1"])
def test_derived_params_after_fit_match_reference(fits, key):
    """The fit's derived parameters: values within 1e-2 of their propagated
    sigma, sigmas 1e-6 rel, the same keys and binary."""
    fr, _, fp, _ = fits("gls" if key == "gls" else "wls")
    _, dr = fr.get_derived_params(returndict=True)
    _, dp = fp.get_derived_params(returndict=True)
    assert list(dp) == list(dr) and dp.get("Binary") == dr.get("Binary")
    for k, v in dr.items():
        if k == "Binary":
            continue
        (gv, gs), (wv, ws) = dp[k], v
        if ws:
            assert abs(float(gv) - float(wv)) <= 1e-2 * ws, k
            assert abs(gs / ws - 1) <= 1e-6, k
        else:
            assert abs(float(gv) - float(wv)) <= 1e-6 * abs(float(wv)), k


# ---------------------------------------------------------------------------
# model states
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("state,case,fitter", [
    ("GLSState", "gls", "DownhillGLSFitter"),
    ("WLSState", "ell1", "DownhillWLSFitter"),
    ("WidebandState", "wb", "WidebandDownhillFitter")])
def test_model_state_predicted_chi2_matches_reference(live, state, case,
                                                      fitter):
    """``predicted_chi2`` at lambda 1 and 0.5 and chi2: 1e-6 rel; a step
    taken gives a state whose chi2 agrees too."""
    from pint_tpu import fitter as RF

    from pint_torch import fitter as PF

    model, toas, m, b = live(case)
    R, P = _classes(fitter)
    sr = getattr(RF, state)(R(toas, model), model)
    sp = getattr(PF, state)(P(b, m), m)
    assert abs(sp.chi2 / sr.chi2 - 1) <= 1e-6
    for lam in (1.0, 0.5):
        want = sr.predicted_chi2(lambda_=lam)
        assert abs(sp.predicted_chi2(lambda_=lam) / want - 1) <= 1e-6
    assert sp.params == sr.params
    nr, npm = sr.take_step(), sp.take_step(lambda_=1.0)
    assert abs(npm.chi2 / nr.chi2 - 1) <= 1e-6
    assert sp.parameter_covariance_matrix.shape \
        == np.asarray(sr.parameter_covariance_matrix).shape


def test_gls_normal_equation_helpers_match_reference():
    """``get_gls_mtcm_mtcy`` (diagonal white noise and the basis prior)
    and ``get_gls_mtcm_mtcy_fullcov`` (the dense covariance) on a seeded
    system: 1e-12 of each output's largest."""
    import torch

    from pint_tpu.fitter import get_gls_mtcm_mtcy as ref
    from pint_tpu.fitter import get_gls_mtcm_mtcy_fullcov as ref_full

    from pint_torch.fitter import (get_gls_mtcm_mtcy,
                                   get_gls_mtcm_mtcy_fullcov)

    rng = np.random.default_rng(23)
    M = rng.normal(size=(60, 7))
    y = rng.normal(size=60)
    Nvec = rng.uniform(0.5, 2.0, 60)
    phiinv = np.concatenate([np.zeros(4), rng.uniform(0.1, 1.0, 3)])
    A = rng.normal(size=(60, 60))
    cov = A @ A.T / 60 + np.eye(60)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float64)

    for got, want in (
            (get_gls_mtcm_mtcy(t(phiinv), t(Nvec), t(M), t(y)),
             ref(phiinv, Nvec, M, y)),
            (get_gls_mtcm_mtcy_fullcov(t(cov), t(M), t(y)),
             ref_full(cov, M, y))):
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert np.abs(g.numpy() - w).max() <= 1e-12 * np.abs(w).max()
