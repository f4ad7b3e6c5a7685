"""The port's fitter, residuals, model and grid API against the JAX
package's on the CPU, part 1: the wideband downhill fit with the dense
covariance (``full_cov``), then the model's API -- its own parameters and
accessors, the noise basis and weights, ``d_delay_d_param`` through the
kernels' twins, the central differences, the derived parameters, the
labelled matrices -- and the residual statistics.

Built live from the small stand-ins (80 TOAs) with seeded numpy.  Bars:
chi2 1e-6 rel, values 1e-2 sigma, uncertainties 1e-6 rel;
``d_delay_d_param`` 1e-10 of the column's largest; derived values 1e-12
rel and sigmas 1e-10 rel at the same parameters, 1e-2 sigma and 1e-6 rel
after a fit; times 1e-10 s; the F-test, the ECORR errors 1e-12 rel; the
Taylor frequency, the dispersion slope, the DM covariance and the basis
weights 1e-13 rel; a central difference within the reference's own
truncation (its value at step h less its value at h/2).
"""

import os
import sys
import types

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import _torch_standin as standin  # noqa: E402

pytestmark = pytest.mark.torch

#: the small FBX black widow (J0023+0923-shaped, 80 TOAs)
SMALL_BW = dict(standin.BW_SETTINGS, n_epochs=20, n_subbands=4,
                mjd_start=54000.0, mjd_end=56000.0, n_dmx=3, dmx_days=700.0,
                grid_points=3)
CASES = {"gls": standin.SMALL_SETTINGS, "ell1": standin.SMALL_ELL1_SETTINGS,
         "wb": standin.SMALL_WB_SETTINGS, "bw": SMALL_BW}


@pytest.fixture(scope="module")
def live():
    """(reference model, reference TOAs, port model, port batch) per
    stand-in, built once."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = standin.port_and_reference(CASES[name])
        return cache[name]

    return get


def _fit_bars(f_r, f_p, chi2_r, chi2_p, names):
    sig = np.array([getattr(f_r.model, p).uncertainty for p in names])
    vals = np.array([f_p.model.value(p) - float(getattr(f_r.model, p).value)
                     for p in names])
    unc = np.array([f_p.model[p].uncertainty for p in names])
    assert abs(chi2_p / chi2_r - 1) <= 1e-6
    assert np.abs(vals / sig).max() <= 1e-2
    assert np.abs(unc / sig - 1).max() <= 1e-6


# ---------------------------------------------------------------------------
# the repair: WidebandDownhillFitter.fit_toas(full_cov=True)
# ---------------------------------------------------------------------------
def test_wideband_downhill_full_cov_matches_reference(live):
    """The downhill wideband fit with the dense data covariance: chi2,
    values and uncertainties at the fit bars, the same converged flag and
    no noise amplitudes in either package.  The reference's downhill class
    is no ``WidebandTOAFitter`` and lacks the covariance its ``full_cov``
    solve reads, so its own ``WidebandTOAFitter`` method is bound to the
    instance."""
    from pint_tpu.wideband import WidebandDownhillFitter as RD
    from pint_tpu.wideband import WidebandTOAFitter as RT

    from pint_torch.wideband import WidebandDownhillFitter

    model, toas, m, b = live("wb")
    fr = RD(toas, model)
    fr.get_noise_covariancematrix = types.MethodType(
        RT.get_noise_covariancematrix, fr)
    chi2_r = fr.fit_toas(full_cov=True)
    fp = WidebandDownhillFitter(b, m)
    chi2_p = fp.fit_toas(full_cov=True)
    assert fp.full_cov and fp.converged == fr.converged
    _fit_bars(fr, fp, chi2_r, chi2_p, list(model.design_param_names()))
    assert not getattr(fr.resids, "noise_ampls", None)
    assert not fp.noise_ampls and not fp.resids.toa.noise_ampls


# ---------------------------------------------------------------------------
# host copies: FTest, ELL1_check, derived quantities, taylor_horner
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("args", [(120.0, 60, 80.0, 58), (50.0, 40, 49.9, 39),
                                  (10.0, 5, 12.0, 4), (30.0, 20, 29.0, 20)])
def test_ftest_matches_reference(args):
    from pint_tpu.utils import FTest as ref

    from pint_torch.utils import FTest

    want = ref(*args)
    assert abs(FTest(*args) - want) <= 1e-12 * abs(want)


@pytest.mark.parametrize("ecc", [1e-7, 1e-4, 3e-3, 2e-2])
def test_ell1_check_matches_reference(ecc):
    from pint_tpu.utils import ELL1_check as ref

    from pint_torch.utils import ELL1_check

    for out in (True, False):
        assert ELL1_check(1.9, ecc, 0.4, 4005, outstring=out) \
            == ref(1.9, ecc, 0.4, 4005, outstring=out)


@pytest.mark.parametrize("name,args", [
    ("pulsar_age", (339.3, -1.6e-15)), ("pulsar_edot", (339.3, -1.6e-15)),
    ("pulsar_B", (339.3, -1.6e-15)), ("pulsar_B_lightcyl", (339.3, -1.6e-15)),
    ("mass_funct", (1.533, 1.89)), ("companion_mass", (1.533, 1.89, 60.0)),
    ("pulsar_mass", (1.533, 1.89, 0.21, 86.5)), ("omdot", (1.4, 0.21, 1.533,
                                                          1e-7)),
    ("pbdot", (1.4, 0.21, 1.533, 1e-7))])
def test_derived_quantities_are_the_reference_copy(name, args):
    from pint_tpu import derived_quantities as ref

    from pint_torch import derived_quantities as dq

    got, want = getattr(dq, name)(*args), getattr(ref, name)(*args)
    assert np.array_equal(np.asarray(got), np.asarray(want))


def test_taylor_horner_matches_reference():
    from pint_tpu.utils import taylor_horner as ref

    from pint_torch.utils import taylor_horner

    x = np.random.default_rng(5).uniform(-1e8, 1e8, 64)
    c = [3.1e-5, -2.2e-13, 4.0e-22, 1.5e-30]
    assert np.array_equal(taylor_horner(x, c), np.asarray(ref(x, c)))


# ---------------------------------------------------------------------------
# the model's own parameters and accessors
# ---------------------------------------------------------------------------
def test_top_level_params_and_accessors(live):
    """The model's own parameters lead ``params`` in the reference's order,
    PSR and EPHEM travel in the snapshot's ``meta``, and the dict
    accessors agree."""
    model, toas, m, b = live("gls")
    assert m.params == list(model.params)
    assert m["PSR"].value == model.PSR.value
    assert m["EPHEM"].value == model.EPHEM.value and b.ephem == toas.ephem
    assert m["START"].kind == "mjd" and m["NTOA"].kind == "int"
    assert m.get_params_mapping() == model.get_params_mapping()
    for which in ("free", "all"):
        got = m.get_params_dict(which, "value")
        want = model.get_params_dict(which, "value")
        assert list(got) == list(want)
    assert m.get_params_dict("free", "uncertainty") \
        == model.get_params_dict("free", "uncertainty")
    assert m.ntmpar == model.ntmpar and m.is_binary and "F0" in m
    c = m.copy()
    c.set_param_values({"F1": -1.8e-15})
    c.set_param_uncertainties({"F1": 1e-20})
    assert (c["F1"].value, c["F1"].uncertainty) == (-1.8e-15, 1e-20)
    assert m["F1"].value == model.F1.value


def test_noise_basis_api_matches_reference(live):
    """The noise basis and its dimensions exactly, the full design matrix
    to 1e-10 of each column's largest, the basis weights 1e-13 rel."""
    model, toas, m, b = live("gls")
    assert np.array_equal(m.noise_model_designmatrix(b),
                          np.asarray(model.noise_model_designmatrix(toas)))
    assert m.noise_model_dimensions(b) == model.noise_model_dimensions(toas)
    Mf, names = m.full_designmatrix(b)
    Mr, names_r, _ = model.full_designmatrix(toas)
    assert names == list(names_r) and Mf.shape == Mr.shape
    gap = np.abs(Mf.numpy() - Mr).max(0) / np.maximum(np.abs(Mr).max(0),
                                                      1e-300)
    assert gap.max() <= 1e-10
    w, wr = m.full_basis_weight(b), np.asarray(model.full_basis_weight(toas))
    assert np.abs(w / wr - 1).max() <= 1e-13


def test_dm_api_matches_reference(live):
    """The dispersion slope and the DM covariance: 1e-13 rel."""
    model, toas, m, b = live("wb")
    got = m.total_dispersion_slope(b).numpy()
    want = np.asarray(model.total_dispersion_slope(toas))
    assert np.abs(got / want - 1).max() <= 1e-13
    got = np.diag(m.dm_covariance_matrix(b).numpy())
    want = np.diag(np.asarray(model.dm_covariance_matrix(toas)))
    assert np.abs(got / want - 1).max() <= 1e-13


# ---------------------------------------------------------------------------
# d_delay_d_param through the kernels' twins
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case,param", [
    ("gls", "M2"), ("gls", "PB"), ("gls", "A1"), ("gls", "FD1"),
    ("gls", "DMX_0001"), ("gls", "T0"), ("gls", "SINI"),
    ("ell1", "EPS1"), ("ell1", "A1"), ("ell1", "TASC"),
    ("bw", "FB1"), ("bw", "FB0"), ("wb", "SWXDM_0001"), ("wb", "NE_SW")])
def test_d_delay_d_param_matches_reference_jacfwd(live, case, param):
    """``torch.func.jacfwd`` of the delay in one parameter -- frozen ones
    (M2 of the small DD, TASC, T0) too -- against the reference's
    ``jax.jacfwd``: 1e-10 of the column's largest."""
    model, toas, m, b = live(case)
    want = np.asarray(model.d_delay_d_param(toas, param))
    got = m.d_delay_d_param(b, param).numpy()
    assert np.abs(want).max() > 0
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


def _truncation_bar(fn, h):
    """The reference's own truncation: its value at step h less at h/2."""
    return np.abs(np.asarray(fn(h)) - np.asarray(fn(h / 2))).max()


@pytest.mark.parametrize("param", ["PB", "A1", "DMX_0001"])
def test_d_delay_d_param_num_within_reference_truncation(live, param):
    model, toas, m, b = live("gls")
    v = abs(float(getattr(model, param).value))
    step = 1e-6
    want = np.asarray(model.d_delay_d_param_num(toas, param, step=step))
    got = m.d_delay_d_param_num(b, param, step=step).numpy()
    bar = _truncation_bar(
        lambda h: model.d_delay_d_param_num(toas, param, step=h / v), v * step)
    assert np.abs(got - want).max() <= bar


@pytest.mark.parametrize("param", ["EFAC1", "EQUAD1"])
def test_d_toasigma_d_param_matches_reference(live, param):
    model, toas, m, b = live("gls")
    got = m.d_toasigma_d_param(b, param)
    want = np.asarray(model.d_toasigma_d_param(toas, param))
    # the reference's step is fixed: its truncation bar is the h/2 value's
    # gap, taken with the same central difference by hand
    par = getattr(model, param)
    v0 = float(par.value)
    h = max(abs(v0) * 1e-6, 1e-9) / 2
    out = []
    for v in (v0 + h, v0 - h):
        par.value = v
        out.append(np.asarray(model.scaled_toa_uncertainty(toas)))
    par.value = v0
    bar = np.abs(want - (out[0] - out[1]) / (2 * h)).max()
    assert np.abs(got - want).max() <= max(bar, 1e-300)


@pytest.mark.parametrize("param", ["F0", "PB", "EFAC1"])
def test_d_lnlikelihood_d_param_within_reference_truncation(live, param):
    from pint_tpu.residuals import Residuals as RR

    from pint_torch.residuals import Residuals

    model, toas, m, b = live("gls")
    rr, rp = RR(toas, model), Residuals(b, m)
    want = rr.d_lnlikelihood_d_param(param, step=1e-9)
    got = rp.d_lnlikelihood_d_param(param, step=1e-9)
    bar = abs(want - rr.d_lnlikelihood_d_param(param, step=5e-10))
    assert abs(got - want) <= bar


# ---------------------------------------------------------------------------
# derived parameters
# ---------------------------------------------------------------------------
def _derived_bars(dr, dp, rel_v, rel_s=None, sig_bar=None):
    assert list(dp) == list(dr)
    assert dp.get("Binary") == dr.get("Binary")
    for k, (v, s) in ((k, v) for k, v in dr.items() if k != "Binary"):
        gv, gs = dp[k]
        if sig_bar is not None and s:
            assert abs(float(gv) - float(v)) <= sig_bar * float(s), k
        else:
            assert abs(float(gv) - float(v)) <= rel_v * abs(float(v)), k
        if rel_s is not None:
            assert abs(float(gs) - float(s)) <= rel_s * abs(float(s)), k


@pytest.mark.parametrize("case", ["gls", "ell1", "bw"])
def test_derived_params_at_the_same_parameters(live, case):
    """At the stand-in's values with each free parameter's uncertainty set
    to 1e-3 of its value (seeded): values 1e-12 rel, sigmas 1e-10 rel,
    the same keys and binary, the same report lines but for the
    numbers."""
    import copy

    model, toas, m, b = live(case)
    rng = np.random.default_rng(17)
    mr, mp = copy.deepcopy(model), m.copy()
    for p in model.free_params:
        u = abs(float(getattr(mr, p).value or 1.0)) * 1e-3 * rng.uniform(.5, 2)
        getattr(mr, p).uncertainty = u
        mp[p].uncertainty = u
    sr, dr = mr.get_derived_params(rms=0.5, ntoas=80, returndict=True)
    sp, dp = mp.get_derived_params(rms=0.5, ntoas=80, returndict=True)
    _derived_bars(dr, dp, 1e-12, 1e-10)
    assert len(sp.splitlines()) == len(sr.splitlines())
    if case == "ell1":
        assert "Checking applicability of ELL1 model" in sp
        assert {"ECC", "OM (deg)", "T0"} <= set(dp)
    if case == "bw":
        assert "PBDOT (s/s)" in dp


# ---------------------------------------------------------------------------
# labelled matrices
# ---------------------------------------------------------------------------
def test_pint_matrix_makers_match_reference(live):
    from pint_tpu import pint_matrix as R

    from pint_torch import pint_matrix as P

    model, toas, m, b = live("wb")
    for q in ("toa", "dm"):
        dr = R.DesignMatrixMaker(q)(toas, model)
        dp = P.DesignMatrixMaker(q)(b, m)
        assert dp.axis_labels == dr.axis_labels
        gap = np.abs(dp.matrix - dr.matrix).max(0) \
            / np.maximum(np.abs(dr.matrix).max(0), 1e-300)
        assert gap.max() <= 1e-10
    nr = R.NoiseDesignMatrixMaker()(toas, model)
    npm = P.NoiseDesignMatrixMaker()(b, m)
    assert npm.axis_labels == nr.axis_labels
    assert np.array_equal(npm.matrix, nr.matrix)
    sub = P.TOADesignMatrixMaker()(b, m, derivative_params=["F0", "A1"])
    assert sub.derivative_params == ["Offset", "F0", "A1"]
    both = P.combine_design_matrices_by_quantity(
        [P.DesignMatrixMaker("toa")(b, m), P.DesignMatrixMaker("dm")(b, m)])
    assert both.shape[0] == 2 * b.ntoas
    for q in ("toa", "dm"):
        cr = R.CovarianceMatrixMaker(q)(toas, model)
        cp = P.CovarianceMatrixMaker(q)(b, m)
        assert cp.axis_labels == cr.axis_labels
        assert np.abs(cp.matrix - cr.matrix).max() \
            <= 1e-13 * np.abs(cr.matrix).max()
    comb = P.combine_covariance_matrix(
        [P.CovarianceMatrixMaker(q)(b, m) for q in ("toa", "dm")])
    assert comb.get_label_names(axis=0) == ["toa", "dm"]


# ---------------------------------------------------------------------------
# residual statistics
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def gls_fits(live):
    from pint_tpu.gls_fitter import GLSFitter as RG

    from pint_torch.gls_fitter import GLSFitter

    model, toas, m, b = live("gls")
    fr, fp = RG(toas, model), GLSFitter(b, m)
    return fr, fr.fit_toas(maxiter=2), fp, fp.fit_toas(maxiter=2)


def test_residual_statistics_match_reference(gls_fits):
    """After the GLS fit: the weighted rms and means, the whitened
    residuals times sigma, the noise realizations and the ECORR averages
    at 1e-10 s; the phase mean at 1e-10 s x F0 cycles; the ECORR epochs
    exactly and their errors 1e-12 rel; the Taylor frequency 1e-13 rel."""
    fr, _, fp, _ = gls_fits
    rr, rp = fr.resids, fp.resids
    F0 = fp.model.value("F0")
    assert abs(rp.rms_weighted() - rr.rms_weighted()) <= 1e-10
    assert abs(rp.calc_time_mean() - rr.calc_time_mean()) <= 1e-10
    assert abs(rp.calc_time_mean(weighted=False)
               - rr.calc_time_mean(weighted=False)) <= 1e-10
    assert abs(rp.calc_phase_mean() - rr.calc_phase_mean()) <= 1e-10 * F0
    sig = rr.get_data_error()
    assert np.abs((rp.calc_whitened_resids().numpy()
                   - np.asarray(rr.calc_whitened_resids())) * sig).max() \
        <= 1e-10
    nr_r, nr_p = rr.noise_resids(), rp.noise_resids()
    assert list(nr_p) == list(nr_r) == ["EcorrNoise", "PLRedNoise"]
    for k in nr_r:
        assert np.abs(nr_p[k].numpy() - np.asarray(nr_r[k])).max() <= 1e-10
    for use in (True, False):
        er, ep = rr.ecorr_average(use), rp.ecorr_average(use)
        assert [list(map(int, i)) for i in ep["indices"]] \
            == [list(map(int, i)) for i in er["indices"]]
        assert np.abs(ep["errors"].numpy() / np.asarray(er["errors"])
                      - 1).max() <= 1e-12
        assert np.abs(ep["time_resids"].numpy()
                      - np.asarray(er["time_resids"])).max() <= 1e-10
        for k in er["noise_resids"]:
            assert np.abs(ep["noise_resids"][k].numpy()
                          - np.asarray(er["noise_resids"][k])).max() <= 1e-10
        assert np.abs(ep["mjds"].numpy() / np.asarray(er["mjds"])
                      - 1).max() <= 1e-13
    got = rp.get_PSR_freq("taylor").numpy()
    want = np.asarray(rr.get_PSR_freq("taylor"))
    assert np.abs(got / want - 1).max() <= 1e-13
    assert rp.get_PSR_freq("modelF0") == rr.get_PSR_freq("modelF0")
    assert rp.chi2_reduced == pytest.approx(rr.chi2_reduced, rel=1e-6)
    assert np.array_equal(rp.get_data_error(scaled=False).numpy(),
                          np.asarray(rr.get_data_error(scaled=False)))
    assert rp.resids_value is rp.time_resids
    rp.update()
    assert rp._time_resids is None and rp.residual_type == "toa"


def test_wideband_residual_api_matches_reference(live):
    from pint_tpu.wideband import WidebandTOAFitter as RT

    from pint_torch.wideband import WidebandTOAFitter

    model, toas, m, b = live("wb")
    fr, fp = RT(toas, model), WidebandTOAFitter(b, m)
    fr.fit_toas(maxiter=2)
    fp.fit_toas(maxiter=2)
    rr, rp = fr.resids, fp.resids
    assert rp.dm.dof == rr.dm.dof and rp.unit == rr.unit
    assert rp.model is fp.model and rp.dm.unit == "pc/cm3"
    got, want = rp.rms_weighted(), rr.rms_weighted()
    assert set(got) == {"toa", "dm"}
    assert abs(got["toa"] - want["toa"]) <= 1e-10
    assert abs(got["dm"] / want["dm"] - 1) <= 1e-6
    for scaled in (True, False):
        assert np.array_equal(
            fp.get_data_uncertainty(scaled).numpy(),
            np.asarray(fr.get_data_uncertainty(scaled)))
        assert np.array_equal(rp.dm.get_data_error(scaled).numpy(),
                              np.asarray(rr.dm.get_data_error(scaled)))
    assert np.array_equal(rp.data_error.numpy(), np.asarray(rr.data_error))
    dm, err = rp.dm.get_dm_data()
    assert np.array_equal(dm.numpy(), np.asarray(rr.dm.get_dm_data()[0]))
    assert np.array_equal(err.numpy(), np.asarray(rr.dm.get_dm_data()[1]))
    again = fp.make_combined_residuals()
    assert abs(again.chi2 / rp.chi2 - 1) <= 1e-12
    rp.update()
    assert rp._chi2 is None and rp.dm._resids is None
