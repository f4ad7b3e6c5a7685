"""The port's priors and Bayesian timing interface (``pint_torch/models/
priors.py``, ``Param.prior``, ``pint_torch/bayesian.py``) against the JAX
package's on the CPU.

Priors: each family's ``pdf``, ``logpdf``, ``ppf``, ``rvs`` (a seeded
``RandomState``) and ``jax_spec`` equal the reference's.  ``BayesianTiming``
on the small ELL1 stand-in, built live by the reference package, and on
the committed ngc_phoff and small_wb_white snapshots (``ref/bayes/``,
written by the reference): ``lnposterior_batch`` within 5e-7 of the
reference's chi2 at each point with ``-inf`` (and NaN) exactly where the
reference has them, ``lnprior`` and ``prior_transform`` to 1e-12 relative,
the scalar ``lnposterior`` against the reference's and against the port's
own batch.  The refusals: correlated noise, an unbounded prior,
``use_pulse_numbers``, and ``batched_posterior`` with a free noise
parameter.
"""

import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import _torch_standin as standin  # noqa: E402

pytestmark = pytest.mark.torch

#: lnposterior at a point: |port - reference| <= LNPOST_BAR * chi2
LNPOST_BAR = 5e-7


def _same_nonfinite(got, want):
    """-inf and NaN exactly where the reference has them."""
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    assert np.array_equal(np.isnan(got), np.isnan(want))


def _lnpost_bar(got, want, chi2):
    _same_nonfinite(got, want)
    fin = np.isfinite(want)
    assert np.all(np.abs(got[fin] - want[fin]) <= LNPOST_BAR * chi2[fin])


# -- priors -------------------------------------------------------------------
def _families(mod):
    from scipy.stats import norm

    return {
        "uniform": mod.Prior(mod.UniformBoundedRV(1.0, 3.0)),
        "gaussian_bounded": mod.Prior(mod.GaussianBoundedRV(0.5, 2.0, -1.0,
                                                            4.0)),
        "gaussian_gen": mod.Prior(mod.GaussianRV_gen(0.5, 2.0, -3.0, 2.0)),
        "normal": mod.Prior(norm(0.25, 1.5)),
        "inclination": mod.Prior(mod.RandomInclinationPrior()),
    }


@pytest.mark.parametrize("family", ["uniform", "gaussian_bounded",
                                    "gaussian_gen", "normal", "inclination"])
def test_prior_families_match_the_reference(family):
    from pint_torch.models import priors as P
    from pint_tpu.models import priors as R

    got, want = _families(P)[family], _families(R)[family]
    x = np.linspace(-1.5, 4.5, 61)
    q = np.linspace(0.0, 1.0, 21)
    with np.errstate(divide="ignore", invalid="ignore"):
        for fn in ("pdf", "logpdf"):
            assert np.array_equal(getattr(got, fn)(x), getattr(want, fn)(x),
                                  equal_nan=True), fn
        assert np.array_equal(got.ppf(q), want.ppf(q), equal_nan=True)
    a = got.rvs(size=50, random_state=np.random.RandomState(5))
    b = want.rvs(size=50, random_state=np.random.RandomState(5))
    assert np.array_equal(a, b)
    assert got.jax_spec() == want.jax_spec()
    assert not got.is_unbounded


def test_unbounded_prior_and_the_rebound_gaussian():
    from pint_torch.models import priors as P
    from pint_tpu.models import priors as R

    assert P.GaussianRV_gen is P.GaussianBoundedRV
    assert R.GaussianRV_gen is R.GaussianBoundedRV
    for mod in (P, R):
        u = mod.Prior(mod.UniformUnboundedRV())
        assert u.is_unbounded and u.jax_spec() is None
        assert np.array_equal(u.pdf([1.0, 2.0]), [1.0, 1.0])
        assert np.array_equal(u.logpdf([1.0, 2.0]), [0.0, 0.0])
        with pytest.raises(NotImplementedError):
            u.ppf(0.5)
        with pytest.raises(NotImplementedError):
            u.rvs(size=2)


def test_param_prior_default_and_pdf():
    from pint_torch.models import Param
    from pint_torch.models.priors import Prior, UniformBoundedRV

    p = Param("F0", "Spindown", value=2.0)
    assert p.prior.is_unbounded
    assert p.prior_pdf(logpdf=True) == 0.0 and p.prior_pdf() == 1.0
    p.prior = Prior(UniformBoundedRV(1.0, 3.0))
    assert p.prior_pdf() == pytest.approx(0.5)
    assert p.prior_pdf(5.0, logpdf=True) == -np.inf


# -- the small ELL1 stand-in, live --------------------------------------------
@pytest.fixture(scope="module")
def ell1():
    """(reference BayesianTiming, port BayesianTiming, points, reference
    model, reference TOAs, port model, port batch, prior box) of the
    small ELL1 stand-in, the box ``set_priors_basic``'s about a reference
    WLS fit's uncertainties."""
    from pint_torch.bayesian import BayesianTiming as PBT
    from pint_tpu.bayesian import BayesianTiming as RBT
    from pint_tpu.fitter import WLSFitter

    model, toas, m, b = standin.port_and_reference(
        standin.SMALL_ELL1_SETTINGS)
    f = WLSFitter(toas, model)
    f.fit_toas(maxiter=1)
    names = list(model.free_params)
    unc = [float(getattr(f.model, p).uncertainty) for p in names]
    info = standin.bayes_prior_info(model, toas, names, unc)
    pmin = np.array([info[p]["pmin"] for p in names])
    pmax = np.array([info[p]["pmax"] for p in names])
    values = np.array([float(getattr(model, p).value) for p in names])
    pts, cubes = standin.bayes_points(values, pmin, pmax, 3)
    return dict(rbt=RBT(model, toas, prior_info=info),
                pbt=PBT(m, b, prior_info=info), pts=pts, cubes=cubes,
                model=model, toas=toas, m=m, b=b, info=info, values=values)


def _reference_chi2(model, toas, info, pts):
    """The reference batched path's chi2 at ``pts`` (what the exporter
    stores), from a box 100 times as wide."""
    from pint_tpu.bayesian import BayesianTiming

    names = list(info)
    wide = {}
    for p in names:
        c = 0.5 * (info[p]["pmin"] + info[p]["pmax"])
        h = 50.0 * (info[p]["pmax"] - info[p]["pmin"])
        wide[p] = dict(distr="uniform", pmin=c - h, pmax=c + h)
    bw = BayesianTiming(model, toas, prior_info=wide)
    lp = np.asarray(bw.lnposterior_batch(pts))
    lognorm = float(np.sum(np.log(np.asarray(
        model.scaled_toa_uncertainty(toas)))))
    return -2.0 * (lp - np.array([bw.lnprior(x) for x in pts]) + lognorm)


def test_ell1_batched_lnposterior_matches_the_reference(ell1):
    want = np.asarray(ell1["rbt"].lnposterior_batch(ell1["pts"]))
    got = ell1["pbt"].lnposterior_batch(ell1["pts"])
    chi2 = _reference_chi2(ell1["model"], ell1["toas"], ell1["info"],
                           ell1["pts"])
    assert got.shape == (standin.BAYES_POINTS,) and got.dtype == np.float64
    assert np.isneginf(want[-standin.BAYES_OUTSIDE:]).all()
    assert np.isfinite(want[:8]).all()
    _lnpost_bar(got, want, chi2)


def test_ell1_prior_and_transform_match_the_reference(ell1):
    rbt, pbt = ell1["rbt"], ell1["pbt"]
    for x in ell1["pts"]:
        a, b = pbt.lnprior(x), rbt.lnprior(x)
        assert a == b or abs(a - b) <= 1e-12 * abs(b)
    for c in ell1["cubes"]:
        a, b = pbt.prior_transform(c), rbt.prior_transform(c)
        assert np.all(np.abs(a - b) <= 1e-12 * np.abs(b))


def test_ell1_scalar_lnposterior_matches_reference_and_batch(ell1):
    """The scalar path (the model's own residuals) against the reference's
    scalar path and the port's batch, at the in-box points whose
    residuals stay a fraction of a cycle; and -inf outside the box."""
    from pint_torch.bayesian import BayesianTiming as PBT
    from pint_tpu.bayesian import BayesianTiming as RBT

    pts = ell1["pts"][:6]
    rbt = RBT(ell1["model"], ell1["toas"], prior_info=ell1["info"])
    pbt = PBT(ell1["m"], ell1["b"], prior_info=ell1["info"])
    batch = pbt.lnposterior_batch(pts)
    chi2 = _reference_chi2(ell1["model"], ell1["toas"], ell1["info"], pts)
    for x, lb, c2 in zip(pts, batch, chi2):
        got, want = pbt.lnposterior(x), rbt.lnposterior(x)
        assert abs(got - want) <= LNPOST_BAR * c2
        assert abs(got - lb) <= LNPOST_BAR * c2
    assert pbt.lnposterior(ell1["pts"][-1]) == -np.inf


def test_ell1_lnlikelihood_is_the_residuals_chi2(ell1):
    """-chi2/2 - sum(log sigma) with the model's Residuals, and the
    parameters keep the point's values afterwards, as the reference's
    do."""
    from pint_torch.bayesian import BayesianTiming as PBT
    from pint_torch.residuals import Residuals

    pbt = PBT(ell1["m"], ell1["b"], prior_info=ell1["info"])
    x = ell1["pts"][2]
    ll = pbt.lnlikelihood(x)
    assert [pbt.model.value(p) for p in pbt.param_labels] == list(x)
    r = Residuals(ell1["b"], pbt.model)
    want = -0.5 * r.chi2 - float(np.sum(np.log(r.get_data_error().numpy())))
    assert ll == pytest.approx(want, rel=1e-12)


def test_batched_posterior_is_one_device_function(ell1):
    """``batched_posterior().fn`` maps a (B, ndim) tensor to (B,) on the
    model's device; its labels and specs are the free parameters' and
    their priors'."""
    import torch

    bp = ell1["pbt"].batched_posterior()
    assert bp.param_labels == tuple(ell1["m"].free_params)
    assert bp.ndim == len(bp.param_labels)
    assert all(s[0] == "uniform" for s in bp.prior_specs)
    x = torch.tensor(ell1["pts"][:4], dtype=torch.float64)
    out = bp.fn(x)
    assert out.shape == (4,) and out.dtype == torch.float64
    assert np.array_equal(out.numpy(),
                          ell1["pbt"].lnposterior_batch(ell1["pts"][:4]))
    with pytest.raises(NotImplementedError, match="item 9"):
        ell1["pbt"].lnposterior_batch(x)


# -- the committed snapshots' reference outputs -------------------------------
@pytest.mark.parametrize("attr", ["NGC_PHOFF_PATH", "WB_WHITE_SMALL_PATH"])
def test_committed_bayes_points_match_the_reference(attr):
    """The port on the committed snapshot with its stored prior box: the
    stored points' ``lnposterior_batch``, ``lnprior`` and the cubes'
    ``prior_transform`` at the section-2 bars."""
    from pint_torch import bridge
    from pint_torch.bayesian import BayesianTiming

    meta, ref = bridge.read_snapshot(getattr(bridge, attr))
    m, b = bridge.load_snapshot(getattr(bridge, attr), device="cpu")
    bz = meta["reference"]["bayes"]
    info = {p: dict(distr="uniform", pmin=lo, pmax=hi) for p, lo, hi in
            zip(bz["params"], ref["ref/bayes/pmin"], ref["ref/bayes/pmax"])}
    bt = BayesianTiming(m, b, prior_info=info)
    assert bt.param_labels == bz["params"]
    assert bt.likelihood_method == bz["likelihood"]
    pts = ref["ref/bayes/points"]
    _lnpost_bar(bt.lnposterior_batch(pts), ref["ref/bayes/lnposterior"],
                ref["ref/bayes/chi2"])
    assert bt.lognorm == pytest.approx(bz["lognorm"], rel=1e-14)
    lp = np.array([bt.lnprior(x) for x in pts])
    want = ref["ref/bayes/lnprior"]
    assert np.array_equal(np.isneginf(lp), np.isneginf(want))
    fin = np.isfinite(want)
    assert np.all(np.abs(lp[fin] - want[fin]) <= 1e-12 * np.abs(want[fin]))
    pt = np.array([bt.prior_transform(c) for c in ref["ref/bayes/cubes"]])
    want = ref["ref/bayes/prior_transform"]
    assert np.all(np.abs(pt - want) <= 1e-12 * np.abs(want))


def test_ngc_phoff_batch_skips_the_mean_and_the_tzr_row():
    """With a PhaseOffset the batched path subtracts no mean and, like the
    reference's, reads the model phase without the TZR row, so it differs
    from the scalar path (the model's absolute-phase residuals); the
    port's scalar path equals the reference's."""
    from pint_torch.bayesian import BayesianTiming as PBT
    from pint_tpu.bayesian import BayesianTiming as RBT

    model, toas, m, b = standin.port_and_reference(
        standin.NGC_PHOFF_SETTINGS, full=True)
    from pint_torch import bridge

    meta, ref = bridge.read_snapshot(bridge.NGC_PHOFF_PATH)
    bz = meta["reference"]["bayes"]
    info = {p: dict(distr="uniform", pmin=lo, pmax=hi) for p, lo, hi in
            zip(bz["params"], ref["ref/bayes/pmin"], ref["ref/bayes/pmax"])}
    pts = ref["ref/bayes/points"][:4]
    pbt, rbt = PBT(m, b, prior_info=info), RBT(model, toas, prior_info=info)
    batch = pbt.lnposterior_batch(pts)
    chi2 = ref["ref/bayes/chi2"][:4]
    for x, lb, c2 in zip(pts, batch, chi2):
        got, want = pbt.lnposterior(x), rbt.lnposterior(x)
        assert abs(got - want) <= LNPOST_BAR * abs(want)
        assert abs(got - lb) > LNPOST_BAR * c2


def test_wideband_batch_equals_scalar_inside_the_port():
    """On small_wb_white (the wb_wls likelihood, K7's twin through
    ``evaluate_dm``) the batch and the scalar path agree."""
    from pint_torch import bridge
    from pint_torch.bayesian import BayesianTiming

    meta, ref = bridge.read_snapshot(bridge.WB_WHITE_SMALL_PATH)
    m, b = bridge.load_snapshot(bridge.WB_WHITE_SMALL_PATH, device="cpu")
    bz = meta["reference"]["bayes"]
    info = {p: dict(distr="uniform", pmin=lo, pmax=hi) for p, lo, hi in
            zip(bz["params"], ref["ref/bayes/pmin"], ref["ref/bayes/pmax"])}
    bt = BayesianTiming(m, b, prior_info=info)
    pts = ref["ref/bayes/points"][:8]
    batch = bt.lnposterior_batch(pts)
    for x, lb, c2 in zip(pts, batch, ref["ref/bayes/chi2"][:8]):
        assert abs(bt.lnposterior(x) - lb) <= LNPOST_BAR * c2


# -- refusals -----------------------------------------------------------------
def _box(m, names=None):
    names = names or m.free_params
    return {p: dict(distr="uniform", pmin=m.value(p) - 1.0,
                    pmax=m.value(p) + 1.0) for p in names}


def test_correlated_noise_is_refused():
    from pint_torch.bayesian import BayesianTiming
    from pint_torch.bridge import BT_SMALL_PATH, load_snapshot

    m, b = load_snapshot(BT_SMALL_PATH, device="cpu")
    assert m.has_correlated_errors
    with pytest.raises(NotImplementedError, match="correlated noise"):
        BayesianTiming(m, b, prior_info=_box(m))


def test_unbounded_prior_refused_and_pulse_numbers_tracked(ell1):
    """An unbounded prior is refused as the reference's is;
    ``use_pulse_numbers=True`` computes the TOAs' pulse numbers and tracks
    the scalar and the batched lnposterior by them, as the reference's,
    within the lnposterior bar."""
    import dataclasses

    from pint_torch.bayesian import BayesianTiming
    from pint_torch.bridge import NGC_PHOFF_PATH, load_snapshot
    from pint_tpu.bayesian import BayesianTiming as RBT

    m, b = load_snapshot(NGC_PHOFF_PATH, device="cpu")
    with pytest.raises(NotImplementedError, match="Unbounded"):
        BayesianTiming(m, b)
    b = dataclasses.replace(ell1["b"])
    pbt = BayesianTiming(ell1["m"], b, use_pulse_numbers=True,
                         prior_info=ell1["info"])
    toas = ell1["toas"]
    try:
        rbt = RBT(ell1["model"], toas, use_pulse_numbers=True,
                  prior_info=ell1["info"])
        assert pbt.track_mode == rbt.track_mode == "use_pulse_numbers"
        assert np.array_equal(b.pulse_number.numpy(), toas.pulse_number)
        pts = ell1["pts"]
        want = np.asarray(rbt.lnposterior_batch(pts))
        got = pbt.lnposterior_batch(pts)
        chi2 = _reference_chi2(ell1["model"], toas, ell1["info"], pts)
        _lnpost_bar(got, want, chi2)
        for x, c2 in list(zip(pts, chi2))[:3]:
            assert abs(pbt.lnposterior(x) - rbt.lnposterior(x)) \
                <= LNPOST_BAR * c2
    finally:
        toas.pulse_number = None


def test_free_noise_parameter_takes_the_host_loop():
    """A free noise parameter: ``batched_posterior`` raises UsageError and
    ``lnposterior_batch`` loops the scalar path on the host."""
    from pint_torch.bayesian import BayesianTiming
    from pint_torch.bridge import WB_WHITE_SMALL_PATH, load_snapshot
    from pint_torch.fitter import UsageError

    m, b = load_snapshot(WB_WHITE_SMALL_PATH, device="cpu")
    efac = next(p for p in m.params if p.startswith("EFAC")
                and m[p].value is not None)
    m[efac].frozen = False
    bt = BayesianTiming(m, b, prior_info=_box(m, m.free_params))
    assert bt.model._is_noise_param(efac)
    with pytest.raises(UsageError):
        bt.batched_posterior()
    x = np.array([[m.value(p) for p in bt.param_labels]])
    assert bt.lnposterior_batch(x)[0] == bt.lnposterior(x[0])
