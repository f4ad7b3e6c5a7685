"""The rest of ``Fitter.auto``'s family on the CPU: the dispatch itself,
``DownhillGLSFitter`` and Huber IRLS (``robust="huber"``) on both WLS
fitters, each against the reference package on the same inputs.

* ``Fitter.auto`` picks the reference's class on every committed stand-in
  (``DownhillGLSFitter`` with correlated noise, ``DownhillWLSFitter``
  without; ``GLSFitter`` / ``WLSFitter`` with ``downhill=False``) and, on
  wideband TOAs, ``WidebandDownhillFitter`` (``WidebandTOAFitter``);
* ``DownhillGLSFitter`` on the small GLS stand-in (both packages in this
  process) and on the committed full-width B1855+09-shaped one (against
  the reference outputs stored in it): chi2 1e-6 rel, values 1e-2 sigma,
  uncertainties 1e-6 rel, the converged flag and the number of downhill
  steps equal, the noise amplitudes within 1e-6 of their largest;
* Huber IRLS on the small ELL1 stand-in with five seeded outliers of 15-40
  sigma moved into its TOAs: weights within 1e-6, the same set of
  down-weighted TOAs and the same number of IRLS rounds, values and
  uncertainties at the fits' bars;
* the GLS fitters refuse ``robust`` with the reference's ``UsageError``.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import _torch_standin as standin  # noqa: E402

pytestmark = pytest.mark.torch

#: the committed stand-ins, by bridge path name
COMMITTED = ("STANDIN_PATH", "DMX15_PATH", "ELL1_PATH", "ELL1H_PATH",
             "NGC_PATH", "NGC_PHOFF_PATH")


def _fit_gaps(f, chi2, ref, rr, key):
    """(chi2 rel, values in sigma, uncertainties rel) of a port fit
    against the reference's ``key`` fit."""
    params = rr["postfit_params"]
    vals = np.array([f.model.value(p) for p in params])
    unc = np.array([f.model[p].uncertainty for p in params])
    sig = ref[f"ref/{key}_uncertainties"]
    return (abs(chi2 / rr[f"{key}_chi2"] - 1),
            float(np.abs((vals - ref[f"ref/{key}_values"]) / sig).max()),
            float(np.abs(unc / sig - 1).max()))


@pytest.mark.parametrize("path", COMMITTED)
def test_auto_picks_the_references_fitter(path):
    from pint_torch import bridge
    from pint_torch.fitter import Fitter
    from pint_torch.gls_fitter import GLSFitter

    meta, _ = bridge.read_snapshot(getattr(bridge, path))
    m, b = bridge.load_snapshot(getattr(bridge, path), device="cpu")
    f = Fitter.auto(b, m)
    assert type(f).__name__ == meta["reference"]["auto_fitter"]
    plain = Fitter.auto(b, m, downhill=False)
    assert type(plain).__name__ == ("GLSFitter" if m.has_correlated_errors
                                    else "WLSFitter")
    assert isinstance(plain, GLSFitter) == m.has_correlated_errors


def test_auto_refuses_wideband_toas():
    """Wideband TOAs (a DM measurement on every TOA) no longer wait:
    ``Fitter.auto`` picks ``WidebandDownhillFitter``, or
    ``WidebandTOAFitter`` with ``downhill=False``, as the reference's
    ``fitter.py:81-86`` does, whatever the noise model."""
    import torch

    from pint_torch.bridge import NGC_PATH, STANDIN_PATH, load_snapshot
    from pint_torch.fitter import Fitter
    from pint_torch.wideband import WidebandDownhillFitter, WidebandTOAFitter

    for path in (NGC_PATH, STANDIN_PATH):
        m, b = load_snapshot(path, device="cpu")
        assert not b.wideband
        dm = m.total_dm(b)
        wb = dataclasses.replace(b, dm=dm, dm_error=torch.full_like(dm, 1e-4))
        assert wb.wideband
        assert type(Fitter.auto(wb, m)) is WidebandDownhillFitter
        assert type(Fitter.auto(wb, m, downhill=False)) is WidebandTOAFitter


@pytest.fixture(scope="module")
def gls_snap():
    model, toas = standin.make_standin(standin.SMALL_SETTINGS, full=False)
    return standin.export_snapshot(model, toas, standin.SMALL_SETTINGS,
                                   grid=False)


def _downhill_gls_bars(arrays):
    from pint_torch.bridge import load_snapshot, read_snapshot
    from pint_torch.gls_fitter import DownhillGLSFitter

    meta, ref = read_snapshot(arrays)
    rr = meta["reference"]
    m, b = load_snapshot(arrays, device="cpu")
    f = DownhillGLSFitter(b, m)
    chi2 = f.fit_toas()
    c, v, u = _fit_gaps(f, chi2, ref, rr, "auto")
    assert c <= 1e-6 and v <= 1e-2 and u <= 1e-6, (c, v, u)
    assert f.converged == rr["auto_converged"]
    assert f.iterations == rr["auto_iterations"]
    want = {k.rsplit("/", 1)[1]: v for k, v in ref.items()
            if k.startswith("ref/auto_noise_ampls/")}
    assert set(f.noise_ampls) == set(want) and want
    for comp, a in want.items():
        got = f.noise_ampls[comp].numpy()
        assert np.abs(got - a).max() <= 1e-6 * np.abs(a).max(), comp
    return f


def test_downhill_gls_matches_reference_on_the_small_stand_in(gls_snap):
    f = _downhill_gls_bars(gls_snap)
    assert f.method == "downhill_gls"
    assert f.covariance.shape == (len(f.fitted_params),) * 2


def test_downhill_gls_matches_committed_b1855_reference():
    from pint_torch.bridge import STANDIN_PATH

    _downhill_gls_bars(STANDIN_PATH)


def test_gls_fitters_refuse_robust_like_the_reference(gls_snap):
    from pint_tpu.exceptions import UsageError as RefUsageError
    from pint_tpu.gls_fitter import DownhillGLSFitter as RefDownhill

    from pint_torch.bridge import load_snapshot
    from pint_torch.fitter import UsageError
    from pint_torch.gls_fitter import DownhillGLSFitter, GLSFitter

    m, b = load_snapshot(gls_snap, device="cpu")
    for cls in (GLSFitter, DownhillGLSFitter):
        with pytest.raises(UsageError, match="WLS-family"):
            cls(b, m).fit_toas(robust="huber")
    with pytest.raises(UsageError, match="robust must be"):
        GLSFitter(b, m).fit_toas(robust="tukey")
    model, toas = standin.make_standin(standin.SMALL_SETTINGS, full=False)
    with pytest.raises(RefUsageError, match="WLS-family"):
        RefDownhill(toas, model).fit_toas(robust="huber")


@pytest.fixture(scope="module")
def outliers():
    """The small ELL1 stand-in with five seeded outliers (15-40 sigma, both
    signs) moved into its TOAs, in the reference and as a snapshot with
    both WLS fitters' Huber fits (the reference's, from the snapshot's
    values)."""
    s = dict(standin.SMALL_ELL1_SETTINGS, huber=True)
    model, toas = standin.make_standin(s, full=False)
    rng = np.random.default_rng(20261017)
    idx = rng.choice(len(toas), 5, replace=False)
    err = np.asarray(toas.get_errors()) * 1e-6
    dt = np.zeros(len(toas))
    dt[idx] = rng.uniform(15.0, 40.0, 5) * rng.choice([-1.0, 1.0], 5) \
        * err[idx]
    toas.adjust_TOAs(dt)
    # only the robust fits: a plain fit of these TOAs pulls SINI past 1
    arrays = standin.export_state(model, toas)
    meta = json.loads(str(arrays["meta"]))
    meta["reference"] = ref = {
        "settings": s, "postfit_params": list(model.design_param_names())}
    standin._huber_outputs(model, toas, ref["postfit_params"], arrays, ref)
    arrays["meta"] = np.asarray(json.dumps(meta))
    return arrays, idx


@pytest.mark.parametrize("key", ["huber", "huber_downhill"])
def test_huber_irls_matches_reference(outliers, key):
    from pint_torch.bridge import load_snapshot, read_snapshot
    from pint_torch.fitter import DownhillWLSFitter, WLSFitter

    arrays, idx = outliers
    meta, ref = read_snapshot(arrays)
    rr = meta["reference"]
    m, b = load_snapshot(arrays, device="cpu")
    if key == "huber":
        f = WLSFitter(b, m)
        chi2 = f.fit_toas(robust="huber",
                          maxiter=rr["settings"]["fit_maxiter"])
    else:
        f = DownhillWLSFitter(b, m)
        chi2 = f.fit_toas(robust="huber")
    w, wr = f.robust_weights.numpy(), ref[f"ref/{key}_weights"]
    assert np.abs(w - wr).max() <= 1e-6
    assert np.array_equal(w < 1.0, wr < 1.0)
    assert set(idx) <= set(np.nonzero(wr < 1.0)[0])
    assert f.robust_iterations == rr[f"{key}_iterations"]
    c, v, u = _fit_gaps(f, chi2, ref, rr, key)
    assert c <= 1e-6 and v <= 1e-2 and u <= 1e-6, (c, v, u)
    # a plain fit on the same fitter drops the weights again
    f.fit_toas()
    assert f.robust_weights is None and f.robust_iterations == 0


def test_huber_median_and_weights_are_numpys():
    import torch

    from pint_tpu.integrity.robust import huber_weights as ref_weights

    from pint_torch.integrity.robust import huber_weights, median

    rng = np.random.default_rng(5)
    for n in (6, 7):
        z = rng.normal(size=n) * 3.0
        assert float(median(torch.tensor(z))) == float(np.median(z))
    z = np.concatenate([rng.normal(size=50) * 3.0, [np.nan, np.inf, 0.0]])
    np.testing.assert_array_equal(huber_weights(torch.tensor(z)).numpy(),
                                  ref_weights(z))


def test_robust_argument_is_checked():
    """``robust`` takes None or "huber" only, and a downhill robust fit
    refuses free noise parameters (reference ``fitter.py:636-650``)."""
    from pint_torch.bridge import ELL1_PATH, NGC_PATH, load_snapshot
    from pint_torch.fitter import DownhillWLSFitter, UsageError, WLSFitter

    m, b = load_snapshot(NGC_PATH, device="cpu")
    for cls in (WLSFitter, DownhillWLSFitter):
        with pytest.raises(UsageError, match="robust must be"):
            cls(b, m).fit_toas(robust="tukey")
    m, b = load_snapshot(ELL1_PATH, device="cpu")
    m[next(p for p in m.params_table if p.startswith("EFAC"))].frozen = False
    with pytest.raises(UsageError, match="free noise"):
        DownhillWLSFitter(b, m).fit_toas(robust="huber")
