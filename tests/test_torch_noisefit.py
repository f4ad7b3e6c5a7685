"""The port's maximum-likelihood noise fit (``pint_torch/noisefit.py``,
``Residuals.lnlikelihood``, the fitters' alternation of timing and noise
fits) against the JAX package's on the CPU.

The small noise stand-in (:data:`SMALL_NOISE`: 60 epochs x 4 sub-bands,
TOAs simulated with their ECORR and red noise, TOA errors spread by a
seeded factor so that EFAC and EQUAD are told apart) with every EFAC,
EQUAD and ECORR and TNREDAMP/TNREDGAM free: the likelihood to 1e-10 rel at
the model's values and at 20 seeded random points, its gradient to 1e-8
of its norm, its Hessian to 1e-6 of its largest entry; ``fit_noise_ml``
on the same residuals -- values within 1e-2 of their Hessian uncertainty,
the same L-BFGS-B iterations and converged flag, lnlike 1e-9 rel -- and
``DownhillGLSFitter``'s alternation at the same bars with the timing
values at 1e-2 sigma and uncertainties 1e-4 rel.  The joint wideband
likelihood (DMEFAC/DMEQUAD) on the small wideband stand-in; the tempo1
RNAMP/RNIDX branch; TNEQ's and narrowband DMEFAC's exclusions.  The
committed b1855_wb snapshot's ``Fitter.auto`` noise fit at the same bars
against its stored reference outputs (b1855_noise's in
``tests/test_torch_noisefit_b1855.py``).
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

#: the small noise stand-in: identifiable EFAC/EQUAD/ECORR and red noise
SMALL_NOISE = dict(standin.SMALL_SETTINGS, n_epochs=60, correlated=True,
                   err_spread=0.5, noise_scale=2.0, rn_amp=-12.5)
NOISE_FREE = ["EFAC", "EQUAD", "ECORR", "TNREDAMP", "TNREDGAM"]


def _pair(settings, prefixes):
    """(reference model, reference TOAs, port model, port batch) with the
    noise parameters of ``prefixes`` free in both."""
    from pint_torch.bridge import load_snapshot

    model, toas = standin.make_standin(settings, full=False)
    standin.free_noise(model, prefixes)
    m, b = load_snapshot(standin.export_state(model, toas), device="cpu")
    return model, toas, m, b


@pytest.fixture(scope="module")
def small():
    return _pair(SMALL_NOISE, NOISE_FREE)


@pytest.fixture(scope="module")
def likelihoods(small):
    """Both packages' likelihoods of the reference's residuals."""
    import torch

    from pint_tpu.noisefit import build_noise_lnlikelihood as ref_build
    from pint_tpu.residuals import Residuals

    from pint_torch.noisefit import build_noise_lnlikelihood

    model, toas, m, b = small
    r = np.asarray(Residuals(toas, model).time_resids)
    lr, x0r, names_r = ref_build(model, toas)
    lp, x0, names = build_noise_lnlikelihood(m, b)
    assert names == names_r and np.array_equal(x0, x0r)
    return lr, lp, x0, r, torch.tensor(r)


def _points(x0, n=20):
    rng = np.random.default_rng(11)
    pts = [x0]
    for _ in range(n):
        x = x0 * rng.uniform(0.5, 1.5, x0.size)
        x[-2:] = x0[-2:] + rng.uniform(-0.5, 0.5, 2)  # TNREDAMP, TNREDGAM
        pts.append(x)
    return pts


def test_lnlike_matches_reference_at_x0_and_random_values(likelihoods):
    import torch

    lr, lp, x0, r, rt = likelihoods
    for x in _points(x0):
        want = float(lr(x, r))
        got = float(lp(torch.tensor(x), rt))
        assert abs(got / want - 1) <= 1e-10, (x, got, want)


def test_gradient_and_hessian_match_reference(likelihoods):
    """``torch.func.grad`` to 1e-8 of the gradient's norm, ``hessian``
    (forward over reverse through the masked variances and the Cholesky)
    to 1e-6 of its largest entry, against ``jax.grad``/``jax.hessian``."""
    import jax
    import torch
    from torch.func import grad, hessian

    lr, lp, x0, r, rt = likelihoods
    for x in _points(x0, 3):
        g_r = np.asarray(jax.grad(lambda v: lr(v, r))(x))
        g = grad(lambda v: lp(v, rt))(torch.tensor(x)).numpy()
        assert np.abs(g - g_r).max() <= 1e-8 * np.linalg.norm(g_r)
    H_r = np.asarray(jax.hessian(lambda v: lr(v, r))(x0))
    H = hessian(lambda v: lp(v, rt))(torch.tensor(x0)).numpy()
    assert np.abs(H - H_r).max() <= 1e-6 * np.abs(H_r).max()


def test_lnlikelihood_matches_the_noise_likelihood(small):
    """``Residuals.lnlikelihood`` is the noise likelihood at the model's
    values (one definition), and the reference's to 1e-9 rel (the
    residuals differ at ~1e-13 s between the packages)."""
    import torch

    from pint_tpu.residuals import Residuals as RR

    from pint_torch.noisefit import build_noise_lnlikelihood
    from pint_torch.residuals import Residuals

    model, toas, m, b = small
    res = Residuals(b, m)
    lp, x0, _ = build_noise_lnlikelihood(m, b)
    own = float(lp(torch.tensor(x0), res.time_resids))
    assert abs(res.lnlikelihood() / own - 1) <= 1e-13
    assert abs(res.lnlikelihood() / RR(toas, model).lnlikelihood() - 1) \
        <= 1e-9


def _noise_bars(res, want, nit_want, rel_unc=1e-6):
    assert res.names == list(want.names)
    assert res.converged == want.converged
    assert res.nit == nit_want
    assert abs(res.lnlike / want.lnlike - 1) <= 1e-9
    err = np.asarray(want.errors)
    assert np.abs((res.values - want.values) / err).max() <= 1e-2
    assert np.abs(res.errors / err - 1).max() <= rel_unc


def test_fit_noise_ml_matches_reference(small):
    """Both fits from the same residuals: L-BFGS-B sees the same values
    and gradients, so it takes the same iterations."""
    from pint_tpu.noisefit import fit_noise_ml as ref_fit
    from pint_tpu.residuals import Residuals

    from pint_torch.noisefit import fit_noise_ml

    model, toas, m, b = small
    r = np.asarray(Residuals(toas, model).time_resids)
    holder = type("Fit", (), {})()
    holder.fit_noise = lambda **kw: ref_fit(model, toas, r, **kw)
    rounds = standin._recorded_noise_fits(holder)
    want = holder.fit_noise(uncertainty=True)
    res = fit_noise_ml(m, b, r, uncertainty=True)
    _noise_bars(res, want, rounds[0][1])
    assert res.nfev == rounds[0][2]


def test_alternation_matches_reference(small):
    """``DownhillGLSFitter.fit_toas()`` with free noise parameters: two
    rounds of (timing fit, noise fit), the Hessian's uncertainties on the
    last, a final timing fit; each round's L-BFGS-B iterations and
    converged flag equal the reference's, noise values within 1e-2 of
    their uncertainties, timing values 1e-2 sigma and uncertainties 1e-4
    rel; the built likelihood is kept across the rounds."""
    from pint_tpu.gls_fitter import DownhillGLSFitter as RD

    from pint_torch.gls_fitter import DownhillGLSFitter

    model, toas, m, b = small
    fr = standin._counted_steps(RD(toas, model))
    rounds = standin._recorded_noise_fits(fr)
    f = DownhillGLSFitter(b, m)
    cr, c = fr.fit_toas(), f.fit_toas()
    assert len(f.noise_fit_results) == len(rounds) == 2
    for got, (want, nit, _) in zip(f.noise_fit_results, rounds):
        assert got.nit == nit and got.converged == want.converged
        assert abs(got.lnlike / want.lnlike - 1) <= 1e-9
    names = f.noise_fit_results[-1].names
    err = np.array([float(getattr(fr.model, p).uncertainty) for p in names])
    vals = np.array([f.model.value(p) for p in names])
    want = np.array([float(getattr(fr.model, p).value) for p in names])
    assert np.abs((vals - want) / err).max() <= 1e-2
    design = list(model.design_param_names())
    sig = np.array([float(getattr(fr.model, p).uncertainty) for p in design])
    vals = np.array([f.model.value(p) for p in design])
    want = np.array([float(getattr(fr.model, p).value) for p in design])
    unc = np.array([f.model[p].uncertainty for p in design])
    assert abs(c / cr - 1) <= 1e-6
    assert np.abs((vals - want) / sig).max() <= 1e-2
    assert np.abs(unc / sig - 1).max() <= 1e-4
    assert (f.converged, f.iterations) == (fr.converged, fr.steps)
    assert sum(k[0] == "noisefit_fns" for k in f.model._cache
               if isinstance(k, tuple)) == 1


def test_wideband_lnlike_matches_reference():
    """The joint TOA+DM likelihood with DMEFAC, DMEQUAD and EFAC free on
    the small wideband stand-in: value 1e-10 rel, gradient 1e-8 of its
    norm."""
    import jax
    import torch
    from torch.func import grad

    from pint_tpu.noisefit import build_noise_lnlikelihood as ref_build
    from pint_tpu.wideband import WidebandTOAResiduals

    from pint_torch.noisefit import build_noise_lnlikelihood

    model, toas, m, b = _pair(standin.SMALL_WB_SETTINGS,
                              ["DMEFAC", "DMEQUAD", "EFAC"])
    wr = WidebandTOAResiduals(toas, model)
    r, r_dm = np.asarray(wr.toa.time_resids), np.asarray(wr.dm.resids)
    lr, x0, names = ref_build(model, toas, wideband=True)
    lp, x0p, names_p = build_noise_lnlikelihood(m, b, wideband=True)
    assert names == names_p and any(n.startswith("DMEQUAD") for n in names)
    rt, rdt = torch.tensor(r), torch.tensor(r_dm)
    for x in _points(x0, 5):
        x = np.abs(x)
        want = float(lr(x, r, r_dm))
        assert abs(float(lp(torch.tensor(x), rt, rdt)) / want - 1) <= 1e-10
        g_r = np.asarray(jax.grad(lambda v: lr(v, r, r_dm))(x))
        g = grad(lambda v: lp(v, rt, rdt))(torch.tensor(x)).numpy()
        assert np.abs(g - g_r).max() <= 1e-8 * np.linalg.norm(g_r)


def test_tempo1_red_noise_branch_matches_reference():
    """RNAMP/RNIDX in place of TNREDAMP: the weights take the tempo1
    conversion, in the basis and in the likelihood."""
    import torch

    from pint_tpu.models import get_model
    from pint_tpu.noisefit import build_noise_lnlikelihood as ref_build
    from pint_tpu.residuals import Residuals as RR

    from pint_torch.bridge import load_snapshot
    from pint_torch.noisefit import build_noise_lnlikelihood
    from pint_torch.residuals import Residuals

    _, toas = standin.make_standin(standin.SMALL_SETTINGS, full=False)
    par = standin.standin_par(standin.SMALL_SETTINGS, False) \
        .replace("TNRedAmp -13.8", "RNAMP 0.02") \
        .replace("TNRedGam 3.2", "RNIDX -4.1")
    model = get_model(par.splitlines(keepends=True))
    standin.free_noise(model, ["RNAMP", "RNIDX", "EFAC"])
    m, b = load_snapshot(standin.export_state(model, toas), device="cpu")
    assert m["TNREDAMP"].value is None
    r = np.asarray(RR(toas, model).time_resids)
    lr, x0, names = ref_build(model, toas)
    lp, _, names_p = build_noise_lnlikelihood(m, b)
    assert names == names_p and "RNAMP" in names
    assert abs(float(lp(torch.tensor(x0), torch.tensor(r)))
               / float(lr(x0, r)) - 1) <= 1e-10
    assert abs(Residuals(b, m).lnlikelihood()
               / RR(toas, model).lnlikelihood() - 1) <= 1e-9


def test_tneq_and_narrowband_dm_scaling_are_left_out(small):
    """A free TNEQ and, on narrowband TOAs, a free DMEFAC are left out
    with a warning, as in the reference."""
    import dataclasses

    from pint_torch.noisefit import free_noise_params

    _, _, m, b = small
    m2 = m.copy()
    m2["TNEQ1"].value, m2["TNEQ1"].frozen = -6.0, False
    m2.params_table["DMEFAC1"] = dataclasses.replace(
        m2["EFAC1"], name="DMEFAC1", component="ScaleToaError")
    m2.components["ScaleToaError"].params.append("DMEFAC1")
    with pytest.warns(UserWarning) as rec:
        free = free_noise_params(m2)
    assert "TNEQ1" not in free and "DMEFAC1" not in free
    assert {str(w.message).split()[0] for w in rec} == {"TNEQ1", "DMEFAC1"}
    assert "DMEFAC1" in free_noise_params(m2, wideband=True)


def test_committed_wideband_noise_fit_matches_reference():
    """The joint TOA+DM noise fit of the 890-TOA wideband stand-in
    (DMEFAC, DMEQUAD and EFAC per receiver)."""
    from pint_torch.bridge import WB_PATH

    standin.snapshot_noise_bars(WB_PATH, "WidebandDownhillFitter")


def test_update_noise_params_takes_the_non_negative_branch(small):
    from pint_torch.fitter import Fitter

    _, _, m, b = small
    f = Fitter(b, m)
    f._update_noise_params(["EFAC1", "TNREDGAM"], [-1.2, -0.5], [0.1, 0.2])
    assert f.model.value("EFAC1") == 1.2 and f.model.value("TNREDGAM") == -0.5
    assert f.errors == {"EFAC1": 0.1, "TNREDGAM": 0.2}
