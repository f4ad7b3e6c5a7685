"""Pulse numbers and ``track_mode`` in the port against the JAX package on
the CPU: the TOAs' pulse-number columns (computed under a model, read
from ``-pn``/``-padd`` flags, carried through subsets, merges and batches),
the residuals in both tracking modes, every fitter class and
``Fitter.auto`` under them, the scalar and the batched lnposterior with
``use_pulse_numbers``, and ``TimingModel.d_phase_d_toa``.

The TOAs are ngc's committed par and tim files (62 TOAs, WLS), with F0
offset by :data:`WRAP` cycles over the span so that the nearest-pulse
residuals wrap; the GLS fitters run on the small GLS stand-in (80 TOAs,
ECORR and red noise) and the wideband ones on the small wideband
stand-in.  Bars: pulse numbers exact, residuals 1e-10 s, fits chi2 1e-6
rel with values within 1e-2 of their uncertainties and uncertainties 1e-6
rel (the repo's fit bars), lnposterior 5e-7 x chi2, ``d_phase_d_toa``
within ``max(1e-11 |ref|, 8 q / (2 h))``, q = ulp(F0 max|delay|).
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import _torch_standin as standin  # noqa: E402

pytestmark = pytest.mark.torch

#: cycles the F0 offset wraps the nearest-pulse residuals over the span
WRAP = 3.0


@pytest.fixture(scope="module")
def ngc():
    """Both packages' model and host TOAs of ngc's committed files."""
    from pint_torch.bridge import NGC_PATH, standin_files
    from pint_torch.models import get_model_and_toas
    from pint_tpu.models import get_model_and_toas as rget

    par, tim = standin_files(NGC_PATH)
    m, t = get_model_and_toas(str(par), str(tim), device="cpu")
    rm, rt = rget(str(par), str(tim))
    return dict(m=m, t=t, rm=rm, rt=rt)


def _fresh(ngc, wrap=0.0):
    """Copies of both packages' model and TOAs, F0 offset by ``wrap``
    cycles over the span."""
    m, t = ngc["m"].copy(), copy.deepcopy(ngc["t"])
    rm, rt = copy.deepcopy(ngc["rm"]), copy.deepcopy(ngc["rt"])
    if wrap:
        mjd = t.get_mjds()
        d = wrap / ((mjd.max() - mjd.min()) * 86400.0)
        m["F0"].value = m["F0"].value + d
        rm.F0.value = rm.F0.value + d
    return m, t, rm, rt


def test_compute_pulse_numbers_is_the_references(ngc):
    """Host TOAs and a batch take the reference's integers exactly; the
    batch of TOAs with pulse numbers carries them; removing drops both
    columns."""
    m, t, rm, rt = _fresh(ngc)
    assert t.get_pulse_numbers() is None
    pn = t.compute_pulse_numbers(m)
    want = rt.compute_pulse_numbers(rm)
    assert np.array_equal(pn, want)
    b = t.to_batch(device="cpu", model=m)
    assert np.array_equal(b.get_pulse_numbers().numpy(), want)
    b2 = copy.deepcopy(ngc["t"]).to_batch(device="cpu", model=m)
    assert b2.get_pulse_numbers() is None
    assert np.array_equal(b2.compute_pulse_numbers(m).numpy(), want)
    b2.remove_pulse_numbers()
    t.remove_pulse_numbers()
    rt.remove_pulse_numbers()
    assert b2.pulse_number is None and t.get_pulse_numbers() is None \
        is rt.get_pulse_numbers()


def test_pulse_number_flags_make_the_references_columns(ngc):
    """``-pn`` flags on every TOA are the pulse numbers; on some,
    ``phase_columns_from_flags`` gives the reference's columns bitwise
    (NaN where a TOA has none, ``-padd`` the added pulses) and drops the
    ``-pn`` flags; without any it raises as the reference's."""
    from pint_torch.exceptions import InvalidTOAError
    from pint_tpu.exceptions import InvalidTOAError as RInvalid

    m, t, rm, rt = _fresh(ngc)
    pn = rt.compute_pulse_numbers(rm)
    rt.pulse_number = None
    for tt in (t, rt):
        for i, fl in enumerate(tt.flags):
            fl["pn"] = repr(float(pn[i] + (i % 3)))
    assert np.array_equal(t.get_pulse_numbers(), rt.get_pulse_numbers())
    for tt in (t, rt):
        del tt.flags[5]["pn"]
        tt.flags[7]["padd"] = "2"
        tt.flags[9]["padd"] = "-1"
        assert tt.get_pulse_numbers() is None
        tt.phase_columns_from_flags()
    assert np.array_equal(t.pulse_number, rt.pulse_number, equal_nan=True)
    assert np.array_equal(t.delta_pulse_number, rt.delta_pulse_number)
    assert t.flags == rt.flags
    with pytest.raises(InvalidTOAError):
        t.phase_columns_from_flags()
    with pytest.raises(RInvalid):
        rt.phase_columns_from_flags()


def test_columns_ride_through_subsets_merges_and_batches(ngc):
    """``toas[mask]``, ``merge_TOAs`` and ``to_batch`` carry both columns
    as the reference's; a batch's ``select`` and a merge of batches carry
    its own."""
    from pint_torch.toa import merge_TOAs
    from pint_tpu.toa import merge_TOAs as rmerge

    m, t, rm, rt = _fresh(ngc)
    for tt, mm in ((t, m), (rt, rm)):
        tt.compute_pulse_numbers(mm)
        tt.delta_pulse_number = np.arange(len(tt), dtype=float) % 2
    keep = np.arange(len(t)) % 3 != 0
    for name in ("pulse_number", "delta_pulse_number"):
        assert np.array_equal(getattr(t[keep], name), getattr(rt[keep], name))
        got = getattr(merge_TOAs([t[keep], t[~keep]]), name)
        assert np.array_equal(got, getattr(rmerge([rt[keep], rt[~keep]]),
                                           name))
    b = t.to_batch(device="cpu", model=m)
    sub = b.select(keep, m)
    assert np.array_equal(sub.pulse_number.numpy(), rt[keep].pulse_number)
    assert np.array_equal(sub.delta_pulse_number.numpy(),
                          rt[keep].delta_pulse_number)
    both = merge_TOAs([sub, b.select(~keep, m)])
    assert np.array_equal(
        both.pulse_number.numpy(),
        np.concatenate([rt[keep].pulse_number, rt[~keep].pulse_number]))


@pytest.mark.parametrize("track_mode", [None, "nearest",
                                        "use_pulse_numbers"])
def test_residuals_track_as_the_references(ngc, track_mode):
    """With F0 off by three cycles over the span: ``nearest`` wraps, the
    pulse numbers do not; with added pulses both modes add them.  Without
    pulse numbers ``use_pulse_numbers`` raises ``UsageError`` in both."""
    from pint_torch.exceptions import UsageError
    from pint_torch.residuals import Residuals
    from pint_tpu.exceptions import UsageError as RUsage
    from pint_tpu.residuals import Residuals as RR

    m, t, rm, rt = _fresh(ngc)
    if track_mode == "use_pulse_numbers":
        with pytest.raises(UsageError):
            Residuals(t, m, track_mode=track_mode).calc_phase_resids()
        with pytest.raises(RUsage):
            RR(rt, rm, track_mode=track_mode).calc_phase_resids()
    t.compute_pulse_numbers(m)
    rt.compute_pulse_numbers(rm)
    m, _, rm, _ = _fresh(ngc, WRAP)
    for dpn in (None, np.arange(len(t), dtype=float) % 3 - 1.0):
        t.delta_pulse_number, rt.delta_pulse_number = dpn, dpn
        t._version += 1
        r = Residuals(t, m, track_mode=track_mode)
        rr = RR(rt, rm, track_mode=track_mode)
        assert r.track_mode == rr.track_mode
        got, want = r.time_resids.numpy(), np.asarray(rr.time_resids)
        assert np.abs(got - want).max() <= 1e-10
        if dpn is None:
            span = np.ptp(np.asarray(rr.phase_resids))
            assert (span > 1.0) == (rr.track_mode == "use_pulse_numbers")


def _fit_bars(f, rf, chi2, rchi2):
    assert abs(chi2 / rchi2 - 1) <= 1e-6
    for p in rf.model.free_params:
        sig = float(getattr(rf.model, p).uncertainty)
        assert abs(f.model.value(p) - float(getattr(rf.model, p).value)) \
            <= 1e-2 * sig, p
        assert abs(f.model[p].uncertainty / sig - 1) <= 1e-6, p


@pytest.mark.parametrize("cls", ["WLSFitter", "DownhillWLSFitter", "auto"])
@pytest.mark.parametrize("track_mode", ["use_pulse_numbers", "nearest"])
def test_wls_fitters_track_as_the_references(ngc, cls, track_mode):
    """Each WLS fitter (and ``Fitter.auto``) in either mode on the wrapped
    ngc TOAs: the reference's chi2, values and uncertainties, and the
    fitter's mode in its residuals."""
    import pint_torch.fitter as P
    import pint_tpu.fitter as R

    m, t, rm, rt = _fresh(ngc)
    t.compute_pulse_numbers(m)
    rt.compute_pulse_numbers(rm)
    m, _, rm, _ = _fresh(ngc, WRAP)
    b = t.to_batch(device="cpu", model=m)
    if cls == "auto":
        f = P.Fitter.auto(b, m, track_mode=track_mode)
        rf = R.Fitter.auto(rt, rm, track_mode=track_mode)
        assert type(f).__name__ == type(rf).__name__
    else:
        f = getattr(P, cls)(b, m, track_mode=track_mode)
        rf = getattr(R, cls)(rt, rm, track_mode=track_mode)
    assert f.resids.track_mode == track_mode
    kw = {"maxiter": 3} if cls == "WLSFitter" else {}
    chi2, rchi2 = f.fit_toas(**kw), rf.fit_toas(**kw)
    assert f.resids.track_mode == track_mode
    if track_mode == "use_pulse_numbers" or cls == "WLSFitter":
        _fit_bars(f, rf, chi2, rchi2)
    else:
        assert abs(chi2 / rchi2 - 1) <= 1e-6
        assert bool(f.converged) == bool(rf.converged)


def test_lm_fitter_tracks_as_the_reference():
    """``LMFitter`` with pulse numbers on the small ELL1 stand-in, F0 off
    by two cycles over its span, at the fit bars.  (On ngc its normal
    equations square the conditioning of the nearly degenerate Offset and
    DM columns, so its uncertainties are held where the stand-in is well
    conditioned.)"""
    from pint_torch.fitter import LMFitter
    from pint_tpu.fitter import LMFitter as RLM

    model, toas, m, b = standin.port_and_reference(
        standin.SMALL_ELL1_SETTINGS)
    b.compute_pulse_numbers(m)
    toas.compute_pulse_numbers(model)
    d = 2.0 / (np.ptp(b.mjds) * 86400.0)
    m["F0"].value = m["F0"].value + d
    model.F0.value = model.F0.value + d
    f = LMFitter(b, m, track_mode="use_pulse_numbers")
    rf = RLM(toas, model, track_mode="use_pulse_numbers")
    _fit_bars(f, rf, f.fit_toas(), rf.fit_toas())
    assert f.resids.track_mode == "use_pulse_numbers"


def test_powell_keeps_the_fitters_mode(ngc):
    """Powell's evaluations read the residuals in the fitter's mode."""
    from pint_torch.fitter import PowellFitter

    m, t, _, _ = _fresh(ngc)
    t.compute_pulse_numbers(m)
    f = PowellFitter(t.to_batch(device="cpu", model=m), m,
                     track_mode="nearest")
    assert f.resids.track_mode == f.make_resids(f.model).track_mode \
        == "nearest"
    f.minimize_func([f.model.value(p) for p in f.model.free_params],
                    list(f.model.free_params))
    assert f.resids.track_mode == "nearest"


@pytest.fixture(scope="module")
def gls_pair():
    return standin.port_and_reference(standin.SMALL_SETTINGS)


@pytest.mark.parametrize("cls", ["GLSFitter", "DownhillGLSFitter"])
def test_gls_fitters_track_as_the_references(gls_pair, cls):
    """The GLS fitters on the small GLS stand-in with pulse numbers and F0
    off by two cycles over its span, at the fit bars."""
    import dataclasses

    import pint_torch.gls_fitter as P
    import pint_tpu.gls_fitter as R

    model, toas, m, b = gls_pair
    rm, rt, m = copy.deepcopy(model), copy.deepcopy(toas), m.copy()
    b = dataclasses.replace(b)
    b.compute_pulse_numbers(m)
    rt.compute_pulse_numbers(rm)
    d = 2.0 / (np.ptp(b.mjds) * 86400.0)
    m["F0"].value = m["F0"].value + d
    rm.F0.value = rm.F0.value + d
    f = getattr(P, cls)(b, m)
    rf = getattr(R, cls)(rt, rm)
    assert f.resids.track_mode == rf.resids.track_mode == "use_pulse_numbers"
    kw = {"maxiter": 2} if cls == "GLSFitter" else {}
    _fit_bars(f, rf, f.fit_toas(**kw), rf.fit_toas(**kw))


def test_wideband_fitter_tracks_as_the_reference():
    """``WidebandTOAFitter(track_mode="use_pulse_numbers")`` on the small
    wideband stand-in with pulse numbers, at the fit bars."""
    from pint_torch.wideband import WidebandTOAFitter
    from pint_tpu.wideband import WidebandTOAFitter as RW

    model, toas, m, b = standin.port_and_reference(
        standin.SMALL_WB_SETTINGS)
    b.compute_pulse_numbers(m)
    toas.compute_pulse_numbers(model)
    f = WidebandTOAFitter(b, m, track_mode="use_pulse_numbers")
    rf = RW(toas, model, track_mode="use_pulse_numbers")
    assert f.resids.toa.track_mode == "use_pulse_numbers"
    _fit_bars(f, rf, f.fit_toas(maxiter=1), rf.fit_toas(maxiter=1))


def test_lnposterior_tracks_pulse_numbers_as_the_reference(ngc):
    """``BayesianTiming(use_pulse_numbers=True)`` on the wrapped ngc TOAs:
    the pulse numbers computed under the wrapped model, the scalar and the
    batched lnposterior (K1's integer part in every row) within 5e-7 x
    chi2 of the reference's; ``nearest`` differs from them."""
    from pint_torch.bayesian import BayesianTiming
    from pint_tpu.bayesian import BayesianTiming as RBT

    m, t, rm, rt = _fresh(ngc, WRAP)
    names = list(rm.free_params)
    rng = np.random.default_rng(24)
    x0 = np.array([float(getattr(rm, p).value) for p in names])
    h = np.array([abs(v) * 1e-9 + 1e-12 for v in x0])
    info = {p: dict(distr="uniform", pmin=v - 50 * s, pmax=v + 50 * s)
            for p, v, s in zip(names, x0, h)}
    pts = x0 + rng.uniform(-20, 20, size=(6, len(names))) * h
    bt = BayesianTiming(m, t.to_batch(device="cpu", model=m),
                        use_pulse_numbers=True, prior_info=info)
    rbt = RBT(rm, rt, use_pulse_numbers=True, prior_info=info)
    assert np.array_equal(bt.batch.pulse_number.numpy(), rt.pulse_number)
    got = bt.lnposterior_batch(pts)
    want = np.asarray(rbt.lnposterior_batch(pts))
    lognorm = float(np.sum(np.log(np.asarray(
        rm.scaled_toa_uncertainty(rt)))))
    chi2 = -2.0 * (want - np.array([rbt.lnprior(x) for x in pts])
                   + lognorm)
    assert np.all(np.abs(got - want) <= 5e-7 * chi2)
    for x, c2 in zip(pts[:2], chi2[:2]):
        assert abs(bt.lnposterior(x) - rbt.lnposterior(x)) <= 5e-7 * c2
    near = BayesianTiming(m, t.to_batch(device="cpu", model=m),
                          prior_info=info).lnposterior_batch(pts)
    assert np.all(np.abs(near - got) > 1.0)


def test_d_phase_d_toa_is_the_references(ngc):
    """The topocentric frequency from shifted copies of the host TOAs
    (their own batches, not the original's cached one), at the default
    step and at a given one."""
    m, t, rm, rt = _fresh(ngc)
    before = m.batch_of(t)
    F0 = m.value("F0")
    q = np.spacing(F0 * np.abs(m.delay(t).numpy()).max())
    for step in (None, 0.5):
        got = m.d_phase_d_toa(t, sample_step=step).numpy()
        want = np.asarray(rm.d_phase_d_toa(rt, sample_step=step))
        h = 2.0 / F0 if step is None else step
        bar = np.maximum(1e-11 * np.abs(want), 8 * q / (2 * h))
        assert np.all(np.abs(got - want) <= bar)
    assert m.batch_of(t) is before
    b = t.to_batch(device="cpu", model=m)
    assert torch.equal(m.d_phase_d_toa(b), m.d_phase_d_toa(t))


def test_the_model_keeps_no_host_toas_alive(ngc):
    """A batch of host TOAs is kept on those TOAs, not on the model:
    after the phase, the residuals and ``d_phase_d_toa`` of fresh TOAs,
    dropping them frees them and their batches; a deep copy or a pickle
    of the TOAs carries no batch."""
    import gc
    import pickle
    import weakref

    from pint_torch.residuals import Residuals

    m = ngc["m"].copy()
    ts = copy.deepcopy(ngc["t"])
    m.phase(ts)
    Residuals(ts, m).time_resids
    m.d_phase_d_toa(ts)
    assert m.batch_of(ts) is m.batch_of(ts)
    assert "_batches" not in copy.deepcopy(ts).__dict__
    assert "_batches" not in pickle.loads(pickle.dumps(ts)).__dict__
    gone, batch = weakref.ref(ts), weakref.ref(m.batch_of(ts))
    del ts
    gc.collect()
    assert gone() is None and batch() is None
    assert not any(isinstance(v, weakref.WeakKeyDictionary) and len(v)
                   for v in m._cache.values())


def test_tracking_phase_rehearses_on_the_cpu():
    """``chip_smoke._tracking_phase`` on ngc on the CPU (its plain kernel
    versions): the preflight and (a), (c), (d), (e), (h) on ngc against
    the committed ``ref/tracking/``, every bar held."""
    repo = os.path.dirname(HERE)
    if repo not in sys.path:
        sys.path.insert(0, repo)
    import chip_smoke
    from pint_torch import kernels

    counts, _, times = chip_smoke._tracking_phase(kernels, "[cpu]",
                                                  device="cpu", only=())
    assert "ngc WLS fit use_pulse_numbers" in times
    assert not any(counts.values())
