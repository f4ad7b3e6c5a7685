"""Faults C10 and C11 on the CPU: calls that bind as the reference's, the
narrowband GLS fitters' full-covariance path, and a settable
``TimingModel.free_params``.

* C10: ``inspect.signature`` of each function equals the reference's --
  names, kinds and defaults in order, the TOA argument's name aside (the
  port's ``batch``): ``build_grid_chi2_fn``, ``TimingModel.designmatrix``,
  ``GLSFitter.fit_toas``, ``DownhillGLSFitter.fit_toas``, the fitters'
  constructors and ``Fitter.auto``, the ``fit_toas`` of ``WLSFitter``,
  ``DownhillFitter`` and ``LMFitter``, and ``dd_sum``; a positional call of
  each held against the reference's on the same inputs (the grid's chi2 at
  the GLS grid bar of ``test_torch_sweep.py``, 1e-6 rel; the design
  matrix's columns at 1e-9 of each column's largest; the fits at the GLS
  bars of ``test_torch_fitters.py``: chi2 1e-6 rel,
  values 1e-2 sigma, uncertainties 1e-6 rel; ``dd_sum`` bitwise);
  ``full_cov=True`` on ``GLSFitter`` and ``DownhillGLSFitter`` against the
  reference's own full-covariance fits; ``residuals=`` taken as given,
  ``track_mode=`` and ``plan=`` refused naming their ROADMAP items;
* C11: setting ``free_params`` frees exactly the named parameters and
  freezes the rest as the reference's setter does, an unknown name raises
  ``UnknownParameter``, and a fit after the setter equals a fresh model's
  fit with the same free set (no cache keyed on the old set survives).
"""

import copy
import inspect
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import _torch_standin as standin  # noqa: E402

pytestmark = pytest.mark.torch

#: (reference qualified name, port qualified name) under their modules
PAIRS = [
    ("grid", "build_grid_chi2_fn"),
    ("models.timing_model", "TimingModel.designmatrix"),
    ("gls_fitter", "GLSFitter.fit_toas"),
    ("gls_fitter", "DownhillGLSFitter.fit_toas"),
    ("gls_fitter", "GLSFitter.__init__"),
    ("gls_fitter", "DownhillGLSFitter.__init__"),
    ("fitter", "Fitter.__init__"),
    ("fitter", "Fitter.auto"),
    ("fitter", "WLSFitter.__init__"),
    ("fitter", "WLSFitter.fit_toas"),
    ("fitter", "DownhillFitter.__init__"),
    ("fitter", "DownhillFitter.fit_toas"),
    ("fitter", "DownhillWLSFitter.__init__"),
    ("fitter", "LMFitter.__init__"),
    ("fitter", "LMFitter.fit_toas"),
    ("fitter", "PowellFitter.__init__"),
    ("dd", "dd_sum"),
]


def _resolve(pkg, module, qual):
    import importlib

    obj = importlib.import_module(f"{pkg}.{module}")
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


def _params(fn):
    return [("toas" if p.name == "batch" else p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("module,qual", PAIRS,
                         ids=[f"{m}.{q}" for m, q in PAIRS])
def test_signature_is_the_references(module, qual):
    """C10: the reference's parameters in its order, names, kinds and
    defaults."""
    assert _params(_resolve("pint_torch", module, qual)) \
        == _params(_resolve("pint_tpu", module, qual))


@pytest.fixture(scope="module")
def gls_pair():
    """(reference model, TOAs, port model, batch) of the small GLS
    stand-in (red noise, ECORR)."""
    return standin.port_and_reference(standin.SMALL_SETTINGS)


@pytest.fixture(scope="module")
def wls_pair():
    return standin.port_and_reference(standin.SMALL_ELL1_SETTINGS)


def _gaps(f, chi2, rf, rchi2):
    """(chi2 rel, values in sigma, uncertainties rel) of a port fit ``f``
    against the reference's fit ``rf``."""
    params = [p for p in rf.fitted_params if p != "Offset"]
    vals = np.array([f.model.value(p) for p in params])
    unc = np.array([f.model[p].uncertainty for p in params])
    rv = np.array([float(getattr(rf.model, p).value) for p in params])
    ru = np.array([float(getattr(rf.model, p).uncertainty) for p in params])
    return (abs(chi2 / rchi2 - 1), float(np.abs((vals - rv) / ru).max()),
            float(np.abs(unc / ru - 1).max()))


@pytest.mark.parametrize("cls", ["GLSFitter", "DownhillGLSFitter"])
def test_full_cov_fit_matches_the_references(gls_pair, cls):
    """``full_cov=True``, passed positionally where the reference takes it
    third (GLS) or second (downhill GLS): the dense-covariance fit at the
    GLS bars, and no noise amplitudes stored."""
    import pint_tpu.gls_fitter as R

    import pint_torch.gls_fitter as P

    model, toas, m, b = gls_pair
    rf, f = getattr(R, cls)(toas, model), getattr(P, cls)(b, m)
    if cls == "GLSFitter":
        rchi2, chi2 = rf.fit_toas(2, 0.0, True), f.fit_toas(2, 0.0, True)
    else:
        rchi2, chi2 = rf.fit_toas(20, True), f.fit_toas(20, True)
        assert f.full_cov and f.converged == rf.converged
    c, v, u = _gaps(f, chi2, rf, rchi2)
    assert c <= 1e-6 and v <= 1e-2 and u <= 1e-6, (c, v, u)
    assert f.noise_ampls == {}
    assert f.fitted_params == list(rf.fitted_params)
    # the Woodbury fit is not the dense one's: the path really changed
    woodbury = getattr(P, cls)(b, m)
    c2 = woodbury.fit_toas(2) if cls == "GLSFitter" else woodbury.fit_toas()
    assert woodbury.noise_ampls and abs(c2 / chi2 - 1) > 0


def test_gls_fit_refuses_plan_naming_item_9(gls_pair):
    from pint_torch.gls_fitter import GLSFitter

    _, _, m, b = gls_pair
    with pytest.raises(NotImplementedError, match="queue A item 9"):
        GLSFitter(b, m).fit_toas(plan="auto")


def test_fitter_takes_residuals_and_refuses_track_mode(wls_pair):
    from pint_torch.fitter import DownhillWLSFitter, Fitter, WLSFitter
    from pint_torch.gls_fitter import GLSFitter
    from pint_torch.residuals import Residuals

    _, _, m, b = wls_pair
    r = Residuals(b, m)
    f = WLSFitter(b, m, residuals=r)
    assert f.resids is r
    assert DownhillWLSFitter(b, m, residuals=None).resids is not r
    for cls in (Fitter, WLSFitter, DownhillWLSFitter, GLSFitter):
        with pytest.raises(NotImplementedError, match="item 10c"):
            cls(b, m, track_mode="nearest")
    assert type(Fitter.auto(b, m, residuals=r)) is DownhillWLSFitter


def test_wls_positional_debug_binds_as_the_reference(wls_pair):
    """``fit_toas(1, None, True)``: the third positional is ``debug`` in
    both packages (it was ``robust`` in the port)."""
    import pint_tpu.fitter as R

    import pint_torch.fitter as P

    model, toas, m, b = wls_pair
    rf, f = R.WLSFitter(toas, model), P.WLSFitter(b, m)
    rchi2, chi2 = rf.fit_toas(1, None, True), f.fit_toas(1, None, True)
    assert f.robust_weights is None
    c, v, u = _gaps(f, chi2, rf, rchi2)
    assert c <= 1e-6 and v <= 1e-2 and u <= 1e-6, (c, v, u)
    for cls in ("DownhillFitter", "LMFitter"):
        rf, f = getattr(R, cls)(toas, model), getattr(P, cls)(b, m)
        kw = dict(debug=True)
        rchi2, chi2 = rf.fit_toas(**kw), f.fit_toas(**kw)
        c, v, u = _gaps(f, chi2, rf, rchi2)
        assert c <= 1e-6 and v <= 1e-2 and u <= 1e-6, (cls, c, v, u)


def test_designmatrix_positional_incfrozen(gls_pair):
    """``designmatrix(t, True)``: frozen columns added (the reference's
    second positional), offset kept; ``(t, False, False)`` drops the
    offset in both.  On the small GLS stand-in: the ELL1 one's ecliptic
    astrometry has ``ECL`` (a string) among the continuous parameters, so
    the reference's own ``incfrozen=True`` raises ``ValueError`` there."""
    model, toas, m, b = gls_pair
    for args in ((True,), (False, False), (True, False)):
        Mr, nr, _ = model.designmatrix(toas, *args)
        Mp, n_p = m.designmatrix(b, *args)
        assert list(n_p) == list(nr), args
        Mp, Mr = Mp.numpy(), np.asarray(Mr)
        scale = np.maximum(np.abs(Mr).max(axis=0), 1e-300)
        assert np.all(np.abs(Mp - Mr) <= 1e-9 * scale), args
    frozen = [p for p in m.design_param_names(True)
              if p not in m.design_param_names()]
    assert frozen


def test_grid_builder_positional_grid_spans(gls_pair):
    """The sixth positional is ``grid_spans`` in both packages (``chunk``
    in the port before): the same chi2 at the same points."""
    import pint_tpu.grid as R

    import pint_torch.grid as P

    model, toas, m, b = gls_pair
    names = ("M2", "SINI")
    vals = np.array([[float(getattr(model, p).value) for p in names]])
    pts = vals + np.array([[0.0, 0.0], [0.01, -0.005]])
    spans = [0.02, 0.01]
    rfn, _, rfit = R.build_grid_chi2_fn(model, toas, names, None, 1, spans,
                                        2)
    pfn, _, pfit = P.build_grid_chi2_fn(m, b, names, None, 1, spans, 2)
    assert list(pfit) == list(rfit)
    want = np.asarray(rfn(pts)[0])
    got = np.asarray(pfn(pts)[0].cpu() if hasattr(pfn(pts)[0], "cpu")
                     else pfn(pts)[0])
    assert np.all(np.abs(got / want - 1) <= 1e-6), (got, want)


def test_dd_sum_positional_axis():
    import jax.numpy as jnp
    import torch

    import pint_tpu.dd as R
    import pint_torch.dd as P

    rng = np.random.default_rng(3)
    hi = rng.standard_normal((5, 7)) * 1e3
    lo = hi * 2.0 ** -60 * rng.standard_normal((5, 7))
    for axis in (None, 0, 1):
        r = R.dd_sum(R.DD(jnp.asarray(hi), jnp.asarray(lo)), axis)
        p = P.dd_sum(P.DD(torch.from_numpy(hi), torch.from_numpy(lo)), axis)
        assert np.array_equal(p.hi.numpy(), np.asarray(r.hi)), axis
        assert np.array_equal(p.lo.numpy(), np.asarray(r.lo)), axis


# ---------------------------------------------------------------------------
# C11: the free_params setter
# ---------------------------------------------------------------------------
def test_free_params_setter_frees_and_freezes_as_the_reference(wls_pair):
    from pint_tpu.exceptions import UnknownParameter as RUnknown

    from pint_torch.exceptions import UnknownParameter

    model, _, m, _ = wls_pair
    rm, pm = copy.deepcopy(model), m.copy()
    want = ["F0", "A1", "DMX_0002"] if "DMX_0002" in rm.params else \
        ["F0", "A1"]
    rm.free_params = want
    pm.free_params = want
    assert pm.free_params == rm.free_params
    assert sorted(pm.free_params) == sorted(want)
    pm.free_params = []
    rm.free_params = []
    assert pm.free_params == rm.free_params == []
    with pytest.raises(UnknownParameter, match="NOTAPARAM"):
        pm.free_params = ["F0", "NOTAPARAM"]
    with pytest.raises(RUnknown, match="NOTAPARAM"):
        rm.free_params = ["F0", "NOTAPARAM"]


def test_fit_after_setting_free_params_equals_a_fresh_models(wls_pair):
    """A model fitted once, its free set changed by the setter, then
    fitted again equals a fresh model given that free set: the design
    matrix and the grid's column caches were dropped."""
    from pint_torch.fitter import WLSFitter
    from pint_torch.grid import grid_chisq

    _, _, m, b = wls_pair
    used = m.copy()
    WLSFitter(b, used).fit_toas(1)
    used.designmatrix(b, reuse_linear=True)
    grid_chisq(WLSFitter(b, used), ("F0",),
               (np.array([used.value("F0")]),), niter=1)
    new = [p for p in used.free_params if p not in ("A1", "PB")]
    used.free_params = new
    fresh = m.copy()
    for p in fresh.free_params:
        fresh[p].frozen = p not in new
    assert used.free_params == fresh.free_params == new
    fa, fb = WLSFitter(b, used), WLSFitter(b, fresh)
    ca, cb = fa.fit_toas(2), fb.fit_toas(2)
    assert ca == cb
    assert fa.fitted_params == fb.fitted_params
    for p in new:
        assert fa.model.value(p) == fb.model.value(p), p
    Ma, na = used.designmatrix(b, reuse_linear=True)
    Mb, nb = fresh.designmatrix(b, reuse_linear=True)
    assert na == nb and bool((Ma == Mb).all())


@pytest.mark.parametrize("key", ["gls", "downhill"])
def test_full_cov_fits_match_the_committed_b1855_noise(key):
    """``ref/full_cov/`` of the full-width B1855+09-shaped noise stand-in
    (4005 TOAs, red noise and ECORR in the dense covariance): both
    fitters with ``full_cov=True`` at the GLS bars."""
    from pint_torch.bridge import NOISE_PATH, load_snapshot, read_snapshot
    from pint_torch.gls_fitter import DownhillGLSFitter, GLSFitter

    meta, ref = read_snapshot(NOISE_PATH)
    R = meta["reference"]["full_cov"]
    m, b = load_snapshot(NOISE_PATH, device="cpu")
    if key == "gls":
        f = GLSFitter(b, m)
        chi2 = f.fit_toas(maxiter=R["gls_maxiter"], full_cov=True)
    else:
        f = DownhillGLSFitter(b, m)
        chi2 = f.fit_toas(full_cov=True)
    r = R[key]
    assert f.converged == r["converged"]
    params = r["params"]
    assert [p for p in f.fitted_params if p != "Offset"] == params
    vals = np.array([f.model.value(p) for p in params])
    unc = np.array([f.model[p].uncertainty for p in params])
    sig = ref[f"ref/full_cov/{key}_uncertainties"]
    assert abs(chi2 / r["chi2"] - 1) <= 1e-6
    assert np.abs((vals - ref[f"ref/full_cov/{key}_values"]) / sig).max() \
        <= 1e-2
    assert np.abs(unc / sig - 1).max() <= 1e-6
