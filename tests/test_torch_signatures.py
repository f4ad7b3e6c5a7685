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
import torch

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
    # C12
    ("wideband", "WidebandTOAFitter.__init__"),
    ("wideband", "WidebandDownhillFitter.__init__"),
    ("wideband", "WidebandLMFitter.__init__"),
    ("wideband", "WidebandTOAFitter.fit_toas"),
    ("wideband", "WidebandTOAResiduals.__init__"),
    ("wideband", "WidebandDMResiduals.__init__"),
    ("residuals", "Residuals.__init__"),
    ("utils", "weighted_mean"),
    ("utils", "normalize_designmatrix"),
    ("integrity.quarantine", "run_toa_checks"),
    # the reading layer (ROADMAP A 10b)
    ("toa", "get_TOAs"), ("toa", "get_TOAs_list"), ("toa", "build_table"),
    ("toa", "read_toa_file"), ("toa", "load_pickle"), ("toa", "save_pickle"),
    ("toa", "merge_TOAs"), ("toa", "TOA.__init__"), ("toa", "TOAs.validate"),
    ("toa", "TOAs.get_clusters"), ("toa", "TOAs.adjust_TOAs"),
    ("toa", "TOAs.select"), ("toa", "TOAs.get_flag_value"),
    ("toa", "FlagDict.__init__"), ("io.par", "parse_parfile"),
    ("io.par", "format_parfile"), ("io.par", "fortran_float"),
    ("io.tim", "read_tim_file"), ("io.tim", "format_toa_line"),
    ("models.model_builder", "get_model_and_toas"),
    ("models.model_builder", "guess_binary_model"),
    ("models.model_builder", "convert_binary_params_dict"),
    ("models.model_builder", "ModelBuilder.choose_components"),
    ("models.tcb_conversion", "convert_tcb_tdb"),
    ("models.parameter", "parse_angle"), ("models.parameter", "format_angle"),
    ("models.parameter", "split_prefixed_name"),
    *[("models.parameter", f"{c}.__init__") for c in (
        "Parameter", "floatParameter", "MJDParameter", "AngleParameter",
        "prefixParameter", "maskParameter", "pairParameter",
        "funcParameter")],
    ("models.parameter", "maskParameter.select_toa_mask"),
    ("pulsar_mjd", "str_to_mjds"), ("pulsar_mjd", "mjds_to_str"),
    ("pulsar_mjd", "day_frac"), ("dd", "dd_from_string"),
    ("dd", "dd_from_longdouble"), ("integrity.diagnostics", "Diagnostics.add"),
    ("toa_select", "TOASelect.get_select_index"),
]

#: every public function or method with one qualified name in both
#: packages whose parameters still differ, with the reason: a trailing
#: ``device=None`` (the port's idiom) or the ROADMAP queue A item that
#: owns the difference
TRAILING_DEVICE = "trailing device="
ALLOWED = {
    "amortized.elbo:AmortizedVI.__init__": TRAILING_DEVICE,
    "amortized.flows:Flow.init": TRAILING_DEVICE,
    "amortized.posterior:AmortizedPosterior.load": TRAILING_DEVICE,
    "fftfit:fftfit_basic": TRAILING_DEVICE,
    "fftfit:fftfit_full": TRAILING_DEVICE,
    "orbital.kepler:kepler_2d": TRAILING_DEVICE,
    "orbital.kepler:kepler_3d": TRAILING_DEVICE,
    "orbital.kepler:kepler_two_body": TRAILING_DEVICE,
    "predict.cache:PredictorCache.__init__": TRAILING_DEVICE,
    "predict.generate:fit_windows": TRAILING_DEVICE,
    "predict.generate:generate_predictor_sets": TRAILING_DEVICE,
    "predict.generate:generate_predictors": TRAILING_DEVICE,
    "serving.batcher:FitRequest.__init__": TRAILING_DEVICE,
    "serving.batcher:ShapeBatcher.__init__": TRAILING_DEVICE,
    **{f"autotune:{f}": "8: autotune/search.py (the port's stubs raise "
       "naming item 8)" for f in (
           "autotune_workload", "chunk_ladder", "confirm_measured",
           "measured_from_sweep", "rank_grid_chunks", "tune_bucket_ladders",
           "tune_catalog_ladders", "tune_grid_chunk", "tune_plan_axes",
           "tune_plan_strategy", "tune_precision", "tune_solve_rung",
           "tune_update_blocks")},
    "grid:default_gls_chunk": "8: pint_torch.config's device policies "
                              "(device= for the reference's backend=)",
    "streaming.cache:StreamCache.__init__": "8: the warm pool (pool=)",
    "streaming.update:StreamingGLS.__init__": "8: the warm pool (pool=)",
    "models.timing_model:TimingModel.delay": "6f: delay(cutoff_component=, "
                                             "include_last=)",
    "models.timing_model:TimingModel.dm_designmatrix":
        "6f: dm_designmatrix(incfrozen=, incoffset=)",
    "models.astrometry:Astrometry.sun_angle": "6f: the host sun_angle",
    **{k: "6f: port-only trailing parameters with defaults" for k in (
        "catalog.likelihood:JointLikelihood.__init__",
        "noisefit:NoiseFitResult.__init__",
        "runtime.checkpoint:SweepCheckpoint.__init__",
        "runtime.checkpoint:checkpointed_map",
        "models.binary.components:BinaryBT.binary_delay",
        "models.absolute_phase:AbsPhase.get_TZR_toas")},
    **{f"models.binary.engines:{f}": "6f: the binary engines on the "
       "port's parameter dict (orbits through K2, K4, K6)" for f in (
           "bt_delay", "dd_delay", "ddk_corrections", "ell1_delay",
           "ell1_eps", "ell1_inverse_delay", "ell1_roemer_terms",
           "ell1h_delay", "ell1k_delay")},
    "models.model_builder:get_model": TRAILING_DEVICE,
    "catalog.ingest:ingest_catalog": TRAILING_DEVICE,
    # what stays of 10b: the port's structure, not a missing port
    "models.timing_model:Component.__init__": "10b: a port component "
        "holds the config its setup resolved and its per-TOA device "
        "context; the builder (Component.template) and the bridge pass "
        "them",
    "models.timing_model:TimingModel.__init__": "10b: the port's model is "
        "its parameter table and components on a device, built by "
        "get_model or the bridge, not filled by add_component",
    "toa:TOABatch.__init__": "10b: the port's batch is a dataclass of "
        "device tensors with its contexts, quarantine holder, host columns "
        "and host TOAs",
    "toa:TOAs.to_batch": "10b: the batch's device, the model whose "
        "contexts it carries and the TZR flag (the port builds the TZR row "
        "on the host)",
    "toa:TOAs.write_TOA_file": "10b: the default TOA name is the port's "
        "package name",
    "runtime.preflight:DeviceProfile.__init__": "B13: the profile records "
        "torch's version where the reference's records jax's",
    "runtime.preflight:device_profile": TRAILING_DEVICE,
    "runtime.preflight:check_device": TRAILING_DEVICE,
}


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


def _shared_differences():
    """``{"module:qualified name": (port params, reference params)}`` of
    every public function and method (constructors included) that both
    packages define under one module and qualified name and whose
    parameters differ in names, kinds, defaults or order (the port's
    ``batch`` read as ``toas``; a function or class default compared by
    name, NaN equal to NaN)."""
    import importlib
    import pkgutil

    import pint_torch
    import pint_tpu

    def names(pkg):
        return {mi.name[len(pkg.__name__) + 1:]: mi.name
                for mi in pkgutil.walk_packages(pkg.__path__,
                                                pkg.__name__ + ".")}

    def same_default(x, y):
        if isinstance(x, float) and isinstance(y, float) and x != x \
                and y != y:
            return True
        if callable(x) and callable(y) and hasattr(x, "__name__") \
                and hasattr(y, "__name__"):
            return x.__name__ == y.__name__
        try:
            return bool(x == y)
        except Exception:
            return x is y

    def same(pa, pb):
        return len(pa) == len(pb) and all(
            x[:2] == y[:2] and same_default(x[2], y[2])
            for x, y in zip(pa, pb))

    port, ref = names(pint_torch), names(pint_tpu)
    out = {}
    for mod in sorted(set(port) & set(ref)):
        t = importlib.import_module(port[mod])
        r = importlib.import_module(ref[mod])
        for attr in sorted(vars(t)):
            to, ro = getattr(t, attr), getattr(r, attr, None)
            if attr.startswith("_") or ro is None \
                    or getattr(to, "__module__", None) != t.__name__:
                continue
            pairs = []
            if inspect.isfunction(to) and inspect.isfunction(ro):
                pairs.append((attr, to, ro))
            elif inspect.isclass(to) and inspect.isclass(ro):
                for meth in sorted(vars(to)):
                    if meth.startswith("_") and meth != "__init__":
                        continue
                    if inspect.getattr_static(ro, meth, None) is None \
                            or isinstance(inspect.getattr_static(to, meth),
                                          property) \
                            or isinstance(inspect.getattr_static(ro, meth),
                                          property):
                        continue
                    tf, rf = getattr(to, meth), getattr(ro, meth)
                    if callable(tf) and callable(rf):
                        pairs.append((f"{attr}.{meth}", tf, rf))
            for qual, tf, rf in pairs:
                try:
                    pa, pb = _params(tf), _params(rf)
                except (TypeError, ValueError):
                    continue
                if not same(pa, pb):
                    out[f"{mod}:{qual}"] = (pa, pb)
    return out


def test_every_shared_signature_is_the_references_or_allowed():
    """C12's guard: every public signature the two packages share is the
    reference's, or its difference is in :data:`ALLOWED` with its reason:
    a trailing ``device=None`` (then exactly the reference's parameters
    and that one), or the ROADMAP item that owns it (queue A 6f, 8, 10b,
    queue B 13).  A new difference fails, and so does an entry no longer
    needed."""
    import re

    diffs = _shared_differences()
    new = sorted(set(diffs) - set(ALLOWED))
    assert not new, f"signatures that differ from the reference's: {new}"
    stale = sorted(set(ALLOWED) - set(diffs))
    assert not stale, f"allowed differences that are gone: {stale}"
    for key, why in ALLOWED.items():
        pa, pb = diffs[key]
        if why == TRAILING_DEVICE:
            assert pa[:-1] == pb and pa[-1][0] == "device" \
                and pa[-1][2] is None, key
        else:
            assert re.match(r"(6f|8|10b|B13)\b", why), (key, why)


@pytest.fixture(scope="module")
def wb_pair():
    """(reference model, TOAs, port model, batch) of the small wideband
    stand-in (80 TOAs with DMs, DMJUMP, DMEFAC/DMEQUAD)."""
    return standin.port_and_reference(standin.SMALL_WB_SETTINGS)


@pytest.mark.parametrize("args", [{"subtract_mean": True},
                                  {"subtract_mean": True,
                                   "use_weighted_mean": False}],
                         ids=["weighted", "plain"])
def test_dm_resid_args_reach_the_dm_residuals(wb_pair, args):
    """``WidebandTOAResiduals(dm_resid_args=)`` and the fitters'
    ``additional_args={"dm": ...}``: the DM residuals less their mean as
    the reference's, within the wideband DM bar (1e-12 pc/cm^3); the mean really
    went."""
    import pint_tpu.wideband as R

    import pint_torch.wideband as P

    model, toas, m, b = wb_pair
    want = np.asarray(R.WidebandTOAResiduals(
        toas, model, dm_resid_args=args).dm.resids)
    got = P.WidebandTOAResiduals(b, m, dm_resid_args=args).dm.resids.numpy()
    assert np.abs(got - want).max() <= 1e-12
    plain = P.WidebandTOAResiduals(b, m).dm.resids.numpy()
    assert np.abs(got - plain).max() > 1e-9
    f = P.WidebandTOAFitter(b, m, additional_args={"dm": dict(args)})
    rf = R.WidebandTOAFitter(toas, model, additional_args={"dm": dict(args)})
    assert np.abs(f.resids.dm.resids.numpy()
                  - np.asarray(rf.resids.dm.resids)).max() <= 1e-12
    toa_args = {"subtract_mean": False}
    f = P.WidebandTOAFitter(b, m, None, {"toa": toa_args})
    rf = R.WidebandTOAFitter(toas, model, None, {"toa": toa_args})
    assert not f.resids.toa.subtract_mean
    assert np.abs(f.resids.toa.time_resids.numpy()
                  - np.asarray(rf.resids.toa.time_resids)).max() <= 1e-10


def test_weighted_mean_along_an_axis_is_the_references_bitwise():
    """``weighted_mean(axis=)`` on seeded (6, 9) inputs: bitwise the
    reference's along either axis (sums in index order, as XLA's CPU code
    takes an axis this short); over every element within 1e-13 rel (the
    order of a whole-array sum differs); ``normalize_designmatrix(params=)``
    unchanged by its unused argument."""
    import jax.numpy as jnp
    import torch

    import pint_tpu.utils as R
    import pint_torch.utils as P

    rng = np.random.default_rng(12)
    arr = rng.standard_normal((6, 9)) * 1e-6
    w = rng.uniform(0.5, 2.0, size=(6, 9)) * 1e12
    for axis in (0, 1):
        rm, re_ = R.weighted_mean(jnp.asarray(arr), jnp.asarray(w), axis)
        pm, pe = P.weighted_mean(torch.from_numpy(arr), torch.from_numpy(w),
                                 axis=axis)
        assert np.array_equal(pm.numpy(), np.asarray(rm)), axis
        assert np.array_equal(pe.numpy(), np.asarray(re_)), axis
    rm, re_ = R.weighted_mean(jnp.asarray(arr), jnp.asarray(w))
    pm, pe = P.weighted_mean(torch.from_numpy(arr), torch.from_numpy(w))
    assert abs(float(pm) / float(rm) - 1) <= 1e-13
    assert abs(float(pe) / float(re_) - 1) <= 1e-13
    assert P.weighted_mean(torch.from_numpy(arr), torch.from_numpy(w),
                           0)[0].shape == (9,)
    M = torch.from_numpy(arr)
    a, na = P.normalize_designmatrix(M, ["x"] * 9)
    b, nb = P.normalize_designmatrix(M)
    assert torch.equal(a, b) and torch.equal(na, nb)


def test_wideband_fit_toas_positional_debug():
    """``fit_toas(maxiter, 0.0, False, True)``: the fourth positional is
    ``debug`` in both packages, taken and unused: the committed small
    wideband snapshot's ``WidebandTOAFitter.fit_toas(maxiter=2)`` at the
    wideband fit bars of ``test_torch_wideband.py`` (chi2 1e-6 rel, values
    1e-2 sigma, uncertainties 1e-6 rel)."""
    from pint_torch.bridge import WB_SMALL_PATH, load_snapshot, read_snapshot
    from pint_torch.wideband import WidebandTOAFitter

    meta, ref = read_snapshot(WB_SMALL_PATH)
    rr = meta["reference"]
    m, b = load_snapshot(WB_SMALL_PATH, device="cpu")
    f = WidebandTOAFitter(b, m)
    chi2 = f.fit_toas(rr["settings"]["fit_maxiter"], 0.0, False, True)
    params = rr["postfit_params"]
    vals = np.array([f.model.value(p) for p in params])
    unc = np.array([f.model[p].uncertainty for p in params])
    sig = ref["ref/postfit_uncertainties"]
    assert abs(chi2 / rr["postfit_chi2"] - 1) <= 1e-6
    assert np.abs((vals - ref["ref/postfit_values"]) / sig).max() <= 1e-2
    assert np.abs(unc / sig - 1).max() <= 1e-6


def test_track_mode_reaches_the_wideband_toa_residuals(wb_pair):
    """``track_mode`` (positional or through ``additional_args`` and
    ``toa_resid_args``) reaches the wideband fitters' TOA residuals: None
    resolves to ``nearest`` without pulse numbers, and under
    ``use_pulse_numbers`` with the TOAs' pulse numbers computed the
    residuals are the reference's (the TOA bar, 1e-10 s)."""
    from pint_torch.exceptions import UsageError
    from pint_torch.residuals import Residuals
    from pint_torch.wideband import (WidebandDownhillFitter,
                                     WidebandLMFitter, WidebandTOAFitter,
                                     WidebandTOAResiduals)
    from pint_tpu.wideband import WidebandTOAFitter as RW

    model, toas, m, b = wb_pair
    assert Residuals(b, m, track_mode=None).track_mode == "nearest"
    assert Residuals(b, m, True, True, "nearest").track_mode == "nearest"
    with pytest.raises(UsageError):
        Residuals(b, m, track_mode="use_pulse_numbers").calc_phase_resids()
    try:
        b.compute_pulse_numbers(m)
        toas.compute_pulse_numbers(model)
        want = np.asarray(RW(toas, model, "use_pulse_numbers")
                          .resids.toa.time_resids)
        for cls in (WidebandTOAFitter, WidebandDownhillFitter,
                    WidebandLMFitter):
            for f in (cls(b, m, "use_pulse_numbers"),
                      cls(b, m, additional_args={
                          "toa": {"track_mode": "use_pulse_numbers"}})):
                assert f.resids.toa.track_mode == "use_pulse_numbers"
                got = f.resids.toa.time_resids.numpy()
                assert np.abs(got - want).max() <= 1e-10
        r = WidebandTOAResiduals(b, m,
                                 toa_resid_args={"track_mode": "nearest"})
        assert r.toa.track_mode == "nearest"
    finally:
        b.remove_pulse_numbers()
        toas.pulse_number = None


def test_run_toa_checks_checks_the_named_ephemeris(wb_pair, monkeypatch):
    """``run_toa_checks(ephem=)``: the coverage of the named ephemeris (a
    stand-in span that cuts the TOAs' on both sides, patched into each
    package's ``load_ephemeris``) gives the reference's findings; one that
    does not load gives none in either; without it the batch's own."""
    import pint_tpu.ephemeris as RE
    import pint_tpu.integrity.quarantine as RQ

    import pint_torch.ephemeris as PE
    import pint_torch.integrity.quarantine as PQ

    _, toas, _, b = wb_pair
    mjd = np.asarray(toas.utc_mjd, dtype=np.float64)
    lo, hi = np.quantile(mjd, [0.2, 0.7])

    class Span:
        def coverage_mjd(self):
            return float(lo), float(hi)

    def load(name="DE440"):
        if name != "DE_SPAN":
            raise FileNotFoundError(name)
        return Span()

    monkeypatch.setattr(RE, "load_ephemeris", load)
    monkeypatch.setattr(PE, "load_ephemeris", load)

    def rows(report):
        return [(f.index, f.code, f.message) for f in report.findings]

    want = rows(RQ.run_toa_checks(toas, ephem="DE_SPAN"))
    got = rows(PQ.run_toa_checks(b, True, 1e9, "DE_SPAN"))
    assert got == want and any(c == "toa-ephem-coverage" for _, c, _ in got)
    assert rows(PQ.run_toa_checks(b, ephem="DE_NONE")) \
        == rows(RQ.run_toa_checks(toas, ephem="DE_NONE"))
    assert not any(c == "toa-ephem-coverage"
                   for _, c, _ in rows(PQ.run_toa_checks(b)))


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


def test_fitter_takes_residuals_and_track_mode(wls_pair):
    """``residuals=`` are the fitter's first residuals; ``track_mode``
    reaches every fitter's residuals (``nearest`` equal to the default's
    without pulse numbers)."""
    from pint_torch.fitter import DownhillWLSFitter, Fitter, WLSFitter
    from pint_torch.gls_fitter import GLSFitter
    from pint_torch.residuals import Residuals

    _, _, m, b = wls_pair
    r = Residuals(b, m)
    f = WLSFitter(b, m, residuals=r)
    assert f.resids is r
    assert DownhillWLSFitter(b, m, residuals=None).resids is not r
    for cls in (Fitter, WLSFitter, DownhillWLSFitter, GLSFitter):
        f = cls(b, m, track_mode="nearest")
        assert f.track_mode == f.resids.track_mode == "nearest"
        assert torch.equal(f.resids.time_resids, r.time_resids)
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
