"""Model editing in the port against the JAX package on the CPU: the
par-file writer in its three dialects and ``compare``, ``setup``, adding
and removing parameters and components, the components' editing methods
(DMX and SWX windows, WaveX terms, jumps and their flags, POSEPOCH), the
TZR TOA, and ``Fitter.ftest``'s add and remove forms; after each edit a
fit equals the reference's fit of the same edited model and the port's
fit of a model built fresh from the edited par text.

Inputs: the small GLS stand-in written as par and tim files (80 TOAs: DD
binary, three DMX windows, a JUMP, EFAC/EQUAD/ECORR per backend, red
noise) and read by each package, ngc's committed files (62 TOAs, WLS),
and the small ELL1 and PTA stand-ins from their exported state.  Bars:
par text and ``compare`` text equal line by line (but the creator line),
residuals of a model read back from its own par text bitwise, fits chi2
1e-6 rel, values within 1e-2 of their uncertainties, uncertainties 1e-6
rel (the repo's fit bars); ``ftest``'s p-value 1e-6 rel, the refit's
chi2 1e-6 rel and its dof exact.
"""

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

DIALECTS = ("pint", "tempo", "tempo2")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{name: (par path, tim path)}: the small GLS stand-in written by the
    reference's writer, and ngc's committed files."""
    from pint_torch.bridge import NGC_PATH, standin_files

    d = tmp_path_factory.mktemp("small")
    model, toas = standin.make_standin(standin.SMALL_SETTINGS, full=False)
    par, tim = d / "small.par", d / "small.tim"
    par.write_text(standin.standin_par_text(standin.SMALL_SETTINGS, False))
    toas.write_TOA_file(str(tim))
    return {"small": (str(par), str(tim)),
            "ngc": tuple(map(str, standin_files(NGC_PATH)))}


def _read(files, name):
    """(port model, port host TOAs, reference model, reference TOAs)."""
    from pint_torch.models import get_model_and_toas
    from pint_tpu.models import get_model_and_toas as rget

    par, tim = files[name]
    m, t = get_model_and_toas(par, tim, device="cpu")
    rm, rt = rget(par, tim)
    return m, t, rm, rt


def _lines(text):
    return text.splitlines()[1:]


def _fit_bars(f, rf, chi2, rchi2):
    assert abs(chi2 / rchi2 - 1) <= 1e-6
    for p in rf.model.free_params:
        sig = float(getattr(rf.model, p).uncertainty)
        assert abs(f.model.value(p) - float(getattr(rf.model, p).value)) \
            <= 1e-2 * sig, p
        assert abs(f.model[p].uncertainty / sig - 1) <= 1e-6, p


def _fit(m, t, rm, rt, maxiter=2):
    """Both packages' one-shot fit (GLS with correlated noise, else WLS)
    of the models on their TOAs; the port's on a batch made before any
    later edit is fine (its contexts are made again)."""
    import pint_torch.fitter as P
    import pint_torch.gls_fitter as PG
    import pint_tpu.fitter as R
    import pint_tpu.gls_fitter as RG

    if rm.has_correlated_errors:
        f, rf = PG.GLSFitter(t, m), RG.GLSFitter(rt, rm)
    else:
        f, rf = P.WLSFitter(t, m), R.WLSFitter(rt, rm)
    return f, rf, f.fit_toas(maxiter=maxiter), rf.fit_toas(maxiter=maxiter)


def _fresh_fit(m, t, maxiter=2):
    """The port's fit of a model read fresh from ``m``'s par text."""
    from pint_torch.models import get_model
    import pint_torch.fitter as P
    import pint_torch.gls_fitter as PG

    m2 = get_model(m.as_parfile(), device="cpu")
    cls = PG.GLSFitter if m2.has_correlated_errors else P.WLSFitter
    f = cls(t.to_batch(device="cpu", model=m2), m2)
    return f, f.fit_toas(maxiter=maxiter)


def _same_fit(f, g, chi2, chi2_g):
    """Two port fits of one model: the same chi2, values and
    uncertainties bitwise."""
    assert chi2 == chi2_g
    assert f.model.free_params == g.model.free_params
    for p in f.model.free_params:
        assert f.model[p].value == g.model[p].value, p
        assert f.model[p].uncertainty == g.model[p].uncertainty, p


@pytest.mark.parametrize("name", ["small", "ngc", "snapshot"])
def test_as_parfile_is_the_references(files, name):
    """Each dialect's text line by line the reference's (the creator line
    aside), for models read from par files and one loaded from a
    snapshot; ``write_parfile`` writes it."""
    if name == "snapshot":
        rm, _, m, _ = standin.port_and_reference(standin.SMALL_ELL1_SETTINGS)
    else:
        m, _, rm, _ = _read(files, name)
    for fmt in DIALECTS:
        assert _lines(m.as_parfile(format=fmt)) \
            == _lines(rm.as_parfile(format=fmt)), fmt
    assert m.as_parfile(comment="x").splitlines()[0] == "# x"


@pytest.mark.parametrize("name", ["small", "ngc"])
def test_par_text_reads_back_to_bitwise_residuals(files, name, tmp_path):
    """A model read back from its own par text (each dialect the port
    reads, and through ``write_parfile``) gives its residuals bitwise."""
    from pint_torch.models import get_model
    from pint_torch.residuals import Residuals

    m, t, _, _ = _read(files, name)
    want = Residuals(t, m).time_resids
    path = tmp_path / "w.par"
    m.write_parfile(str(path))
    for text in (m.as_parfile(), path.read_text()):
        m2 = get_model(text, device="cpu")
        got = Residuals(t.to_batch(device="cpu", model=m2), m2).time_resids
        assert torch.equal(got, want)


def test_compare_is_the_references(files):
    """``compare`` of the file's model against it with the reference's
    fitted values and uncertainties, in each verbosity and with
    ``nodmx``: the reference's text."""
    m, t, rm, rt = _read(files, "small")
    _, rf, _, _ = _fit(m, t, rm, rt)
    m2 = m.copy()
    for p in rf.model.free_params:
        m2[p].value = float(getattr(rf.model, p).value)
        m2[p].uncertainty = float(getattr(rf.model, p).uncertainty)
    for kw in ({}, {"verbosity": "med"}, {"verbosity": "min"},
               {"verbosity": "check"}, {"nodmx": True},
               {"threshold_sigma": 0.5}):
        assert m.compare(m2, **kw) == rm.compare(rf.model, **kw), kw
        assert m2.compare(m, **kw) == rf.model.compare(rm, **kw), kw


def test_remove_dmx_range_fits_as_the_reference_and_a_fresh_model(files):
    """Two of the three DMX windows removed: the GLS fit (on a batch made
    before the edit) is the reference's of its edited model and bitwise
    the port's fit of the edited par text read fresh; an index not in the
    model raises ``ValueError`` in both.  (Window 1 stays: either
    package's reader declares DMX_0001 and needs its range.)"""
    m, t, rm, rt = _read(files, "small")
    b = t.to_batch(device="cpu", model=m)
    for mm in (m, rm):
        mm.components["DispersionDMX"].remove_DMX_range([2, 3])
        with pytest.raises(ValueError):
            mm.components["DispersionDMX"].remove_DMX_range(7)
    assert m.params == rm.params
    assert _lines(m.as_parfile()) == _lines(rm.as_parfile())
    f, rf, chi2, rchi2 = _fit(m, b, rm, rt)
    _fit_bars(f, rf, chi2, rchi2)
    g, chi2_g = _fresh_fit(m, t)
    _same_fit(f, g, chi2, chi2_g)


def test_edit_fit_then_grid_equals_a_fresh_model(files):
    """Edit (a DMX window removed), fit, then a 2 x 2 grid: the surface
    bitwise the fresh model's (no cached contexts, linear columns or
    bundles of the model before the edit survive)."""
    import pint_torch.gls_fitter as PG
    from pint_torch.grid import grid_chisq

    m, t, _, _ = _read(files, "small")
    f0 = PG.GLSFitter(t, m)
    f0.fit_toas(maxiter=2)
    grid_chisq(f0, ("M2", "SINI"), [[0.3, 0.31], [0.95, 0.96]], niter=1)
    m.components["DispersionDMX"].remove_DMX_range(2)
    f = PG.GLSFitter(t, m)
    chi2 = f.fit_toas(maxiter=2)
    g, chi2_g = _fresh_fit(m, t)
    _same_fit(f, g, chi2, chi2_g)
    axes = [[0.3, 0.31], [0.95, 0.96]]
    s1, _ = grid_chisq(f, ("M2", "SINI"), axes, niter=1)
    s2, _ = grid_chisq(g, ("M2", "SINI"), axes, niter=1)
    assert np.array_equal(np.asarray(s1), np.asarray(s2))


def test_add_wavex_components_fits_as_the_reference(files):
    """A WaveX component added to ngc (three terms, amplitudes free): the
    parameters and the WLS fit as the reference's, and the fit bitwise a
    fresh model's."""
    from pint_torch.models.wavex import WaveX
    from pint_tpu.models.wavex import WaveX as RWaveX

    m, t, rm, rt = _read(files, "ngc")
    m.add_component(WaveX.template(), validate=False)
    rm.add_component(RWaveX(), validate=False)
    freqs = [1.0 / 400.0, 1.0 / 250.0, 1.0 / 150.0]
    m["WXEPOCH"].value = m["PEPOCH"].value
    rm.WXEPOCH.value = rm.PEPOCH.value
    got = m.components["WaveX"].add_wavex_components(
        freqs, indices=[1, 2, 3], frozens=False)
    want = rm.components["WaveX"].add_wavex_components(
        freqs, indices=[1, 2, 3], frozens=False)
    assert got == want and m.params == rm.params
    assert m.free_params == rm.free_params
    assert list(m.components["WaveX"].get_indices()) \
        == list(rm.components["WaveX"].get_indices())
    f, rf, chi2, rchi2 = _fit(m, t, rm, rt, maxiter=3)
    _fit_bars(f, rf, chi2, rchi2)
    g, chi2_g = _fresh_fit(m, t, maxiter=3)
    _same_fit(f, g, chi2, chi2_g)
    for mm in (m, rm):
        mm.components["WaveX"].remove_wavex_component(2)
        with pytest.raises(ValueError):
            mm.components["WaveX"].remove_wavex_component([1, 3])
    assert m.params == rm.params


@pytest.mark.parametrize("cls", ["DMWaveX", "CMWaveX"])
def test_dm_and_cm_wavex_terms_as_the_references(files, cls):
    """DMWaveX's and CMWaveX's add and remove methods leave the
    reference's parameters and par text."""
    import pint_torch.models.wavex as P
    import pint_tpu.models.wavex as R

    m, _, rm, _ = _read(files, "ngc")
    low = cls.lower()
    m.add_component(getattr(P, cls).template(), validate=False)
    rm.add_component(getattr(R, cls)(), validate=False)
    for mm, comp in ((m, m.components[cls]), (rm, rm.components[cls])):
        getattr(comp, f"add_{low}_component")(1.0 / 300.0, index=1)
        getattr(comp, f"add_{low}_components")([1.0 / 200.0, 1.0 / 90.0])
        getattr(comp, f"remove_{low}_component")(2)
    assert m.params == rm.params
    assert _lines(m.as_parfile()) == _lines(rm.as_parfile())


def test_jump_editing_leaves_the_references_flags_and_parameters(files):
    """``jump_params_to_flags``, ``add_jump_and_flags`` (a reused JUMP1 and
    a new one), ``delete_not_all_jump_toas``, ``get_number_of_jumps``,
    ``delete_jump_and_flags`` and ``jump_flags_to_params``: after each the
    TOAs' flags and the jump parameters (selection, value, frozen) are the
    reference's."""
    m, t, rm, rt = _read(files, "small")

    def same():
        assert t.flags == rt.flags
        assert m.params == rm.params
        for p in rm.params:
            if p.startswith("JUMP"):
                rp, pp = getattr(rm, p), m[p]
                assert (pp.key, pp.key_value, pp.value, pp.frozen) \
                    == (rp.key, [str(v) for v in rp.key_value],
                        rp.value, rp.frozen), p

    pj, rpj = m.components["PhaseJump"], rm.components["PhaseJump"]
    pj.jump_params_to_flags(t)
    rpj.jump_params_to_flags(rt)
    same()
    sel = [3, 4, 5, 40]
    assert pj.add_jump_and_flags([t.flags[i] for i in sel], value=1e-4) \
        == rpj.add_jump_and_flags([rt.flags[i] for i in sel], value=1e-4)
    same()
    assert pj.get_number_of_jumps() == rpj.get_number_of_jumps() == 2
    pj.delete_not_all_jump_toas([t.flags[3]], 1)
    rpj.delete_not_all_jump_toas([rt.flags[3]], 1)
    same()
    m.delete_jump_and_flags(t, 1)
    rm.delete_jump_and_flags(rt, 1)
    same()
    for tt in (t, rt):
        for i in (10, 11, 12):
            tt.flags[i]["gui_jump"] = "3"
    m.jump_flags_to_params(t)
    rm.jump_flags_to_params(rt)
    same()
    f, rf, chi2, rchi2 = _fit(m, t, rm, rt)
    _fit_bars(f, rf, chi2, rchi2)


def test_parameters_and_components_edit_as_the_references(files):
    """``remove_param``, ``add_param_from_top`` (a component's and the
    model's own), ``remove_component``, ``add_component``, ``setup`` and
    ``validate_toas``: the reference's parameters, free parameters and
    residuals."""
    from pint_torch.models.parameter import floatParameter, prefixParameter
    from pint_torch.residuals import Residuals
    from pint_tpu.models.parameter import floatParameter as RFloat
    from pint_tpu.models.parameter import prefixParameter as RPrefix
    from pint_tpu.residuals import Residuals as RR

    m, t, rm, rt = _read(files, "small")
    for mm, Pre, Flt in ((m, prefixParameter, floatParameter),
                         (rm, RPrefix, RFloat)):
        mm.remove_param("FD2")
        mm.add_param_from_top(Pre("F2", value=1e-27, frozen=False,
                                  units="Hz/s^2"), "Spindown", setup=True)
        mm.add_param_from_top(Flt("XTRA", value=1.5), "")
        mm.remove_component("BinaryDD")
        mm.setup()
        mm.validate_toas(t if mm is m else rt)
        with pytest.raises(AttributeError):
            mm.remove_param("NOPE")
    assert m.params == rm.params and m.free_params == rm.free_params
    got = Residuals(t, m).time_resids.numpy()
    assert np.abs(got - np.asarray(RR(rt, rm).time_resids)).max() <= 1e-10
    from pint_torch.models.binary.components import BinaryDD
    from pint_tpu.models.binary.components import BinaryDD as RDD

    m2, _, rm2, _ = _read(files, "small")
    m.add_component(m2.components["BinaryDD"])
    rm.add_component(rm2.components["BinaryDD"])
    assert m.params == rm.params
    got = Residuals(t, m).time_resids.numpy()
    assert np.abs(got - np.asarray(RR(rt, rm).time_resids)).max() <= 1e-10
    assert BinaryDD.__name__ == RDD.__name__


def test_empty_masks_and_the_tzr_toa_as_the_references(files):
    """``find_empty_masks`` (a JUMP over no TOA found and frozen) and
    ``add_tzr_toa`` (the small stand-in has no TZR): the reference's names,
    TZR parameters and absolute-phase residuals."""
    from pint_torch.models.parameter import maskParameter
    from pint_torch.residuals import Residuals
    from pint_tpu.models.parameter import maskParameter as RMask
    from pint_tpu.residuals import Residuals as RR

    m, t, rm, rt = _read(files, "small")
    m.components["PhaseJump"].add_param(maskParameter(
        "JUMP", index=5, key="-fe", key_value=["nowhere"], value=0.0,
        frozen=False), setup=True)
    rm.components["PhaseJump"].add_param(RMask(
        "JUMP", index=5, key="-fe", key_value=["nowhere"], value=0.0,
        frozen=False), setup=True)
    rm.setup()
    assert m.find_empty_masks(t) == rm.find_empty_masks(rt) == ["JUMP5"]
    assert m.find_empty_masks(t, freeze=True) \
        == rm.find_empty_masks(rt, freeze=True)
    assert m.free_params == rm.free_params
    m.add_tzr_toa(t)
    rm.add_tzr_toa(rt)
    for p in ("TZRMJD", "TZRSITE", "TZRFRQ"):
        assert float(m.epoch_value(p) if p == "TZRMJD" else 0) \
            == float(getattr(rm, p).value if p == "TZRMJD" else 0)
        if p != "TZRMJD":
            assert m[p].value == getattr(rm, p).value
    got = Residuals(t, m).time_resids.numpy()
    assert np.abs(got - np.asarray(RR(rt, rm).time_resids)).max() <= 1e-10


@pytest.mark.parametrize("which", ["equatorial", "ecliptic"])
def test_change_posepoch_as_the_reference(files, which):
    """POSEPOCH moved 500 d: the position advanced along the proper
    motion as the reference's does, bitwise."""
    if which == "equatorial":
        m, _, rm, _ = _read(files, "small")
        names = ("RAJ", "DECJ", "PMRA", "PMDEC")
        comp = "AstrometryEquatorial"
    else:
        rm, _, m, _ = standin.port_and_reference(standin.SMALL_ELL1_SETTINGS)
        names = ("ELONG", "ELAT", "PMELONG", "PMELAT")
        comp = "AstrometryEcliptic"
    pe = 55000.0
    for mm in (m, rm):
        if mm is m:
            mm[names[2]].value, mm[names[3]].value = 3.5, -7.25
            if mm["POSEPOCH"].value is None:
                mm["POSEPOCH"].value = (pe, 0.0)
        else:
            getattr(mm, names[2]).value = 3.5
            getattr(mm, names[3]).value = -7.25
            if mm.POSEPOCH.value is None:
                mm.POSEPOCH.value = np.longdouble(pe)
    new = float(m.epoch_value("POSEPOCH")) + 500.0
    m.components[comp].change_posepoch(new)
    rm.components[comp].change_posepoch(new)
    for p in names[:2]:
        assert m[p].value == float(getattr(rm, p).value), p
    assert m.epoch_value("POSEPOCH") == float(rm.POSEPOCH.value)


def test_remove_swx_range_as_the_reference(files):
    """A SWX window removed from the small stand-in with two SWX windows
    added to its par text: the reference's parameters and par text."""
    from pint_torch.models import get_model
    from pint_tpu.models import get_model as rget

    text = open(files["small"][0]).read() + "".join(
        f"SWXDM_000{i} {0.5 * i} 1\nSWXP_000{i} 2.0\n"
        f"SWXR1_000{i} {54000 + 600 * i}\nSWXR2_000{i} {54600 + 600 * i}\n"
        for i in (1, 2))
    m, rm = get_model(text, device="cpu"), rget(text)
    for mm in (m, rm):
        mm.components["SolarWindDispersionX"].remove_swx_range(1)
        with pytest.raises(ValueError):
            mm.components["SolarWindDispersionX"].remove_swx_range(9)
    assert m.params == rm.params
    assert _lines(m.as_parfile()) == _lines(rm.as_parfile())


@pytest.mark.parametrize("name", ["small", "ngc"])
def test_ftest_add_and_remove_as_the_references(files, name):
    """``ftest`` adding F2 to Spindown and removing a free parameter, on
    the GLS (small) and the WLS (ngc) fits: the p-value, the refit's chi2
    and rms as the reference's, dof exact; the two-number form too."""
    from pint_torch.models.parameter import prefixParameter
    from pint_tpu.models.parameter import prefixParameter as RPrefix

    m, t, rm, rt = _read(files, name)
    f, rf, _, _ = _fit(m, t, rm, rt)
    drop = "FD2" if name == "small" else "F1"
    outs = [f.ftest(prefixParameter("F2", value=0.0, units="Hz/s^2"),
                    "Spindown", full_output=True),
            f.ftest(f.model[drop], None, remove=True, full_output=True)]
    routs = [rf.ftest(RPrefix("F2", value=0.0, units="Hz/s^2"),
                      "Spindown", full_output=True),
             rf.ftest(getattr(rf.model, drop), None, remove=True,
                      full_output=True)]
    for got, want in zip(outs, routs):
        if want["ft"] > 1e-12:
            assert abs(got["ft"] / want["ft"] - 1) <= 1e-6
        assert abs(got["chi2_test"] / want["chi2_test"] - 1) <= 1e-6
        assert abs(got["resid_rms_test"] / want["resid_rms_test"] - 1) \
            <= 1e-6
        assert got["dof_test"] == want["dof_test"]
    assert abs(f.ftest(rf.resids.chi2 * 1.1, rf.resids.dof - 1)
               / rf.ftest(rf.resids.chi2 * 1.1, rf.resids.dof - 1) - 1) \
        <= 1e-6


def test_snapshot_context_after_an_edit_is_refused():
    """A snapshot's model carries its contexts but no host TOAs: an edit
    that changes one (a DMX window removed) makes evaluating on the
    snapshot's batch raise ``UsageError`` rather than use the stale
    context; an edit that leaves the contexts (F2 added) evaluates as the
    reference's."""
    from pint_torch.exceptions import UsageError
    from pint_torch.models.parameter import prefixParameter
    from pint_torch.residuals import Residuals
    from pint_tpu.models.parameter import prefixParameter as RPrefix
    from pint_tpu.residuals import Residuals as RR

    model, toas, m, b = standin.port_and_reference(standin.SMALL_SETTINGS)
    m2 = m.copy()
    m2.components["DispersionDMX"].remove_DMX_range(2)
    with pytest.raises(UsageError):
        Residuals(b, m2).time_resids
    m.components["Spindown"].add_param(
        prefixParameter("F2", value=1e-27, frozen=False), setup=True)
    model.components["Spindown"].add_param(
        RPrefix("F2", value=1e-27, frozen=False), setup=True)
    model.setup()
    got = Residuals(b, m).time_resids.numpy()
    assert np.abs(got - np.asarray(RR(toas, model).time_resids)).max() \
        <= 1e-10


def test_subset_of_a_snapshot_after_an_edit_is_refused():
    """A subset or a merge of a snapshot's batch carries the contexts it
    sliced with what they were built for, and no host TOAs: after an edit
    that changes one (a DMX window removed) evaluating the edited model
    on it raises ``UsageError``, directly and through ``Residuals``; the
    unedited model evaluates it as the rows of the whole batch."""
    from pint_torch.exceptions import UsageError
    from pint_torch.residuals import Residuals
    from pint_torch.toa import merge_TOAs

    _, _, m, b = standin.port_and_reference(standin.SMALL_SETTINGS)
    keep = np.arange(b.ntoas) % 2 == 0
    sub = b.select(keep, m)
    both = merge_TOAs([sub, b.select(~keep, m)])
    full = Residuals(b, m, subtract_mean=False).time_resids
    assert torch.equal(Residuals(sub, m, subtract_mean=False).time_resids,
                       full[torch.tensor(keep)])
    m2 = m.copy()
    m2.components["DispersionDMX"].remove_DMX_range(2)
    for batch in (sub, both):
        with pytest.raises(UsageError):
            m2.phase(batch)
        with pytest.raises(UsageError):
            Residuals(batch, m2)
