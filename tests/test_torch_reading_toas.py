"""The port's host TOAs read from tim files against the reference's on the
same files: ``get_TOAs``' host columns and ``to_batch(device="cpu")``
bitwise, flag masks, selection and merging, the tim writer byte for byte,
the hash-keyed pickles, and the small stand-in's whole file path (model,
TOAs, residuals, GLS fit and grid) live in both packages.

The stand-ins are simulated by the reference from seeds and written with
its own writer into a temporary directory."""

from __future__ import annotations

import pickle

import numpy as np
import pytest

import _torch_standin as standin

from pint_torch.models import get_model_and_toas
from pint_torch.toa import (TOA, FlagDict, get_TOAs, get_TOAs_list,
                            load_pickle, merge_TOAs, save_pickle)
from pint_tpu.models import get_model_and_toas as ref_get_model_and_toas
from pint_tpu.toa import TOA as RefTOA
from pint_tpu.toa import get_TOAs as ref_get_TOAs
from pint_tpu.toa import get_TOAs_list as ref_get_TOAs_list
from pint_tpu.toa import merge_TOAs as ref_merge_TOAs

#: the host columns compared bitwise
COLUMNS = ("utc_mjd", "utc_mjd_lo", "error_us", "freq_mhz", "clock_corr_s",
           "tdb", "tdb_lo", "ssb_obs_pos_km", "ssb_obs_vel_kms",
           "obs_sun_pos_km")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The small GLS stand-in written as par and tim files, and the
    reference's model and TOAs read from them."""
    d = tmp_path_factory.mktemp("small")
    s = standin.SMALL_SETTINGS
    model, toas = standin.make_standin(s, full=False)
    par, tim = d / "small.par", d / "small.tim"
    par.write_text(standin.standin_par_text(s, False))
    toas.write_TOA_file(str(tim))
    rm, rt = ref_get_model_and_toas(str(par), str(tim))
    return dict(par=str(par), tim=str(tim), rm=rm, rt=rt, dir=d)


def _same_columns(t, rt):
    for c in COLUMNS:
        a, b = getattr(t, c), getattr(rt, c)
        assert (a is None) == (b is None), c
        if a is not None:
            assert np.asarray(a).dtype == np.asarray(b).dtype, c
            assert np.array_equal(a, b), c
    assert list(map(str, t.obs)) == list(map(str, rt.obs))
    assert t.flags == rt.flags
    assert t.commands == rt.commands


def test_get_TOAs_columns_and_batch_bitwise(files):
    """``get_TOAs`` gives the reference's host columns, flags, commands and
    diagnostics bitwise, and ``to_batch(device="cpu")`` its batch."""
    t = get_TOAs(files["tim"], model=None)
    rt = ref_get_TOAs(files["tim"])
    _same_columns(t, rt)
    assert [d.render() for d in t.ingest_diagnostics] \
        == [d.render() for d in rt.ingest_diagnostics]
    b, rb = t.to_batch(device="cpu"), rt.to_batch()
    for name in ("tdb", "tdb_s"):
        for part in ("hi", "lo"):
            assert np.array_equal(getattr(getattr(b, name), part).numpy(),
                                  np.asarray(getattr(getattr(rb, name),
                                                     part))), name
    assert b.tdb0 == float(rb.tdb0)
    for name in ("freq", "error_us", "ssb_obs_pos", "ssb_obs_vel",
                 "obs_sun_pos"):
        assert np.array_equal(getattr(b, name).numpy(),
                              np.asarray(getattr(rb, name))), name
    for attr in ("first_MJD", "last_MJD", "get_Tspan", "get_summary",
                 "get_all_flags"):
        assert getattr(t, attr)() == getattr(rt, attr)(), attr
    assert t.observatories == rt.observatories
    assert np.array_equal(t.get_clusters(), rt.get_clusters())
    assert t.get_flag_value("f") == rt.get_flag_value("f")
    assert np.array_equal(t.get_errors(), rt.get_errors())
    assert t.get_dms() is None and rt.get_dms() is None


def test_model_contexts_from_files(files):
    """``get_model_and_toas``: the model's settings reach the pipeline as
    in the reference, and each component's context for the TOAs (DMX
    windows, JUMP and EFAC/EQUAD/ECORR masks by flag) is the reference's
    bitwise."""
    m, t = get_model_and_toas(files["par"], files["tim"], device="cpu")
    rm, rt = files["rm"], files["rt"]
    _same_columns(t, rt)
    assert (t.ephem, t.planets, t.include_bipm, t.bipm_version) \
        == (rt.ephem, rt.planets, rt.include_bipm, rt.bipm_version)
    b = t.to_batch(device="cpu", model=m)
    want = standin.export_state(rm, rt)
    n = 0
    for key, arr in want.items():
        if not key.startswith("ctx/"):
            continue
        _, comp, *sub = key.split("/")
        got = b.contexts[comp]
        for s_ in sub:
            got = got[s_]
        got = got.numpy() if hasattr(got, "numpy") else np.asarray(got)
        assert np.array_equal(np.asarray(got, dtype=arr.dtype), arr), key
        n += 1
    assert n >= 4


def test_masks_select_and_merge(files):
    """Flag-selected masks, ``toas[mask]``, ``select``/``unselect`` and
    ``merge_TOAs`` of host TOAs as in the reference, quarantine state
    carried."""
    t, rt = get_TOAs(files["tim"]), ref_get_TOAs(files["tim"])
    m = np.array([fl.get("f") == t.flags[0]["f"] for fl in t.flags])
    _same_columns(t[m], rt[m])
    half = len(t) // 2
    _same_columns(merge_TOAs([t[:half], t[half:]]),
                  ref_merge_TOAs([rt[:half], rt[half:]]))
    assert merge_TOAs([t[:half], t[half:]]).filename is None
    n = len(t)
    with pytest.warns(DeprecationWarning):
        t.select(m)
    assert len(t) == int(m.sum())
    with pytest.warns(DeprecationWarning):
        t.unselect()
    assert len(t) == n
    _same_columns(t, rt)
    t.quarantine_mask = np.zeros(n, dtype=bool)
    t.quarantine_mask[:3] = True
    t.quarantine_reasons = [["x"]] * 3 + [[] for _ in range(n - 3)]
    assert len(t.certified()) == n - 3 and len(t.quarantined()) == 3
    merged = merge_TOAs([t, t[:2]])
    assert merged.quarantine_mask.sum() == 5
    fd = FlagDict({"F": "1", "be": "GUPPI"})
    assert dict(fd) == {"f": "1", "be": "GUPPI"}


def test_validate_policies(files):
    """A duplicated row: ``strict`` raises, ``lenient``/``collect``
    quarantine it, with the reference's report."""
    from pint_torch.exceptions import TOAIntegrityError

    t, rt = get_TOAs(files["tim"]), ref_get_TOAs(files["tim"])
    dup, rdup = merge_TOAs([t, t[:1]]), ref_merge_TOAs([rt, rt[:1]])
    with pytest.raises(TOAIntegrityError):
        dup.validate(policy="strict", check_coverage=False)
    for policy in ("lenient", "collect"):
        a = merge_TOAs([t, t[:1]])
        b = ref_merge_TOAs([rt, rt[:1]])
        ra = a.validate(policy=policy, check_coverage=False)
        rb = b.validate(policy=policy, check_coverage=False)
        assert ra.render() == rb.render()
        assert np.array_equal(a.quarantine_mask, b.quarantine_mask)
    assert rdup is not None


def test_write_TOA_file_byte_for_byte(files, tmp_path):
    """The tim writer gives the reference's text, and ``adjust_TOAs``
    shifts the times as the reference's does."""
    t, rt = get_TOAs(files["tim"]), ref_get_TOAs(files["tim"])
    t.write_TOA_file(str(tmp_path / "a.tim"))
    rt.write_TOA_file(str(tmp_path / "b.tim"))
    assert (tmp_path / "a.tim").read_bytes() \
        == (tmp_path / "b.tim").read_bytes()
    shift = np.linspace(-1e-3, 1e-3, len(t))
    t.adjust_TOAs(shift)
    rt.adjust_TOAs(shift)
    _same_columns(t, rt)
    toas = [TOA("55000.000000000123456789", error=1.5, obs="gbt",
                freq=1400.0, flags={"f": "x"}),
            TOA((55001.0, 0.25), error=2.0, obs="ao", freq=430.0)]
    rtoas = [RefTOA("55000.000000000123456789", error=1.5, obs="gbt",
                    freq=1400.0, flags={"f": "x"}),
             RefTOA((55001.0, 0.25), error=2.0, obs="ao", freq=430.0)]
    assert [x.as_line() for x in toas] == [x.as_line() for x in rtoas]
    _same_columns(get_TOAs_list(toas), ref_get_TOAs_list(rtoas))


def test_pickle_round_trip(files, tmp_path):
    """``save_pickle``/``load_pickle`` and the hash-keyed cache of
    ``get_TOAs(usepickle=True)`` return the port's own TOAs; an edited
    tim file misses the cache."""
    import shutil

    tim = tmp_path / "c.tim"
    shutil.copy(files["tim"], tim)
    t = get_TOAs(str(tim), usepickle=True)
    cached = get_TOAs(str(tim), usepickle=True)
    _same_columns(cached, t)
    assert type(cached).__module__ == "pint_torch.toa"
    assert cached.check_hashes()
    save_pickle(t)
    back = load_pickle(str(tim))
    _same_columns(back, t)
    with open(str(tim) + ".pint_torch_toas.pickle", "rb") as f:
        assert pickle.load(f)["toas"].__class__.__name__ == "TOAs"
    with open(tim, "a") as f:
        f.write("x1 1400.0 56000.5 1.0 ao -f L-wide\n")
    assert not cached.check_hashes()
    assert len(get_TOAs(str(tim), usepickle=True)) == len(t) + 1


def test_small_file_path_end_to_end(files):
    """The small stand-in's file path in both packages: residuals 1e-10 s,
    the GLS fit's chi2 1e-6 rel, values 1e-2 sigma and uncertainties
    1e-6 rel, and a 3 x 3 M2 x SINI grid's chi2 1e-6 rel with the same
    argmin and rungs."""
    from pint_torch.gls_fitter import GLSFitter
    from pint_torch.grid import grid_chisq
    from pint_torch.residuals import Residuals
    from pint_tpu.gls_fitter import GLSFitter as RefGLS
    from pint_tpu.grid import grid_chisq as ref_grid_chisq
    from pint_tpu.residuals import Residuals as RefResiduals

    m, t = get_model_and_toas(files["par"], files["tim"], device="cpu")
    rm, rt = ref_get_model_and_toas(files["par"], files["tim"])
    b = t.to_batch(device="cpu", model=m)
    r = Residuals(b, m).time_resids.numpy()
    rr = np.asarray(RefResiduals(rt, rm).time_resids)
    assert np.abs(r - rr).max() <= 1e-10
    f, rf = GLSFitter(b, m), RefGLS(rt, rm)
    c2, rc2 = f.fit_toas(maxiter=2), float(rf.fit_toas(maxiter=2))
    assert abs(c2 / rc2 - 1) <= 1e-6
    names = list(rm.design_param_names())
    assert list(m.design_param_names()) == names
    sig = np.array([float(getattr(rf.model, p).uncertainty) for p in names])
    vals = np.array([f.model.value(p) for p in names])
    rvals = np.array([float(getattr(rf.model, p).value) for p in names])
    assert np.abs((vals - rvals) / sig).max() <= 1e-2
    unc = np.array([f.model[p].uncertainty for p in names])
    assert np.abs(unc / sig - 1).max() <= 1e-6
    axes = standin.grid_axes(rm, 3)
    g, _ = grid_chisq(f, ("M2", "SINI"), axes, niter=1)
    rg, _ = ref_grid_chisq(rf, ("M2", "SINI"), axes, niter=1)
    rg = np.asarray(rg)
    assert np.abs(g / rg - 1).max() <= 1e-6
    assert np.nanargmin(g) == np.nanargmin(rg)
    assert np.array_equal(f.last_grid_diagnostics["ladder_rung"],
                          rf.last_grid_diagnostics["ladder_rung"])


def test_chromatic_noise_basis_scales(tmp_path):
    """The power-law DM, chromatic and solar-wind noise's per-TOA basis
    scales built on the host from TOAs read from a file: DM and chromatic
    bitwise the reference's ``_chromatic_scale``, the solar wind's (its
    DM geometry at 1 cm^-3 in torch) within 1e-13 rel."""
    from pint_tpu.models import get_model as ref_get_model

    s = standin.SMALL_PTA_SETTINGS
    _, toas = standin.make_standin(s, full=False)
    toas.write_TOA_file(str(tmp_path / "p.tim"))
    text = standin.standin_par_text(s, False) + (
        "TNDMAMP -13.1\nTNDMGAM 2.5\nTNDMC 5\n"
        "TNCHROMAMP -13.4\nTNCHROMGAM 3.1\nTNCHROMC 5\n")
    m, t = get_model_and_toas(text, str(tmp_path / "p.tim"), device="cpu")
    rm = ref_get_model(text.splitlines(keepends=True))
    standin._patch_sw_geometry(rm)
    rt = ref_get_TOAs(str(tmp_path / "p.tim"), model=rm)
    for name in ("PLDMNoise", "PLChromNoise", "PLSWNoise"):
        got = m.components[name].basis_scale(t)
        want = np.asarray(rm.components[name]._chromatic_scale(rm, rt))
        if name == "PLSWNoise":
            assert np.abs(got / want - 1).max() <= 1e-13
        else:
            assert np.array_equal(got, want), name
    assert "scale" in t.to_batch(device="cpu", model=m).contexts["PLDMNoise"]
