"""The DDK slice on the CPU: a J1713+0747-shaped GLS stand-in end to end.

The small stand-in (``SMALL_DDK_SETTINGS``: 80 epochs x 4 sub-bands,
ecliptic astrometry with PX and PMELONG/PMELAT, a DDK binary with KIN,
KOM and K96 on, DMX, FD, a JUMP, EFAC/EQUAD/ECORR and red noise) runs
through the reference package (``GLSFitter.fit_toas(maxiter=2)``,
``Fitter.auto``'s fit, a 4 x 4 KIN x KOM GLS grid 3 sigma about the fit at
``niter=1``) and, through a snapshot, through the port on the CPU (K2's
DDK twin with the Kopeikin corrections in torch).  The bars are
``chip_smoke.py``'s: residuals 1e-10 s, chi2 1e-6 rel, values 1e-2
sigma, uncertainties 1e-6 rel, ``Fitter.auto``'s class, converged flag
and steps, the grid 1e-6 rel with the same argmin and rungs.  The
committed full-width file (``j1713_ddk_standin.npz``) loads with its
stated shapes.
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


@pytest.fixture(scope="module")
def snap():
    model, toas = standin.make_standin(standin.SMALL_DDK_SETTINGS,
                                       full=False)
    return standin.export_snapshot(model, toas, standin.SMALL_DDK_SETTINGS,
                                   chunk=16)


@pytest.fixture(scope="module")
def port(snap):
    from pint_torch.bridge import load_snapshot, read_snapshot
    from pint_torch.fitter import Fitter
    from pint_torch.gls_fitter import GLSFitter
    from pint_torch.grid import grid_chisq

    meta, arrays = read_snapshot(snap)
    m, b = load_snapshot(snap, device="cpu")
    f = GLSFitter(b, m)
    chi2 = f.fit_toas(maxiter=2)
    auto = Fitter.auto(b, m)
    chi2_auto = auto.fit_toas()
    names = tuple(meta["reference"]["grid_params"])
    surface, _ = grid_chisq(f, names, tuple(arrays[f"ref/grid_{n.lower()}"]
                                            for n in names),
                            niter=1, chunk=16)
    return dict(meta=meta, ref=arrays, model=m, batch=b, fitter=f, chi2=chi2,
                auto=auto, chi2_auto=chi2_auto, names=names,
                surface=surface)


def test_ddk_residuals_and_designmatrix_match(port):
    from pint_torch.residuals import Residuals

    m = port["model"]
    assert {"BinaryDDK", "AstrometryEcliptic"} <= set(m.components)
    assert m["K96"].value is True
    assert {"KIN", "KOM", "PX", "PMELONG", "PMELAT"} <= set(m.free_params)
    r = Residuals(port["batch"], m).time_resids.numpy()
    assert np.abs(r - port["ref"]["ref/time_resids"]).max() <= 1e-10
    M, names = m.designmatrix(port["batch"])
    Mr = port["ref"]["ref/designmatrix"]
    assert names == port["meta"]["reference"]["designmatrix_names"]
    err = np.abs(M.numpy() - Mr).max(axis=0) / np.abs(Mr).max(axis=0)
    assert err.max() <= 1e-9


@pytest.mark.parametrize("key", ["postfit", "auto"])
def test_ddk_fits_match(port, key):
    ref, rr = port["ref"], port["meta"]["reference"]
    f = port["fitter"] if key == "postfit" else port["auto"]
    chi2 = port["chi2"] if key == "postfit" else port["chi2_auto"]
    vals = np.array([f.model.value(p) for p in rr["postfit_params"]])
    unc = np.array([f.model[p].uncertainty for p in rr["postfit_params"]])
    sig = ref[f"ref/{key}_uncertainties"]
    assert abs(chi2 / rr[f"{key}_chi2"] - 1) <= 1e-6
    assert np.abs((vals - ref[f"ref/{key}_values"]) / sig).max() <= 1e-2
    assert np.abs(unc / sig - 1).max() <= 1e-6
    if key == "auto":
        assert type(f).__name__ == rr["auto_fitter"] == "DownhillGLSFitter"
        assert (bool(f.converged), f.iterations) == (
            rr["auto_converged"], rr["auto_iterations"])
        for comp, a in f.noise_ampls.items():
            want = ref[f"ref/auto_noise_ampls/{comp}"]
            assert np.abs(a.numpy() - want).max() <= 1e-6 * np.abs(want).max()


def test_ddk_kin_kom_grid_matches(port):
    ref, rr = port["ref"], port["meta"]["reference"]
    assert port["names"] == ("KIN", "KOM")
    s = port["surface"]
    assert s.shape == (4, 4) and np.isfinite(s).all()
    assert np.abs(s / ref["ref/grid_chi2"] - 1).max() <= 1e-6
    argmin = [int(i) for i in np.unravel_index(int(np.nanargmin(s)), s.shape)]
    assert argmin == rr["grid_argmin"]
    np.testing.assert_array_equal(
        port["fitter"].last_grid_diagnostics["ladder_rung"],
        ref["ref/grid_rungs"])


def test_ddk_k96_off_changes_only_the_proper_motion_terms(snap):
    """K96 = N drops the Kopeikin 1996 proper-motion terms: the delay moves
    (by the secular terms, microseconds over the span) and matches the
    reference's own K96 = N evaluation to 1e-10 s."""
    import json

    from pint_torch.bridge import load_snapshot

    model, toas = standin.make_standin(standin.SMALL_DDK_SETTINGS,
                                       full=False)
    model.K96.value = False
    model._cache.clear()  # K96 is read when the evaluation is traced
    want = np.asarray(model.delay(toas))
    meta = json.loads(str(snap["meta"]))
    for p in meta["params"]:
        if p["name"] == "K96":
            p["value"] = False
    m, b = load_snapshot(dict(snap, meta=np.asarray(json.dumps(meta))),
                         device="cpu")
    got = m.delay(b).numpy()
    on = load_snapshot(snap, device="cpu")
    moved = np.abs(on[0].delay(on[1]).numpy() - got).max()
    assert moved > 1e-8
    assert np.abs(got - want).max() <= 1e-10


def test_committed_ddk_file_loads_with_stated_shapes():
    """The full-width J1713+0747-shaped stand-in: 4005 TOAs, DDK with
    ecliptic astrometry, the B1855 stand-in's noise (ECORR, 90 red-noise
    columns), the reference's GLS and auto fits and its 16 x 16 KIN x KOM
    grid; written with ``DDK_SETTINGS``."""
    from pint_torch.bridge import DDK_PATH, load_snapshot, read_snapshot

    assert os.path.getsize(DDK_PATH) < 8 * 1024 * 1024
    meta, arrays = read_snapshot(DDK_PATH)
    rr = meta["reference"]
    assert rr["settings"] == standin.DDK_SETTINGS
    m, b = load_snapshot(DDK_PATH, device="cpu")
    assert b.ntoas == 4005 and "BinaryDDK" in m.components
    assert m.has_correlated_errors
    _, _, dims = m.noise_basis_by_component(b)
    assert dims["PLRedNoise"][1] == 90
    assert rr["grid_params"] == ["KIN", "KOM"]
    for k in ("ref/grid_kin", "ref/grid_kom"):
        assert arrays[k].shape == (16,) and np.isfinite(arrays[k]).all()
    assert arrays["ref/grid_chi2"].shape == (16, 16)
    assert rr["auto_fitter"] == "DownhillGLSFitter"
