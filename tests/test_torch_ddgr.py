"""The DDGR slice on the CPU: a B1913+16-shaped WLS stand-in end to end.

The small stand-in (``SMALL_DDGR_SETTINGS``: 20 epochs x 4 sub-bands,
equatorial astrometry, a DDGR binary at ECC 0.617 with MTOT and M2
fitted, DMX, FD, a JUMP, EFAC/EQUAD, no correlated noise) runs through the
reference package (``WLSFitter.fit_toas(maxiter=3)``,
``DownhillWLSFitter``, ``Fitter.auto``, a 4 x 4 MTOT x M2 WLS grid 3 sigma
about the WLS fit at ``niter=4``) and, through a snapshot, through the
port on the CPU (the GR-derived row in torch, K2's DDGR twin).  Bars as
``chip_smoke.py``'s: residuals 1e-10 s, chi2 1e-6 rel, values 1e-2 sigma,
uncertainties 1e-6 rel, converged flags and steps, the grid 1e-6 rel with
the same argmin and rungs; a grid point with sini = a1 / ar > 1 is NaN as
in the reference.  The committed full-width file
(``b1913_ddgr_standin.npz``) loads with its stated shapes.
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
    model, toas = standin.make_standin(standin.SMALL_DDGR_SETTINGS,
                                       full=False)
    return standin.export_wls_snapshot(model, toas,
                                       standin.SMALL_DDGR_SETTINGS, chunk=16)


@pytest.fixture(scope="module")
def port(snap):
    from pint_torch.bridge import load_snapshot, read_snapshot
    from pint_torch.fitter import DownhillWLSFitter, Fitter, WLSFitter
    from pint_torch.grid import grid_chisq

    meta, arrays = read_snapshot(snap)
    m, b = load_snapshot(snap, device="cpu")
    f = WLSFitter(b, m)
    fits = {"postfit": (f, f.fit_toas(maxiter=3))}
    d = DownhillWLSFitter(b, m)
    fits["downhill"] = (d, d.fit_toas())
    a = Fitter.auto(b, m)
    fits["auto"] = (a, a.fit_toas())
    names = tuple(meta["reference"]["grid_params"])
    surface, _ = grid_chisq(f, names, tuple(arrays[f"ref/grid_{n.lower()}"]
                                            for n in names),
                            niter=4, chunk=16)
    return dict(meta=meta, ref=arrays, model=m, batch=b, fitter=f,
                fits=fits, names=names, surface=surface)


def test_ddgr_residuals_and_designmatrix_match(port):
    from pint_torch.residuals import Residuals

    m = port["model"]
    assert "BinaryDDGR" in m.components and not m.has_correlated_errors
    assert {"MTOT", "M2", "ECC", "OM", "PB", "A1"} <= set(m.free_params)
    r = Residuals(port["batch"], m).time_resids.numpy()
    assert np.abs(r - port["ref"]["ref/time_resids"]).max() <= 1e-10
    M, names = m.designmatrix(port["batch"])
    Mr = port["ref"]["ref/designmatrix"]
    assert names == port["meta"]["reference"]["designmatrix_names"]
    err = np.abs(M.numpy() - Mr).max(axis=0) / np.abs(Mr).max(axis=0)
    assert err.max() <= 1e-9


@pytest.mark.parametrize("key", ["postfit", "downhill", "auto"])
def test_ddgr_fits_match(port, key):
    ref, rr = port["ref"], port["meta"]["reference"]
    f, chi2 = port["fits"][key]
    vals = np.array([f.model.value(p) for p in rr["postfit_params"]])
    unc = np.array([f.model[p].uncertainty for p in rr["postfit_params"]])
    sig = ref[f"ref/{key}_uncertainties"]
    assert abs(chi2 / rr[f"{key}_chi2"] - 1) <= 1e-6
    assert np.abs((vals - ref[f"ref/{key}_values"]) / sig).max() <= 1e-2
    assert np.abs(unc / sig - 1).max() <= 1e-6
    if key == "downhill":
        assert bool(f.converged) == rr["downhill_converged"]
    if key == "auto":
        assert type(f).__name__ == rr["auto_fitter"] == "DownhillWLSFitter"
        assert (bool(f.converged), f.iterations) == (
            rr["auto_converged"], rr["auto_iterations"])


def test_ddgr_mtot_m2_grid_matches(port):
    ref, rr = port["ref"], port["meta"]["reference"]
    assert port["names"] == ("MTOT", "M2")
    s = port["surface"]
    assert s.shape == (4, 4)
    assert np.abs(s / ref["ref/grid_chi2"] - 1).max() <= 1e-6
    argmin = [int(i) for i in np.unravel_index(int(np.nanargmin(s)), s.shape)]
    assert argmin == rr["grid_argmin"]
    np.testing.assert_array_equal(
        port["fitter"].last_grid_diagnostics["ladder_rung"],
        ref["ref/grid_rungs"])


def test_ddgr_grid_poisons_sini_above_one(port):
    """A companion mass so large that sini = a1 / ar exceeds 1 makes the
    Shapiro log NaN: the point's chi2 is NaN (rung -1), as the reference's
    is; the physical point beside it stays finite."""
    from pint_torch.grid import grid_chisq

    f = port["fitter"]
    m = f.model
    s, _ = grid_chisq(f, ("MTOT", "M2"), ([m.value("MTOT")],
                                           [m.value("M2"), 0.3]),
                      niter=2, chunk=4)
    assert np.isfinite(s[0, 0]) and np.isnan(s[0, 1])
    assert f.last_grid_diagnostics["ladder_rung"][0, 1] == -1


def test_committed_ddgr_file_loads_with_stated_shapes():
    """The full-width B1913+16-shaped stand-in: 4005 TOAs, DDGR at ECC
    0.617, white noise only, the reference's three fits and its 16 x 16
    MTOT x M2 grid; written with ``DDGR_SETTINGS``."""
    from pint_torch.bridge import DDGR_PATH, load_snapshot, read_snapshot

    assert os.path.getsize(DDGR_PATH) < 8 * 1024 * 1024
    meta, arrays = read_snapshot(DDGR_PATH)
    rr = meta["reference"]
    assert rr["settings"] == standin.DDGR_SETTINGS
    m, b = load_snapshot(DDGR_PATH, device="cpu")
    assert b.ntoas == 4005 and "BinaryDDGR" in m.components
    assert not m.has_correlated_errors
    assert m.value("ECC") == pytest.approx(0.617134, abs=1e-3)
    assert rr["grid_params"] == ["MTOT", "M2"]
    assert arrays["ref/grid_chi2"].shape == (16, 16)
    assert rr["auto_fitter"] == "DownhillWLSFitter"
    for key in ("postfit", "downhill", "auto"):
        assert np.isfinite(arrays[f"ref/{key}_uncertainties"]).all()
