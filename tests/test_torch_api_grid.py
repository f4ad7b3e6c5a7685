"""The port's fitter, residuals, model and grid API against the JAX
package's on the CPU, part 3: ``PowellFitter``, and the tuple and
derived grids with ``doonefit``.

Powell is held against the reference's outputs in the committed
``ngc6440e_standin.npz`` and ``small_bt_standin.npz`` (``ref/api/``), the
grids live on the small GLS and ELL1 stand-ins (80 TOAs, seeded numpy).
Bars: Powell's chi2 1e-6 rel, values within 1e-2 of their uncertainties,
the same converged flag; the grids' chi2 1e-6 rel with the same argmin
and rungs, their refit values within 1e-2 of their uncertainties.
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

CASES = {"gls": standin.SMALL_SETTINGS, "ell1": standin.SMALL_ELL1_SETTINGS}


@pytest.fixture(scope="module")
def fits():
    """(reference fitter, chi2, port fitter, chi2) after the first fit:
    ``GLSFitter`` on the small GLS stand-in, ``WLSFitter`` on the small
    ELL1 one, ``maxiter=2``."""
    from pint_tpu.fitter import WLSFitter as RW
    from pint_tpu.gls_fitter import GLSFitter as RG

    from pint_torch.fitter import WLSFitter
    from pint_torch.gls_fitter import GLSFitter

    cache = {}

    def get(key):
        if key not in cache:
            case = "gls" if key == "gls" else "ell1"
            R, P = (RG, GLSFitter) if case == "gls" else (RW, WLSFitter)
            model, toas, m, b = standin.port_and_reference(CASES[case])
            fr, fp = R(toas, model), P(b, m)
            cache[key] = (fr, fr.fit_toas(maxiter=2), fp,
                          fp.fit_toas(maxiter=2))
        return cache[key]

    return get


# ---------------------------------------------------------------------------
# Powell
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["ngc", "bt"])
def test_powell_matches_committed_reference(which):
    """``PowellFitter`` from the start the committed snapshot names (ngc:
    its values, each parameter in units of the WLS fit's uncertainty; bt:
    ``Fitter.auto``'s fit), against the reference's result in it: chi2
    1e-6 rel, values within 1e-2 of their uncertainties, the same
    converged flag (each package's evaluations differ: scipy's line
    searches see the last bits of chi2)."""
    from pint_torch import bridge
    from pint_torch.fitter import PowellFitter

    path = bridge.NGC_PATH if which == "ngc" else bridge.BT_SMALL_PATH
    meta, ref = bridge.read_snapshot(path)
    rr = meta["reference"]
    pw = rr["api"]["powell"]
    m, b = bridge.load_snapshot(path, device="cpu")
    key = "postfit" if pw["start"] == "prefit" else "auto"
    names = rr["postfit_params"]
    for i, p in enumerate(names):
        m[p].uncertainty = float(ref[f"ref/{key}_uncertainties"][i])
        if key == "auto":
            m[p].value = float(ref[f"ref/{key}_values"][i])
    f = PowellFitter(b, m)
    chi2 = f.fit_toas(maxiter=pw["maxiter"])
    sig = ref[f"ref/{key}_uncertainties"]
    vals = np.array([f.model.value(p) for p in names])
    assert abs(chi2 / pw["chi2"] - 1) <= 1e-6
    assert np.abs((vals - ref["ref/api/powell_values"]) / sig).max() <= 1e-2
    assert f.converged == pw["converged"] and f.nfev > 0
    assert f.model["CHI2"].value == chi2


# ---------------------------------------------------------------------------
# tuple and derived grids
# ---------------------------------------------------------------------------
def _grid_setup(fits, case):
    fr, _, fp, _ = fits("gls" if case == "gls" else "wls")
    pts, mc, cosi = standin.api_grid_points(fr.model, fr.errors)
    return fr, fp, pts, mc, cosi


@pytest.mark.parametrize("case", ["gls", "ell1"])
def test_tuple_chisq_matches_reference(fits, case):
    """37 (M2, SINI) tuples, no multiple of the port's chunk (16): chi2 1e-6
    rel, the same argmin and rungs (no padding row in them), the refit
    values within 1e-2 of their uncertainties."""
    from pint_tpu.grid import tuple_chisq as ref

    from pint_torch.grid import tuple_chisq

    fr, fp, pts, _, _ = _grid_setup(fits, case)
    niter = CASES[case]["grid_niter"]
    c_r, e_r = ref(fr, ("M2", "SINI"), pts, extraparnames=standin.API_EXTRA,
                   niter=niter)
    c_p, e_p = tuple_chisq(fp, ("M2", "SINI"), pts,
                           extraparnames=standin.API_EXTRA, niter=niter,
                           chunk=16)
    assert c_p.shape == (standin.API_TUPLES,)
    assert np.abs(c_p / np.asarray(c_r) - 1).max() <= 1e-6
    assert int(np.argmin(c_p)) == int(np.argmin(c_r))
    assert np.array_equal(fp.last_grid_diagnostics["ladder_rung"],
                          fr.last_grid_diagnostics["ladder_rung"])
    for k in standin.API_EXTRA:
        assert np.abs((e_p[k] - np.asarray(e_r[k])) / fr.errors[k]).max() \
            <= 1e-2


@pytest.mark.parametrize("case", ["gls", "ell1"])
def test_grid_chisq_derived_matches_reference(fits, case):
    """A 4 x 4 grid in (Mc, cos i) mapped onto (M2, SINI): chi2 1e-6 rel,
    argmin and rungs, the mesh arrays exactly, refit values 1e-2 sigma;
    the tuple form of the same points gives the same chi2."""
    from pint_tpu.grid import grid_chisq_derived as ref
    from pint_tpu.grid import tuple_chisq_derived as ref_t

    from pint_torch.grid import grid_chisq_derived, tuple_chisq_derived

    fr, fp, _, mc, cosi = _grid_setup(fits, case)
    mc, cosi = mc[::5], cosi[::5]
    funcs = (standin.derived_m2, standin.derived_sini)
    niter = CASES[case]["grid_niter"]
    c_r, g_r, e_r = ref(fr, ("M2", "SINI"), funcs, (mc, cosi),
                        extraparnames=standin.API_EXTRA, niter=niter)
    c_p, g_p, e_p = grid_chisq_derived(fp, ("M2", "SINI"), funcs, (mc, cosi),
                                       extraparnames=standin.API_EXTRA,
                                       niter=niter, chunk=5)
    assert c_p.shape == (4, 4)
    assert np.abs(c_p / np.asarray(c_r) - 1).max() <= 1e-6
    assert np.argmin(c_p) == np.argmin(c_r)
    assert np.array_equal(fp.last_grid_diagnostics["ladder_rung"],
                          fr.last_grid_diagnostics["ladder_rung"])
    assert all(np.array_equal(a, c) for a, c in zip(g_p, g_r))
    for k in standin.API_EXTRA:
        assert np.abs((e_p[k] - np.asarray(e_r[k])) / fr.errors[k]).max() \
            <= 1e-2
    raw = np.stack([g.ravel() for g in g_p], axis=-1)
    t_r, raw_r, _ = ref_t(fr, ("M2", "SINI"), funcs, raw, niter=niter)
    t_p, raw_p, _ = tuple_chisq_derived(fp, ("M2", "SINI"), funcs, raw,
                                        niter=niter, chunk=7)
    assert np.abs(t_p / np.asarray(t_r) - 1).max() <= 1e-6
    assert all(np.array_equal(a, np.asarray(c)) for a, c in zip(raw_p, raw_r))


def test_doonefit_matches_reference(fits):
    """One fit with M2 and SINI frozen at a tuple: chi2 1e-6 rel, the refit
    values within 1e-2 of their uncertainties; the wrapper's fitter is the
    caller's class."""
    from pint_tpu.grid import doonefit as ref

    from pint_torch.grid import WrappedFitter, doonefit

    fr, _, fp, _ = fits("wls")
    pts, _, _ = standin.api_grid_points(fr.model, fr.errors)
    c_r, x_r = ref(fr, ("M2", "SINI"), pts[0],
                   extraparnames=standin.API_EXTRA, maxiter=2)
    c_p, x_p = doonefit(fp, ("M2", "SINI"), pts[0],
                        extraparnames=standin.API_EXTRA, maxiter=2)
    assert abs(c_p / c_r - 1) <= 1e-6
    for k, a, c in zip(standin.API_EXTRA, x_p, x_r):
        assert abs(a - float(c)) <= 1e-2 * fr.errors[k]
    assert WrappedFitter(fp).fitargs == {}
