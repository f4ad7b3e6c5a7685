"""The slice end to end: residuals, design matrix, GLS fit and GLS grid.

The small stand-in runs through the reference package (design matrix, a
two-iteration ``GLSFitter`` fit and a 4x4 M2 x SINI grid with
``niter=1``) and, through a snapshot, through the port on the CPU -- the
kernels' plain twins.  The committed full-width stand-in is also driven
through the port's fit on the CPU and held against the reference outputs
stored in it.

Measured gaps on the small stand-in (they come from the reference's jitted
evaluation, which rounds the ~100-s delays ~1e-13 s differently from its
own eager arithmetic; the port equals the eager arithmetic): residuals
8e-14 s, post-fit chi2 2.6e-9 relative, grid chi2 6.8e-9 relative.
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
def reference():
    """(model, toas) of the small stand-in in the reference package."""
    return standin.make_standin(standin.SMALL_SETTINGS, full=False)


@pytest.fixture(scope="module")
def snap(reference):
    model, toas = reference
    return standin.export_snapshot(model, toas, standin.SMALL_SETTINGS,
                                   chunk=16)


@pytest.fixture(scope="module")
def port(snap):
    from pint_torch.bridge import load_snapshot, read_snapshot
    from pint_torch.gls_fitter import GLSFitter
    from pint_torch.grid import grid_chisq

    meta, arrays = read_snapshot(snap)
    m, b = load_snapshot(snap, device="cpu")
    f = GLSFitter(b, m)
    chi2 = f.fit_toas(maxiter=2)
    surface, _ = grid_chisq(f, ("M2", "SINI"),
                            (arrays["ref/grid_m2"], arrays["ref/grid_sini"]),
                            niter=1, chunk=16)
    return dict(meta=meta, ref=arrays, model=m, batch=b, fitter=f, chi2=chi2,
                surface=surface)


def test_residuals_match(port):
    from pint_torch.residuals import Residuals

    r = Residuals(port["batch"], port["model"]).time_resids.numpy()
    assert np.abs(r - port["ref"]["ref/time_resids"]).max() <= 1e-12


def test_designmatrix_columns_match(port):
    M, names = port["model"].designmatrix(port["batch"])
    Mr = port["ref"]["ref/designmatrix"]
    assert names == port["meta"]["reference"]["designmatrix_names"]
    err = np.abs(M.numpy() - Mr).max(axis=0) / np.abs(Mr).max(axis=0)
    assert err.max() <= 1e-9


def test_fit_matches(port):
    ref, rr = port["ref"], port["meta"]["reference"]
    f = port["fitter"]
    vals = np.array([f.model.value(p) for p in rr["postfit_params"]])
    unc = np.array([f.model[p].uncertainty for p in rr["postfit_params"]])
    sig = ref["ref/postfit_uncertainties"]
    assert np.abs((vals - ref["ref/postfit_values"]) / sig).max() <= 1e-3
    assert np.abs(unc / sig - 1).max() <= 1e-6
    assert abs(port["chi2"] / rr["postfit_chi2"] - 1) <= 1e-8


def test_grid_matches(port):
    ref, rr = port["ref"], port["meta"]["reference"]
    s = port["surface"]
    assert s.shape == (4, 4)
    assert np.abs(s / ref["ref/grid_chi2"] - 1).max() <= 1e-8
    argmin = [int(i) for i in np.unravel_index(int(np.nanargmin(s)), s.shape)]
    assert argmin == rr["grid_argmin"]
    np.testing.assert_array_equal(
        port["fitter"].last_grid_diagnostics["ladder_rung"],
        ref["ref/grid_rungs"])


def test_grid_poisons_an_unphysical_point(port):
    """SINI > 1 makes the Shapiro log NaN: the point's chi2 is NaN at every
    escalation rung (rung -1), never a fabricated number."""
    from pint_torch.grid import grid_chisq

    f = port["fitter"]
    s, _ = grid_chisq(f, ("M2", "SINI"), ([0.3], [0.95, 1.2]), niter=1,
                      chunk=16)
    assert np.isfinite(s[0, 0]) and np.isnan(s[0, 1])
    assert f.last_grid_diagnostics["ladder_rung"].tolist() == [[0, -1]]


def test_full_width_fit_matches_committed_reference():
    """The committed B1855-shaped stand-in through the port's fit on the
    CPU (4005 TOAs, 89 free parameters), against the reference outputs in
    the file: residuals 1e-10 s, post-fit chi2 1e-6, values 1e-2 sigma (the
    card's bars; measured 1.6e-13 s, 3e-10, 1.2e-7 sigma)."""
    from pint_torch.bridge import STANDIN_PATH, load_snapshot, read_snapshot
    from pint_torch.gls_fitter import GLSFitter
    from pint_torch.residuals import Residuals

    meta, ref = read_snapshot(STANDIN_PATH)
    m, b = load_snapshot(STANDIN_PATH, device="cpu")
    r = Residuals(b, m).time_resids.numpy()
    assert np.abs(r - ref["ref/time_resids"]).max() <= 1e-10
    f = GLSFitter(b, m)
    chi2 = f.fit_toas(maxiter=2)
    rr = meta["reference"]
    assert abs(chi2 / rr["postfit_chi2"] - 1) <= 1e-6
    vals = np.array([f.model.value(p) for p in rr["postfit_params"]])
    assert np.abs((vals - ref["ref/postfit_values"])
                  / ref["ref/postfit_uncertainties"]).max() <= 1e-2


@pytest.fixture(scope="module")
def system(reference):
    """The reference's augmented GLS system of the small stand-in, as
    numpy: (M, r, Nvec, phiinv, U, w, sigma)."""
    model, toas = reference
    from pint_tpu.gls_fitter import build_augmented_system
    from pint_tpu.residuals import Residuals

    M, _, _, phiinv, Nvec, _ = build_augmented_system(model, toas)
    r = np.asarray(Residuals(toas, model).time_resids)
    U, w = model.noise_model_basis_weight(toas)
    return (np.asarray(M), r, np.asarray(Nvec), np.asarray(phiinv),
            np.asarray(U), np.asarray(w),
            np.asarray(model.scaled_toa_uncertainty(toas)))


def _t(x):
    import torch

    return torch.tensor(np.asarray(x), dtype=torch.float64)


def test_dense_gls_path_matches_reference(system):
    """Normal equations, the Cholesky ladder and the SVD solve against the
    reference's (``gls_fitter.py:50-88,162-185``), 1e-9 relative."""
    from pint_tpu import gls_fitter as jg
    from pint_torch import gls_fitter as tg

    M, r, Nvec, phiinv = system[:4]
    mj, yj = jg.gls_normal_equations(M, r, Nvec=Nvec, phiinv=phiinv)
    mt, yt = tg.gls_normal_equations(_t(M), _t(r), _t(Nvec), _t(phiinv))
    assert np.abs(mt.numpy() - mj).max() <= 1e-12 * np.abs(mj).max()
    assert np.abs(yt.numpy() - yj).max() <= 1e-12 * np.abs(yj).max()
    for solve in ("_solve_cholesky", "_solve_svd"):
        args = () if solve == "_solve_cholesky" else (0.0, [])
        xvj, xhj, dj = getattr(jg, solve)(mj, yj, *args)
        xvt, xht, dt = getattr(tg, solve)(mt, yt, *args)
        assert dt.method == dj.method
        assert np.abs(xht.numpy() - xhj).max() <= 1e-9 * np.abs(xhj).max()
        assert np.abs(xvt.numpy() - xvj).max() <= 1e-9 * np.abs(xvj).max()


def test_woodbury_and_sherman_morrison_match_reference(system):
    from pint_tpu import utils as ju
    from pint_torch import utils as tu

    _, r, _, _, U, w, sigma = system
    N = sigma**2
    dj, lj = ju.woodbury_dot(N, U, w, r, r)
    dt, lt = tu.woodbury_dot(_t(N), _t(U), _t(w), _t(r), _t(r))
    assert abs(float(dt) / float(dj) - 1) <= 1e-10
    assert abs(float(lt) / float(lj) - 1) <= 1e-12
    ne = sum(1 for c in range(U.shape[1]) if set(np.unique(U[:, c])) <= {0, 1}
             and w[c] < 1e-9)  # the ECORR columns lead the basis
    dj, lj = ju.sherman_morrison_dot(N, U[:, :ne], w[:ne], r, r)
    dt, lt = tu.sherman_morrison_dot(_t(N), _t(U[:, :ne]), _t(w[:ne]),
                                     _t(r), _t(r))
    assert abs(float(dt) / float(dj) - 1) <= 1e-10
    assert abs(float(lt) / float(lj) - 1) <= 1e-12


@pytest.mark.parametrize("case", ["healthy", "singular", "nan"])
def test_ladder_cholesky_solve_matches_reference(case):
    from pint_tpu.runtime.solve import ladder_cholesky_solve as jladder
    from pint_torch.runtime.solve import ladder_cholesky_solve as tladder

    rng = np.random.default_rng(5)
    X = rng.standard_normal((12, 30))
    A = X @ X.T
    if case == "singular":
        A = X[:, :6] @ X[:, :6].T
    if case == "nan":
        A[1, 2] = np.nan
    b = rng.standard_normal(12)
    xj, lvj, rj, cj = (np.asarray(v) for v in jladder(A, b, 1e-12))
    xt, lvt, rt, ct = (v.numpy() for v in tladder(_t(A), _t(b), 1e-12))
    assert int(lvt) == int(lvj)
    assert float(rt) == float(rj)
    if case == "nan":
        assert np.isnan(xt).all() and np.isnan(xj).all()
        assert np.isnan(float(ct)) and np.isnan(float(cj))
    elif case == "singular":
        # rank 6 of 12: the ridge rung solves, and x is ridge-dominated
        assert np.all(np.isfinite(xt))
    else:
        assert np.abs(xt - xj).max() <= 1e-9 * np.abs(xj).max()
        assert abs(float(ct) / float(cj) - 1) <= 1e-9


def test_batch_moves_between_devices_unchanged(port):
    b = port["batch"]
    c = b.to("cpu")
    assert c is not b and c.ntoas == b.ntoas and c.tdb0 == b.tdb0
    for x, y in ((c.tdb.hi, b.tdb.hi), (c.tdb_s.lo, b.tdb_s.lo),
                 (c.ssb_obs_vel, b.ssb_obs_vel)):
        assert x.dtype == y.dtype and bool((x == y).all())
