"""The WLS slice end to end on the CPU: ELL1 residuals and design matrix,
``WLSFitter``, ``DownhillWLSFitter`` and the WLS chi2 grid, plus K5's
plain twin against ``jnp.linalg.lstsq``.

The small J1909-3744-shaped stand-in (``SMALL_ELL1_SETTINGS``: 20 epochs
x 4 sub-bands, ELL1, ecliptic astrometry, 3 DMX windows, EFAC/EQUAD, no
correlated noise) runs through the reference package (``WLSFitter`` with
``maxiter=2``, ``DownhillWLSFitter``, a 4x4 M2 x SINI grid with
``niter=4``) and, through a snapshot, through the port on the CPU.  The
bars are ``chip_smoke.py``'s for the full-width stand-in: residuals 1e-10
s, chi2 1e-6 rel, values 1e-2 sigma, uncertainties 1e-6 rel, the grid 1e-6
rel with the same argmin and rungs.  Measured on the small stand-in:
residuals 9.5e-14 s (the reference's jitted evaluation against its own
eager arithmetic, which the port matches), chi2 6.5e-8 and 4.6e-9 rel,
grid 1.2e-7 rel.
"""

import os
import sys
import warnings

import numpy as np
import pytest

import jax.numpy as jnp
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import _torch_standin as standin  # noqa: E402

from pint_torch.kernels import wls_lstsq as K5  # noqa: E402

pytestmark = pytest.mark.torch

F64 = torch.float64
EPS = np.finfo(np.float64).eps


@pytest.fixture(scope="module")
def snap():
    model, toas = standin.make_standin(standin.SMALL_ELL1_SETTINGS,
                                       full=False)
    return standin.export_wls_snapshot(model, toas,
                                       standin.SMALL_ELL1_SETTINGS, chunk=16)


@pytest.fixture(scope="module")
def port(snap):
    from pint_torch.bridge import load_snapshot, read_snapshot
    from pint_torch.fitter import DownhillWLSFitter, WLSFitter
    from pint_torch.grid import grid_chisq

    meta, arrays = read_snapshot(snap)
    m, b = load_snapshot(snap, device="cpu")
    f = WLSFitter(b, m)
    chi2 = f.fit_toas(maxiter=2)
    d = DownhillWLSFitter(b, m)
    chi2_d = d.fit_toas()
    surface, _ = grid_chisq(f, ("M2", "SINI"),
                            (arrays["ref/grid_m2"], arrays["ref/grid_sini"]),
                            niter=4, chunk=16)
    return dict(meta=meta, ref=arrays, model=m, batch=b, fitter=f, chi2=chi2,
                downhill=d, chi2_downhill=chi2_d, surface=surface)


def test_ell1_residuals_and_designmatrix_match(port):
    from pint_torch.residuals import Residuals

    assert "BinaryELL1" in port["model"].components
    assert "AstrometryEcliptic" in port["model"].components
    r = Residuals(port["batch"], port["model"]).time_resids.numpy()
    assert np.abs(r - port["ref"]["ref/time_resids"]).max() <= 1e-10
    M, names = port["model"].designmatrix(port["batch"])
    Mr = port["ref"]["ref/designmatrix"]
    assert names == port["meta"]["reference"]["designmatrix_names"]
    err = np.abs(M.numpy() - Mr).max(axis=0) / np.abs(Mr).max(axis=0)
    assert err.max() <= 1e-9


@pytest.mark.parametrize("which", ["postfit", "downhill"])
def test_wls_fits_match(port, which):
    """``WLSFitter.fit_toas(maxiter=2)`` and ``DownhillWLSFitter.fit_toas()``
    from the snapshot's values: chi2, values, uncertainties and the
    downhill converged flag against the reference's."""
    ref, rr = port["ref"], port["meta"]["reference"]
    f = port["fitter"] if which == "postfit" else port["downhill"]
    chi2 = port["chi2"] if which == "postfit" else port["chi2_downhill"]
    vals = np.array([f.model.value(p) for p in rr["postfit_params"]])
    unc = np.array([f.model[p].uncertainty for p in rr["postfit_params"]])
    sig = ref[f"ref/{which}_uncertainties"]
    assert np.abs((vals - ref[f"ref/{which}_values"]) / sig).max() <= 1e-2
    assert np.abs(unc / sig - 1).max() <= 1e-6
    assert abs(chi2 / rr[f"{which}_chi2"] - 1) <= 1e-6
    if which == "downhill":
        assert port["downhill"].converged == rr["downhill_converged"]
    assert f.covariance.shape == (len(f.fitted_params),) * 2


def test_wls_grid_matches(port):
    ref, rr = port["ref"], port["meta"]["reference"]
    s = port["surface"]
    assert s.shape == (4, 4)
    assert np.abs(s / ref["ref/grid_chi2"] - 1).max() <= 1e-6
    argmin = [int(i) for i in np.unravel_index(int(np.nanargmin(s)), s.shape)]
    assert argmin == rr["grid_argmin"]
    diag = port["fitter"].last_grid_diagnostics
    np.testing.assert_array_equal(diag["ladder_rung"], ref["ref/grid_rungs"])
    assert (diag["ridge"] == 0).all() and np.isfinite(diag["condition"]).all()


def test_wls_grid_poisons_an_unphysical_point(port):
    """SINI > 1 makes the Shapiro log NaN: the point's chi2 is NaN and its
    rung -1, never a fabricated number."""
    from pint_torch.grid import grid_chisq

    f = port["fitter"]
    s, _ = grid_chisq(f, ("M2", "SINI"), ([0.2], [0.99, 1.2]), niter=2,
                      chunk=4)
    assert np.isfinite(s[0, 0]) and np.isnan(s[0, 1])
    assert f.last_grid_diagnostics["ladder_rung"].tolist() == [[3, -1]]


def test_wls_fitters_refuse_correlated_noise_and_unported_modes(port):
    """The refusal that remains: correlated noise in a WLS fitter.  The
    modes that waited for ``ROADMAP.md`` A6 now run: ``Fitter.auto`` on
    wideband TOAs picks ``WidebandDownhillFitter``, and a downhill fit
    with a free EFAC alternates timing and noise fits."""
    import dataclasses

    from pint_torch.bridge import STANDIN_PATH, load_snapshot
    from pint_torch.fitter import (CorrelatedErrors, DownhillWLSFitter,
                                   Fitter, WLSFitter)
    from pint_torch.wideband import WidebandDownhillFitter

    m, b = load_snapshot(STANDIN_PATH, device="cpu")
    for cls in (WLSFitter, DownhillWLSFitter):
        with pytest.raises(CorrelatedErrors, match="EcorrNoise"):
            cls(b, m)
    batch, model = port["batch"], port["model"]
    dm = model.total_dm(batch)
    wb = dataclasses.replace(batch, dm=dm, dm_error=torch.full_like(dm, 1e-4))
    assert type(Fitter.auto(wb, model)) is WidebandDownhillFitter
    m2 = model.copy()
    efac = next(p for p in m2.params_table if p.startswith("EFAC"))
    m2[efac].frozen = False
    f = DownhillWLSFitter(batch, m2)
    f.fit_toas(noise_fit_niter=1)
    assert [r.names for r in f.noise_fit_results] == [[efac]]
    assert f.noise_fit_results[0].converged
    assert f.model.value(efac) != model.value(efac)
    assert f.model[efac].uncertainty > 0


def test_downhill_stops_at_maxiter_as_the_reference_does(port):
    """One downhill step from the snapshot's values does not meet the
    chi2-decrease tolerance: ``raise_on_maxiter`` raises
    :class:`MaxiterReached`, and without it the fit warns and returns
    unconverged (reference ``fitter.py:739-745``)."""
    from pint_torch.fitter import DownhillWLSFitter, MaxiterReached

    with pytest.raises(MaxiterReached):
        DownhillWLSFitter(port["batch"], port["model"]).fit_toas(
            maxiter=1, raise_on_maxiter=True)
    f = DownhillWLSFitter(port["batch"], port["model"])
    with pytest.warns(UserWarning, match="maxiter=1"):
        f.fit_toas(maxiter=1)
    assert not f.converged


def test_wls_entry_points_default_to_the_gpu():
    from pint_torch import NoGPUError
    from pint_torch.bridge import ELL1_PATH, load_snapshot

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(NoGPUError):
        load_snapshot(ELL1_PATH)


@pytest.fixture(scope="module")
def empty_jump():
    """The small ELL1 stand-in with a JUMP that selects no TOA, in the
    reference: its WLS fit's warnings and its grid."""
    from pint_tpu.fitter import WLSFitter

    s = standin.SMALL_ELL1_EMPTY_JUMP_SETTINGS
    model, toas = standin.make_standin(s, full=False)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        WLSFitter(toas, model).fit_toas(maxiter=1)
    msgs = [str(x.message) for x in w
            if x.category.__name__ == "DegeneracyWarning"]
    return standin.export_wls_snapshot(model, toas, s, chunk=16), msgs


def test_rank_deficient_wls_warns_like_the_reference(empty_jump):
    """A JUMP with no TOA leaves a zero design column: the port's WLS fit
    drops that direction with the reference's DegeneracyWarning text, its
    fit matches, and its grid stays finite and matches the reference's."""
    from pint_torch.bridge import load_snapshot, read_snapshot
    from pint_torch.fitter import DegeneracyWarning, WLSFitter
    from pint_torch.grid import grid_chisq

    arrays, ref_msgs = empty_jump
    assert ref_msgs and all("JUMP2" in m for m in ref_msgs)
    meta, _ = read_snapshot(arrays)
    m, b = load_snapshot(arrays, device="cpu")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        WLSFitter(b, m).fit_toas(maxiter=1)
    msgs = [str(x.message) for x in w if x.category is DegeneracyWarning]
    assert msgs == ref_msgs
    f = WLSFitter(b, m)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DegeneracyWarning)
        chi2 = f.fit_toas(maxiter=2)
    assert abs(chi2 / meta["reference"]["postfit_chi2"] - 1) <= 1e-6
    s, _ = grid_chisq(f, ("M2", "SINI"),
                      (arrays["ref/grid_m2"], arrays["ref/grid_sini"]),
                      niter=4, chunk=16)
    assert np.isfinite(s).all()
    assert np.abs(s / arrays["ref/grid_chi2"] - 1).max() <= 1e-6
    np.testing.assert_array_equal(f.last_grid_diagnostics["ladder_rung"],
                                  arrays["ref/grid_rungs"])


def test_committed_ell1_stand_in_fits_match_on_the_cpu():
    """The committed full-width stand-in through the port's two WLS fits on
    the CPU, against the reference outputs stored in it (measured: chi2
    9.5e-10 rel, values 2.2e-7 sigma)."""
    from pint_torch.bridge import ELL1_PATH, load_snapshot, read_snapshot
    from pint_torch.fitter import DownhillWLSFitter, WLSFitter

    meta, ref = read_snapshot(ELL1_PATH)
    rr = meta["reference"]
    m, b = load_snapshot(ELL1_PATH, device="cpu")
    for cls, key, kw in ((WLSFitter, "postfit", {"maxiter": 2}),
                         (DownhillWLSFitter, "downhill", {})):
        f = cls(b, m)
        chi2 = f.fit_toas(**kw)
        vals = np.array([f.model.value(p) for p in rr["postfit_params"]])
        sig = ref[f"ref/{key}_uncertainties"]
        assert abs(chi2 / rr[f"{key}_chi2"] - 1) <= 1e-6
        assert np.abs((vals - ref[f"ref/{key}_values"]) / sig).max() <= 1e-2


# ---------------------------------------------------------------------------
# K5's twin against the reference's lstsq
# ---------------------------------------------------------------------------
def _system(rng, n, k, cond_n, colscale):
    q1, _ = np.linalg.qr(rng.normal(size=(n, k)))
    q2, _ = np.linalg.qr(rng.normal(size=(k, k)))
    A = (q1 * np.logspace(0, -np.log10(cond_n), k)) @ q2.T
    return A * np.logspace(0, colscale, k)[rng.permutation(k)]


def _reference_lstsq(Aw, rw):
    norms = jnp.linalg.norm(Aw, axis=0)
    norms = jnp.where(norms == 0, 1.0, norms)
    x, _, _, sv = jnp.linalg.lstsq(Aw / norms, rw)
    return np.asarray(x), np.asarray(sv), np.asarray(norms)


@pytest.mark.parametrize("kind", ["full-rank", "rank-deficient", "nan"])
def test_wls_lstsq_twin_matches_reference_lstsq(kind):
    """K5's twin against ``jnp.linalg.lstsq`` of the normalized matrix, as
    ``grid.py:309-321`` calls it, point by point: x within 1e-10 of
    max|x|, singular values within 1e-12 of the largest, the same rank
    under the cutoff eps max(N, k) s_max; NaN x and s for a point holding
    a NaN.  Full-rank systems reach raw condition numbers of 1e10 (a
    normalized one to 1e5 times column scales to 1e7: two SVDs of one
    matrix agree in x to about cond(normalized) x eps, see the next
    test); the rank-deficient ones hold an all-zero column or two equal
    ones."""
    rng = np.random.default_rng({"full-rank": 1, "rank-deficient": 2,
                                 "nan": 3}[kind])
    N, k = 300, 24
    if kind == "full-rank":
        As = [_system(rng, N, k, 1e5, 5), _system(rng, N, k, 1e3, 7),
              rng.normal(size=(N, k))]
    elif kind == "rank-deficient":
        As = [rng.normal(size=(N, k)), _system(rng, N, k, 1e3, 2)]
        As[0][:, 5] = 0.0
        As[1][:, 9] = As[1][:, 2]
    else:
        As = [rng.normal(size=(N, k)), rng.normal(size=(N, k))]
        As[1][17, 4] = np.nan
    Aw = np.stack(As)
    rw = rng.normal(size=(len(As), N))
    x, sv, norms = (t.numpy() for t in K5.wls_lstsq_reference(
        torch.tensor(Aw), torch.tensor(rw)))
    cut = EPS * max(N, k)
    for i in range(len(As)):
        xr, svr, nr = _reference_lstsq(jnp.asarray(Aw[i]), jnp.asarray(rw[i]))
        np.testing.assert_allclose(norms[i], nr, rtol=1e-14)
        if not np.isfinite(Aw[i]).all():
            assert np.isnan(x[i]).all() and np.isnan(sv[i]).all()
            assert np.isnan(svr).all()
            continue
        assert np.abs(x[i] - xr).max() <= 1e-10 * np.abs(xr).max()
        assert np.abs(sv[i] - svr).max() <= 1e-12 * svr[0]
        assert ((sv[i] > 0) & (sv[i] >= cut * sv[i][0])).sum() \
            == ((svr > 0) & (svr >= cut * svr[0])).sum()
        if kind == "rank-deficient":
            assert ((svr > 0) & (svr >= cut * svr[0])).sum() == k - 1
    if kind == "rank-deficient":
        assert abs(x[0, 5]) <= 1e-10 * np.abs(x[0]).max()


def test_wls_lstsq_twin_agrees_to_the_condition_number():
    """Beyond that, the twin's x and the reference's differ by the
    rounding any SVD leaves, about cond(normalized) x eps of max|x|: at a
    normalized condition number of 1e6 (raw 1e10) this system's gap is
    8.0e-11 of max|x| on LAPACK's CPU SVDs, held here to 3e-10 so that a
    twin rounding worse than an SVD would fail; the singular values stay
    within 1e-12."""
    rng = np.random.default_rng(1)
    N, k, cond = 300, 24, 1e6
    Aw = _system(rng, N, k, cond, 4)
    rw = rng.normal(size=N)
    x, sv, _ = (t.numpy()[0] for t in K5.wls_lstsq_reference(
        torch.tensor(Aw[None]), torch.tensor(rw[None])))
    xr, svr, _ = _reference_lstsq(jnp.asarray(Aw), jnp.asarray(rw))
    assert np.abs(x - xr).max() <= 3e-10 * np.abs(xr).max()
    assert np.abs(sv - svr).max() <= 1e-12 * svr[0]


def test_wls_lstsq_dispatches_on_the_device_and_checks_shapes():
    from pint_torch import kernels

    kernels.reset_counts()
    Aw = torch.ones((2, 5, 3), dtype=F64)
    with pytest.raises(ValueError):
        K5.wls_lstsq(Aw, torch.ones((2, 4), dtype=F64))
    with pytest.raises(ValueError):
        K5.wls_lstsq(Aw.float(), torch.ones((2, 5)))
    x, sv, norms = K5.wls_lstsq(Aw, torch.ones((2, 5), dtype=F64))
    assert x.shape == sv.shape == norms.shape == (2, 3)
    assert not any(kernels.launch_counts()[n] for n in K5.KERNELS.values())
