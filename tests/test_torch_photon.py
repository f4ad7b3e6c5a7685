"""The port's photon-template fitters and K8's plain version
(``pint_torch/event_fitter.py``, ``pint_torch/kernels/photon_lnlike.py``)
against the JAX package's on the CPU.

K8's plain version against the reference's ``_template_density`` and its
log-sum, in both modes, with and without weights, on edge phases (0, -0.0,
-1e-17, 1 - 1e-16, every k / nbins and one ulp either side, NaNs), a
zero-density bin and 1, 2 and 5 peaks (the density bitwise, with XLA's
exponential for the Gaussian mode; the sums within 1e-12 of their sum of
|terms|).  Both fitters live on the small photon stand-in (the reference
photon test's 300 photons, with weights): ``lnposterior_batch`` at 1e-12
rel, a seeded 16-walker x 30-step chain at the chain bars (each decision
the reference's unless the port's margin is within the lnposterior bar,
the walkers bitwise), the ``minMJD``/``maxMJD`` selection, the empty
chain's ``ValueError``, ``marginalize_over_phase`` (bitwise), the FFTFIT
start; a template of other primitives through their torch branches; and
the committed full-width J0030 stand-in's ``ref/photon/`` outputs replayed
at a small depth.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import _torch_standin as standin  # noqa: E402

pytestmark = pytest.mark.torch

S = standin.SMALL_PHOTON_SETTINGS


def _xla_exp(x):
    return torch.from_numpy(np.array(jnp.exp(jnp.asarray(x.numpy()))))


@pytest.fixture(scope="module")
def small():
    """The reference's small photon stand-in (truth, TOAs, weights, the
    starting model and priors) and the port's from the committed file."""
    from pint_torch.bridge import PHOTON_SMALL_PATH, load_snapshot

    truth, toas, w = standin.make_photon_standin(S)
    m2, info = standin.photon_start(truth, S)
    m, b = load_snapshot(PHOTON_SMALL_PATH, device="cpu")
    return dict(truth=truth, toas=toas, w=w, m2=m2, info=info, m=m, b=b)


def _templates(peaks):
    from pint_torch import templates as P
    from pint_tpu import templates as R

    return tuple(mod.LCTemplate([mod.LCGaussian([sg, loc])
                                 for sg, loc, _ in peaks],
                                [n for _, _, n in peaks]) for mod in (P, R))


def _edge_rows(nbins):
    """Edge phases; next to 0 the smallest normal numbers stand for the
    ulps (XLA's CPU code, the reference here, flushes subnormals to zero;
    the card's check of K8 against its plain version takes the
    subnormals)."""
    tiny = np.finfo(np.float64).tiny
    edge = [0.0, -0.0, -1e-17, 1.0 - 1e-16, 0.5, -0.5, 1e-300, -tiny, tiny]
    for k in range(1, nbins + 1):
        x = k / nbins
        edge += [np.nextafter(x, -np.inf), x, np.nextafter(x, np.inf)]
    edge = np.asarray(edge)
    rng = np.random.default_rng(3)
    nan_row = rng.uniform(-0.5, 0.5, len(edge))
    nan_row[::7] = np.nan
    return np.stack([edge, edge - 1.0, rng.uniform(-0.5, 0.5, len(edge)),
                     nan_row])


PEAKS = {"1 peak": [[0.005, 0.3, 0.7]],
         "2 peaks": [[0.04, 0.15, 0.35], [0.06, 0.59, 0.25]],
         "5 peaks": [[0.005, 0.1, 0.2], [0.3, 0.5, 0.2], [0.02, 0.62, 0.15],
                     [0.1, 0.8, 0.1], [0.05, 0.95, 0.1]]}


@pytest.mark.parametrize("weighted", [True, False], ids=["w", "no-w"])
@pytest.mark.parametrize("mode", ["binned", "1 peak", "2 peaks", "5 peaks"])
def test_k8_plain_version_is_the_reference_density_and_log_sum(
        mode, weighted, monkeypatch):
    """K8's plain version, through its CPU wrapper, against the
    reference fitters' ``_template_density`` at ``jnp.mod(frac, 1)`` and
    ``jnp.sum(jnp.log(jnp.maximum(w f + 1 - w, 1e-300)))`` on edge rows:
    the density bitwise (NaN where the reference has NaN), each row's
    sum within 1e-12 of its sum of |terms|."""
    from pint_torch.kernels.photon_lnlike import (BINNED, GAUSS,
                                                  gauss_table, photon_lnlike)
    from pint_tpu.event_fitter import (MCMCFitterAnalyticTemplate,
                                       MCMCFitterBinnedTemplate)

    nbins = 64
    frac = _edge_rows(nbins)
    rng = np.random.default_rng(4)
    w = rng.beta(0.5, 1.5, frac.shape[1])
    w[::5], w[1::5] = 0.0, 1.0
    port_t, ref_t = _templates(PEAKS["2 peaks" if mode == "binned"
                                     else mode])
    ref = (MCMCFitterBinnedTemplate if mode == "binned"
           else MCMCFitterAnalyticTemplate).__new__(
        MCMCFitterBinnedTemplate if mode == "binned"
        else MCMCFitterAnalyticTemplate)
    ref.template = ref_t
    if mode == "binned":
        ref.nbins = nbins
        ref.template_bins = np.asarray(ref_t((np.arange(nbins) + 0.5)
                                             / nbins))
        ref.template_bins[3] = 0.0  # a zero-density bin
        table = torch.tensor(ref.template_bins, dtype=torch.float64)
        w[np.minimum(((frac[0] % 1.0) * nbins).astype(int), nbins - 1)
          == 3] = 1.0
        kmode = BINNED
    else:
        table = torch.tensor(gauss_table(port_t), dtype=torch.float64)
        kmode = GAUSS
    wt = torch.tensor(w, dtype=torch.float64) if weighted else None
    want_f = np.stack([np.asarray(ref._template_density(
        jnp.mod(jnp.asarray(r), 1.0))) for r in frac])
    wj = jnp.asarray(w) if weighted else None
    want_l = np.array([float(jnp.sum(jnp.log(jnp.maximum(
        f if wj is None else wj * f + (1.0 - wj), 1e-300))))
        for f in want_f])
    if mode != "binned":
        monkeypatch.setattr(torch, "exp", _xla_exp)
    ft = torch.tensor(frac, dtype=torch.float64)
    got_f = photon_lnlike(ft, wt, table, kmode, density=True).numpy()
    got_l = photon_lnlike(ft, wt, table, kmode).numpy()
    assert np.array_equal(got_f, want_f, equal_nan=True)
    v = want_f if not weighted else w * want_f + (1.0 - w)
    scale = np.abs(np.log(np.maximum(v, 1e-300))).sum(axis=1)
    fin = np.isfinite(want_l)
    assert np.array_equal(np.isnan(got_l), np.isnan(want_l))
    assert (np.abs(got_l[fin] - want_l[fin]) <= 1e-12 * scale[fin]).all()
    if mode == "binned":  # the zero bin's photons give log(1e-300)
        assert np.isclose(got_l[0], want_l[0], rtol=0, atol=1e-9)


def test_k8_refuses_bad_shapes_and_modes():
    from pint_torch.kernels.photon_lnlike import (BINNED, GAUSS,
                                                  photon_lnlike)

    f = torch.zeros((2, 5), dtype=torch.float64)
    with pytest.raises(ValueError):
        photon_lnlike(f, None, torch.ones(6, dtype=torch.float64), GAUSS)
    with pytest.raises(ValueError):
        photon_lnlike(f, torch.ones(4, dtype=torch.float64),
                      torch.ones(8, dtype=torch.float64), BINNED)
    with pytest.raises(ValueError):
        photon_lnlike(f, None, torch.ones(8, dtype=torch.float64), 7)
    with pytest.raises(ValueError):
        photon_lnlike(f.float(), None, torch.ones(8, dtype=torch.float64),
                      BINNED)


def _fitters(small, pkg, kind, nwalkers=16, **kw):
    """A ``kind`` fitter of package ``pkg`` on the small stand-in after the
    FFTFIT start (the stored shift), with the settings' priors."""
    from pint_torch import event_fitter as PE
    from pint_torch.templates import LCGaussian as PG
    from pint_torch.templates import LCTemplate as PT
    from pint_tpu import event_fitter as RE
    from pint_tpu.sampler import EnsembleSampler as RS
    from pint_torch.sampler import EnsembleSampler as PS

    port = pkg == "port"
    mod = PE if port else RE
    tpl = PT([PG([sg, loc]) for sg, loc, _ in S["peaks"]],
             [n for *_, n in S["peaks"]]) if port \
        else standin.photon_template(S)
    shift = float(_stored(small)[1]["fftfit"][0])
    rot = tpl.copy()
    rot.rotate(shift)
    sampler = (PS if port else RS)(nwalkers,
                                   seed=standin.PHOTON_SEEDS["sampler"])
    toas = small["b"] if port else small["toas"]
    model = small["m"] if port else small["m2"]
    w = None if port else small["w"]
    if kind == "binned":
        f = mod.MCMCFitterBinnedTemplate(toas, model, tpl, nbins=S["nbins"],
                                         weights=w, prior_info=small["info"],
                                         sampler=sampler, **kw)
        f.set_template(rot)
        return f
    return mod.MCMCFitterAnalyticTemplate(toas, model, rot, weights=w,
                                          prior_info=small["info"],
                                          sampler=sampler, **kw)


def _stored(small):
    from pint_torch.bridge import PHOTON_SMALL_PATH, read_snapshot

    meta, ref = read_snapshot(PHOTON_SMALL_PATH)
    return ref, meta["reference"]["photon"]


def test_committed_small_photon_is_a_fresh_export(small):
    """The committed small stand-in's state is the reference's simulation
    bitwise, its weights under ``weight``; the batch carries them, every
    component's context is empty and the photons are barycentred at
    infinite frequency."""
    arrays = standin.export_state(small["m2"], small["toas"])
    ref, R = _stored(small)
    for k, v in arrays.items():
        if k != "meta":
            assert np.array_equal(v, ref[k]), k
    assert np.array_equal(ref["weight"], small["w"])
    b = small["b"]
    assert np.array_equal(b.weights.numpy(), small["w"])
    assert bool(torch.isinf(b.freq).all())
    assert not bool(b.ssb_obs_pos.any())
    assert not any(c.context for c in small["m"].components.values())
    assert R["settings"] == S


@pytest.mark.parametrize("kind", ["binned", "analytic"])
def test_lnposterior_batch_matches_reference(small, kind):
    """Both fitters' lnposterior at the stored points (8 outside the
    prior box) within 1e-12 rel of the live reference's, -inf where its;
    the photon prior adds no normalization; the route is in the repr."""
    ref_pts, R = _stored(small)
    pts = ref_pts["ref/photon/points"]
    port = _fitters(small, "port", kind)
    ref = _fitters(small, "ref", kind)
    got, want = port.lnposterior_batch(pts), ref.lnposterior_batch(pts)
    fin = np.isfinite(want)
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    assert (~fin).sum() == standin.PHOTON_OUTSIDE
    assert (np.abs(got[fin] - want[fin]) <= 1e-12 * np.abs(want[fin])).all()
    assert np.array_equal(want, ref_pts[f"ref/photon/lnposterior_{kind}"])
    assert port.lnposterior(pts[0]) == got[0]
    route = "BINNED" if kind == "binned" else "GAUSS"
    assert f"K8 photon_lnlike {route}" in repr(port)
    with pytest.raises(NotImplementedError, match="item 9"):
        port.lnposterior_batch(torch.tensor(pts))


@pytest.mark.parametrize("kind", ["binned", "analytic"])
def test_seeded_chain_at_the_chain_bars(small, kind):
    """A seeded 16-walker x 30-step ``fit_toas`` in both packages from
    the same walkers: each accept decision the reference's unless the
    port's margin is within 1e-12 of the lnposterior's size, the walkers
    bitwise up to the first differing decision, and with none differing
    the whole chain, the maximum and the stds bitwise."""
    port = _fitters(small, "port", kind)
    ref = _fitters(small, "ref", kind)
    pos = port.sampler.get_initial_pos(port.fitkeys, port.get_fitvals(),
                                       port.get_fiterrs(), port.errfact,
                                       seed=standin.PHOTON_SEEDS["pos"])
    port.sampler.decision_log = []
    a = port.fit_toas(maxiter=30, pos=pos.copy())
    b = ref.fit_toas(maxiter=30, pos=pos.copy())
    want = ref.sampler.get_chain()
    prev = np.concatenate([pos[None], want[:-1]])
    acc_ref = np.any(want != prev, axis=2)
    half, upto = 8, 30
    for t in range(30):
        for h, sl in enumerate((slice(0, half), slice(half, 16))):
            marg, lp = port.sampler.decision_log[2 * t + h]
            differ = (marg > 0) != acc_ref[t, sl]
            tol = 2e-12 * np.abs(lp)
            assert not (differ & ~(np.abs(marg) <= tol)).any()
            if differ.any() and upto == 30:
                upto = t
    got = port.sampler.get_chain()
    assert np.array_equal(got[:upto], want[:upto])
    if upto < 30:  # a rounding-close decision parted the chains there
        return
    assert np.array_equal(got, want)
    assert np.allclose(port.sampler.get_log_prob(),
                       ref.sampler.get_log_prob(), rtol=1e-12, atol=0)
    assert port.sampler.naccepted == ref.sampler.naccepted
    assert np.array_equal(port.maxpost_fitvals, ref.maxpost_fitvals)
    assert abs(a - b) <= 1e-12 * abs(b)
    assert port.errors == ref.errors and port.converged


def test_committed_small_chain_replays(small):
    """The committed small stand-in's stored chains replay bitwise on the
    CPU from their stored walkers."""
    ref_a, R = _stored(small)
    for kind in ("binned", "analytic"):
        f = _fitters(small, "port", kind)
        f.fit_toas(maxiter=S["nsteps"],
                   pos=ref_a[f"ref/photon/{kind}/pos"].copy())
        want = ref_a[f"ref/photon/{kind}/walker_chain"].transpose(2, 0, 1)
        assert np.array_equal(f.sampler.get_chain(), want)
        assert f.sampler.naccepted == R[kind]["naccepted"]
        assert np.array_equal(f.maxpost_fitvals,
                              ref_a[f"ref/photon/{kind}/maxpost_fitvals"])


@pytest.mark.parametrize("autocorr", [False, True])
def test_empty_chain_raises(small, autocorr):
    f = _fitters(small, "port", "binned")
    with pytest.raises(ValueError, match="empty chain"):
        f.fit_toas(maxiter=0, seed=1, autocorr=autocorr)


def test_min_max_mjd_selection(small):
    """``minMJD``/``maxMJD`` keep the photons in range in both packages,
    with their weights: the same count, phases and lnposterior."""
    kw = dict(minMJD=54995.0, maxMJD=55005.0)
    port = _fitters(small, "port", "analytic", **kw)
    ref = _fitters(small, "ref", "analytic", **kw)
    assert port.batch.ntoas == len(ref.toas) < S["photons"]
    assert np.array_equal(port.weights, ref.weights)
    assert np.array_equal(port.batch.mjds, np.asarray(ref.toas.get_mjds(),
                                                      dtype=np.float64))
    d = port.phaseogram_phases() - ref.phaseogram_phases()
    assert np.abs((d + 0.5) % 1.0 - 0.5).max() <= 1e-12
    pts = _stored(small)[0]["ref/photon/points"][:8]
    got, want = port.lnposterior_batch(pts), ref.lnposterior_batch(pts)
    assert np.allclose(got, want, rtol=1e-12, atol=0)


def test_select_slices_per_toa_contexts(small):
    """A batch whose model holds per-TOA contexts (DMX windows, JUMP and
    noise masks, ECORR epochs and a basis over the data span) slices into
    a TOA set of its own, its residuals those of its rows; a selection
    that keeps every TOA gives the batch's own residuals; a model without
    contexts slices every per-TOA tensor."""
    from pint_torch.bridge import STANDIN_PATH, load_snapshot
    from pint_torch.residuals import Residuals

    m, b = load_snapshot(STANDIN_PATH, device="cpu")
    full = Residuals(b, m, subtract_mean=False).time_resids
    for keep in (np.arange(b.ntoas) % 2 == 0, np.ones(b.ntoas, bool)):
        sub = b.select(keep, m)
        assert sub.ntoas == int(keep.sum())
        got = Residuals(sub, m, subtract_mean=False).time_resids
        assert torch.equal(got, full[torch.tensor(keep)])
    m, b = small["m"], small["b"]
    keep = np.arange(b.ntoas) % 2 == 0
    half = b.select(keep, m)
    assert half.ntoas == int(keep.sum())
    assert np.array_equal(half.mjds, b.mjds[keep])
    assert torch.equal(half.tdb.hi, b.tdb.hi[torch.tensor(keep)])
    assert torch.equal(half.weights, b.weights[torch.tensor(keep)])
    with pytest.raises(ValueError):
        b.select(keep[:-1], m)


def test_marginalize_over_phase_bitwise(small):
    from pint_torch.event_fitter import marginalize_over_phase as P
    from pint_tpu.event_fitter import marginalize_over_phase as R

    ph = (np.asarray(small["truth"].phase(small["toas"]).frac) + 0.3) % 1.0
    grid = (np.arange(128) + 0.5) / 128
    tb = np.asarray(standin.photon_template(S)(grid))
    for w in (None, small["w"]):
        a, b = P(ph, tb, w), R(ph, tb, w)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_fftfit_start_sequence(small):
    """event_optimize's start: the weighted profile of the port's phases,
    ``fftfit_full``, ``rotate``, ``set_template``: the shift the stored
    one within 1e-12 cycles, the bins rebuilt and the batched function
    dropped, so the next evaluation uses the rotated template."""
    from pint_torch.event_fitter import MCMCFitterBinnedTemplate
    from pint_torch.fftfit import fftfit_full

    ref_a, R = _stored(small)
    tpl, _ = _templates(S["peaks"])
    f = MCMCFitterBinnedTemplate(small["b"], small["m"], tpl,
                                 nbins=S["nbins"], prior_info=small["info"])
    pts = ref_a["ref/photon/points"][:4]
    before = f.lnposterior_batch(pts)
    ph = f.phaseogram_phases()
    assert np.abs(ph - ref_a["ref/photon/phases"]).max() <= 1e-12
    prof, _ = np.histogram(ph, bins=S["nbins"], range=(0.0, 1.0),
                           weights=f.weights)
    grid = (np.arange(S["nbins"]) + 0.5) / S["nbins"]
    got = fftfit_full(tpl(grid), prof.astype(np.float64), device="cpu")
    assert abs(got[0] - R["fftfit"][0]) <= 1e-12
    tpl.rotate(got[0])
    f.set_template(tpl)
    assert f._batch_fn is None and f._bins is None
    assert np.array_equal(f.template_bins, tpl(grid))
    after = f.lnposterior_batch(pts)
    assert not np.array_equal(before, after)
    want = ref_a["ref/photon/lnposterior_binned"][:4]
    assert np.allclose(after, want, rtol=1e-12, atol=0)


def test_accessors_and_refusals(small):
    """The reference's accessor surface: template values (K8's density on
    the batch's device) against the host template, weights, parameters;
    ``lnlikelihood_basic`` and ``lnprior_basic``; the phaseogram's plot
    refused naming item 12; the template fitters from ``mcmc_fitter``."""
    from pint_torch import mcmc_fitter as PM
    from pint_torch.event_fitter import MCMCFitterAnalyticTemplate

    f = _fitters(small, "port", "analytic")
    ph = f.phaseogram_phases()
    assert np.allclose(f.get_template_vals(ph), f.template(ph), rtol=1e-13,
                       atol=0)
    assert np.array_equal(f.get_weights(), small["w"])
    assert f.get_parameter_names() == ["F0"]
    assert f.get_template_parameters() is not None
    x = f.get_parameters()
    lnl = PM.lnlikelihood_basic(f, x)
    lnp = f.lnposterior_batch(x[None])[0]
    assert abs(lnp - lnl) <= 1e-12 * abs(lnl)  # the uniform prior adds 0
    assert PM.lnprior_basic(f, x) == float(f.model["F0"].prior.logpdf(x[0]))
    with pytest.raises(NotImplementedError, match="item 12"):
        f.phaseogram()
    with pytest.raises(TypeError):
        MCMCFitterAnalyticTemplate(small["b"], small["m"], np.ones(8))
    assert PM.MCMCFitterAnalyticTemplate is MCMCFitterAnalyticTemplate


def test_other_primitives_take_the_torch_route(small):
    """An analytic template with a skewed Gaussian peak and a two-sided
    Gaussian is evaluated by the primitives' torch branches (the repr
    says so; a von Mises peak and a two-sided Gaussian alone now take K8's
    MIXED mode, ``test_torch_photon_mixed.py``): its lnposterior within
    1e-12 rel of the reference's."""
    from pint_torch import templates as P
    from pint_torch.event_fitter import MCMCFitterAnalyticTemplate as PA
    from pint_torch.templates import lcprimitives as PP
    from pint_tpu import templates as R
    from pint_tpu.event_fitter import MCMCFitterAnalyticTemplate as RA
    from pint_tpu.templates import lcprimitives as RP

    def tpl(mod, prims):
        return mod.LCTemplate([prims.LCSkewGaussian([0.05, 0.5, 2.0]),
                               prims.LCGaussian2([0.02, 0.04, 0.7])],
                              [0.4, 0.2])

    a = PA(small["b"], small["m"], tpl(P, PP), prior_info=small["info"])
    b = RA(small["toas"], small["m2"], tpl(R, RP), weights=small["w"],
           prior_info=small["info"])
    assert "torch _pdf (LCGaussian2, LCSkewGaussian)" in repr(a)
    pts = _stored(small)[0]["ref/photon/points"]
    got, want = a.lnposterior_batch(pts), b.lnposterior_batch(pts)
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    assert (np.abs(got[fin] - want[fin]) <= 1e-12 * np.abs(want[fin])).all()


def test_normal_prior_has_no_normalization(small):
    """The photon prior is the reference's: -0.5 ((v - mu) / sigma)^2 for
    a normal prior, with no -log(sigma sqrt(2 pi)) term."""
    info = {"F0": {"distr": "normal", "mu": small["m"].value("F0"),
                   "sigma": 3e-8}}
    port = _fitters(small, "port", "binned")
    ref = _fitters(small, "ref", "binned")
    from pint_torch.bayesian import apply_prior_info as pa
    from pint_tpu.bayesian import apply_prior_info as ra

    pa(port.model, info)
    ra(ref.model, info)
    port._batch_fn = ref._batch_fn = None
    pts = _stored(small)[0]["ref/photon/points"][:16]
    got, want = port.lnposterior_batch(pts), ref.lnposterior_batch(pts)
    assert np.allclose(got, want, rtol=1e-12, atol=0)


def test_photon_fitters_default_to_the_gpu(small):
    """Loaded on the default device the photon stand-in needs the card."""
    from pint_torch import NoGPUError
    from pint_torch.bridge import PHOTON_SMALL_PATH, load_snapshot

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(NoGPUError):
        load_snapshot(PHOTON_SMALL_PATH)


# -- the committed full-width J0030 stand-in ---------------------------------
@pytest.fixture(scope="module")
def j0030():
    from pint_torch.bridge import PHOTON_PATH, load_snapshot, read_snapshot

    meta, ref = read_snapshot(PHOTON_PATH)
    m, b = load_snapshot(PHOTON_PATH, device="cpu")
    return meta["reference"]["photon"], ref, m, b


def _j0030_fitter(j0030, kind, nwalkers=128):
    from pint_torch.event_fitter import (MCMCFitterAnalyticTemplate,
                                         MCMCFitterBinnedTemplate)
    from pint_torch.sampler import EnsembleSampler
    from pint_torch.templates import LCGaussian, LCTemplate

    R, ref, m, b = j0030
    s = R["settings"]
    tpl = LCTemplate([LCGaussian([sg, loc]) for sg, loc, _ in s["peaks"]],
                     [n for *_, n in s["peaks"]])
    rot = tpl.copy()
    rot.rotate(R["fftfit"][0])
    sampler = EnsembleSampler(nwalkers, seed=R["seeds"]["sampler"])
    if kind == "binned":
        f = MCMCFitterBinnedTemplate(b, m, tpl, nbins=R["nbins"],
                                     prior_info=R["prior_info"],
                                     sampler=sampler)
        f.set_template(rot)
        return f
    return MCMCFitterAnalyticTemplate(b, m, rot, prior_info=R["prior_info"],
                                      sampler=sampler)


def test_committed_j0030_phases_and_fftfit(j0030):
    """32768 weighted photons over MJD 54700-59000: the port's phases
    within 1e-10 s x F0 of the stored ones, every photon in the stored
    one's bin, the FFTFIT shift within 1e-12 cycles."""
    from pint_torch.fftfit import fftfit_full

    R, ref, m, b = j0030
    f = _j0030_fitter(j0030, "binned")
    ph = f.phaseogram_phases()
    assert b.ntoas == 32768 and f.weights is not None
    d = (ph - ref["ref/photon/phases"] + 0.5) % 1.0 - 0.5
    assert np.abs(d).max() <= 1e-10 * m.value("F0")
    nb = R["nbins"]
    assert np.array_equal((ph * nb).astype(int),
                          (ref["ref/photon/phases"] * nb).astype(int))
    prof, _ = np.histogram(ph, bins=nb, range=(0.0, 1.0), weights=f.weights)
    _, tpl = _templates(R["settings"]["peaks"])  # as the exporter's, unrotated
    grid = (np.arange(nb) + 0.5) / nb
    got = fftfit_full(np.asarray(tpl(grid)), prof.astype(np.float64),
                      device="cpu")
    assert abs(got[0] - R["fftfit"][0]) <= 1e-12
    assert abs(got[2] - R["fftfit"][2]) <= 1e-12 * abs(R["fftfit"][2])
    assert f.density_route() == "K8 photon_lnlike BINNED (256 bins)"


@pytest.mark.parametrize("kind", ["binned", "analytic"])
def test_committed_j0030_lnposterior_replays(j0030, kind):
    """The stored lnposterior of both fitters at 16 of the 64 points
    (including 2 outside the box), within 1e-12 rel on the CPU, -inf
    where the reference's."""
    R, ref, m, b = j0030
    f = _j0030_fitter(j0030, kind, 16)
    idx = np.r_[0:14, 62:64]
    pts = ref["ref/photon/points"][idx]
    got = f.lnposterior_batch(pts)
    want = ref[f"ref/photon/lnposterior_{kind}"][idx]
    fin = np.isfinite(want)
    assert (~fin).sum() == 2 and np.array_equal(np.isfinite(got), fin)
    assert (np.abs(got[fin] - want[fin]) <= 1e-12 * np.abs(want[fin])).all()


def test_committed_j0030_chain_first_steps(j0030):
    """The stored analytic chain's first two steps from the stored
    walkers replayed on the CPU: walkers bitwise, lnprob 1e-12 rel."""
    R, ref, m, b = j0030
    f = _j0030_fitter(j0030, "analytic")
    f.sampler.initialize_batched(f.lnposterior_batch, f.n_fit_params)
    f.sampler.run_mcmc(ref["ref/photon/analytic/pos"].copy(), 2)
    want = ref["ref/photon/analytic/walker_chain"].transpose(2, 0, 1)[:2]
    assert np.array_equal(f.sampler.get_chain(), want)
    assert np.allclose(f.sampler.get_log_prob(),
                       ref["ref/photon/analytic/lnprob"][:2], rtol=1e-12,
                       atol=0)
